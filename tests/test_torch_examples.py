"""The gpax_torch example scripts (examples_torch/) on the CPU, under
SMOKE=1 (tests/test_examples.py:28-35 runs their JAX forms): the NUTS
scripts of the GP, BO, hypothesis and structured workflows at the JAX
budgets with the tree depth cut to 5, and the SVI scripts as they are.
tests/test_torch_examples_models.py runs the other NUTS scripts.
Also MeasuredNoiseGP.fit's refusal of the sampler options it does not take
(the JAX package hands them on to the kernel, which ignores them), and
``utils.samples_from_numpy`` on the read-only arrays that JAX's draws give.
``run_script`` is the runner of both files: each script is loaded with
SMOKE=1 and its ``main(device="cpu")`` called, with ``nuts=...`` for a
NUTS script; its output must not be empty and must hold no "nan" (as
tests/test_examples.py:28-35 checks the JAX scripts), it must print the
JAX script's statistics, and its return must have the JAX script's
structure."""

import os
import runpy
import warnings

import numpy as np
import pytest
import torch

import gpax_torch

torch.set_num_threads(1)

EXAMPLES_DIR = os.path.join(os.path.dirname(__file__), "..", "examples_torch")

# the depth cut of the NUTS scripts on the CPU (their budgets are not cut;
# hypothesis_learning.py and measured_noise_gp.py merge only the budget, as
# their entry points take no depth)
NUTS_CUT = dict(max_tree_depth=5)


def _floats(n):
    def check(r):
        return (isinstance(r, tuple) and len(r) == n
                and all(isinstance(v, (float, np.floating)) for v in r))
    return check


def _is_float(r):
    return isinstance(r, float)


def _record(r):
    return isinstance(r, np.ndarray) and r.shape == (2, 2)


def _results(r):
    return (isinstance(r, dict) and list(r) == ["ExactGP-Matern", "iBNN", "DKL"]
            and all(_floats(2)(v) for v in r.values()))


# script -> (the lines its JAX form prints, by their opening words; the
# structure of what main() returns)
SCRIPTS = {
    "simple_gp.py": (("prior draws: (4, 12)", "RMSE vs truth:"), _is_float),
    "vigp_sparse_image.py": (("measured ", "reconstruction RMSE:"), _is_float),
    "gp_bo.py": (("iter 00: x_next=", "iter 03: x_next=", "best x:"), _is_float),
    "vidkl_active_learning.py": (("AL step 00: pool RMSE", "AL step 01: pool RMSE",
                                  "latent embedding: (40, 2)"), _is_float),
    "multitask_bo.py": (("high-fidelity RMSE from 4 expensive + 12 cheap points:",
                         "next expensive measurement at x ="), _is_float),
    "hypothesis_learning.py": (("step 0: hypothesis=", "step 2: hypothesis=",
                                "final running rewards:"), _record),
    "sparse_gp_reconstruction.py": (("12 inducing points optimized for 60 observations",
                                     "grid reconstruction RMSE:"), _is_float),
    "heteroskedastic_gp.py": (("inferred noise sd: left", "predictive mean finite: True"),
                              _floats(2)),
    "uncertain_inputs.py": (("inferred input noise sd:", "latent-input recovery improvement:",
                             "predictive mean finite: True"), _is_float),
    "measured_noise_gp.py": (("RMSE vs truth:", "sampled predictions: (100, 2, 41)"),
                             _is_float),
    "compare_gps.py": (("model ", "ExactGP-Matern ", "iBNN ", "DKL ", "best RMSE:"),
                       _results),
    "structured_gp.py": (("extrapolation RMSE  structured-GP:",), _floats(2)),
}


def run_script(script, monkeypatch, capsys, nuts=None):
    """Load examples_torch/<script> under SMOKE=1, run ``main(device="cpu")``
    (with ``nuts=nuts`` unless it is None) and check its output and its
    return."""
    monkeypatch.setenv("SMOKE", "1")
    ns = runpy.run_path(os.path.join(EXAMPLES_DIR, script), run_name="examples_torch")
    result = ns["main"](device="cpu", **({} if nuts is None else {"nuts": nuts}))
    out = capsys.readouterr().out
    assert out.strip(), f"{script} produced no output"
    assert "nan" not in out.lower().replace("nanarg", ""), out
    lines, structure = SCRIPTS[script]
    for opening in lines:
        assert any(line.startswith(opening) for line in out.splitlines()), (opening, out)
    assert structure(result), result
    return result


NUTS_SCRIPTS = ["simple_gp.py", "gp_bo.py", "hypothesis_learning.py", "structured_gp.py"]
SVI_SCRIPTS = ["vigp_sparse_image.py", "sparse_gp_reconstruction.py",
               "vidkl_active_learning.py"]


@pytest.mark.parametrize("script", NUTS_SCRIPTS)
def test_example_nuts_script(script, monkeypatch, capsys):
    run_script(script, monkeypatch, capsys, nuts=NUTS_CUT)


@pytest.mark.parametrize("script", SVI_SCRIPTS)
def test_example_svi_script(script, monkeypatch, capsys):
    run_script(script, monkeypatch, capsys)


def _measured_noise_data():
    rng = np.random.default_rng(0)
    X = np.linspace(-1, 1, 12)
    return X, np.sin(3 * X) + 0.05 * rng.normal(size=12), np.full(12, 0.01)


@pytest.mark.parametrize("option", [dict(max_tree_depth=5), dict(segment_size=10),
                                    dict(target_accept_prob=0.9)])
def test_measured_noise_gp_refuses_sampler_options(option):
    """A sampler option of ExactGP.fit that MeasuredNoiseGP.fit does not take
    raises TypeError before any draw, where it would reach the kernel and be
    ignored there."""
    model = gpax_torch.MeasuredNoiseGP(1, "Matern")
    with pytest.raises(TypeError, match=next(iter(option))):
        model.fit(gpax_torch.utils.get_keys()[0], *_measured_noise_data(), num_warmup=5,
                  num_samples=5, print_summary=False, progress_bar=False, device="cpu",
                  **option)
    assert model.mcmc is None


def test_measured_noise_gp_threads_jitter():
    """The keywords MeasuredNoiseGP.fit does take on to the kernel still pass."""
    model = gpax_torch.MeasuredNoiseGP(1, "Matern")
    model.fit(gpax_torch.utils.get_keys()[0], *_measured_noise_data(), num_warmup=5,
              num_samples=5, print_summary=False, progress_bar=False, device="cpu", jitter=1e-5)
    assert tuple(model.get_samples()["k_length"].shape[:1]) == (5,)


def test_samples_from_numpy_copies_read_only_draws():
    """JAX's draws reach numpy as read-only arrays; the carried tensors own
    their memory (no warning), so writing them leaves the draws alone."""
    draws = np.arange(6, dtype=np.float32)
    draws.flags.writeable = False
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        carried = gpax_torch.utils.samples_from_numpy({"noise": draws}, device="cpu")
    carried["noise"] += 1.0
    np.testing.assert_array_equal(draws, np.arange(6, dtype=np.float32))
