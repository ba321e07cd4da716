"""The port's notebooks (examples_torch/notebooks/) on the CPU.

Static checks of the fourteen notebooks, one case a notebook: the
generator (examples_torch/make_notebooks.py) rewrites each byte for byte,
their names mirror examples/notebooks/, every code cell compiles with no
IPython magic and imports neither jax nor gpax_tpu, each has one
``parameters`` cell with ``DEVICE = None``, no cell mentions the TPU, and a
script's notebook holds the script's body. Then the notebook runner
(examples_torch/notebook_runner.py), and three notebooks through it with
``DEVICE = "cpu"`` and their budgets cut in the parameters cell: the
tutorial at 100 + 100 draws of its 500 + 500, held to gpax_tpu fits of the
same data at the same budget (posterior means within 4 combined posterior
sd, Monte-Carlo tolerance, since the RNG streams differ; ``predict_moments``
on the JAX draws injected through ``utils.samples_from_numpy`` within
float32 tolerance: tests/test_torch_examples_golden.py's limits); the
contrib notebook at 2 of its 15 active-learning steps; simple_gp.ipynb
against its script at the same cut. Each notebook's closing assertions must
hold. Under NOTEBOOK_SMOKE=1 only, every notebook runs uncut through
nbclient, as tests/test_examples.py runs the JAX ones."""

import ast
import os
import pathlib
import re
import runpy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpax_tpu
from _torch_parity import assert_close, to_np
from gpax_torch.utils import get_keys, samples_from_numpy
from test_torch_examples import NUTS_CUT, run_script

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
NB_DIR = ROOT / "examples_torch" / "notebooks"
JAX_NB_DIR = ROOT / "examples" / "notebooks"
MAKE = runpy.run_path(str(ROOT / "examples_torch" / "make_notebooks.py"))
RUNNER = runpy.run_path(str(ROOT / "examples_torch" / "notebook_runner.py"))
NOTEBOOKS = sorted(MAKE["notebooks"]())
SCRIPTS = [p.name for p in MAKE["scripts"]()]

SITES = ("k_length", "k_scale", "noise")
# the tutorial's posterior means against the JAX fit's, in combined posterior sd
CROSS_SD = 4.0
# predictive moments on the same injected draws: float32 grams on both sides
MOMENTS_RTOL, MOMENTS_ATOL = 1e-4, 1e-5
# the cuts: the tutorial's two fits (500 + 500 in the notebook), the contrib
# notebook's active-learning steps (15 in the notebook)
TUTORIAL_NUTS = dict(num_warmup=100, num_samples=100)
CONTRIB_AL_STEPS = 2
# "TPU" as a word or after an underscore ("gpax_tpu"), not inside "outputs"
TPU = re.compile(r"(?<![a-z])tpu(?![a-z])", re.IGNORECASE)


def code_cells(name):
    nb = RUNNER["read_notebook"](NB_DIR / name)
    return [c for c in nb["cells"] if c["cell_type"] == "code"]


def imported_roots(source):
    roots = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    return roots


# ------------------------------------------------------------------ static

@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    out = tmp_path_factory.mktemp("notebooks")
    MAKE["write_all"](out)
    return out


@pytest.mark.parametrize("name", NOTEBOOKS)
def test_notebook_is_generated(generated, name):
    """The committed notebook is the generator's output, byte for byte."""
    assert (NB_DIR / name).read_bytes() == (generated / name).read_bytes()


def test_notebook_names_mirror_jax():
    def names(d):
        return {str(p.relative_to(d)) for p in d.rglob("*.ipynb")}
    assert names(NB_DIR) == names(JAX_NB_DIR) == set(NOTEBOOKS)
    assert len(NOTEBOOKS) == 14


@pytest.mark.parametrize("name", NOTEBOOKS)
def test_notebook_code_cells(name):
    """Every code cell compiles, has no IPython magic and imports neither
    jax nor gpax_tpu."""
    for i, cell in enumerate(code_cells(name)):
        src = RUNNER["cell_source"](cell)
        compile(src, f"{name}[{i}]", "exec")
        assert not any(line.lstrip().startswith(("%", "!")) for line in src.splitlines()), src
        assert "get_ipython" not in src
        assert not imported_roots(src) & {"jax", "jaxlib", "gpax_tpu"}, (i, src)


@pytest.mark.parametrize("name", NOTEBOOKS)
def test_notebook_parameters_cell(name):
    """Exactly one code cell is tagged ``parameters``, and it sets DEVICE
    to None (the card)."""
    cells = [c for c in code_cells(name) if "parameters" in RUNNER["cell_tags"](c)]
    assert len(cells) == 1
    values = {t.id: node.value for node in ast.parse(RUNNER["cell_source"](cells[0])).body
              if isinstance(node, ast.Assign) for t in node.targets}
    assert isinstance(values["DEVICE"], ast.Constant) and values["DEVICE"].value is None


@pytest.mark.parametrize("name", NOTEBOOKS)
def test_notebook_mentions_no_tpu(name):
    """No cell says "TPU" (or "gpax_tpu"), in any case."""
    nb = RUNNER["read_notebook"](NB_DIR / name)
    for cell in nb["cells"]:
        assert not TPU.search(RUNNER["cell_source"](cell)), RUNNER["cell_source"](cell)


@pytest.mark.parametrize("script", SCRIPTS)
def test_script_notebook_holds_the_script(script):
    """A script's notebook: its code cell is the script without its
    docstring and its ``__main__`` guard, and its last cell calls ``main``
    on DEVICE (with NUTS where ``main`` takes it)."""
    src = (ROOT / "examples_torch" / script).read_text()
    after_doc = "\n".join(src.splitlines()[ast.parse(src).body[0].end_lineno:])
    body = after_doc.split('\nif __name__ == "__main__":')[0].strip()
    cells = code_cells(script.replace(".py", ".ipynb"))
    assert RUNNER["cell_source"](cells[0]) == body
    takes_nuts = "def main(device=None, nuts=None)" in src
    call = "main(device=DEVICE, nuts=NUTS)" if takes_nuts else "main(device=DEVICE)"
    assert RUNNER["cell_source"](cells[-1]) == f"result = {call}\nprint('done:', result)"


def test_names_mirror_scripts():
    assert {s.replace(".py", ".ipynb") for s in SCRIPTS} | {
        "simple_gp_tutorial.ipynb", "contrib/dkl_molecular_active_learning.ipynb"} == set(NOTEBOOKS)
    assert len(SCRIPTS) == 12


# ------------------------------------------------------------------ runner

def _tiny(tmp_path, *cells):
    path = tmp_path / "tiny.ipynb"
    path.write_text(MAKE["to_json"](MAKE["notebook"](list(cells))))
    return path


def test_runner_injects_parameters(tmp_path):
    path = _tiny(tmp_path, MAKE["code"]("A = 1\nB = None", "parameters"),
                 MAKE["code"]("C = A * 2"))
    ns = RUNNER["run_notebook"](path, {"A": 5})
    assert (ns["C"], ns["B"]) == (10, None)
    assert RUNNER["run_notebook"](path)["C"] == 2
    with pytest.raises(ValueError, match="does not define"):
        RUNNER["run_notebook"](path, {"Z": 1})
    with pytest.raises(ValueError, match="not a literal"):
        RUNNER["run_notebook"](path, {"A": torch.zeros(1)})


def test_runner_needs_one_parameters_cell(tmp_path):
    path = _tiny(tmp_path, MAKE["code"]("A = 1"))
    with pytest.raises(ValueError, match="0 cells tagged"):
        RUNNER["run_notebook"](path, {"A": 5})


def test_runner_names_the_failing_cell(tmp_path):
    path = _tiny(tmp_path, MAKE["md"]("# title"), MAKE["code"]("A = 1"),
                 MAKE["code"]("A / 0"), MAKE["code"]("B = 2"))
    with pytest.raises(ZeroDivisionError) as info:
        RUNNER["run_notebook"](path)
    assert "raised in tiny.ipynb, cell 2" in info.value.__notes__


def test_runner_plot_cells(tmp_path, monkeypatch, capsys):
    """Plot cells run on Agg with their figures closed, or are left out
    with a printed count: on request, or where matplotlib does not import
    (then ``plots=True`` raises)."""
    import matplotlib.pyplot as plt

    path = _tiny(tmp_path, MAKE["code"]("A = 1"),
                 MAKE["plot"]("import matplotlib.pyplot as plt\nplt.figure()"))
    ns = RUNNER["run_notebook"](path)
    assert ns["__notebook__"]["plot_cells_run"] == 1 and not plt.get_fignums()
    ns = RUNNER["run_notebook"](path, plots=False)
    assert ns["__notebook__"]["plot_cells_left_out"] == 1
    assert "left out 1 of 1 plot cells (plots=False)" in capsys.readouterr().out
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    ns = RUNNER["run_notebook"](path)
    assert (ns["A"], ns["__notebook__"]["plot_cells_left_out"]) == (1, 1)
    assert "(matplotlib is not installed)" in capsys.readouterr().out
    with pytest.raises(ImportError):
        RUNNER["run_notebook"](path, plots=True)


# ------------------------------------------------------------------ runs

@pytest.fixture(scope="module")
def tutorial():
    return RUNNER["run_notebook"](NB_DIR / "simple_gp_tutorial.ipynb",
                                  {"DEVICE": "cpu", "NUTS": TUTORIAL_NUTS})


@pytest.fixture(scope="module")
def tutorial_jax(tutorial):
    """gpax_tpu fits of the tutorial's data at its budget: default priors,
    and the Gamma(2, 5) lengthscale prior."""
    X, y = (jnp.asarray(tutorial[k], jnp.float32) for k in ("X", "y"))
    fits = {}
    for model, prior in (("gp_model", None), ("gp_model2", gpax_tpu.utils.gamma_dist(2, 5))):
        gp = gpax_tpu.ExactGP(1, "RBF", lengthscale_prior_dist=prior)
        gp.fit(gpax_tpu.utils.get_keys()[0], X, y, progress_bar=False, print_summary=False,
               **TUTORIAL_NUTS)
        fits[model] = gp
    return fits


def test_tutorial_runs(tutorial):
    """Every cell ran, the plots included, and the closing assertion held."""
    record = tutorial["__notebook__"]
    assert record["plot_cells_run"] == 6 and record["plot_cells_left_out"] == 0
    assert record["cells_run"] == len(code_cells("simple_gp_tutorial.ipynb")) + 1
    assert tutorial["rmse"] < 0.5
    assert tutorial["curves"].shape == tutorial["curves2"].shape == (100, 100)


@pytest.mark.parametrize("model", ["gp_model", "gp_model2"])
@pytest.mark.parametrize("site", SITES)
def test_tutorial_posterior_against_jax(tutorial, tutorial_jax, model, site):
    """The port's posterior mean of each hyperparameter within CROSS_SD
    combined posterior sd of gpax_tpu's fit of the same data and prior."""
    t = to_np(tutorial[model].get_samples()[site]).reshape(TUTORIAL_NUTS["num_samples"], -1)
    j = np.asarray(tutorial_jax[model].get_samples()[site]).reshape(t.shape)
    sd = np.sqrt(t.var(0) + j.var(0))
    assert (np.abs(t.mean(0) - j.mean(0)) <= CROSS_SD * sd).all(), (t.mean(0), j.mean(0), sd)


@pytest.mark.parametrize("model", ["gp_model", "gp_model2"])
def test_tutorial_moments_on_jax_draws(tutorial, tutorial_jax, model):
    """predict_moments on the JAX fit's draws, injected into the port's
    fitted model, equals gpax_tpu's on the same draws to float32 tolerance."""
    X_test = np.asarray(tutorial["X_test"], np.float32)[:, None]
    jax_gp = tutorial_jax[model]
    jmean, jvar = jax_gp.predict_moments(gpax_tpu.utils.get_keys()[1], jnp.asarray(X_test),
                                         noiseless=True)
    draws = samples_from_numpy({k: np.asarray(v) for k, v in jax_gp.get_samples().items()},
                               device="cpu")
    mean, var = tutorial[model].predict_moments(get_keys()[1], torch.from_numpy(X_test),
                                                samples=draws, noiseless=True, device="cpu")
    assert_close(mean, jmean, rtol=MOMENTS_RTOL, atol=MOMENTS_ATOL)
    assert_close(var, jvar, rtol=MOMENTS_RTOL, atol=MOMENTS_ATOL)


def test_contrib_notebook():
    """The contrib notebook at CONTRIB_AL_STEPS active-learning steps: its
    closing assertion held, and its embedding and predictions are finite."""
    ns = RUNNER["run_notebook"](NB_DIR / "contrib" / "dkl_molecular_active_learning.ipynb",
                                {"DEVICE": "cpu", "AL_STEPS": CONTRIB_AL_STEPS})
    assert len(ns["rmse_trace"]) == CONTRIB_AL_STEPS and ns["rmse_trace"][-1] < 1.0
    assert np.isfinite(ns["rmse_trace"]).all()
    assert ns["z_all"].shape == (600, 2) and np.isfinite(ns["z_all"]).all()
    assert tuple(ns["pred_mean"].shape) == tuple(ns["pred_var"].shape) == (600,)
    assert len(ns["measured"]) == 30 + CONTRIB_AL_STEPS and 0 <= ns["found"] <= 10


class _RecordingCapsys:
    """capsys that keeps what it hands out."""

    def __init__(self, capsys):
        self.capsys, self.out = capsys, ""

    def readouterr(self):
        captured = self.capsys.readouterr()
        self.out += captured.out
        return captured


def test_simple_gp_notebook_matches_script(monkeypatch, capsys):
    """simple_gp.ipynb under SMOKE=1 prints the lines and returns the result
    of examples_torch/simple_gp.py run by run_script at the same cut."""
    recorder = _RecordingCapsys(capsys)
    expected = run_script("simple_gp.py", monkeypatch, recorder, nuts=NUTS_CUT)
    ns = RUNNER["run_notebook"](NB_DIR / "simple_gp.ipynb", {"DEVICE": "cpu", "NUTS": NUTS_CUT})
    assert capsys.readouterr().out == recorder.out + f"done: {expected}\n"
    assert ns["result"] == expected


# ------------------------------------------------------------------ uncut

@pytest.mark.skipif(not bool(int(os.environ.get("NOTEBOOK_SMOKE", "0"))),
                    reason="set NOTEBOOK_SMOKE=1 to execute the notebooks uncut")
@pytest.mark.parametrize("name", NOTEBOOKS)
def test_notebook_smoke(name, monkeypatch):
    """The notebook uncut through nbclient under SMOKE=1, as
    tests/test_examples.py runs the JAX ones; where there is no card, a
    ``DEVICE = "cpu"`` cell is injected after the parameters cell."""
    import nbformat
    from nbclient import NotebookClient

    monkeypatch.setenv("SMOKE", "1")
    nb = nbformat.read(NB_DIR / name, as_version=4)
    if not torch.cuda.is_available():
        nb = nbformat.from_dict(RUNNER["inject_parameters"](nb, {"DEVICE": "cpu"}, name))
    client = NotebookClient(nb, timeout=2400, kernel_name="python3",
                            resources={"metadata": {"path": str(ROOT)}})
    client.execute()
