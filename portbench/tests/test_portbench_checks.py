"""The plain reference against gpax_torch's CPU path at tiny sizes, and the
check of each cell seeing its faults: a run with the timed path broken
underneath (the harness's look for a card left out) comes out not correct.

The faults: a step that returns its state unchanged; half of the batch left
out, the mean taken over the rest; an answer altered where it is produced
(the draws, and the θ-gradient the sampler steps by). No cell runs across
chips, so none can leave out an exchange between them.
"""

from __future__ import annotations

import pytest

import gpax_torch
import gpax_torch.acquisition.acquisition as acq_mod
import gpax_torch.infer.nuts as nuts_mod
import gpax_torch.models.gp as gp_mod
import gpax_torch.ops.linalg as linalg
import gpax_torch.ppl.util as ppl_util

from .conftest import run_in_process, tiny_cell


@pytest.fixture(params=["never", "always"])
def likelihood_route(request):
    """The composed likelihood (the CPU's default) and the fused one (the
    card's at n ≤ 8192), restored after the test."""
    old = gpax_torch.get_config().use_fused_likelihood
    gpax_torch.set_config(use_fused_likelihood=request.param)
    yield request.param
    gpax_torch.set_config(use_fused_likelihood=old)


def test_reference_holds_the_fit(likelihood_route):
    """The draws' recorded potentials and the sampler's θ-gradient against
    the reference's, on both likelihood routes: float32 rounding of U ≈ −100
    and of the gram."""
    _, judged, run = run_in_process(tiny_cell("gp4096.fit"), seconds=1.5)
    assert run.checks["potential_gap"] < 2e-3
    assert run.checks["grad_gap"] < 2e-3
    assert run.checks["draw_excess"] < 20.0


def test_reference_holds_the_scores():
    """EI from the program's float32 predictive against float64."""
    _, _, run = run_in_process(tiny_cell("gp4096.score"), seconds=0.5)
    assert run.checks["ei_gap"] < 1e-3


def test_control_is_read_at_the_same_draws():
    """``--control 1`` reads the sampler's gradient with its WᵀW in float32
    at the run's own draws, and restores the configuration after it."""
    _, _, run = run_in_process(tiny_cell("gp4096.fit"), seconds=1.0, control=True)
    assert set(run.control) == {"potential_gap", "grad_gap"}
    assert run.control["grad_gap"] != run.checks["grad_gap"]
    assert gpax_torch.get_config().hmc_wtw_precision is None


def _half_mvn(orig):
    """The composed route's Gaussian log density of every other point,
    doubled."""
    def half(K, diff):
        return 2.0 * orig(K[..., ::2, ::2], diff[..., ::2])
    return half


def _half_fused(orig):
    """The fused route's (the card's) log density of every other point,
    doubled."""
    def half(X, k_length, k_scale, noise, diff, kind):
        return 2.0 * orig(X[..., ::2, :], k_length, k_scale, noise, diff[..., ::2], kind)
    return half


def _half_batch(mp):
    mp.setattr(linalg, "mvn_log_prob_centered", _half_mvn(linalg.mvn_log_prob_centered))
    mp.setattr(gp_mod, "gp_mvn_log_prob", _half_fused(gp_mod.gp_mvn_log_prob))


def _scaled(orig, factor: float = 1.01):
    """``orig`` with every tensor it returns (alone, in a tuple or in a
    dict) multiplied by ``factor``."""
    def altered(*args, **kwargs):
        out = orig(*args, **kwargs)
        if isinstance(out, dict):
            return {k: v * factor for k, v in out.items()}
        return tuple(o * factor for o in out) if isinstance(out, tuple) else out * factor
    return altered


def _half_train(orig):
    """The predictive on every other training point."""
    def half(k_XX, k_pX, k_pp_diag, y):
        return orig(k_XX[..., ::2, ::2], k_pX[..., ::2], k_pp_diag, y[..., ::2])
    return half


def _frozen_step(potential_grad, state, *args, **kwargs):
    return state


def _steeper(make, factor: float = 1.25):
    """``make_potential_fn`` whose potentials keep their values and whose
    gradients come out ``factor`` times too large."""
    def made(*args, **kwargs):
        fn = make(*args, **kwargs)

        def potential(z):
            u = fn(z)
            return u + (factor - 1.0) * (u - u.detach())
        return potential
    return made


FAULTS = {
    "gp4096.fit": {
        "state unchanged": lambda mp: mp.setattr(nuts_mod, "nuts_step", _frozen_step),
        "half the batch": _half_batch,
        "answer altered": lambda mp: mp.setattr(
            gpax_torch.ExactGP, "get_samples", _scaled(gpax_torch.ExactGP.get_samples, 2.0)),
        "gradient altered": lambda mp: mp.setattr(ppl_util, "make_potential_fn",
                                                  _steeper(ppl_util.make_potential_fn)),
    },
    "gp4096.score": {
        "half the batch": lambda mp: mp.setattr(gp_mod, "gp_predictive_mean_var",
                                                _half_train(gp_mod.gp_predictive_mean_var)),
        "answer altered": lambda mp: mp.setattr(acq_mod, "ei", _scaled(acq_mod.ei, 1.25)),
    },
}


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items() for f in fs])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    FAULTS[cell][fault](monkeypatch)
    line, judged, _ = run_in_process(tiny_cell(cell), seconds=1.0)
    assert line["correct"] is False, judged


@pytest.mark.parametrize("cell", list(FAULTS))
def test_a_sound_tiny_run_is_correct(cell):
    line, judged, _ = run_in_process(tiny_cell(cell), seconds=1.0)
    assert line["correct"] is True, judged
