"""The golden statistical gates of the bundled example workflows
(tests/test_examples.py:55-188) on gpax_torch, on the CPU.

Each gate runs the JAX test's workflow through the port with the same
data, sizes, budgets, NUTS tree depth (the default of 10) and bands, as
examples_torch/golden.py writes them (chip_smoke.py runs the same file on
the card). The simpleGP workflow is also held to gpax_tpu directly: the
port's posterior means of the hyperparameters within 4 combined posterior
sd of a JAX fit of the same data (Monte-Carlo tolerance: the RNG streams
differ), and the port's ``predict_moments`` on the JAX fit's draws,
injected through ``utils.samples_from_numpy``, within float32 tolerance of
gpax_tpu's on the same draws. The MultiTaskGP BO gate is in
tests/test_torch_examples_golden_mtgp.py."""

import os
import runpy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpax_tpu
from _torch_parity import assert_close, to_np
from gpax_torch.utils import get_keys, samples_from_numpy

torch.set_num_threads(1)

GOLDEN = runpy.run_path(os.path.join(os.path.dirname(__file__), "..", "examples_torch",
                                     "golden.py"))
SITES = ("k_length", "k_scale", "noise")
# the port's posterior means against the JAX fit's, in combined posterior sd
CROSS_SD = 4.0
# predictive moments on the same injected draws: float32 grams on both sides
MOMENTS_RTOL, MOMENTS_ATOL = 1e-4, 1e-5


def assert_gates(gates, names=None):
    """Each gate (value, passed, band) of ``names`` (all if None) passed."""
    for name in names or gates:
        value, passed, band = gates[name]
        assert passed, (name, value, band)


@pytest.fixture(scope="module")
def simple_gp():
    """The port's simpleGP fit (tests/test_examples.py:55-65) and its gates,
    shared by the two simpleGP gates and the cross-check."""
    gp = GOLDEN["simple_gp_fit"]("cpu")
    return gp, GOLDEN["simple_gp_gates"](gp, "cpu")


@pytest.fixture(scope="module")
def simple_gp_jax():
    """The same fit in gpax_tpu, on the CPU in JAX."""
    X, y, _, _ = GOLDEN["simple_gp_data"]()
    gp = gpax_tpu.ExactGP(1, "RBF")
    gp.fit(gpax_tpu.utils.get_keys()[0], jnp.asarray(X, jnp.float32),
           jnp.asarray(y, jnp.float32), num_warmup=200, num_samples=200,
           print_summary=False, progress_bar=False)
    return gp


def test_golden_simple_gp_posterior_bands(simple_gp):
    """simpleGP workflow: posterior predictive recovers sin(2x) and the noise
    posterior concentrates near the generating sd (0.1)."""
    assert_gates(simple_gp[1], ("rmse", "noise_mean", "k_length_mean"))


def test_golden_simple_gp_calibration(simple_gp):
    """Central ~95% predictive intervals cover the truth at a sane rate."""
    assert_gates(simple_gp[1], ("coverage",))


@pytest.mark.parametrize("site", SITES)
def test_golden_simple_gp_posterior_against_jax(simple_gp, simple_gp_jax, site):
    """The port's posterior mean of each hyperparameter within CROSS_SD
    combined posterior sd of gpax_tpu's fit of the same data."""
    t = to_np(simple_gp[0].get_samples()[site]).reshape(200, -1)
    j = np.asarray(simple_gp_jax.get_samples()[site]).reshape(200, -1)
    sd = np.sqrt(t.var(0) + j.var(0))
    assert (np.abs(t.mean(0) - j.mean(0)) <= CROSS_SD * sd).all(), (t.mean(0), j.mean(0), sd)


def test_golden_simple_gp_moments_on_jax_draws(simple_gp, simple_gp_jax):
    """predict_moments on the JAX fit's draws, injected into the port's
    model, equals gpax_tpu's on the same draws to float32 tolerance."""
    _, _, X_test, _ = GOLDEN["simple_gp_data"]()
    jmean, jvar = simple_gp_jax.predict_moments(gpax_tpu.utils.get_keys()[1],
                                                jnp.asarray(X_test, jnp.float32)[:, None],
                                                noiseless=True)
    draws = samples_from_numpy({k: np.asarray(v) for k, v in simple_gp_jax.get_samples().items()},
                               device="cpu")
    mean, var = simple_gp[0].predict_moments(get_keys()[1], GOLDEN["f32"](X_test)[:, None],
                                             samples=draws, noiseless=True, device="cpu")
    assert_close(mean, jmean, rtol=MOMENTS_RTOL, atol=MOMENTS_ATOL)
    assert_close(var, jvar, rtol=MOMENTS_RTOL, atol=MOMENTS_ATOL)


def test_golden_vigp_sparse_image():
    """viGP workflow: 2D sparse-image reconstruction error band."""
    assert_gates(GOLDEN["vigp_sparse_image"]("cpu"))


def test_golden_visparsegp_reconstruction():
    """viSparseGP workflow: inducing-point 1D reconstruction error band."""
    assert_gates(GOLDEN["visparsegp_reconstruction"]("cpu"))


def test_golden_vidkl_active_learning_step():
    """viDKL AL workflow: pool RMSE band, a finite (200, 2) embedding, and
    the acquisition step proposes informative (unmeasured) pool points."""
    assert_gates(GOLDEN["vidkl_active_learning"]("cpu"))
