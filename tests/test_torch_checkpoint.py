"""gpax_torch.utils checkpoints and monitoring against gpax_tpu:
tests/test_parallel_ckpt.py:82-133 (the HMC and SVI round trips, pytrees,
fit_report and timed), the .npz layout shared with the JAX package (a file
written by either loads in the other and predicts the same), and the
port's torch.profiler trace and anomaly detection."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpax_torch
import gpax_tpu
from _torch_parity import assert_close, to_np
from gpax_torch.utils import (debug_nans, fit_report, load_model, load_pytree, profile,
                              save_model, save_pytree, timed)

torch.set_num_threads(1)

FIT = dict(print_summary=False, progress_bar=False)
# predictive means of the two packages on the same draws: float32 grams,
# the port's factor in float64 (as tests/test_torch_gp.py holds them)
CROSS_RTOL, CROSS_ATOL = 2e-4, 2e-5


def _data(n=10):
    rng = np.random.default_rng(0)
    X = rng.uniform(-1, 1, n).astype(np.float32)
    return X, np.sin(3 * X).astype(np.float32)


def _fitted_exactgp(n=10):
    X, y = _data(n)
    m = gpax_torch.ExactGP(1, "RBF")
    m.fit(gpax_torch.utils.get_keys()[0], X, y, num_warmup=60, num_samples=60, device="cpu",
          **FIT)
    return m


def test_checkpoint_roundtrip_hmc(tmp_path):
    """tests/test_parallel_ckpt.py:82-96: the draws, the data and predict
    (bit for bit with the same key)."""
    m = _fitted_exactgp()
    path = os.path.join(tmp_path, "gp_ckpt")
    save_model(path, m)
    m2 = load_model(path, gpax_torch.ExactGP(1, "RBF"), device="cpu")
    assert torch.equal(m2.X_train, m.X_train) and torch.equal(m2.y_train, m.y_train)
    s1, s2 = m.get_samples(), m2.get_samples()
    assert torch.equal(s1["noise"], s2["noise"])
    assert m2.get_samples(chain_dim=True)["noise"].shape == (1, 60)
    mean1, draws1 = m.predict(gpax_torch.utils.get_keys()[1], np.linspace(-1, 1, 7),
                              device="cpu")
    mean2, draws2 = m2.predict(gpax_torch.utils.get_keys()[1], np.linspace(-1, 1, 7),
                               device="cpu")
    assert torch.equal(mean1, mean2) and torch.equal(draws1, draws2)


def test_checkpoint_roundtrip_vi(tmp_path):
    """tests/test_parallel_ckpt.py:99-115: a viGP's medians and predict."""
    X, y = _data(12)
    m = gpax_torch.viGP(1, "RBF")
    m.fit(gpax_torch.utils.get_keys()[0], X, y, num_steps=150, device="cpu", **FIT)
    path = os.path.join(tmp_path, "vigp_ckpt")
    save_model(path, m)
    m2 = load_model(path, gpax_torch.viGP(1, "RBF"), device="cpu")
    p1, p2 = m.get_samples(), m2.get_samples()
    assert_close(p2["noise"], p1["noise"], rtol=1e-6)
    mean1, _ = m.predict(gpax_torch.utils.get_keys()[1], X, device="cpu")
    mean2, _ = m2.predict(gpax_torch.utils.get_keys()[1], X, device="cpu")
    assert_close(mean2, mean1, rtol=1e-5)


def test_save_load_pytree(tmp_path):
    """tests/test_parallel_ckpt.py:118-124, with the JAX package reading the
    port's file and the reverse, key for key."""
    tree = {"a": torch.ones(3), "b": {"c": torch.zeros((2, 2)), "d": torch.tensor(2.0)}}
    p = os.path.join(tmp_path, "tree")
    save_pytree(p, tree)
    back = load_pytree(p, device="cpu")
    assert torch.equal(back["b"]["c"], torch.zeros(2, 2)) and torch.equal(back["a"], torch.ones(3))
    jback = gpax_tpu.utils.load_pytree(p)
    np.testing.assert_array_equal(np.asarray(jback["b"]["d"]), 2.0)
    gpax_tpu.utils.save_pytree(os.path.join(tmp_path, "jtree"),
                               {"x": jnp.arange(3.0), "y": {"z": jnp.ones((2,))}})
    tback = load_pytree(os.path.join(tmp_path, "jtree.npz"), device="cpu")
    assert tback["x"].tolist() == [0.0, 1.0, 2.0] and tback["y"]["z"].shape == (2,)
    with np.load(p + ".npz") as f:
        assert sorted(f.files) == ["a", "b/c", "b/d"]


def test_fit_report_and_timed():
    """tests/test_parallel_ckpt.py:127-133."""
    m = _fitted_exactgp()
    with timed("report") as t:
        rep = fit_report(m.mcmc)
    assert t.seconds is not None
    assert 0.0 < rep["mean_accept_prob"] <= 1.0
    assert rep["num_chains"] == 1 and rep["num_samples"] == 60
    assert "noise" in rep["max_rhat"]
    assert rep["min_ess"]["noise"] > 0
    assert rep["num_divergences"] >= 0 and rep["final_step_size"] > 0


def _jax_fitted_exactgp(n=10):
    X, y = _data(n)
    m = gpax_tpu.ExactGP(1, "RBF")
    m.fit(jax.random.PRNGKey(0), jnp.asarray(X), jnp.asarray(y), num_warmup=40,
          num_samples=40, **FIT)
    return m


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    """A file written by gpax_tpu.utils.save_model: the port's load_model
    restores its draws and data, and predicts JAX's mean on those draws."""
    jm = _jax_fitted_exactgp()
    path = os.path.join(tmp_path, "jax_gp")
    gpax_tpu.utils.save_model(path, jm)
    tm = load_model(path, gpax_torch.ExactGP(1, "RBF"), device="cpu")
    np.testing.assert_array_equal(to_np(tm.get_samples()["k_scale"]),
                                  np.asarray(jm.get_samples()["k_scale"]))
    X_new = np.linspace(-1, 1, 7).astype(np.float32)
    jmean, _ = jm.predict(jax.random.PRNGKey(1), jnp.asarray(X_new), noiseless=True)
    tmean, tdraws = tm.predict(1, X_new, noiseless=True, device="cpu")
    assert tdraws.shape == (40, 1, 7)
    assert_close(tmean, jmean, rtol=CROSS_RTOL, atol=CROSS_ATOL)


def test_port_checkpoint_loads_in_jax(tmp_path):
    """The reverse: the port's save_model file through
    gpax_tpu.utils.load_model predicts the port's mean on the same draws."""
    tm = _fitted_exactgp()
    path = os.path.join(tmp_path, "port_gp")
    save_model(path, tm)
    jm = gpax_tpu.utils.load_model(path, gpax_tpu.ExactGP(1, "RBF"))
    np.testing.assert_array_equal(np.asarray(jm.get_samples()["noise"]),
                                  to_np(tm.get_samples()["noise"]))
    X_new = np.linspace(-1, 1, 7).astype(np.float32)
    tmean, _ = tm.predict(1, X_new, noiseless=True, device="cpu")
    jmean, _ = jm.predict(jax.random.PRNGKey(1), jnp.asarray(X_new), noiseless=True)
    assert_close(tmean, jmean, rtol=CROSS_RTOL, atol=CROSS_ATOL)


def test_jax_vigp_checkpoint_loads_in_the_port(tmp_path):
    """An SVI model across: JAX's viGP medians reach the port through
    ``convert.load_vi_state``, and the port predicts JAX's mean and
    variance."""
    X, y = _data(12)
    jm = gpax_tpu.viGP(1, "RBF")
    jm.fit(jax.random.PRNGKey(0), jnp.asarray(X), jnp.asarray(y), num_steps=100, **FIT)
    path = os.path.join(tmp_path, "jax_vigp")
    gpax_tpu.utils.save_model(path, jm)
    tm = load_model(path, gpax_torch.viGP(1, "RBF"), device="cpu")
    jmed = {k: np.asarray(v) for k, v in jm.get_samples().items()}
    for k, v in tm.get_samples().items():
        np.testing.assert_array_equal(to_np(v), jmed[k])
    jmean, jvar = jm.predict(jax.random.PRNGKey(1), jnp.asarray(X))
    tmean, tvar = tm.predict(1, X, device="cpu")
    assert_close(tmean, jmean, rtol=CROSS_RTOL, atol=CROSS_ATOL)
    assert_close(tvar, jvar, rtol=CROSS_RTOL, atol=CROSS_ATOL)


def test_load_model_device_default_is_the_card(tmp_path):
    """Without a card, load_model's default device raises and asks for the
    CPU, as every entry point does."""
    m = _fitted_exactgp()
    path = os.path.join(tmp_path, "gp")
    save_model(path, m)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; tests/test_torch_cuda.py covers the card")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        load_model(path, gpax_torch.ExactGP(1, "RBF"))


def test_profile_writes_a_trace_and_debug_nans_toggles(tmp_path):
    """profile(logdir) writes a Chrome trace of the block with the ops it
    ran; debug_nans turns anomaly detection on and off."""
    logdir = os.path.join(tmp_path, "trace")
    with profile(logdir) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(logdir, "trace.json")) as f:
        trace = json.load(f)
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    assert len(prof.key_averages()) > 0
    debug_nans(True)
    try:
        assert torch.is_anomaly_enabled()
    finally:
        debug_nans(False)
    assert not torch.is_anomaly_enabled()
