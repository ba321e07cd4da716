"""gpax_torch.ExactGP against gpax_tpu.ExactGP: the potential and its
gradient, a small fit (statistically), and the predictive math with the same
injected posterior samples (exactly, up to fp32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpax_torch
import gpax_tpu
from _torch_parity import assert_close
from gpax_torch.infer import effective_sample_size
from gpax_torch.utils import get_keys, samples_from_numpy

torch.set_num_threads(1)

NUM_WARMUP, NUM_SAMPLES = 200, 400


def _data(n=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, n).astype(np.float32)
    y = (10 * X**2 + rng.normal(0, 0.1, n)).astype(np.float32)
    return X, y


def _samples(S=5, seed=1):
    rng = np.random.default_rng(seed)
    return {"k_length": rng.uniform(0.3, 1.5, (S, 1)).astype(np.float32),
            "k_scale": rng.uniform(0.5, 3.0, S).astype(np.float32),
            "noise": rng.uniform(0.01, 0.2, S).astype(np.float32)}


@pytest.fixture
def jax_fp32_wtw():
    old = gpax_tpu.get_config().wtw_precision
    gpax_tpu.set_config(wtw_precision="highest")
    yield
    gpax_tpu.set_config(wtw_precision=old)


@pytest.fixture(scope="module")
def jax_fit():
    """The one JAX NUTS compile of this file."""
    X, y = _data()
    m = gpax_tpu.ExactGP(1, "RBF")
    m.fit(gpax_tpu.utils.get_keys()[0], X, y, num_warmup=NUM_WARMUP,
          num_samples=NUM_SAMPLES, print_summary=False, progress_bar=False)
    return {k: np.asarray(v) for k, v in m.get_samples().items()}


@pytest.mark.parametrize("kernel", ["RBF", "Matern"])
def test_potential_and_gradient_match_jax(kernel, jax_fp32_wtw):
    X, y = _data(24, seed=4)
    jm, tm = gpax_tpu.ExactGP(1, kernel), gpax_torch.ExactGP(1, kernel)
    Xj, yj = jm._set_data(X, y)
    Xt, yt = tm._set_data(X, y, device="cpu")
    jinfo = gpax_tpu.ppl.initialize_model(jm.model, jax.random.PRNGKey(0), (Xj, yj))
    tinfo = gpax_torch.ppl.initialize_model(tm.model, torch.Generator().manual_seed(0), (Xt, yt))
    for point in ([-0.3, 0.2, -2.0], [0.4, 1.1, -3.5], [-1.0, -0.5, -1.2]):
        z = {"k_length": np.array([point[0]], np.float32), "k_scale": np.float32(point[1]),
             "noise": np.float32(point[2])}
        ju, jg = jax.value_and_grad(jinfo.potential_fn)({k: jnp.asarray(v) for k, v in z.items()})
        tz = {k: torch.tensor(v, requires_grad=True) for k, v in z.items()}
        tu = tinfo.potential_fn(tz)
        tu.backward()
        # cond(K) ≤ ~1e4 at these points: fp32 solves agree to ~1e-5 relative
        assert_close(tu, ju, rtol=1e-4)
        for k in z:
            assert_close(tz[k].grad, jg[k], rtol=1e-4, atol=1e-4)


def test_fit_posterior_means_match_jax_within_mc_error(jax_fit):
    X, y = _data()
    m = gpax_torch.ExactGP(1, "RBF")
    m.fit(get_keys(0)[0], X, y, num_warmup=NUM_WARMUP, num_samples=NUM_SAMPLES,
          print_summary=False, progress_bar=False, device="cpu")
    ts = {k: v.numpy() for k, v in m.get_samples().items()}
    assert ts["k_length"].shape == (NUM_SAMPLES, 1)
    assert ts["k_scale"].shape == ts["noise"].shape == (NUM_SAMPLES,)
    for k in ("k_length", "k_scale", "noise"):
        a, b = np.log(ts[k]).reshape(-1), np.log(jax_fit[k]).reshape(-1)
        assert np.isfinite(a).all()
        ess_a = effective_sample_size(a[None])
        ess_b = effective_sample_size(b[None])
        se = np.sqrt(a.var() / ess_a + b.var() / ess_b)
        # two independent chains of the same posterior: 4 standard errors
        assert abs(a.mean() - b.mean()) < 4 * se, (k, a.mean(), b.mean(), se)
    stats = m.mcmc.get_extra_fields()
    assert 0.5 < stats["accept_prob"].mean().item() <= 1.0


@pytest.mark.parametrize("kernel", ["RBF", "Matern"])
@pytest.mark.parametrize("noiseless", [False, True])
def test_mvn_posterior_matches_jax(kernel, noiseless):
    X, y = _data(12, seed=2)
    Xn = np.linspace(-1, 1, 7, dtype=np.float32)[:, None]
    params = {"k_length": np.array([0.5], np.float32), "k_scale": np.float32(2.0),
              "noise": np.float32(0.05)}
    jm, tm = gpax_tpu.ExactGP(1, kernel), gpax_torch.ExactGP(1, kernel)
    jm._set_training_data(jnp.asarray(X[:, None]), jnp.asarray(y))
    tm._set_training_data(X[:, None], y, device="cpu")
    jmean, jcov = jm.get_mvn_posterior(jnp.asarray(Xn), params, noiseless)
    tmean, tcov = tm.get_mvn_posterior(torch.tensor(Xn), samples_from_numpy(params), noiseless)
    # cond(K) ~ 1e3: fp32 W-based and triangular-solve paths agree to ~1e-5
    assert_close(tmean, jmean, rtol=1e-4, atol=1e-4)
    assert_close(tcov, jcov, rtol=1e-3, atol=1e-4)


def test_mean_fn_is_applied_like_jax():
    X, y = _data(10, seed=3)
    Xn = np.linspace(-1, 1, 5, dtype=np.float32)[:, None]
    params = {"k_length": np.array([0.7], np.float32), "k_scale": np.float32(1.0),
              "noise": np.float32(0.1)}
    jm = gpax_tpu.ExactGP(1, "RBF", mean_fn=lambda x: 3.0 * x)
    tm = gpax_torch.ExactGP(1, "RBF", mean_fn=lambda x: 3.0 * x)
    jm._set_training_data(jnp.asarray(X[:, None]), jnp.asarray(y))
    tm._set_training_data(X[:, None], y, device="cpu")
    jmean, _ = jm.get_mvn_posterior(jnp.asarray(Xn), params)
    tmean, _ = tm.get_mvn_posterior(torch.tensor(Xn), samples_from_numpy(params))
    assert_close(tmean, jmean, rtol=1e-4, atol=1e-4)


def test_predict_with_injected_samples_matches_jax():
    X, y = _data()
    s = _samples()
    Xn = np.linspace(-1, 1, 10, dtype=np.float32)[:, None]
    jm, tm = gpax_tpu.ExactGP(1, "RBF"), gpax_torch.ExactGP(1, "RBF")
    jm._set_training_data(jnp.asarray(X[:, None]), jnp.asarray(y))
    tm._set_training_data(X[:, None], y, device="cpu")
    jmean, jdraws = jm.predict(gpax_tpu.utils.get_keys()[1], jnp.asarray(Xn), s, n=2,
                               noiseless=True)
    tmean, tdraws = tm.predict(get_keys()[1], Xn, samples_from_numpy(s), n=2, noiseless=True,
                               device="cpu")
    assert tmean.shape == (10,) and tdraws.shape == jdraws.shape == (5, 2, 10)
    assert torch.isfinite(tdraws).all()
    assert_close(tmean, jmean, rtol=1e-4, atol=1e-4)


def test_predict_chunks_and_batches_agree():
    """Chunked draws (a small memory budget) and point batches change nothing
    but the random draws."""
    X, y = _data()
    s = samples_from_numpy(_samples(7))
    Xn = torch.linspace(-1, 1, 25)[:, None]
    m = gpax_torch.ExactGP(1, "Matern")
    m._set_training_data(X[:, None], y, device="cpu")
    full, _ = m.predict(0, Xn, s, device="cpu")
    m._chunk_size = lambda *a, **k: 2
    chunked, draws = m.predict(0, Xn, s, n=3, device="cpu")
    assert draws.shape == (7, 3, 25)
    assert_close(chunked, full, rtol=1e-6, atol=1e-6)
    batched, bdraws = m.predict_in_batches(0, Xn, batch_size=10, samples=s, n=3,
                                           device="cpu")
    assert bdraws.shape == (7, 3, 25)
    assert_close(batched, full, rtol=1e-5, atol=1e-5)


def test_predict_moments_and_mean_var_match_jax():
    X, y = _data()
    s = _samples(4)
    Xn = np.linspace(-1, 1, 9, dtype=np.float32)[:, None]
    jm, tm = gpax_tpu.ExactGP(1, "RBF"), gpax_torch.ExactGP(1, "RBF")
    jm._set_training_data(jnp.asarray(X[:, None]), jnp.asarray(y))
    tm._set_training_data(X[:, None], y, device="cpu")
    jmean, jvar = jm.predict_moments(None, jnp.asarray(Xn), s)
    tmean, tvar = tm.predict_moments(None, Xn, samples_from_numpy(s), device="cpu")
    assert_close(tmean, jmean, rtol=1e-4, atol=1e-4)
    assert_close(tvar, jvar, rtol=1e-3, atol=1e-4)
    one = {k: v[0] for k, v in s.items()}
    jm1, jv1 = jm.get_predictive_mean_var(jnp.asarray(Xn), one, noiseless=True)
    tm1, tv1 = tm.get_predictive_mean_var(torch.tensor(Xn), samples_from_numpy(one),
                                          noiseless=True)
    assert_close(tm1, jm1, rtol=1e-4, atol=1e-4)
    assert_close(tv1, jv1, rtol=1e-3, atol=1e-4)


def test_fit_input_shapes_padding_and_prior_draws():
    X, y = _data()
    m = gpax_torch.ExactGP(1, "RBF")
    m.fit(1, X, y, num_warmup=30, num_samples=20, print_summary=False, pad_to_multiple=16,
          device="cpu")
    assert m.X_train.shape == (8, 1) and m.y_train.shape == (8,)
    assert all(torch.isfinite(v).all() for v in m.get_samples().values())
    draws = m.sample_from_prior(2, X, num_samples=3, device="cpu")
    assert draws.shape == (3, 8) and torch.isfinite(draws).all()


def test_unported_pieces_raise():
    """The NNGP kernel and lockstep chains, once refused, now run (the name
    is kept from when they raised)."""
    X, y = _data()
    gp = gpax_torch.ExactGP(1, "NNGP")
    params = {"var_b": torch.tensor(0.5), "var_w": torch.tensor(1.5)}
    k = gp.kernel(torch.as_tensor(X)[:, None], torch.as_tensor(X)[:, None], params, 0.1)
    assert k.shape == (8, 8) and bool(torch.isfinite(k).all())
    m = gpax_torch.ExactGP(1, "RBF")
    m.fit(0, X, y, num_warmup=5, num_samples=5, num_chains=2, chain_method="vectorized",
          print_summary=False, device="cpu")
    assert m.get_samples(chain_dim=True)["noise"].shape == (2, 5)


def test_samples_from_numpy():
    s = samples_from_numpy(_samples(3), device="cpu", dtype=torch.float64)
    assert s["k_length"].shape == (3, 1) and s["k_scale"].dtype == torch.float64
