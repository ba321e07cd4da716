"""The port's float64 mode (``gpax_torch.enable_x64``) against gpax_tpu under
``enable_x64``, on the same numpy inputs made from a seed: the mode switch,
the grams, the ExactGP potential and gradient, the predictive math on
injected draws, the viGP ELBO, and a small fit (tests/test_gp.py:257-275).

Each test turns x64 on in both packages and off again in both afterwards.
The JAX backward runs at ``wtw_precision="highest"``: its default
compensated WᵀW splits W into bfloat16 halves, which float64 does not undo.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gpax_torch
import gpax_tpu
from _torch_parity import assert_close
from gpax_torch.utils import get_keys, samples_from_numpy

torch.set_num_threads(1)


@pytest.fixture
def x64():
    old = gpax_tpu.get_config().wtw_precision
    gpax_tpu.enable_x64(True)
    gpax_torch.enable_x64(True)
    gpax_tpu.set_config(wtw_precision="highest")
    try:
        yield
    finally:
        gpax_tpu.set_config(wtw_precision=old)
        gpax_tpu.enable_x64(False)
        gpax_torch.enable_x64(False)


def _data(n=16, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, n)
    y = np.sin(3 * X) + 0.05 * rng.normal(size=n)
    return X, y


def _samples(S=5, seed=1):
    rng = np.random.default_rng(seed)
    return {"k_length": rng.uniform(0.3, 1.5, (S, 1)), "k_scale": rng.uniform(0.5, 3.0, S),
            "noise": rng.uniform(0.01, 0.2, S)}


def test_mode_switch_follows_enable_x64_both_ways():
    try:
        for on in (True, False, True):
            gpax_torch.enable_x64(on)
            gpax_tpu.enable_x64(on)
            assert gpax_torch.config.is_x64() is on and gpax_tpu.config.is_x64() is on
            assert torch.get_default_dtype() == (torch.float64 if on else torch.float32)
            assert jnp.asarray(1.0).dtype == (jnp.float64 if on else jnp.float32)
            # a model built now keeps the mode's dtype; one built before keeps its own
            assert gpax_torch.ExactGP(1).dtype == torch.get_default_dtype()
            assert torch.as_tensor(1.5).dtype == torch.get_default_dtype()
        built_in_x64 = gpax_torch.viGP(1)
        gpax_torch.enable_x64(False)
        assert built_in_x64.dtype == torch.float64 and gpax_torch.ExactGP(1).dtype == torch.float32
    finally:
        gpax_tpu.enable_x64(False)
        gpax_torch.enable_x64(False)


@pytest.mark.parametrize("kernel", ["RBF", "Matern"])
@pytest.mark.parametrize("same", [True, False])
def test_float64_grams_match_jax(x64, kernel, same):
    """The port's gram (K1's twin on the CPU, float64) against gpax_tpu's
    XLA gram under x64, with ARD lengthscales, noise and jitter: 1e-12."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(40, 3))
    Z = X if same else rng.normal(size=(27, 3))
    p = {"k_length": rng.uniform(0.5, 2.0, 3), "k_scale": 1.7}
    jk = gpax_tpu.kernels.get_kernel(kernel)(
        jnp.asarray(X), jnp.asarray(Z), {k: jnp.asarray(v) for k, v in p.items()}, 0.2)
    tk = gpax_torch.kernels.get_kernel(kernel)(
        torch.tensor(X), torch.tensor(Z), {k: torch.tensor(v) for k, v in p.items()}, 0.2)
    assert tk.dtype == torch.float64 and jk.dtype == jnp.float64
    assert_close(tk, jk, rtol=0, atol=1e-12)


@pytest.mark.parametrize("kernel", ["RBF", "Matern"])
def test_exactgp_potential_and_gradient_match_jax(x64, kernel):
    """Both on the composed route with float64 factors: 1e-9 relative."""
    X, y = _data(24, seed=4)
    jm, tm = gpax_tpu.ExactGP(1, kernel), gpax_torch.ExactGP(1, kernel)
    Xj, yj = jm._set_data(X, y)
    Xt, yt = tm._set_data(X, y, device="cpu")
    assert Xt.dtype == torch.float64 and Xj.dtype == jnp.float64
    assert not tm._fused_likelihood_ok(Xt, {"k_length": None, "k_scale": None, "period": None})
    jinfo = gpax_tpu.ppl.initialize_model(jm.model, jax.random.PRNGKey(0), (Xj, yj))
    tinfo = gpax_torch.ppl.initialize_model(tm.model, torch.Generator().manual_seed(0), (Xt, yt))
    z = {"k_length": np.array([-0.3]), "k_scale": np.float64(0.4), "noise": np.float64(-2.5)}
    ju, jg = jax.value_and_grad(jinfo.potential_fn)({k: jnp.asarray(v) for k, v in z.items()})
    tz = {k: torch.tensor(v, requires_grad=True) for k, v in z.items()}
    tu = tinfo.potential_fn(tz)
    tu.backward()
    assert tu.dtype == torch.float64
    assert_close(tu, ju, rtol=1e-9)
    for k in z:
        assert_close(tz[k].grad, jg[k], rtol=1e-9, atol=1e-12)


def test_predictive_mean_and_variance_match_jax(x64):
    """predict_moments and get_predictive_mean_var on injected float64 draws:
    1e-10."""
    X, y = _data()
    s = _samples(4)
    Xn = np.linspace(-1, 1, 9)[:, None]
    jm, tm = gpax_tpu.ExactGP(1, "RBF"), gpax_torch.ExactGP(1, "RBF")
    jm._set_training_data(jnp.asarray(X[:, None]), jnp.asarray(y))
    tm._set_training_data(X[:, None], y, device="cpu")
    ts = samples_from_numpy(s)
    assert ts["noise"].dtype == torch.float64
    jmean, jvar = jm.predict_moments(None, jnp.asarray(Xn), s)
    tmean, tvar = tm.predict_moments(None, Xn, ts, device="cpu")
    assert tmean.dtype == torch.float64
    assert_close(tmean, jmean, rtol=1e-10, atol=1e-10)
    assert_close(tvar, jvar, rtol=1e-10, atol=1e-10)
    one = {k: v[0] for k, v in s.items()}
    jm1, jv1 = jm.get_predictive_mean_var(jnp.asarray(Xn), one, noiseless=True)
    tm1, tv1 = tm.get_predictive_mean_var(torch.tensor(Xn), samples_from_numpy(one),
                                          noiseless=True)
    assert_close(tm1, jm1, rtol=1e-10, atol=1e-10)
    assert_close(tv1, jv1, rtol=1e-10, atol=1e-10)
    jmean, _ = jm.predict(gpax_tpu.utils.get_keys()[1], jnp.asarray(Xn), s, noiseless=True)
    tmean, tdraws = tm.predict(get_keys()[1], Xn, ts, noiseless=True, device="cpu")
    assert tdraws.dtype == torch.float64
    assert_close(tmean, jmean, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("kernel", ["RBF", "Matern"])
def test_vigp_elbo_matches_jax_at_its_initial_guide_values(x64, kernel):
    """viGP's negative ELBO and its gradient under AutoDelta at the guide
    values JAX's init_params starts from: 1e-9 relative."""
    rng = np.random.default_rng(5)
    X = rng.uniform(0, 8, (30, 2))
    y = np.sin(X[:, 0] / 3) * np.cos(X[:, 1] / 4)
    jm, tm = gpax_tpu.viGP(2, kernel), gpax_torch.viGP(2, kernel)
    jargs, targs = jm._set_data(X, y), tm._set_data(X, y, device="cpu")
    jsvi = gpax_tpu.infer.SVI(jm.model, gpax_tpu.infer.AutoDelta(jm.model), optax.adam(1e-3))
    key = jax.random.PRNGKey(0)
    init = jsvi.guide.init_params(key, jargs)
    jv, jg = jax.value_and_grad(jsvi._neg_elbo)(init, {}, key, jargs, {})
    tsvi = gpax_torch.infer.SVI(tm.model, gpax_torch.infer.AutoDelta(tm.model), 1e-3)
    gen = torch.Generator().manual_seed(0)
    tsvi.guide.init_params(gen, targs)
    tp = {k: torch.tensor(np.asarray(v), requires_grad=True) for k, v in init.items()}
    assert all(v.dtype == torch.float64 for v in tp.values())
    tv = tsvi._neg_elbo(tp, {}, gen, targs, {})
    tv.backward()
    assert_close(tv, jv, rtol=1e-9)
    for k in init:
        assert_close(tp[k].grad, jg[k], rtol=1e-9, atol=1e-12)


def test_fit_under_x64(x64):
    """tests/test_gp.py:257-275 on the port: the whole stack runs in double
    precision, samples float64, predict finite."""
    rng = np.random.default_rng(0)
    X = rng.uniform(-1, 1, 10)
    y = np.sin(3 * X)
    m = gpax_torch.ExactGP(1, "RBF")
    m.fit(get_keys()[0], X, y, num_warmup=50, num_samples=50,
          print_summary=False, progress_bar=False, device="cpu")
    s = m.get_samples()
    assert all(v.dtype == torch.float64 for v in s.values())
    assert m.X_train.dtype == torch.float64
    mean, draws = m.predict(get_keys()[1], X, device="cpu")
    assert mean.dtype == torch.float64 and bool(torch.isfinite(mean).all())
    assert draws.shape == (50, 1, 10)
