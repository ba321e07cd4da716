"""gpax_torch's NUTS-fitted NN models, DKL, sPM and BNN, against gpax_tpu's
on the same numpy inputs: the potential and its gradient at the same
draws, the predictive math on injected posterior draws, and short fits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpax_torch
import gpax_tpu
from _torch_parity import assert_close, to_np
from gpax_torch.utils import samples_from_numpy

torch.set_num_threads(1)

POT_RTOL = 1e-4  # potentials and gradients (as tests/test_torch_gp.py)
FIT_WARMUP, FIT_SAMPLES = 40, 40
BNN_WARMUP, BNN_SAMPLES = 20, 20


@pytest.fixture
def jax_fp32_wtw():
    old = gpax_tpu.get_config().wtw_precision
    gpax_tpu.set_config(wtw_precision="highest")
    yield
    gpax_tpu.set_config(wtw_precision=old)


def _features(n=21, d=8, seed=0):
    """tests/test_dkl.py's dummy features at a smaller width."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (np.sin(X[:, 0]) + 0.05 * rng.normal(size=n)).astype(np.float32)
    return X, y


def _line_data(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 2, 25).astype(np.float32)
    y = (3.0 * X + 1.0 + 0.05 * rng.normal(size=25)).astype(np.float32)
    return X, y


def _bnn_data(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, 20).astype(np.float32)
    return X, np.sin(3 * X).astype(np.float32)


def _line_models():
    """tests/test_dkl.py::test_spm_fit_predict's line, in both packages."""
    def line(x, params):
        return params["a"] * x + params["b"]

    def jprior():
        return {"a": gpax_tpu.ppl.sample("a", gpax_tpu.distributions.Normal(0.0, 10.0)),
                "b": gpax_tpu.ppl.sample("b", gpax_tpu.distributions.Normal(0.0, 10.0))}

    def tprior():
        return {"a": gpax_torch.ppl.sample("a", gpax_torch.distributions.Normal(0.0, 10.0)),
                "b": gpax_torch.ppl.sample("b", gpax_torch.distributions.Normal(0.0, 10.0))}

    return gpax_tpu.sPM(line, jprior), gpax_torch.sPM(line, tprior)


def _models(kind):
    if kind == "dkl":
        return (gpax_tpu.DKL(8, z_dim=2, kernel="RBF", hidden_dim=[8, 4]),
                gpax_torch.DKL(8, z_dim=2, kernel="RBF", hidden_dim=[8, 4]))
    if kind == "dkl_matern":
        return (gpax_tpu.DKL(8, z_dim=2, kernel="Matern", hidden_dim=[6]),
                gpax_torch.DKL(8, z_dim=2, kernel="Matern", hidden_dim=[6]))
    if kind == "spm":
        return _line_models()
    return gpax_tpu.BNN(1, 1, hidden_dim=[8, 4]), gpax_torch.BNN(1, 1, hidden_dim=[8, 4])


def _args(kind, jm, tm):
    if kind.startswith("dkl"):
        X, y = _features()
        return (jnp.asarray(X), jnp.asarray(y)), tm._set_data(X, y, device="cpu")
    X, y = _line_data() if kind == "spm" else _bnn_data()
    jX, jy = jm._set_data(jnp.asarray(X), jnp.asarray(y))
    return (jX, jy), tm._set_data(X, y, device="cpu")


def _point(shapes, seed):
    """An unconstrained point with the latents' shapes."""
    rng = np.random.default_rng(seed)
    return {k: (0.7 * rng.normal(size=s)).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("kind", ["dkl", "dkl_matern", "spm", "bnn"])
def test_potential_and_gradient_match_jax(kind, jax_fp32_wtw):
    jm, tm = _models(kind)
    jargs, targs = _args(kind, jm, tm)
    jinfo = gpax_tpu.ppl.initialize_model(jm.model, jax.random.PRNGKey(0), jargs)
    tinfo = gpax_torch.ppl.initialize_model(tm.model, torch.Generator().manual_seed(0), targs)
    shapes = {k: tuple(v.shape) for k, v in jinfo.init_unconstrained.items()}
    assert shapes == {k: tuple(v.shape) for k, v in tinfo.init_unconstrained.items()}
    jvg = jax.jit(jax.value_and_grad(jinfo.potential_fn))
    for seed in (1, 2):
        z = _point(shapes, seed)
        ju, jg = jvg({k: jnp.asarray(v) for k, v in z.items()})
        tz = {k: torch.tensor(v, requires_grad=True) for k, v in z.items()}
        tu = tinfo.potential_fn(tz)
        tu.backward()
        assert_close(tu, ju, rtol=POT_RTOL)
        scale = max(np.abs(np.asarray(g)).max() for g in jg.values())
        for k in z:
            assert_close(tz[k].grad, jg[k], rtol=POT_RTOL, atol=POT_RTOL * scale)


def _draws(jm, kind, S=5, seed=3):
    """S posterior-like draws of every latent (constrained)."""
    jargs = _args(kind, jm, _models(kind)[1])[0]
    info = gpax_tpu.ppl.initialize_model(jm.model, jax.random.PRNGKey(0), jargs)
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in info.init_unconstrained.items():
        u = (0.5 * rng.normal(size=(S,) + tuple(v.shape))).astype(np.float32)
        out[k] = np.array(jax.vmap(info.transforms[k])(jnp.asarray(u)))
    return out


@pytest.mark.parametrize("kind", ["dkl", "dkl_matern"])
def test_dkl_predict_and_embed_on_injected_draws_match_jax(kind):
    X, y = _features()
    X_new = _features(n=9, seed=6)[0]
    jm, tm = _models(kind)
    jm._set_training_data(jnp.asarray(X), jnp.asarray(y))
    tm._set_training_data(X, y, device="cpu")
    s = _draws(jm, kind)
    ts = samples_from_numpy(s, device="cpu")
    t_mean, t_cov = tm.get_mvn_posterior(torch.as_tensor(X_new), ts, noiseless=True)
    assert t_mean.shape == (5, 9) and t_cov.shape == (5, 9, 9)
    j_post = jax.jit(lambda p: jm.get_mvn_posterior(jnp.asarray(X_new), p, noiseless=True))
    for i in range(5):
        j_mean, j_cov = j_post({k: jnp.asarray(v[i]) for k, v in s.items()})
        assert_close(t_mean[i], j_mean, rtol=1e-4, atol=1e-5)
        assert_close(t_cov[i], j_cov, rtol=1e-4, atol=1e-5)
    j_pred, _ = jm.predict(jax.random.PRNGKey(0), jnp.asarray(X_new),
                           {k: jnp.asarray(v) for k, v in s.items()}, noiseless=True)
    t_pred, t_draws = tm.predict(0, X_new, ts, noiseless=True, device="cpu")
    assert t_draws.shape == (5, 1, 9) and bool(torch.isfinite(t_draws).all())
    assert_close(t_pred, j_pred, rtol=1e-4, atol=1e-5)
    jz = np.asarray(jax.vmap(lambda p: jm.nn(jnp.asarray(X_new), p))(
        {k: jnp.asarray(v) for k, v in s.items()}))
    assert_close(tm.nn(torch.as_tensor(X_new), ts), jz, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["spm", "bnn"])
def test_spm_bnn_predict_on_injected_draws_matches_jax(kind):
    jm, tm = _models(kind)
    X_new = np.linspace(-1, 2, 13).astype(np.float32)
    s = _draws(jm, kind)
    s["noise"] = np.full(5, 0.01, np.float32)
    jX = jm._set_data(jnp.asarray(X_new))
    j_pred, j_sampled = jm.predict(jax.random.PRNGKey(0), jX,
                                   {k: jnp.asarray(v) for k, v in s.items()}, n=20)
    t_pred, t_sampled = tm.predict(0, X_new, samples_from_numpy(s, device="cpu"), n=20,
                                   device="cpu")
    assert tuple(t_pred.shape) == tuple(j_pred.shape)
    assert tuple(t_sampled.shape) == tuple(j_sampled.shape)
    assert_close(t_pred, j_pred, rtol=1e-5, atol=1e-5)
    # the noisy draws: each draw's mean of 20 noise draws of sd 0.01
    assert_close(t_sampled, j_sampled, rtol=0, atol=0.02)
    t_all, _ = tm.predict(0, X_new, samples_from_numpy(s, device="cpu"),
                          take_point_predictions_mean=False, device="cpu")
    assert t_all.shape[0] == 5


def test_dkl_fit_predict_embed():
    X, y = _features(d=36)
    m = gpax_torch.DKL(36, z_dim=2, kernel="RBF", hidden_dim=[8, 4])
    m.fit(0, X, y, num_warmup=FIT_WARMUP, num_samples=FIT_SAMPLES, max_tree_depth=5,
          print_summary=False, progress_bar=False, device="cpu")
    samples = m.get_samples()
    assert samples["w0"].shape == (FIT_SAMPLES, 36, 8) and "b0" in samples
    mean, sampled = m.predict(1, X, n=1, device="cpu")
    assert mean.shape == (21,) and bool(torch.isfinite(mean).all())
    assert sampled.shape == (FIT_SAMPLES, 1, 21)
    assert m.embed(X, device="cpu").shape == (FIT_SAMPLES, 21, 2)
    assert gpax_torch.DKL._exact_moments_ok is False


def test_spm_fit_recovers_the_line_and_bnn_fits():
    X, y = _line_data()
    _, m = _line_models()
    m.fit(0, X, y, num_warmup=FIT_WARMUP, num_samples=FIT_SAMPLES, print_summary=False,
          progress_bar=False, device="cpu")
    means = m.get_param_means()
    assert abs(means["a"] - 3.0) < 0.3 and abs(means["b"] - 1.0) < 0.3
    y_pred, y_sampled = m.predict(1, X, device="cpu")
    assert y_pred.shape == (25,) and y_sampled.shape == (FIT_SAMPLES, 25)
    assert m.sample_from_prior(2, X, num_samples=5, device="cpu").shape == (5, 25)

    # at the JAX package's depth of 10, the BNN's adapted trees on this data
    # run to hundreds of leapfrogs, each an eager host-driven step (~1.3 ms
    # on one CPU thread): 20 + 20 draws (~6k leapfrogs) where 40 + 40 take ~50k
    Xb, yb = _bnn_data()
    b = gpax_torch.BNN(1, 1, hidden_dim=[8, 4])
    b.fit(0, Xb, yb, num_warmup=BNN_WARMUP, num_samples=BNN_SAMPLES, print_summary=False,
          progress_bar=False, device="cpu")
    assert b.mcmc.kernel.max_tree_depth == 10
    y_pred, _ = b.predict(1, Xb[:, None], device="cpu")
    assert y_pred.shape == (20, 1) and bool(torch.isfinite(y_pred).all())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            b.predict(1, Xb)
    assert to_np(b.get_samples()["w0"]).shape == (BNN_SAMPLES, 1, 8)
