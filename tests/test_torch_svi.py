"""gpax_torch's SVI (guides, Trace_ELBO, Adam) and viGP against the JAX
package on the same inputs, and the entry points' device rule."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gpax_torch
import gpax_tpu
from _torch_parity import assert_close
from gpax_torch.infer import SVI, Adam, AutoDelta, AutoDiagonalNormal, AutoNormal, Trace_ELBO
from gpax_torch.utils import (load_vi_state, preprocess_sparse_image, resolve_device,
                              vi_state_from_jax)

torch.set_num_threads(1)


@pytest.fixture
def jax_fp32_wtw():
    """The JAX backward at float32 WᵀW, as in tests/test_torch_gp.py."""
    old = gpax_tpu.get_config().wtw_precision
    gpax_tpu.set_config(wtw_precision="highest")
    yield
    gpax_tpu.set_config(wtw_precision=old)


def _image_data(size=12, seed=0):
    """bench.py's config-2 image (sin·cos + 1.5, 15 % of the pixels kept) at
    a small size."""
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.arange(size), np.arange(size))
    truth = np.sin(xx / 4.0) * np.cos(yy / 5.0) + 1.5
    mask = rng.uniform(size=truth.shape) < 0.3
    return preprocess_sparse_image(np.where(mask, truth, 0.0).astype(np.float32)), truth


def test_preprocess_sparse_image_matches_jax():
    img = np.zeros((5, 7), np.float32)
    img[1, 2], img[4, 0], img[3, 6] = 1.5, -2.0, 0.25
    for a, b in zip(preprocess_sparse_image(img), gpax_tpu.utils.preprocess_sparse_image(img)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# ------------------------------------------------------------------- guides

def _models(kernel="RBF"):
    (X, y, _), _ = _image_data()
    jm, tm = gpax_tpu.viGP(2, kernel), gpax_torch.viGP(2, kernel)
    return jm, tm, jm._set_data(X, y), tm._set_data(X, y, device="cpu")


_LOCS = {"k_length": np.log(np.array([3.0, 4.0], np.float32)),
         "k_scale": np.float32(np.log(0.8)), "noise": np.float32(np.log(0.05))}


def test_auto_normal_log_q_matches_jax_on_the_same_eps():
    """Both guides fed the same standard normal draws ε (JAX's own, one key
    per site): latents and log q agree to float32 rounding."""
    jm, tm, jargs, targs = _models()
    jg, tg = gpax_tpu.infer.AutoNormal(jm.model), AutoNormal(tm.model)
    jg.init_params(jax.random.PRNGKey(0), jargs)
    tg.init_params(torch.Generator().manual_seed(0), targs)
    params = {}
    for i, (k, v) in enumerate(_LOCS.items()):
        params[f"{k}_loc"] = v
        params[f"{k}_scale_log"] = np.full_like(v, -1.0 - 0.3 * i)
    key = jax.random.PRNGKey(7)
    jz, jlq = jg.sample_and_log_prob({k: jnp.asarray(v) for k, v in params.items()}, key)
    keys = jax.random.split(key, len(jg._transforms))
    eps = {n: torch.tensor(np.asarray(jax.random.normal(k, np.shape(_LOCS[n]), jnp.float32)))
           for k, n in zip(keys, jg._transforms)}
    tz, tlq = tg.from_eps({k: torch.tensor(v) for k, v in params.items()}, eps)
    assert list(tz) == list(jz)
    for n in jz:
        assert_close(tz[n], jz[n], rtol=1e-6)
    assert_close(tlq, jlq, rtol=1e-5)
    for n, v in tg.median({k: torch.tensor(v) for k, v in params.items()}).items():
        assert_close(v, np.exp(_LOCS[n]), rtol=1e-6)


def test_auto_diagonal_normal_log_q_matches_jax_on_the_same_eps():
    """The flat vector in ``ravel_pytree``'s (sorted) order, ε from JAX's key."""
    jm, tm, jargs, targs = _models()
    jg, tg = gpax_tpu.infer.AutoDiagonalNormal(jm.model), AutoDiagonalNormal(tm.model)
    jp = jg.init_params(jax.random.PRNGKey(0), jargs)
    tp = tg.init_params(torch.Generator().manual_seed(0), targs)
    assert jp["auto_loc"].shape == tp["auto_loc"].shape == (4,)
    flat = np.concatenate([np.atleast_1d(_LOCS[n]) for n in sorted(_LOCS)]).astype(np.float32)
    params = {"auto_loc": flat, "auto_scale_log": np.linspace(-2, -1, 4).astype(np.float32)}
    key = jax.random.PRNGKey(3)
    jz, jlq = jg.sample_and_log_prob({k: jnp.asarray(v) for k, v in params.items()}, key)
    eps = torch.tensor(np.asarray(jax.random.normal(key, (4,), jnp.float32)))
    tz, tlq = tg.from_eps({k: torch.tensor(v) for k, v in params.items()}, eps)
    for n in jz:
        assert_close(tz[n], jz[n], rtol=1e-6)
    assert_close(tlq, jlq, rtol=1e-5)
    jmed = jg.median({k: jnp.asarray(v) for k, v in params.items()})
    for n, v in tg.median({k: torch.tensor(v) for k, v in params.items()}).items():
        assert_close(v, jmed[n], rtol=1e-6)


def test_adam_step_matches_optax():
    """Given the same gradients, torch's Adam through ``infer.Adam`` and
    ``optax.adam(5e-3, b1=0.5)`` take the same steps, within 1e-6."""
    rng = np.random.default_rng(0)
    p = rng.normal(size=(7,)).astype(np.float32)
    grads = [rng.normal(size=(7,)).astype(np.float32) * s for s in (1.0, 1e-3, 30.0, 0.5)]
    opt = optax.adam(5e-3, b1=0.5)
    jp = jnp.asarray(p)
    state = opt.init(jp)
    t = torch.tensor(p, requires_grad=True)
    topt = Adam(5e-3, b1=0.5)([t])
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        t.grad = torch.tensor(g)
        topt.step()
        assert np.abs(t.detach().numpy() - np.asarray(jp)).max() <= 1e-6


# -------------------------------------------------------------- viGP model

@pytest.mark.parametrize("kernel", ["RBF", "Matern"])
def test_vigp_neg_elbo_and_gradient_match_jax(kernel, jax_fp32_wtw):
    """viGP's model (ExactGP's MVN likelihood) under AutoDelta at injected
    parameters against ``SVI._neg_elbo`` under ``jax.value_and_grad``. The
    port's factor path is float64 and JAX's float32 on a gram of κ ~ 1e3:
    1e-4 relative on the value and of max on the gradients."""
    jm, tm, jargs, targs = _models(kernel)
    jsvi = gpax_tpu.infer.SVI(jm.model, gpax_tpu.infer.AutoDelta(jm.model), optax.adam(1e-3))
    key = jax.random.PRNGKey(0)
    jsvi.guide.init_params(key, jargs)
    point = {f"{k}_loc": v for k, v in _LOCS.items()}
    jv, jg = jax.value_and_grad(jsvi._neg_elbo)(
        {k: jnp.asarray(v) for k, v in point.items()}, {}, key, jargs, {})
    tsvi = SVI(tm.model, AutoDelta(tm.model), 1e-3)
    gen = torch.Generator().manual_seed(0)
    tsvi.guide.init_params(gen, targs)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in point.items()}
    tv = tsvi._neg_elbo(tp, {}, gen, targs, {})
    tv.backward()
    assert_close(tv, jv, rtol=1e-4)
    for k in point:
        assert_close(tp[k].grad, jg[k], rtol=0, atol=1e-4 * np.abs(np.asarray(jg[k])).max())


def test_vigp_predict_matches_jax_with_carried_state():
    """The state of a JAX viGP (medians and data, as a checkpoint restore
    leaves it) carried across by ``utils.vi_state_from_jax``: predict's mean
    and variance diagonal, and predict_in_batches, equal JAX's. κ(K) ~ 1e3:
    1e-4 of max on the mean, 1e-3 of max on the variance."""
    (X, y, grid), _ = _image_data()
    jm = gpax_tpu.viGP(2, "Matern")
    jm.X_train, jm.y_train = jm._set_data(X, y)
    jm._restored_median = {k: jnp.asarray(np.exp(v)) for k, v in _LOCS.items()}
    state = vi_state_from_jax(jm)
    assert set(state) == {"median", "X_train", "y_train"}
    tm = gpax_torch.viGP(2, "Matern")
    load_vi_state(tm, state, device="cpu")
    jmean, jvar = jm.predict(None, jnp.asarray(grid))
    tmean, tvar = tm.predict(None, grid, device="cpu")
    assert tmean.shape == tvar.shape == (grid.shape[0],)
    assert_close(tmean, jmean, rtol=0, atol=1e-4 * np.abs(np.asarray(jmean)).max())
    assert_close(tvar, jvar, rtol=0, atol=1e-3 * np.abs(np.asarray(jvar)).max())
    bmean, bvar = tm.predict_in_batches(None, grid, batch_size=50, device="cpu")
    assert_close(bmean, tmean, rtol=0, atol=1e-5)
    assert_close(bvar, tvar, rtol=0, atol=1e-5)


def test_vigp_fit_reconstructs_the_image_on_the_cpu():
    """A short fit at config 2's step size: the losses fall, stay on the
    data's device, and the reconstruction beats the image's own spread."""
    (X, y, grid), truth = _image_data()
    m = gpax_torch.viGP(2, "Matern")
    m.fit(0, X, y, num_steps=100, step_size=0.05, print_summary=False, device="cpu")
    assert m.loss.shape == (100,) and m.loss.device.type == "cpu"
    assert m.loss[-10:].mean() < m.loss[:10].mean()
    mean, var = m.predict_in_batches(1, grid, batch_size=64, device="cpu")
    assert torch.isfinite(mean).all() and (var > 0).all()
    rmse = np.sqrt(np.mean((mean.numpy().reshape(truth.shape) - truth) ** 2))
    assert rmse < 0.5 * truth.std()


def test_svi_run_with_particles_and_model_params():
    """Trace_ELBO averages num_particles draws; param sites are optimized
    with the guide; run returns the JAX names."""
    (X, y, _), _ = _image_data()
    tm = gpax_torch.viGP(2, "RBF")
    Xt, yt = tm._set_data(X, y, device="cpu")

    def model(X, y=None):
        shift = gpax_torch.ppl.param("shift", torch.zeros(()))
        tm.model(X, None if y is None else y - shift)

    svi = SVI(model, AutoNormal(model), Adam(0.05, b1=0.5), Trace_ELBO(num_particles=3))
    res = svi.run(0, 40, Xt, yt)
    assert set(res.params) == {"k_length_loc", "k_length_scale_log", "k_scale_loc",
                               "k_scale_scale_log", "noise_loc", "noise_scale_log", "shift"}
    assert res.losses.shape == (40,) and torch.isfinite(res.losses).all()
    assert res.params["shift"].item() > 0.3  # drawn toward the data's mean of ~1.5
    assert svi.get_params(res.state).keys() == res.params.keys()


# ------------------------------------------------------------- device rule

def test_entry_points_without_a_card_raise_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    (X, y, _), _ = _image_data()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device(None)
    for model in (gpax_torch.ExactGP(2), gpax_torch.viGP(2), gpax_torch.viSparseGP(2)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            model._set_data(torch.tensor(X), y)  # not even for CPU tensors
    with pytest.raises(RuntimeError, match='device="cpu"'):
        gpax_torch.viSparseGP(2).fit(0, X, y, num_steps=1, print_summary=False)
    m = gpax_torch.viGP(2)
    m.fit(0, X, y, num_steps=2, print_summary=False, device="cpu")
    assert m.X_train.device.type == "cpu"
    with pytest.raises(RuntimeError, match='device="cpu"'):
        m.predict(None, X[:3])


def test_device_cpu_puts_numpy_inputs_on_the_cpu():
    (X, y, _), _ = _image_data()
    m = gpax_torch.viSparseGP(2)
    Xt, yt = m._set_data(X, y, device="cpu")
    assert Xt.device.type == yt.device.type == "cpu" and Xt.shape == (len(y), 2)
    assert resolve_device("cpu") == torch.device("cpu")
    m.fit(0, X, y, inducing_points_ratio=0.2, num_steps=3, print_summary=False, device="cpu")
    assert m.Xu.device.type == m.X_train.device.type == "cpu"
    mean, var = m.predict(None, X[:4], device="cpu")
    assert mean.device.type == var.device.type == "cpu" and mean.shape == (4,)


@pytest.mark.parametrize("runner", ["mcmc", "svi"])
def test_a_dataless_run_goes_to_the_card_unless_given_the_cpu(runner, monkeypatch):
    """A model without tensor arguments runs on the card by default: without
    one it raises with the device="cpu" hint, and the constructor's
    ``device="cpu"`` runs it on the CPU."""
    from gpax_torch import distributions as tdist
    from gpax_torch import ppl as tppl
    from gpax_torch.infer import MCMC, NUTS

    def model():
        tppl.sample("a", tdist.Normal(0.0, 1.0))

    def run(**kw):
        if runner == "mcmc":
            mcmc = MCMC(NUTS(model), 10, 10, **kw)
            mcmc.run(0)
            return mcmc.get_samples()["a"]
        return SVI(model, AutoNormal(model), 0.01, **kw).run(0, 10).losses

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        run()
    out = run(device="cpu")
    assert out.device.type == "cpu" and out.shape == (10,) and bool(torch.isfinite(out).all())
