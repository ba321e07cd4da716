"""Structured GPs on gpax_torch against gpax_tpu: an ExactGP whose prior mean
is a parametric model written for one draw of its parameters
(examples/structured_gp.py), and sPM, on one chain and on lockstep chains.

The user's mean function takes one draw; the port maps it over a batch of
draws (lockstep chains, a chunk of predictive draws) with
``utils.fn.call_batched``, as the JAX package vmaps it. Held to JAX: the
potential and its gradients at one unconstrained point (the Uniform's
latent through the sigmoid), the predictive math on injected draws, and
2-chain vectorized fits (posterior means within 4 standard errors). A model
whose batch broadcasts wrong runs chain by chain, and says so.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpax_torch
import gpax_tpu
from _torch_parity import assert_close, to_np
from gpax_torch import distributions as tdist
from gpax_torch import ppl as tppl
from gpax_torch.infer import MCMC, NUTS
from gpax_torch.ppl import initialize_model
from gpax_torch.utils import samples_from_numpy
from gpax_torch.utils.fn import call_batched
from gpax_tpu import distributions as jdist
from gpax_tpu import ppl as jppl

torch.set_num_threads(1)

FIT = dict(print_summary=False, progress_bar=False, device="cpu")
# the potential and the mean parameters' gradients; the kernel
# hyperparameters' gradients to 1e-4, as tests/test_torch_models_extra.py
# holds them: float32 grams on both sides, the port's factor in float64
# against JAX's float32 (k_length's gradient differs by 2.1e-5 relative on
# the composed route at this point, every other term by under 4e-6)
POT_RTOL = 1e-5
KERNEL_GRAD_RTOL = 1e-4
# predictive means on injected draws
MEAN_RTOL, MEAN_ATOL = 1e-5, 1e-6


def t_osc(x, p):
    """A·sin(w·x)·exp(−d·x), written for one draw (examples/structured_gp.py:23)."""
    return (p["A"] * torch.sin(p["w"] * x) * torch.exp(-p["d"] * x)).squeeze()


def j_osc(x, p):
    return (p["A"] * jnp.sin(p["w"] * x) * jnp.exp(-p["d"] * x)).squeeze()


def t_osc_prior():
    return {"A": tppl.sample("A", tdist.LogNormal(0.0, 0.5)),
            "w": tppl.sample("w", tdist.Uniform(3.0, 7.0)),
            "d": tppl.sample("d", tdist.LogNormal(0.0, 0.5))}


def j_osc_prior():
    return {"A": jppl.sample("A", jdist.LogNormal(0.0, 0.5)),
            "w": jppl.sample("w", jdist.Uniform(3.0, 7.0)),
            "d": jppl.sample("d", jdist.LogNormal(0.0, 0.5))}


def _data(n=16, seed=0):
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(0.0, 1.2, n)).astype(np.float32)
    y = (1.2 * np.sin(5.0 * X) * np.exp(-0.8 * X) + 0.05 * rng.normal(size=n)).astype(np.float32)
    return X, y


def _models():
    jm = gpax_tpu.ExactGP(1, "Matern", mean_fn=j_osc, mean_fn_prior=j_osc_prior,
                          lengthscale_prior_dist=gpax_tpu.priors.gamma_dist(2.0, 5.0),
                          noise_prior_dist=gpax_tpu.priors.halfnormal_dist(0.1))
    tm = gpax_torch.ExactGP(1, "Matern", mean_fn=t_osc, mean_fn_prior=t_osc_prior,
                            lengthscale_prior_dist=gpax_torch.priors.gamma_dist(2.0, 5.0),
                            noise_prior_dist=gpax_torch.priors.halfnormal_dist(0.1))
    return jm, tm


Z = {"k_length": np.array([-1.2], np.float32), "k_scale": np.float32(0.1),
     "noise": np.float32(-3.0), "A": np.float32(0.2), "w": np.float32(0.3),
     "d": np.float32(-0.2)}


@pytest.fixture
def jax_fp32_wtw():
    old = gpax_tpu.get_config().wtw_precision
    gpax_tpu.set_config(wtw_precision="highest")
    yield
    gpax_tpu.set_config(wtw_precision=old)


@pytest.mark.parametrize("route", ["never", "always"])
def test_structured_potential_and_grads_match_jax(route, jax_fp32_wtw):
    """ExactGP with the oscillator mean, its Uniform(3, 7) frequency taken
    through the sigmoid: the potential and every gradient at one
    unconstrained point, on each of the port's likelihood routes."""
    X, y = _data()
    jm, tm = _models()
    jinfo = gpax_tpu.ppl.initialize_model(
        jm.model, jax.random.PRNGKey(0), (jnp.asarray(X[:, None]), jnp.asarray(y)))
    ju, jg = jax.value_and_grad(jinfo.potential_fn)({k: jnp.asarray(v) for k, v in Z.items()})
    gpax_torch.set_config(use_fused_likelihood=route)
    try:
        tinfo = initialize_model(tm.model, torch.Generator().manual_seed(0),
                                 (torch.as_tensor(X[:, None]), torch.as_tensor(y)))
        assert isinstance(tinfo.transforms["w"], tdist.SigmoidTransform)
        tz = {k: torch.tensor(v, requires_grad=True) for k, v in Z.items()}
        tu = tinfo.potential_fn(tz)
        tu.backward()
    finally:
        gpax_torch.set_config(use_fused_likelihood="auto")
    assert_close(tu, ju, rtol=POT_RTOL)
    for k in Z:
        tol = KERNEL_GRAD_RTOL if k in ("k_length", "k_scale", "noise") else POT_RTOL
        assert_close(tz[k].grad, jg[k], rtol=tol, atol=tol)


@pytest.mark.parametrize("route", ["never", "always"])
def test_batched_structured_potential_equals_single_chains(route):
    """The structured potential over 2 lockstep chains (the mean function
    vmapped over the chain dim) and the gradient of its sum against 2
    single-chain potentials: the gradient reaches A, w and d through the
    residual's cotangent on both routes (float32: the batch reorders no
    sum)."""
    X, y = _data()
    _, tm = _models()
    args = (torch.as_tensor(X[:, None]), torch.as_tensor(y))
    rng = np.random.default_rng(1)
    zb = {k: torch.tensor(np.stack([v, v + rng.normal(0, 0.2, np.shape(v))]).astype(np.float32))
          for k, v in Z.items()}
    gpax_torch.set_config(use_fused_likelihood=route)
    try:
        gen = torch.Generator().manual_seed(0)
        batched = initialize_model(tm.model, gen, args, batch_shape=(2,)).potential_fn
        single = initialize_model(tm.model, gen, args).potential_fn
        zg = {k: v.clone().requires_grad_(True) for k, v in zb.items()}
        ub = batched(zg)
        assert ub.shape == (2,)
        gb = torch.autograd.grad(ub.sum(), list(zg.values()))
        for c in range(2):
            zc = {k: v[c].clone().requires_grad_(True) for k, v in zb.items()}
            uc = single(zc)
            gc = torch.autograd.grad(uc, list(zc.values()))
            assert_close(ub[c], uc, rtol=1e-6)
            for name, a, b in zip(zb, gb, gc):
                assert float(b.abs().max()) > 0, name
                assert_close(a[c], b, rtol=1e-5, atol=1e-6)
    finally:
        gpax_torch.set_config(use_fused_likelihood="auto")


def _draws(S=5, seed=3):
    rng = np.random.default_rng(seed)
    return {"k_length": rng.uniform(0.2, 0.4, (S, 1)).astype(np.float32),
            "k_scale": rng.uniform(0.5, 1.5, S).astype(np.float32),
            "noise": rng.uniform(0.01, 0.05, S).astype(np.float32),
            "A": rng.uniform(1.0, 1.4, S).astype(np.float32),
            "w": rng.uniform(4.5, 5.5, S).astype(np.float32),
            "d": rng.uniform(0.6, 1.0, S).astype(np.float32)}


def test_structured_predictive_on_injected_draws_matches_jax():
    """get_mvn_posterior and get_predictive_mean_var of a chunk of 5 injected
    draws against JAX's, draw by draw (vmapped there)."""
    X, y = _data()
    jm, tm = _models()
    jm.X_train, jm.y_train = jnp.asarray(X[:, None]), jnp.asarray(y)
    tm.X_train, tm.y_train = torch.as_tensor(X[:, None]), torch.as_tensor(y)
    X_new = np.linspace(0.0, 2.4, 9, dtype=np.float32)[:, None]
    draws = _draws()
    jd = {k: jnp.asarray(v) for k, v in draws.items()}
    td = samples_from_numpy(draws, device="cpu")
    jmean, jcov = jax.vmap(lambda p: jm.get_mvn_posterior(jnp.asarray(X_new), p,
                                                          noiseless=True))(jd)
    tmean, tcov = tm.get_mvn_posterior(torch.as_tensor(X_new), td, noiseless=True)
    assert tuple(tmean.shape) == jmean.shape == (5, 9)
    assert_close(tmean, jmean, rtol=MEAN_RTOL, atol=MEAN_ATOL)
    assert_close(tcov, jcov, rtol=2e-4, atol=2e-5)
    jm2, jv2 = jax.vmap(lambda p: jm.get_predictive_mean_var(jnp.asarray(X_new), p))(jd)
    tm2, tv2 = tm.get_predictive_mean_var(torch.as_tensor(X_new), td)
    assert_close(tm2, jm2, rtol=MEAN_RTOL, atol=MEAN_ATOL)
    assert_close(tv2, jv2, rtol=2e-4, atol=2e-5)
    # one draw (no batch dim): the plain call of the user's function
    one = {k: v[0] for k, v in td.items()}
    m1, _ = tm.get_mvn_posterior(torch.as_tensor(X_new), one, noiseless=True)
    assert_close(m1, jmean[0], rtol=MEAN_RTOL, atol=MEAN_ATOL)


def test_predict_with_a_one_draw_mean_function():
    """The JAX package's reproduction of the fault: a mean function written
    for one draw (``p["a"] * x.squeeze()``), 12 points, 20 + 20 draws;
    ``predict`` gives (7,) means and (20, 1, 7) draws, as gpax_tpu does."""
    X, y = _data(12)
    gp = gpax_torch.ExactGP(1, "RBF", mean_fn=lambda x, p: p["a"] * x.squeeze(),
                            mean_fn_prior=lambda: {"a": tppl.sample("a", tdist.Normal(0.0, 1.0))})
    gp.fit(0, X, y, num_warmup=20, num_samples=20, **FIT)
    mean, draws = gp.predict(1, np.linspace(0, 2, 7), noiseless=True, device="cpu")
    assert mean.shape == (7,) and draws.shape == (20, 1, 7)
    assert bool(torch.isfinite(mean).all()) and bool(torch.isfinite(draws).all())
    mm, mv = gp.predict_moments(1, np.linspace(0, 2, 7), device="cpu")
    assert mm.shape == mv.shape == (7,)


def _se(a, b):
    """Standard error of the difference of two posterior means, about a
    quarter of the draws being effective on each side."""
    return np.sqrt(a.var() / (a.size / 4) + b.var() / (b.size / 4))


@pytest.fixture(scope="module")
def jax_structured_fit():
    X, y = _data(12)
    jm, _ = _models()
    jm.fit(jax.random.PRNGKey(0), jnp.asarray(X), jnp.asarray(y), num_warmup=100,
           num_samples=100, num_chains=2, chain_method="vectorized", print_summary=False,
           progress_bar=False)
    return {k: np.asarray(v) for k, v in jm.get_samples(chain_dim=True).items()}


def test_vectorized_structured_fit_matches_jax(jax_structured_fit):
    """A 2-chain vectorized structured fit: every site (2, 100), the
    batched potential trusted (no chain-by-chain fallback), every w draw
    inside (3, 7), and each site's posterior mean within 4 standard errors
    of JAX's vectorized fit."""
    X, y = _data(12)
    _, tm = _models()
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        tm.fit(0, X, y, num_warmup=100, num_samples=100, num_chains=2,
               chain_method="vectorized", **FIT)
    assert not tm.mcmc.chain_by_chain
    by_chain = tm.get_samples(chain_dim=True)
    assert set(by_chain) == set(jax_structured_fit)
    for k, v in by_chain.items():
        assert v.shape[:2] == (2, 100) and bool(torch.isfinite(v).all()), k
    w = by_chain["w"]
    assert bool(((w > 3.0) & (w < 7.0)).all())
    for k in ("A", "w", "d", "noise"):
        t, j = to_np(by_chain[k]).ravel(), jax_structured_fit[k].ravel()
        assert abs(t.mean() - j.mean()) < 4 * _se(t, j) + 1e-3, (k, t.mean(), j.mean())
    mean, draws = tm.predict(1, np.linspace(0, 2.4, 9), noiseless=True, device="cpu")
    assert mean.shape == (9,) and draws.shape == (200, 1, 9)


def test_vectorized_spm_matches_jax():
    """sPM with 2 vectorized chains (the fault's second model) against JAX's
    vectorized fit: means within 4 standard errors, predict on the pooled
    draws."""
    rng = np.random.default_rng(0)
    X = np.linspace(-1, 1, 12).astype(np.float32)
    y = (1.5 * X**2 - 0.5 + 0.05 * rng.normal(size=12)).astype(np.float32)
    jm = gpax_tpu.sPM(lambda x, p: p["a"] * x**2 + p["b"],
                      lambda: {"a": jppl.sample("a", jdist.Normal(0.0, 2.0)),
                               "b": jppl.sample("b", jdist.Normal(0.0, 2.0))})
    jm.fit(jax.random.PRNGKey(0), jnp.asarray(X), jnp.asarray(y), num_warmup=100,
           num_samples=100, num_chains=2, chain_method="vectorized", print_summary=False)
    tm = gpax_torch.sPM(lambda x, p: p["a"] * x**2 + p["b"],
                        lambda: {"a": tppl.sample("a", tdist.Normal(0.0, 2.0)),
                                 "b": tppl.sample("b", tdist.Normal(0.0, 2.0))})
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        tm.fit(0, X, y, num_warmup=100, num_samples=100, num_chains=2,
               chain_method="vectorized", **FIT)
    assert not tm.mcmc.chain_by_chain
    js = jm.get_samples(chain_dim=True)
    ts = tm.get_samples(chain_dim=True)
    assert ts["mu"].shape == (2, 100, 12)
    for k in ("a", "b", "noise"):
        t, j = to_np(ts[k]).ravel(), np.asarray(js[k]).ravel()
        assert abs(t.mean() - j.mean()) < 4 * _se(t, j) + 1e-3, (k, t.mean(), j.mean())
    y_pred, y_sampled = tm.predict(1, X, device="cpu")
    assert y_pred.shape == (12,) and y_sampled.shape == (200, 12)
    assert float(np.sqrt(np.mean((to_np(y_pred) - (1.5 * X**2 - 0.5)) ** 2))) < 0.1


def test_wrongly_broadcasting_model_runs_chain_by_chain():
    """2 chains on 2 data points: ``a * X`` of a (2,) latent and (2,) data
    broadcasts to a (2,) log density, the right shape with the wrong values
    (each chain sees one point). The check at the initial point rejects it,
    one warning says so, and chain by chain the posterior of ``a`` is the
    conjugate one: N(m, s²) with s² = 1/(1 + Σx²/σ²), m = s²·Σxy/σ²."""
    X = torch.tensor([0.5, 1.5])
    y = torch.tensor([0.4, 1.1])
    sigma = 0.5

    def model(X, y):
        a = tppl.sample("a", tdist.Normal(0.0, 1.0))
        tppl.sample("y", tdist.Normal(a * X, sigma), obs=y)

    with pytest.warns(UserWarning, match="differ from the single chains"):
        mcmc = MCMC(NUTS(model), 200, 400, num_chains=2, chain_method="vectorized").run(0, X, y)
    assert mcmc.chain_by_chain
    a = to_np(mcmc.get_samples()["a"])
    s2 = 1.0 / (1.0 + float((X**2).sum()) / sigma**2)
    m = s2 * float((X * y).sum()) / sigma**2
    assert abs(a.mean() - m) < 4 * np.sqrt(s2 / (a.size / 4)), (a.mean(), m)
    assert abs(a.std() - np.sqrt(s2)) < 0.2 * np.sqrt(s2)


def _vmap_unfriendly(x, p):
    # a host read of a parameter: torch.func.vmap cannot run it
    scale = 2.0 if p["a"].item() > 0 else 1.0
    return scale * p["a"] * x.squeeze()


@pytest.mark.parametrize("fn", [lambda x, p: p["a"] * x.squeeze() + p["b"], _vmap_unfriendly])
def test_call_batched_equals_draw_by_draw_calls(fn):
    """call_batched over (2, 3) draws against the 6 plain calls, values and
    gradients: through torch.func.vmap, or draw by draw where vmap cannot
    run the function (``.item()``)."""
    X = torch.linspace(0, 1, 5)[:, None]
    rng = np.random.default_rng(0)
    p = {k: torch.tensor(rng.normal(size=(2, 3)), dtype=torch.float32, requires_grad=True)
         for k in ("a", "b")}
    out = call_batched(fn, X, p, 2, squeeze=True)
    assert out.shape == (2, 3, 5)
    ga = torch.autograd.grad(out.sum(), p["a"])[0]
    for i in range(2):
        for j in range(3):
            pij = {k: v[i, j].detach().requires_grad_(True) for k, v in p.items()}
            o = fn(X, pij)
            assert_close(out[i, j], o, rtol=1e-6)
            assert_close(ga[i, j], torch.autograd.grad(o.sum(), pij["a"])[0], rtol=1e-6)
    # no batch dim: the plain call, bit for bit
    one = {k: v[0, 0].detach() for k, v in p.items()}
    assert torch.equal(call_batched(fn, X, one, 0, squeeze=True), fn(X, one).squeeze())
