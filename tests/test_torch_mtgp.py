"""gpax_torch's multi-task kernels and models against gpax_tpu's: the four
mtkernels (values and gradients, both diagonal rules), the MultiTaskGP and
CoregGP potentials and gradients, the predictive math on injected posterior
draws, and a small NUTS fit (statistically)."""

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

# kernels and posteriors: float32 on both sides, the port's factor in
# float64; the relative differences are those of float32 grams
RTOL, ATOL = 2e-5, 2e-6
# potentials and their gradients at cond(K) ≤ ~1e4 (as tests/test_torch_gp.py)
POT_RTOL = 1e-4
FIT_WARMUP, FIT_SAMPLES = 100, 200


@pytest.fixture
def jax_fp32_wtw():
    old = gpax_tpu.get_config().wtw_precision
    gpax_tpu.set_config(wtw_precision="highest")
    yield
    gpax_tpu.set_config(wtw_precision=old)


def _indexed(n_lo=10, n_hi=6, seed=0):
    """Two-fidelity data of BASELINE config 4's shape (bench.py:471-600)."""
    rng = np.random.default_rng(seed)
    x_lo, x_hi = rng.uniform(0, 2, n_lo), rng.uniform(0, 2, n_hi)
    X = np.concatenate([np.column_stack([x_lo, np.zeros(n_lo)]),
                        np.column_stack([x_hi, np.ones(n_hi)])]).astype(np.float32)
    f = np.sin(5 * X[:, 0]) * np.exp(-X[:, 0])
    y = (np.where(X[:, 1] > 0, f, 0.8 * f + 0.2 * np.cos(3 * X[:, 0]))
         + 0.05 * rng.normal(size=len(X))).astype(np.float32)
    return X, y


def _params(L=None, T=2, R=1, d=1, seed=1, S=None):
    """Kernel parameters of one draw (or S draws), with a latent axis L."""
    rng = np.random.default_rng(seed)
    lead = (() if S is None else (S,)) + (() if L is None else (L,))
    return {"k_length": rng.uniform(0.3, 1.5, lead + (d,)).astype(np.float32),
            "k_scale": rng.uniform(0.5, 2.0, lead).astype(np.float32),
            "W": rng.normal(0, 1.0, lead + (T, R)).astype(np.float32),
            "v": rng.uniform(0.1, 1.0, lead + (T,)).astype(np.float32),
            "noise": rng.uniform(0.01, 0.2, (() if S is None else (S,)) + (T,)).astype(
                np.float32)}


def _kernel_pair(name, base):
    if name == "multitask":
        return (gpax_tpu.kernels.MultitaskKernel(base),
                gpax_torch.kernels.MultitaskKernel(base))
    if name == "multivariate":
        return (gpax_tpu.kernels.MultivariateKernel(base, 2),
                gpax_torch.kernels.MultivariateKernel(base, 2))
    shared = name == "lcm_shared"
    return (gpax_tpu.kernels.LCMKernel(base, shared, 2),
            gpax_torch.kernels.LCMKernel(base, shared, 2))


def test_index_kernel_matches_jax():
    p = _params(T=3, R=2)
    i1 = np.array([0, 2, 1, 1, 0])
    i2 = np.array([2, 2, 0])
    j = gpax_tpu.kernels.index_kernel(jnp.asarray(i1), jnp.asarray(i2),
                                      {k: jnp.asarray(v) for k, v in p.items()})
    t = gpax_torch.kernels.index_kernel(torch.as_tensor(i1), torch.as_tensor(i2),
                                        {k: torch.as_tensor(v) for k, v in p.items()})
    assert t.shape == (5, 3)
    assert_close(t, j, rtol=1e-6)


@pytest.mark.parametrize("base", ["RBF", "Matern"])
@pytest.mark.parametrize("name", ["multitask", "multivariate", "lcm_indexed", "lcm_shared"])
@pytest.mark.parametrize("same", [True, False], ids=["XX", "XZ"])
def test_mtkernel_values_and_grads_match_jax(name, base, same):
    """Values and the gradients of their sum in every parameter, with
    X ≡ Z (noise and jitter on the diagonal) and X ≠ Z (none)."""
    X, _ = _indexed()
    Z = X[:7] + np.float32(0.05)
    if name in ("multivariate", "lcm_shared"):
        X, Z = X[:, :1], Z[:, :1]
    p = _params(L=2 if name.startswith("lcm") else None)
    jk, tk = _kernel_pair(name, base)

    def jax_fn(params):
        Xj = jnp.asarray(X)
        return jk(Xj, Xj if same else jnp.asarray(Z), params, params["noise"])

    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jval = jax.jit(jax_fn)(jp)
    jgrad = jax.jit(jax.grad(lambda q: jnp.sum(jax_fn(q))))(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    Xt = torch.as_tensor(X)
    tval = tk(Xt, Xt if same else torch.as_tensor(Z), tp, tp["noise"])
    assert tuple(tval.shape) == tuple(jval.shape)
    assert_close(tval, jval, rtol=RTOL, atol=ATOL)
    grads = torch.autograd.grad(tval.sum(), list(tp.values()), allow_unused=True,
                                materialize_grads=True)
    for k, g in zip(tp, grads):
        assert_close(g, jgrad[k], rtol=1e-4, atol=1e-4)


def test_mtkernel_batched_draws_match_per_draw():
    """A leading dim of posterior draws before the latent axis gives each
    draw's kernel."""
    X, _ = _indexed()
    p = _params(L=2, S=3)
    _, tk = _kernel_pair("lcm_indexed", "Matern")
    Xt = torch.as_tensor(X)
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    batched = tk(Xt, Xt, tp, tp["noise"])
    assert batched.shape == (3, 16, 16)
    for s in range(3):
        ps = {k: v[s] for k, v in tp.items()}
        assert_close(batched[s], tk(Xt, Xt, ps, ps["noise"]), rtol=1e-6, atol=1e-7)


def _models(kind):
    if kind == "mtgp":
        return (gpax_tpu.MultiTaskGP(1, "Matern", num_latents=1, num_tasks=2),
                gpax_torch.MultiTaskGP(1, "Matern", num_latents=1, num_tasks=2))
    if kind == "mtgp_lcm":
        return (gpax_tpu.MultiTaskGP(1, "RBF", num_latents=2, num_tasks=2),
                gpax_torch.MultiTaskGP(1, "RBF", num_latents=2, num_tasks=2))
    if kind == "mtgp_shared":  # Kronecker form, one latent per task
        return (gpax_tpu.MultiTaskGP(1, "Matern", shared_input_space=True, num_tasks=2),
                gpax_torch.MultiTaskGP(1, "Matern", shared_input_space=True, num_tasks=2))
    return gpax_tpu.CoregGP(1, "RBF"), gpax_torch.CoregGP(1, "RBF")


def _z_point(kind, shift):
    """An unconstrained point of the model's latents."""
    L = 2 if kind in ("mtgp_lcm", "mtgp_shared") else 1
    z = {"k_length": np.full((L, 1), np.log(0.6) + shift, np.float32),
         "W": np.full((L, 2, 1), 0.7 - shift, np.float32),
         "v": np.full((L, 2), np.log(0.5) + shift, np.float32),
         "noise": np.array([np.log(0.02), np.log(0.05) + shift], np.float32)}
    if kind == "corgp":
        z = {"k_length": z["k_length"][0], "W": z["W"][0], "v": z["v"][0], "noise": z["noise"]}
    return z


@pytest.mark.parametrize("kind", ["mtgp", "mtgp_lcm", "mtgp_shared", "corgp"])
def test_potential_and_gradient_match_jax(kind, jax_fp32_wtw):
    X, y = _indexed(16, 8)
    if kind == "mtgp_shared":  # both tasks at each of 12 points, point-major
        X, y = X[:12, :1], np.stack([y[:12], 0.8 * y[:12]], -1).reshape(-1)
    jm, tm = _models(kind)
    jm._set_training_data(jnp.asarray(X), jnp.asarray(y))
    tm._set_training_data(X, y, device="cpu")
    jinfo = gpax_tpu.ppl.initialize_model(jm.model, jax.random.PRNGKey(0),
                                          (jnp.asarray(X), jnp.asarray(y)))
    tinfo = gpax_torch.ppl.initialize_model(tm.model, torch.Generator().manual_seed(0),
                                            (tm.X_train, tm.y_train))
    assert set(jinfo.init_unconstrained) == set(tinfo.init_unconstrained)
    jvg = jax.jit(jax.value_and_grad(jinfo.potential_fn))
    for shift in (0.0, 0.4):
        z = _z_point(kind, shift)
        for k, v in z.items():
            assert tuple(tinfo.init_unconstrained[k].shape) == v.shape, k
        ju, jg = jvg({k: jnp.asarray(v) for k, v in z.items()})
        tz = {k: torch.tensor(v, requires_grad=True) for k, v in z.items()}
        tu = tinfo.potential_fn(tz)
        tu.backward()
        assert_close(tu, ju, rtol=POT_RTOL)
        for k in z:
            assert_close(tz[k].grad, jg[k], rtol=POT_RTOL, atol=POT_RTOL)


def _draws(kind, S=4, seed=2):
    rng = np.random.default_rng(seed)
    L = 2 if kind in ("mtgp_lcm", "mtgp_shared") else 1
    lead = (S,) if kind == "corgp" else (S, L)
    s = {"k_length": rng.uniform(0.3, 1.0, lead + (1,)),
         "k_scale": np.ones(lead),
         "W": rng.normal(0, 1.0, lead + (2, 1)),
         "v": rng.uniform(0.1, 1.0, lead + (2,)),
         "noise": rng.uniform(0.002, 0.02, (S, 2))}
    return {k: v.astype(np.float32) for k, v in s.items()}


@pytest.mark.parametrize("kind", ["mtgp", "mtgp_lcm", "mtgp_shared", "corgp"])
def test_predictive_math_on_injected_draws_matches_jax(kind):
    """get_mvn_posterior of a batch of draws against JAX draw by draw, and
    predict's mean (the average of the draws' means): same draws, float32
    tolerance."""
    X, y = _indexed(16, 8)
    Xn = np.column_stack([np.linspace(0, 2, 9), np.ones(9)]).astype(np.float32)
    rows = 9
    if kind == "mtgp_shared":  # both tasks at each point, point-major
        X, y = X[:12, :1], np.stack([y[:12], 0.8 * y[:12]], -1).reshape(-1)
        Xn, rows = Xn[:, :1], 18
    jm, tm = _models(kind)
    jm._set_training_data(jnp.asarray(X), jnp.asarray(y))
    tm._set_training_data(X, y, device="cpu")
    s = _draws(kind)
    ts = samples_from_numpy(s, device="cpu")
    t_mean, t_cov = tm.get_mvn_posterior(torch.as_tensor(Xn), ts, noiseless=True)
    assert t_mean.shape == (4, rows) and t_cov.shape == (4, rows, rows)
    j_post = jax.jit(lambda p: jm.get_mvn_posterior(jnp.asarray(Xn), p, noiseless=True))
    for i in range(4):
        j_mean, j_cov = j_post({k: jnp.asarray(v[i]) for k, v in s.items()})
        assert_close(t_mean[i], j_mean, rtol=1e-3, atol=1e-4)
        assert_close(t_cov[i], j_cov, rtol=1e-3, atol=1e-4)
    j_pred, _ = jm.predict(jax.random.PRNGKey(0), jnp.asarray(Xn),
                           {k: jnp.asarray(v) for k, v in s.items()}, noiseless=True)
    t_pred, t_draws = tm.predict(0, Xn, ts, noiseless=True, device="cpu")
    assert t_draws.shape == (4, 1, rows) and bool(torch.isfinite(t_draws).all())
    assert_close(t_pred, j_pred, rtol=1e-3, atol=1e-4)


@pytest.fixture(scope="module")
def jax_mtgp_fit():
    """The one MultiTaskGP NUTS compile of this file."""
    X, y = _indexed(10, 6)
    m = gpax_tpu.MultiTaskGP(1, "Matern", num_latents=1, num_tasks=2)
    m.fit(gpax_tpu.utils.get_keys()[0], jnp.asarray(X), jnp.asarray(y), num_warmup=FIT_WARMUP,
          num_samples=FIT_SAMPLES, print_summary=False, progress_bar=False)
    return {k: np.asarray(v) for k, v in m.get_samples().items()}


def test_fit_matches_jax_within_mc_error(jax_mtgp_fit):
    """A segmented port fit and the JAX fit on the same data: the posterior
    means of the identified sites (the lengthscale and the log noise) agree
    within 4 Monte-Carlo standard errors of their difference, taken from
    each chain's effective sample size."""
    from gpax_torch.infer import effective_sample_size

    X, y = _indexed(10, 6)
    m = gpax_torch.MultiTaskGP(1, "Matern", num_latents=1, num_tasks=2)
    m.fit(0, X, y, num_warmup=FIT_WARMUP, num_samples=FIT_SAMPLES, segment_size=50,
          print_summary=False, progress_bar=False, device="cpu")
    ts = {k: to_np(v) for k, v in m.get_samples().items()}
    S = FIT_SAMPLES
    assert ts["W"].shape == (S, 1, 2, 1) and ts["noise"].shape == (S, 2)
    for site, f in (("k_length", np.log), ("noise", np.log)):
        a, b = f(ts[site]).reshape(S, -1), f(jax_mtgp_fit[site]).reshape(S, -1)
        for c in range(a.shape[1]):
            se = [np.std(x[:, c]) / np.sqrt(max(float(effective_sample_size(
                torch.as_tensor(x[None, :, c]))), 5.0)) for x in (a, b)]
            diff = abs(a[:, c].mean() - b[:, c].mean())
            assert diff < 4 * np.hypot(*se) + 1e-3, (site, c, diff, se)
