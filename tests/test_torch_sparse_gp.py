"""K3's path in gpax_torch against the JAX package on the same inputs:
``chol_inv`` (the twin of K3 on each 128-leaf, the recursion and the
closed-form pullback), ``safe_chol_inv``, ``LowRankMultivariateNormal``,
the viSparseGP model's negative ELBO and gradient, its predictive math with
the state carried across, a small fit, and the inducing points."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gpax_torch
import gpax_tpu
from _torch_parity import assert_close, spd, value_and_grads
from gpax_torch.ops import chol as tchol
from gpax_torch.ops import linalg as tlinalg
from gpax_torch.utils import (get_keys, host_syncs, initialize_inducing_points,
                              load_vi_state, vi_state_from_jax)
from gpax_tpu.ops import linalg as jlinalg
from gpax_tpu.ops.chol import chol_inv as j_chol_inv

torch.set_num_threads(1)


@pytest.fixture
def jax_pallas_chol():
    """The JAX package on its chol_inv path (Pallas in interpret mode here),
    which it otherwise takes only on a TPU above 512."""
    old = gpax_tpu.get_config().use_pallas_chol
    gpax_tpu.set_config(use_pallas_chol="always")
    yield
    gpax_tpu.set_config(use_pallas_chol=old)


# ----------------------------------------------------------------- chol_inv

@pytest.mark.parametrize("n", [64, 128, 200, 384])
def test_chol_inv_matches_jax(n):
    """spd(n) has eigenvalues in [0.5, ~4.5], so κ(K) ≤ ~9 and κ(L) ≤ 3: two
    float32 factorizations in other summation orders agree to ~1e-6 of
    max|W|; tolerance 1e-4 of max|L| and of max|W|."""
    K = spd(n, seed=n)
    before = tchol.chol_inv_launches
    L, W = tchol.chol_inv(torch.tensor(K))
    assert tchol.chol_inv_launches == before  # CPU tensor: the twin, no launch
    L_j, W_j = (np.asarray(a) for a in j_chol_inv(jnp.asarray(K), True))
    assert_close(L, L_j, rtol=0, atol=1e-4 * np.abs(L_j).max())
    assert_close(W, W_j, rtol=0, atol=1e-4 * np.abs(W_j).max())
    assert torch.count_nonzero(torch.triu(L, 1)) == 0
    assert torch.count_nonzero(torch.triu(W, 1)) == 0
    assert (L @ L.T - torch.tensor(K)).abs().max().item() < 5e-4
    assert (W @ L - torch.eye(n)).abs().max().item() < 5e-4


def test_chol_inv_is_nan_on_indefinite_input():
    K = spd(160) - 5.0 * np.eye(160, dtype=np.float32)
    L, W = tchol.chol_inv(torch.tensor(K))
    L_j, _ = j_chol_inv(jnp.asarray(K), True)
    assert not bool(jnp.all(jnp.isfinite(L_j)))
    assert not torch.isfinite(L).all() and not torch.isfinite(W).all()


def test_chol_inv_batched_matches_jax_and_per_matrix():
    Ks = np.stack([spd(192, seed=s) for s in range(3)])
    L, W = tchol.chol_inv(torch.tensor(Ks))
    assert L.shape == W.shape == (3, 192, 192)
    L_j, W_j = (np.asarray(a) for a in j_chol_inv(jnp.asarray(Ks), True))
    assert_close(L, L_j, rtol=0, atol=1e-4 * np.abs(L_j).max())
    assert_close(W, W_j, rtol=0, atol=1e-4 * np.abs(W_j).max())
    L1, W1 = tchol.chol_inv(torch.tensor(Ks[1]))
    assert_close(L[1], L1, rtol=0, atol=1e-6)
    assert_close(W[1], W1, rtol=0, atol=1e-6)


def _f_terms(n, seed):
    y = np.random.default_rng(seed).normal(size=n).astype(np.float32)
    P = (np.random.default_rng(seed + 1).normal(size=(n, n)) / n).astype(np.float32)
    return y, P


@pytest.mark.parametrize("n", [100, 200])
def test_chol_inv_backward_matches_jax_vjp(n):
    """A scalar of L and W (as tests/test_chol.py:53) through the port's
    pullback and JAX's custom VJP. Both are the same matmul formula in
    float32 on κ(K) ≤ 9: 1e-3 of max|∂K|."""
    K = spd(n, seed=3)
    y, P = _f_terms(n, 1)

    def jf(K):
        L, W = j_chol_inv(K, True)
        return 0.5 * jnp.sum((W @ y) ** 2) + jnp.sum(jnp.log(jnp.diagonal(L))) + jnp.sum(L * P)

    def tf(K):
        L, W = tchol.chol_inv(K)
        return (0.5 * ((W @ torch.tensor(y)) ** 2).sum() + torch.log(L.diagonal()).sum()
                + (L * torch.tensor(P)).sum())

    (jv, tv), [(jg, tg)] = value_and_grads(jf, tf, [K], (0,))
    assert_close(tv, jv, rtol=1e-5)
    assert_close(tg, jg, rtol=0, atol=1e-3 * np.abs(jg).max())


def test_chol_inv_backward_matches_autograd_through_cholesky():
    """The same scalar through torch.linalg.cholesky's own autograd and a
    triangular solve, in float64 so that the reference is exact: the
    pullback is the same function, 1e-3 of max|∂K| in float32."""
    n = 150
    K = spd(n, seed=4)
    y, P = _f_terms(n, 5)
    yt, Pt = torch.tensor(y), torch.tensor(P)
    Kt = torch.tensor(K, requires_grad=True)
    L, W = tchol.chol_inv(Kt)
    (0.5 * ((W @ yt) ** 2).sum() + torch.log(L.diagonal()).sum() + (L * Pt).sum()).backward()
    K64 = torch.tensor(K, dtype=torch.float64, requires_grad=True)
    L64 = torch.linalg.cholesky(K64)
    w64 = torch.linalg.solve_triangular(L64, yt.double()[:, None], upper=False)[:, 0]
    (0.5 * (w64**2).sum() + torch.log(L64.diagonal()).sum() + (L64 * Pt.double()).sum()).backward()
    ref = 0.5 * (K64.grad + K64.grad.T)  # the pullback returns the symmetric part
    assert_close(Kt.grad, ref, rtol=0, atol=1e-3 * ref.abs().max().item())


# ------------------------------------------------------------ safe_chol_inv

def _gp_gram(n, seed):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-1, 1, n))
    return (1.3 * np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2 / 0.4**2)
            + 0.05 * np.eye(n)).astype(np.float32)


def test_safe_chol_inv_matches_jax_and_inverts(jax_pallas_chol):
    """tests/test_chol.py:81's well-conditioned case, both packages on
    chol_inv: 1e-4 of max|L| and of max|W| (κ(K) ≤ 9), and no host sync."""
    K = spd(192, seed=5)
    syncs = host_syncs()
    L, W = tlinalg.safe_chol_inv(torch.tensor(K))
    assert host_syncs() == syncs
    L_j, W_j = (np.asarray(a) for a in jlinalg.safe_chol_inv(jnp.asarray(K)))
    assert_close(L, L_j, rtol=0, atol=1e-4 * np.abs(L_j).max())
    assert_close(W, W_j, rtol=0, atol=1e-4 * np.abs(W_j).max())
    assert (W @ L - torch.eye(192)).abs().max().item() < 5e-4


def test_safe_chol_inv_escalates_like_jax(jax_pallas_chol):
    """A slightly indefinite gram (min eigenvalue ≈ −0.01) fails the base
    jitter; both escalate to max(0.05, 1000·n·eps)·mean(diag K) and agree.
    The escalated K is well conditioned (diagonal ≥ 0.05): 1e-4 of max."""
    K = _gp_gram(40, seed=3) - 0.06 * np.eye(40, dtype=np.float32)
    assert torch.linalg.cholesky_ex(torch.tensor(K))[1].item() != 0
    L, W = tlinalg.safe_chol_inv(torch.tensor(K))
    assert torch.isfinite(L).all() and torch.isfinite(W).all()
    L_j, W_j = (np.asarray(a) for a in jlinalg.safe_chol_inv(jnp.asarray(K)))
    assert_close(L, L_j, rtol=0, atol=1e-4 * np.abs(L_j).max())
    assert_close(W, W_j, rtol=0, atol=1e-4 * np.abs(W_j).max())


def test_safe_chol_inv_is_nan_where_escalation_fails_and_batches(jax_pallas_chol):
    worse = _gp_gram(40, seed=3)
    worse[0, 0] = -5.0
    L, _ = tlinalg.safe_chol_inv(torch.tensor(worse))
    L_j, _ = jlinalg.safe_chol_inv(jnp.asarray(worse))
    assert torch.isnan(L).any() and bool(jnp.isnan(L_j).any())
    # per-matrix choice in a batch: the good matrix keeps the base jitter
    both = torch.tensor(np.stack([_gp_gram(40, seed=3), worse]))
    Lb, _ = tlinalg.safe_chol_inv(both)
    assert torch.isfinite(Lb[0]).all() and torch.isnan(Lb[1]).any()
    assert_close(Lb[0], tlinalg.safe_chol_inv(both[0])[0], rtol=0, atol=1e-6)


def test_safe_chol_inv_in_float64_is_float64_accurate():
    """The sparse GP's factor: a float32 gram factored in float64 with the
    float32 jitter 4·n·eps₃₂, returned in float32. At κ(K) ~ 1e6, where a
    float32 factorization carries errors of ~κ·2⁻²⁴ ≈ 6e-2 relative in W,
    L and W equal a float64 Cholesky of the same jittered K to float32
    rounding (1e-6 of max), and W·L = I to 1e-4 (float32 rounding of W,
    whose entries reach ~1e3)."""
    x = np.linspace(0, 4, 200)
    K = np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2 / 0.8**2).astype(np.float32)
    L, W = tlinalg.safe_chol_inv_f64(torch.tensor(K))
    assert L.dtype == W.dtype == torch.float32
    K64 = torch.tensor(K, dtype=torch.float64) + 4.0 * 200 * 2.0**-23 * torch.eye(200,
                                                                              dtype=torch.float64)
    L64 = torch.linalg.cholesky(K64)
    W64 = torch.linalg.solve_triangular(L64, torch.eye(200, dtype=torch.float64), upper=False)
    assert_close(L, L64, rtol=0, atol=1e-6 * L64.abs().max().item())
    assert_close(W, W64, rtol=0, atol=1e-6 * W64.abs().max().item())
    assert (W.double() @ L64 - torch.eye(200, dtype=torch.float64)).abs().max().item() < 1e-4


def test_safe_chol_inv_gradient_matches_jax(jax_pallas_chol):
    K = _gp_gram(48, seed=6)

    def jf(k):
        L, W = jlinalg.safe_chol_inv(k)
        return jnp.sum(jnp.sin(L)) + jnp.sum(W[:, 0])

    def tf(k):
        L, W = tlinalg.safe_chol_inv(k)
        return torch.sin(L).sum() + W[:, 0].sum()

    (jv, tv), [(jg, tg)] = value_and_grads(jf, tf, [K], (0,))
    # κ(K) ~ 1e2: float32 pullbacks agree to 1e-3 of max|∂K|
    assert_close(tv, jv, rtol=1e-4)
    assert_close(tg, jg, rtol=0, atol=1e-3 * np.abs(jg).max())


# ------------------------------------------------- LowRankMultivariateNormal

def _lowrank(n=30, m=5, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n).astype(np.float32) * 0.1,
            (rng.normal(size=(n, m)) * 0.5).astype(np.float32),
            rng.uniform(0.05, 0.3, n).astype(np.float32),
            rng.normal(size=n).astype(np.float32))


def test_lowrank_mvn_log_prob_and_gradients_match_jax():
    loc, W, D, y = _lowrank()

    def jf(loc, W, D, y):
        return gpax_tpu.distributions.LowRankMultivariateNormal(loc, W, D).log_prob(y)

    def tf(loc, W, D, y):
        return gpax_torch.distributions.LowRankMultivariateNormal(loc, W, D).log_prob(y)

    (jv, tv), grads = value_and_grads(jf, tf, [loc, W, D, y], (0, 1, 2))
    # the capacitance I + WᵀD⁻¹W has κ ~ 1e2: float32 Woodbury terms agree
    # to ~1e-6 relative; 1e-5 on the value, 1e-4 of max on the gradients
    assert_close(tv, jv, rtol=1e-5)
    for jg, tg in grads:
        assert_close(tg, jg, rtol=0, atol=1e-4 * np.abs(jg).max())
    dist = gpax_torch.distributions.LowRankMultivariateNormal(
        torch.tensor(loc), torch.tensor(W), torch.tensor(D))
    cov = torch.tensor(W) @ torch.tensor(W).T + torch.diag(torch.tensor(D))
    ref = torch.distributions.MultivariateNormal(torch.tensor(loc).double(), cov.double())
    assert_close(dist.log_prob(torch.tensor(y)), ref.log_prob(torch.tensor(y).double()),
                 rtol=1e-5)
    assert_close(dist.variance, torch.diagonal(cov), rtol=1e-6)


def test_lowrank_mvn_batched_and_nan_like_jax():
    loc, W, D, y = _lowrank(seed=1)
    ys = np.stack([y, -y, 2 * y])
    tdist = gpax_torch.distributions.LowRankMultivariateNormal(
        torch.tensor(loc), torch.tensor(W), torch.tensor(D))
    jdist = gpax_tpu.distributions.LowRankMultivariateNormal(loc, W, D)
    assert_close(tdist.log_prob(torch.tensor(ys)), jdist.log_prob(ys), rtol=1e-5)
    # a negative diagonal makes the capacitance indefinite: NaN in both
    bad = -np.ones_like(D)
    t = gpax_torch.distributions.LowRankMultivariateNormal(
        torch.tensor(loc), torch.tensor(W), torch.tensor(bad)).log_prob(torch.tensor(y))
    j = gpax_tpu.distributions.LowRankMultivariateNormal(loc, W, bad).log_prob(y)
    assert np.isnan(float(j)) and torch.isnan(t)


def test_lowrank_mvn_sample_moments():
    loc, W, D, _ = _lowrank(n=6, m=2, seed=2)
    dist = gpax_torch.distributions.LowRankMultivariateNormal(
        torch.tensor(loc), torch.tensor(W), torch.tensor(D))
    draws = dist.sample(torch.Generator().manual_seed(0), (40000,))
    assert draws.shape == (40000, 6)
    cov = W @ W.T + np.diag(D)
    # Monte-Carlo error of 40000 draws: ~5e-3 on the mean, ~1e-2 on the covariance
    assert_close(draws.mean(0), loc, rtol=0, atol=0.02)
    assert_close(torch.cov(draws.T), cov, rtol=0, atol=0.03)


# ----------------------------------------------------------------- the model

def _sparse_data(n=200, seed=0):
    """bench.py's config-3 generator at a small n."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 4, n).astype(np.float32)
    y = (np.sin(3 * X) * np.exp(-0.3 * X) + 0.05 * rng.normal(size=n)).astype(np.float32)
    return X, y


_POINT = {"k_length_loc": np.log(np.array([0.6], np.float32)),
          "k_scale_loc": np.float32(np.log(0.9)), "noise_loc": np.float32(np.log(0.02))}


@pytest.mark.parametrize("jax_chol", ["auto", "always"])
def test_sparse_neg_elbo_and_gradient_match_jax(jax_chol):
    """The viSparseGP model's negative ELBO under AutoDelta at injected
    parameters, and its gradient in the guide's locations and the inducing
    inputs Xu (through K1's backward and chol_inv's pullback), against
    ``SVI._neg_elbo`` under ``jax.value_and_grad``, with JAX on its XLA
    Cholesky ("auto") or on chol_inv ("always"). The gram of 10 inducing
    points 0.4 apart at ℓ = 0.6 has κ ~ 1e4 in float32: 1e-4 relative on the
    value, 2e-3 of max on each gradient."""
    X, y = _sparse_data(60, seed=1)
    Xu = np.linspace(0.2, 3.8, 10, dtype=np.float32)[:, None]
    jm, tm = gpax_tpu.viSparseGP(1, "RBF"), gpax_torch.viSparseGP(1, "RBF")
    Xj, yj = jm._set_data(X, y)
    old = gpax_tpu.get_config().use_pallas_chol
    gpax_tpu.set_config(use_pallas_chol=jax_chol)
    try:
        jsvi = gpax_tpu.infer.SVI(jm.model, gpax_tpu.infer.AutoDelta(jm.model),
                                  optax.adam(1e-3))
        key = jax.random.PRNGKey(0)
        jsvi.guide.init_params(key, (Xj, yj), {"Xu": jnp.asarray(Xu)})
        jv, (jg, jmg) = jax.value_and_grad(jsvi._neg_elbo, argnums=(0, 1))(
            {k: jnp.asarray(v) for k, v in _POINT.items()}, {"Xu": jnp.asarray(Xu)}, key,
            (Xj, yj), {"Xu": jnp.asarray(Xu)})
    finally:
        gpax_tpu.set_config(use_pallas_chol=old)
    Xt, yt = tm._set_data(X, y, device="cpu")
    tsvi = gpax_torch.infer.SVI(tm.model, gpax_torch.infer.AutoDelta(tm.model), 1e-3)
    gen = torch.Generator().manual_seed(0)
    tsvi.guide.init_params(gen, (Xt, yt), {"Xu": torch.tensor(Xu)})
    gp = {k: torch.tensor(v, requires_grad=True) for k, v in _POINT.items()}
    mp = {"Xu": torch.tensor(Xu, requires_grad=True)}
    tv = tsvi._neg_elbo(gp, mp, gen, (Xt, yt), {"Xu": torch.tensor(Xu)})
    tv.backward()
    assert_close(tv, jv, rtol=1e-4)
    for k in _POINT:
        assert_close(gp[k].grad, jg[k], rtol=0, atol=2e-3 * np.abs(np.asarray(jg[k])).max())
    assert_close(mp["Xu"].grad, jmg["Xu"], rtol=0,
                 atol=2e-3 * np.abs(np.asarray(jmg["Xu"])).max())


def test_kff_diagonal_is_one_batched_kernel_call():
    """k(x, x) of the n training points is one kernel call on (n, 1, d)
    inputs (one K1 launch on the card), beside Kuu and Kuf."""
    X, y = _sparse_data(50, seed=2)
    tm = gpax_torch.viSparseGP(1, "RBF")
    shapes = []
    kernel = tm.kernel

    def spy(A, B, *args, **kwargs):
        shapes.append((tuple(A.shape), tuple(B.shape)))
        return kernel(A, B, *args, **kwargs)

    tm.kernel = spy
    Xt, yt = tm._set_data(X, y, device="cpu")
    Xu = Xt[::10]
    gpax_torch.ppl.log_density(tm.model, (Xt, yt), {"Xu": Xu},
                               {"k_length": torch.tensor([0.5]), "k_scale": torch.tensor(1.0),
                                "noise": torch.tensor(0.1)})
    assert shapes == [((5, 1), (5, 1)), ((5, 1), (50, 1)), ((50, 1, 1), (50, 1, 1))]


# --------------------------------------------------------- fit and predict

FIT_N, FIT_STEPS, FIT_STEP_SIZE = 200, 300, 0.05


@pytest.fixture(scope="module")
def fits():
    """The JAX and the port's fit of the same data: n = 200, ratio 0.1
    (m = 20, "uniform"), 300 Adam steps of 0.05 (config 2's step size; at
    config 3's 5e-3 300 steps stop short of the optimum from either
    package's prior draw). The port runs on the CPU."""
    X, y = _sparse_data(FIT_N)
    jm = gpax_tpu.viSparseGP(1, "RBF")
    jm.fit(gpax_tpu.utils.get_keys()[0], X, y, inducing_points_ratio=0.1,
           inducing_points_selection="uniform", num_steps=FIT_STEPS, step_size=FIT_STEP_SIZE,
           print_summary=False, progress_bar=False)
    tm = gpax_torch.viSparseGP(1, "RBF")
    tm.fit(get_keys(0)[0], X, y, inducing_points_ratio=0.1,
           inducing_points_selection="uniform", num_steps=FIT_STEPS, step_size=FIT_STEP_SIZE,
           print_summary=False, progress_bar=False, device="cpu")
    return jm, tm


def test_small_fit_agrees_with_jax_statistically(fits):
    """Both packages start from their own prior draw and reach the same
    optimum: final losses within 0.5 (the last-step Adam jitter of a loss
    near −262) and predictive means within 5e-3 of each other, against a
    noise sd of 0.05. The losses fall."""
    jm, tm = fits
    losses = tm.loss
    assert losses.shape == (FIT_STEPS,) and torch.isfinite(losses).all()
    assert losses[-50:].mean() < losses[:50].mean() and losses[-1] < losses[0]
    assert abs(losses[-1].item() - float(jm.loss[-1])) < 0.5
    assert tm.Xu.shape == (20, 1)
    grid = np.linspace(0, 4, 101, dtype=np.float32)
    tmean, tvar = tm.predict_in_batches(0, grid, batch_size=50, device="cpu")
    jmean, jvar = jm.predict_in_batches(gpax_tpu.utils.get_keys()[1], grid, batch_size=50)
    assert tmean.shape == tvar.shape == (101,)
    assert_close(tmean, jmean, rtol=0, atol=5e-3)
    truth = np.sin(3 * grid) * np.exp(-0.3 * grid)
    assert np.sqrt(np.mean((tmean.numpy() - truth) ** 2)) < 0.02


@pytest.mark.parametrize("noiseless", [False, True])
def test_predictive_math_matches_jax_with_carried_state(fits, noiseless):
    """The JAX fit's state (medians, Xu, data) carried into the port by
    ``utils.vi_state_from_jax``/``load_vi_state``: get_mvn_posterior and
    predict equal JAX's. The capacitance B = I + V D⁻¹ Vᵀ reaches ~1e5 at
    noise 0.003, so float32 factors agree to ~1e-4 relative: 1e-3 of max."""
    jm, _ = fits
    state = vi_state_from_jax(jm)
    assert set(state) == {"median", "X_train", "y_train", "Xu"}
    tm = gpax_torch.viSparseGP(1, "RBF")
    load_vi_state(tm, state, device="cpu")
    Xn = np.linspace(-0.5, 4.5, 37, dtype=np.float32)[:, None]
    params = state["median"]
    jmean, jcov = jm.get_mvn_posterior(jnp.asarray(Xn), params, noiseless)
    tmean, tcov = tm.get_mvn_posterior(torch.tensor(Xn), tm.get_samples(), noiseless)
    assert_close(tmean, jmean, rtol=0, atol=1e-3 * np.abs(np.asarray(jmean)).max())
    assert_close(tcov, jcov, rtol=0, atol=1e-3 * np.abs(np.asarray(jcov)).max())
    pm, pv = tm.predict(None, Xn, noiseless=noiseless, device="cpu")
    jpm, jpv = jm.predict(None, jnp.asarray(Xn), noiseless=noiseless)
    assert_close(pm, jpm, rtol=0, atol=1e-3 * np.abs(np.asarray(jpm)).max())
    assert_close(pv, jpv, rtol=0, atol=1e-3 * np.abs(np.asarray(jpv)).max())


# ------------------------------------------------------------ inducing points

@pytest.mark.parametrize("n,ratio", [(200, 0.1), (2000, 0.05), (20000, 0.05), (2455, 0.05)])
def test_uniform_inducing_points_are_jax_indices(n, ratio):
    X = np.arange(n, dtype=np.float32)[:, None]
    Xu_j = np.asarray(gpax_tpu.utils.initialize_inducing_points(jnp.asarray(X), ratio,
                                                                "uniform"))
    Xu_t = initialize_inducing_points(torch.tensor(X), ratio, "uniform")
    assert Xu_t.shape == (int(n * ratio), 1)
    assert np.array_equal(Xu_t.numpy(), Xu_j)


def test_random_and_kmeans_inducing_points():
    X = torch.arange(300, dtype=torch.float32)[:, None] * 0.01
    Xu = initialize_inducing_points(X, 0.1, "random", torch.Generator().manual_seed(0))
    assert Xu.shape == (30, 1) and len(torch.unique(Xu)) == 30
    assert all(bool((X == v).any()) for v in Xu)
    Xu2 = initialize_inducing_points(X, 0.1, "random", 3)
    assert len(torch.unique(Xu2)) == 30
    with pytest.raises(ValueError):
        initialize_inducing_points(X, 0.1, "random")
    with pytest.raises(ValueError):
        initialize_inducing_points(X, 1.5)
    # kmeans runs scikit-learn on both sides with the same seed
    rng = np.random.default_rng(0)
    Xn = rng.normal(size=(120, 2)).astype(np.float32)
    c_t = initialize_inducing_points(torch.tensor(Xn), 0.05, "kmeans")
    c_j = gpax_tpu.utils.initialize_inducing_points(jnp.asarray(Xn), 0.05, "kmeans")
    assert_close(c_t, c_j, rtol=1e-5, atol=1e-6)
