"""K2 (blocked triangular inverse) and the factor/density path of
gpax_torch.ops.linalg, against the JAX package on the same inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_parity import assert_close, spd, value_and_grads
from gpax_torch.ops import chol as tchol
from gpax_torch.ops import linalg as tlinalg
from gpax_torch.utils import host_syncs
from gpax_tpu import get_config, set_config
from gpax_tpu.ops import linalg as jlinalg
from gpax_tpu.ops.chol import blocked_trtri as j_blocked_trtri

torch.set_num_threads(1)


@pytest.fixture
def jax_fp32_wtw():
    """The JAX backward at the port's only WᵀW precision (fp32)."""
    old = get_config().wtw_precision
    set_config(wtw_precision="highest")
    yield
    set_config(wtw_precision=old)


@pytest.mark.parametrize("n", [128, 200, 384])
def test_blocked_trtri_twin_matches_jax(n):
    L = np.linalg.cholesky(spd(n, seed=n)).astype(np.float32)
    W_j = np.asarray(j_blocked_trtri(jnp.asarray(L), True))
    W_t = tchol.blocked_trtri(torch.tensor(L))
    # κ(L) ≤ 3 here: two fp32 forward substitutions agree to ~1e-6 of max|W|
    assert_close(W_t, W_j, rtol=1e-4, atol=1e-5 * np.abs(W_j).max())
    assert np.abs(W_t.numpy() @ L - np.eye(n)).max() < 5e-4


def test_blocked_trtri_twin_batched_matches_jax():
    Ls = np.stack([np.linalg.cholesky(spd(160, seed=s)) for s in range(2)]).astype(np.float32)
    W_j = np.asarray(j_blocked_trtri(jnp.asarray(Ls), True))
    W_t = tchol.blocked_trtri(torch.tensor(Ls))
    assert W_t.shape == (2, 160, 160)
    assert_close(W_t, W_j, rtol=1e-4, atol=1e-5 * np.abs(W_j).max())


@pytest.mark.parametrize("n", [200, 384])
def test_blocked_trtri_twin_in_float64_inverts(n):
    """The factor path's dtype: the float64 recursion on the twin's tiles
    inverts L to float64 rounding (κ(L) ≤ 3: ~n·2⁻⁵³)."""
    L = torch.tensor(np.linalg.cholesky(spd(n, seed=n).astype(np.float64)))
    W = tchol.blocked_trtri(L)
    assert W.dtype == torch.float64
    assert (W @ L - torch.eye(n, dtype=torch.float64)).abs().max().item() < 1e-12
    ref = torch.linalg.solve_triangular(L, torch.eye(n, dtype=torch.float64), upper=False)
    assert_close(W, ref, rtol=0, atol=1e-12 * ref.abs().max().item())


def _tri_factor(B, n, dtype, seed):
    """Lower-triangular (B, n, n): diagonal in [1, 2), strictly lower entries
    uniform of variance 1/(4n), so κ(L) is a few; built without an n³ product."""
    g = torch.Generator().manual_seed(seed)
    a = (0.75 / n) ** 0.5
    L = torch.empty((B, n, n), dtype=torch.float64).uniform_(-a, a, generator=g).tril_(-1)
    L.diagonal(dim1=-2, dim2=-1).copy_(1.0 + torch.rand((B, n), generator=g, dtype=torch.float64))
    return L.to(dtype)


def _within(W, ref, dtype):
    """float64: max|ΔW| ≤ 1e-12·max|W|; float32: the JAX-parity tolerance of
    ``test_blocked_trtri_twin_matches_jax`` (rtol 1e-4, atol 1e-5·max|W|)."""
    scale = max(r.abs().max().item() for r in ref)
    for w, r in zip(W, ref):  # a matrix at a time: the batch of 5 at n = 4096 is 0.7 GB
        d = (w - r).abs()
        if dtype == torch.float64 and d.max().item() > 1e-12 * scale:
            return False
        if dtype == torch.float32 and not (d <= 1e-5 * scale + 1e-4 * r.abs()).all():
            return False
    return True


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 2, 5])
@pytest.mark.parametrize("n", [128, 256, 384, 512, 2560, 4096, 200, 385])
def test_trtri_levels_match_the_per_node_recursion_and_a_solve(n, B, dtype):
    """blocked_trtri's level schedule against the TPU's per-node recursion
    on the same tiles, and against ``solve_triangular``: powers of two of
    tiles (the same partition), 3 and 20 tiles (uneven last pairs), two
    padded n; batches on both sides of the node count (n = 4096, B = 5
    batches nodes at 128 and 256, matrices above)."""
    L = _tri_factor(B, n, dtype, seed=n + B)
    W = tchol.blocked_trtri(L)
    assert W.shape == (B, n, n) and W.dtype == dtype
    n_pad = -(-n // tchol.TILE) * tchol.TILE
    Lp = tchol._pad_spd(L, n_pad)
    W_node = tchol.tile_tri_inv(Lp)
    tchol._trtri_rec(Lp, W_node, 0, n_pad)
    assert _within(W, W_node[:, :n, :n], dtype)
    del W_node, Lp
    eye = torch.eye(n, dtype=dtype)
    assert _within(W, [torch.linalg.solve_triangular(m, eye, upper=False) for m in L], dtype)


class _Ops(TorchDispatchMode):
    """The aten ops dispatched inside the block, by name."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func.__name__)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("B,levels,gemms", [(1, 5, 10), (4, 3, 30), (100, 0, 62)])
def test_trtri_levels_batch_the_larger_of_nodes_and_matrices(B, levels, gemms):
    """At n = 4096 (32 tiles, levels of 16, 8, 4, 2 and 1 nodes), on meta
    tensors: the fit's one matrix runs every level as one strided batch of
    nodes, two products a level; EI's 100 draws run no level so, and launch
    the per-node recursion's 2 × 31 products; 4 lockstep chains batch nodes
    where a level has at least 4. No copy, no negation pass."""
    L = torch.empty((B, 4096, 4096), dtype=torch.float64, device="meta")
    W = torch.empty_like(L)
    g0, l0 = tchol.trtri_gemms, tchol.trtri_batched_levels
    with _Ops() as log:
        tchol._trtri_levels(L, W)
    assert (tchol.trtri_gemms - g0, tchol.trtri_batched_levels - l0) == (gemms, levels)
    assert log.ops.count("bmm.default") + log.ops.count("baddbmm_.default") == gemms
    assert set(log.ops) <= {"as_strided.default", "slice.Tensor", "bmm.default",
                            "baddbmm_.default"}
    with _Ops() as rec:
        tchol._trtri_rec(L, W, 0, 4096)
    assert rec.ops.count("bmm.default") == 62
    if B == 1:  # four views and two products a level
        assert len(log.ops) == 30


def test_tile_twin_is_per_tile_solve_and_zero_off_tiles():
    L = torch.tensor(np.linalg.cholesky(spd(256, seed=4)).astype(np.float32))[None]
    before = tchol.launches
    W = tchol.tile_tri_inv(L)
    assert tchol.launches == before  # CPU tensor: the twin, no launch
    for t in range(2):
        sl = slice(128 * t, 128 * (t + 1))
        ref = torch.linalg.solve_triangular(L[0, sl, sl], torch.eye(128), upper=False)
        assert_close(W[0, sl, sl], ref, 0, 0)
    assert torch.count_nonzero(W[0, :128, 128:]) == 0
    assert torch.count_nonzero(W[0, 128:, :128]) == 0


def test_tile_twin_propagates_a_zero_pivot():
    L = torch.eye(128)[None].clone()
    L[0, 5, 5] = 0.0
    W = tchol.tile_tri_inv(L)
    assert not torch.isfinite(W).all()


def _gp_gram(n, seed):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-1, 1, n))
    K = 1.3 * np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2 / 0.4**2) + 0.05 * np.eye(n)
    return K.astype(np.float32), rng.normal(size=n).astype(np.float32)


@pytest.mark.parametrize("n", [24, 150])
def test_mvn_log_prob_value_and_grads(n, jax_fp32_wtw):
    K, diff = _gp_gram(n, seed=n)
    (jv, tv), grads = value_and_grads(jlinalg.mvn_log_prob_centered,
                                      tlinalg.mvn_log_prob_centered, [K, diff], (0, 1))
    # cond(K) ~ 1e3: fp32 solves in two summation orders agree to ~1e-5
    assert_close(tv, jv, rtol=1e-5)
    for jg, tg in grads:
        assert_close(tg, jg, rtol=1e-3, atol=1e-3 * np.abs(jg).max())


@pytest.mark.parametrize("n", [150, 300])
def test_mvn_log_prob_is_float64_accurate_on_an_ill_conditioned_gram(n):
    """The factor path works in float64 (Cholesky and K2's blocked inverse),
    so value and ∂/∂K match a float64 Cholesky reference of the same
    jittered K at float64-class tolerances, at cond(K) ~ 1e5 where a float32
    path is off by ~κ·2⁻²⁴ ≈ 1e-2 relative in K⁻¹."""
    rng = np.random.default_rng(n)
    x = np.sort(rng.uniform(-2, 2, n))
    K = (3.0 * np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2) + 1e-3 * np.eye(n)).astype(np.float32)
    diff = rng.normal(size=n).astype(np.float32)
    L, W, _ = tlinalg._chol_tri_factors_ld(torch.tensor(K))
    assert L.dtype == W.dtype == torch.float64
    eye = torch.eye(n, dtype=torch.float64)
    # a float64 inverse: κ(L)·n·2⁻⁵³ ~ 1e-11 at κ(L) ≈ 600, where a float32
    # one is off by ~4e-5
    assert (W @ L - eye).abs().max().item() < 1e-8
    K64 = torch.tensor(K, dtype=torch.float64) + 4.0 * n * 2.0**-23 * eye
    L64 = torch.linalg.cholesky(K64)
    d64 = torch.tensor(diff, dtype=torch.float64)
    alpha = torch.linalg.solve_triangular(L64, d64[:, None], upper=False)[:, 0]
    ref = -0.5 * (alpha @ alpha + n * np.log(2 * np.pi)) - torch.log(L64.diagonal()).sum()
    Kinv = torch.cholesky_inverse(L64)
    beta = Kinv @ d64
    ref_dK = 0.5 * (beta[:, None] * beta[None, :] - Kinv)
    Kt = torch.tensor(K, requires_grad=True)
    tv = tlinalg.mvn_log_prob_centered(Kt, torch.tensor(diff))
    tv.backward()
    assert tv.dtype == Kt.grad.dtype == torch.float32
    # float32 rounding of the float64 results, 2⁻²⁴ ≈ 6e-8 relative
    assert_close(tv, ref, rtol=1e-6)
    assert_close(Kt.grad, ref_dK, rtol=1e-4, atol=1e-6 * ref_dK.abs().max().item())


def test_mvn_log_prob_escalates_on_indefinite_input(jax_fp32_wtw):
    """A slightly indefinite K fails the first factorization: both packages
    escalate the jitter to max(0.05, 1000·n·eps)·mean(diag K) and agree."""
    K, diff = _gp_gram(32, seed=2)
    K = K - 0.06 * np.eye(32, dtype=np.float32)  # min eigenvalue ≈ −0.01
    assert torch.linalg.cholesky_ex(torch.tensor(K))[1].item() != 0
    syncs = host_syncs()
    jv = jlinalg.mvn_log_prob_centered(jnp.asarray(K), jnp.asarray(diff))
    Kt = torch.tensor(K, requires_grad=True)
    tv = tlinalg.mvn_log_prob_centered(Kt, torch.tensor(diff))
    assert host_syncs() == syncs + 1  # one info read per factorization
    assert np.isfinite(tv.item())
    assert_close(tv, jv, rtol=1e-4)
    tv.backward()
    assert torch.isfinite(Kt.grad).all()


def test_mvn_log_prob_is_nan_when_escalation_fails_too():
    """The trap: cholesky_ex's partial factor is finite, so failure must come
    from ``info``. A K the escalated jitter cannot repair gives NaN, as in
    JAX, and a zero (not NaN) gradient."""
    K, diff = _gp_gram(32, seed=2)
    K[-1, -1] = -1.0  # fails at the last pivot
    L, info = torch.linalg.cholesky_ex(torch.tensor(K))
    assert info.item() == 32 and torch.isfinite(L[:31, :31]).all()
    jv = jlinalg.mvn_log_prob_centered(jnp.asarray(K), jnp.asarray(diff))
    Kt = torch.tensor(K, requires_grad=True)
    tv = tlinalg.mvn_log_prob_centered(Kt, torch.tensor(diff))
    assert np.isnan(float(jv)) and np.isnan(tv.item())
    tv.backward()
    assert torch.count_nonzero(Kt.grad) == 0


def test_mvn_log_prob_batched_matches_per_matrix():
    Ks, ds = zip(*(_gp_gram(20, seed=s) for s in range(3)))
    Kt, dt = torch.tensor(np.stack(Ks)), torch.tensor(np.stack(ds))
    out = tlinalg.mvn_log_prob_centered(Kt, dt)
    for i in range(3):
        assert_close(out[i], tlinalg.mvn_log_prob_centered(Kt[i], dt[i]), 1e-6)


def test_chol_tri_factors_matches_jax():
    K, _ = _gp_gram(200, seed=8)
    L_j, W_j = jlinalg.chol_tri_factors(jnp.asarray(K))
    L_t, W_t = tlinalg.chol_tri_factors(torch.tensor(K))
    assert_close(L_t, L_j, rtol=1e-4, atol=1e-5)
    assert_close(W_t, W_j, rtol=1e-3, atol=1e-4 * np.abs(np.asarray(W_j)).max())


def test_safe_cholesky_matches_jax_and_escalates():
    K, _ = _gp_gram(40, seed=3)
    assert_close(tlinalg.safe_cholesky(torch.tensor(K)), jlinalg.safe_cholesky(K),
                 rtol=1e-4, atol=1e-5)
    bad = K - 0.06 * np.eye(40, dtype=np.float32)  # escalation repairs it
    L_t = tlinalg.safe_cholesky(torch.tensor(bad))
    assert torch.isfinite(L_t).all()
    assert_close(L_t, jlinalg.safe_cholesky(bad), rtol=1e-4, atol=1e-5)
    worse = K.copy()
    worse[0, 0] = -5.0  # escalation cannot: a NaN factor in both
    assert torch.isnan(tlinalg.safe_cholesky(torch.tensor(worse)).diagonal()).all()
    assert np.isnan(np.diag(np.asarray(jlinalg.safe_cholesky(worse)))).all()


def test_safe_cholesky_gradient_matches_jax():
    K, _ = _gp_gram(16, seed=6)

    def jf(k):
        return jnp.sum(jnp.sin(jlinalg.safe_cholesky(k)))

    def tf(k):
        return torch.sin(tlinalg.safe_cholesky(k)).sum()

    (jv, tv), [(jg, tg)] = value_and_grads(jf, tf, [K], (0,))
    assert_close(tv, jv, rtol=1e-5)
    assert_close(tg, jg, rtol=1e-3, atol=1e-3 * np.abs(jg).max())


def test_predictive_moments_and_mean_var_match_jax():
    rng = np.random.default_rng(9)
    K, y = _gp_gram(60, seed=9)
    k_pX = rng.uniform(0, 1, (7, 60)).astype(np.float32) * 0.1
    k_pp = spd(7, seed=1)
    m_j, c_j = jlinalg.gp_predictive_moments(K, k_pX, k_pp, y)
    m_t, c_t = tlinalg.gp_predictive_moments(*(torch.tensor(a) for a in (K, k_pX, k_pp, y)))
    assert_close(m_t, m_j, rtol=1e-3, atol=1e-4)
    assert_close(c_t, c_j, rtol=1e-3, atol=1e-4)
    d = np.diag(k_pp).copy()
    m_j, v_j = jlinalg.gp_predictive_mean_var(K, k_pX, d, y)
    m_t, v_t = tlinalg.gp_predictive_mean_var(*(torch.tensor(a) for a in (K, k_pX, d, y)))
    assert_close(m_t, m_j, rtol=1e-3, atol=1e-4)
    assert_close(v_t, v_j, rtol=1e-3, atol=1e-4)


def test_robust_mvn_sample_moments_and_fallback():
    g = torch.Generator().manual_seed(0)
    cov = torch.tensor(spd(3, seed=2))
    mean = torch.tensor([1.0, -2.0, 0.5])
    draws = tlinalg.robust_mvn_sample(g, mean, cov, 20000)
    assert draws.shape == (20000, 3)
    # Monte-Carlo error of 20000 draws: a few 1e-2
    assert_close(draws.mean(0), mean, rtol=0, atol=0.05)
    assert_close(torch.cov(draws.T), cov, rtol=0, atol=0.08)
    nan_cov = torch.full((2, 2), float("nan"))
    out = tlinalg.robust_mvn_sample(g, torch.zeros(2), nan_cov, 3)
    assert out.shape == (3, 2)
    batched = tlinalg.robust_mvn_sample(g, mean.expand(4, 3), cov.expand(4, 3, 3), 2)
    assert batched.shape == (2, 4, 3) and torch.isfinite(batched).all()


def test_mvn_sample_from_cov_shape():
    g = torch.Generator().manual_seed(1)
    out = tlinalg.mvn_sample_from_cov(g, torch.zeros(4), torch.tensor(spd(4)), 5)
    assert out.shape == (5, 4) and torch.isfinite(out).all()


def test_jax_reference_default_is_untouched():
    # the fixture above restores the JAX package's own default
    assert get_config().wtw_precision == "compensated"
    assert jax.default_backend() == "cpu"
