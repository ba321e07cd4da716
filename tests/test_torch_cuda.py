"""CUDA kernels K1-K5 against their plain twins, on the card.

These tests need an NVIDIA GPU with nvcc (marker ``cuda``) and skip
elsewhere. The file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import gpax_torch
from gpax_torch.ops import chol, fused_density, gram, linalg, panel_chol
from gpax_torch.utils import initialize_inducing_points

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("kind", ["rbf", "matern52"])
@pytest.mark.parametrize("n,m,d,B", [(1000, 1000, 1, 1), (517, 333, 8, 3), (64, 64, 70, 2),
                                     (300, 301, 1, 1), (300, 302, 2, 2), (299, 299, 3, 1),
                                     (40, 77, 1, 3), (17, 17, 2, 2), (1, 130, 1, 1)])
def test_k1_matches_twin(dev, kind, n, m, d, B):
    """Among the cases: rows that are not 16-byte aligned (m % 4 in {1, 2,
    3}), which K1 stores element by element, fewer rows than its 64-row
    tile, a ragged last column group, and d > 32 (several feature chunks)."""
    g = torch.Generator(device=dev).manual_seed(0)
    Xs = torch.randn((B, n, d), generator=g, device=dev) / d**0.5
    same = n == m
    Zs = Xs if same else torch.randn((B, m, d), generator=g, device=dev) / d**0.5
    nz = torch.rand((B, n), generator=g, device=dev)
    before = gram.launches
    out = gram.gram_unscaled(Xs, Zs, nz, kind, same)
    assert gram.launches == before + 1
    ref = gram.gram_twin(Xs, Zs, nz, kind, same)
    # fp32 r² from norms of a few units: 1e-5 of max|K|
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def test_k1_config2_matern_gram_matches_twin(dev):
    """viGP's config-2 gram: 2455 pixel coordinates (m % 4 = 3) in 2-D,
    Matérn, with noise on the diagonal."""
    rng = np.random.default_rng(0)
    coords = np.argwhere(rng.uniform(size=(128, 128)) < 0.15)[:2455].astype(np.float32)
    Xs = torch.tensor(coords / 12.0, device=dev)[None].contiguous()
    nz = torch.full((1, Xs.shape[1]), 0.01, device=dev)
    out = gram.gram_unscaled(Xs, Xs, nz, "matern52", True)
    ref = gram.gram_twin(Xs, Xs, nz, "matern52", True)
    # norms up to ~2·(128/12)²: 1e-5 of max|K| scaled as chip_smoke.py's k1_compare
    norms = 2 * (Xs * Xs).sum(-1).max().item()
    assert (out - ref).abs().max().item() <= 1e-5 * max(1.0, norms / 60) * ref.abs().max().item()


def test_k1_a_batch_of_1x1_grams_over_two_launches(dev):
    """The sparse GP's k(x, x) diagonal, as a batch of 1×1 grams larger
    than one launch takes: two launches, within 1e-5 of max|K|."""
    B = gram._MAX_BATCH + 4465
    g = torch.Generator(device=dev).manual_seed(2)
    Xs = torch.rand((B, 1, 1), generator=g, device=dev)
    nz = torch.rand((B, 1), generator=g, device=dev)
    before = gram.launches
    out = gram.gram_unscaled(Xs, Xs, nz, "rbf", True)
    assert gram.launches == before + 2
    ref = gram.gram_twin(Xs, Xs, nz, "rbf", True)
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def test_k1_gradient_on_card_matches_cpu(dev):
    rng = np.random.default_rng(1)
    X = torch.tensor(rng.normal(size=(300, 2)), dtype=torch.float32)
    grads = []
    for device in ("cpu", dev):
        p = [torch.tensor(v, device=device, requires_grad=True)
             for v in ([0.8, 1.3], 1.5, 0.2)]
        Xd = X.to(device)
        torch.sin(gram.gram(Xd, Xd, *p)).sum().backward()
        grads.append([q.grad.cpu() for q in p])
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4)


def test_k1_rejects_what_it_does_not_take(dev):
    """K1 takes float32 and float64 (since its float64 instantiation):
    another dtype, or mixed dtypes, raise."""
    X = torch.zeros((1, 8, 1), dtype=torch.float16, device=dev)
    with pytest.raises(ValueError):
        gram.gram_unscaled(X, X, torch.zeros((1, 8), dtype=torch.float16, device=dev))
    X = torch.zeros((1, 8, 1), dtype=torch.float64, device=dev)
    with pytest.raises(ValueError):
        gram.gram_unscaled(X, X, torch.zeros((1, 8), dtype=torch.float32, device=dev))


@pytest.mark.parametrize("kind", ["rbf", "matern52"])
@pytest.mark.parametrize("n,m,d,B", [(1000, 1000, 1, 1), (517, 333, 8, 3), (64, 64, 70, 2),
                                     (300, 301, 1, 1), (300, 302, 2, 2), (299, 299, 3, 1),
                                     (17, 17, 2, 2), (1, 130, 1, 1)])
def test_k1_float64_matches_twin(dev, kind, n, m, d, B):
    """K1's float64 instantiation (``gpax_gram_f64``) against the float64
    twin, on the float32 cases' shapes: unaligned rows, a ragged last column
    group, d > 16 (several of its 16-feature chunks). Max abs error 1e-12:
    float64 r² from norms of a few units rounds at ~1e-15."""
    g = torch.Generator(device=dev).manual_seed(0)
    Xs = torch.randn((B, n, d), generator=g, device=dev, dtype=torch.float64) / d**0.5
    same = n == m
    Zs = Xs if same else torch.randn((B, m, d), generator=g, device=dev,
                                     dtype=torch.float64) / d**0.5
    nz = torch.rand((B, n), generator=g, device=dev, dtype=torch.float64)
    before, before64 = gram.launches, gram.launches_f64
    out = gram.gram_unscaled(Xs, Zs, nz, kind, same)
    assert (gram.launches, gram.launches_f64) == (before + 1, before64 + 1)
    assert out.dtype == torch.float64
    ref = gram.gram_twin(Xs, Zs, nz, kind, same)
    assert (out - ref).abs().max().item() <= 1e-12


def test_exactgp_x64_fit_launches_float64_k1(dev):
    """Under enable_x64 an ExactGP fit on the card takes the composed route
    with float64 K1 launches only, and returns float64 draws."""
    rng = np.random.default_rng(0)
    X = rng.uniform(-1, 1, 64)
    y = np.sin(3 * X)
    gpax_torch.enable_x64()
    try:
        gp = gpax_torch.ExactGP(1, "RBF")
        before, before64 = gram.launches, gram.launches_f64
        gp.fit(0, X, y, num_warmup=20, num_samples=20, max_tree_depth=4,
               print_summary=False, progress_bar=False)
        torch.cuda.synchronize()
        fit = gram.launches - before
        assert fit > 0 and gram.launches_f64 - before64 == fit
        assert gp.get_samples()["noise"].dtype == torch.float64
        mean, _ = gp.predict(1, X, n=1)
        assert mean.dtype == torch.float64 and bool(torch.isfinite(mean).all())
    finally:
        gpax_torch.enable_x64(False)


@pytest.mark.parametrize("n,B", [(128, 1), (1000, 2), (2048, 1)])
def test_k2_matches_twin_and_inverts(dev, n, B):
    g = torch.Generator(device=dev).manual_seed(n)
    A = torch.randn((B, n, n), generator=g, device=dev)
    K = A @ A.mT / n + 0.5 * torch.eye(n, device=dev)
    L = torch.linalg.cholesky(K)
    before = chol.launches
    W = chol.blocked_trtri(L)
    assert chol.launches == before + 1  # one launch for every tile of the batch
    Lc = L.contiguous()
    n_pad = -(-n // 128) * 128
    if n_pad == n:
        diff = chol.tile_tri_inv(Lc) - chol.tile_tri_inv_twin(Lc)
        assert diff.abs().max().item() <= 1e-4 * W.abs().max().item()
    assert (W @ L - torch.eye(n, device=dev)).abs().max().item() < 1e-3


@pytest.mark.parametrize("n,B", [(128, 1), (1000, 2), (4096, 3)])
def test_k2_float64_matches_twin_and_inverts(dev, n, B):
    """The factor path's dtype: K2's float64 instantiation, W kept in global
    memory. Two float64 forward substitutions agree to ~κ·128·2⁻⁵³."""
    g = torch.Generator(device=dev).manual_seed(n)
    A = torch.randn((B, n, n), generator=g, device=dev, dtype=torch.float64)
    K = A @ A.mT / n
    K.diagonal(dim1=-2, dim2=-1).add_(0.5)
    L = torch.linalg.cholesky(K)
    before = chol.launches
    W = chol.blocked_trtri(L)
    assert chol.launches == before + 1 and W.dtype == torch.float64
    if n % 128 == 0:
        Lc = L.contiguous()
        diff = chol.tile_tri_inv(Lc) - chol.tile_tri_inv_twin(Lc)
        assert diff.abs().max().item() <= 1e-12 * W.abs().max().item()
    eye = torch.eye(n, device=dev, dtype=torch.float64)
    assert (W @ L - eye).abs().max().item() < 1e-10


def test_k2_propagates_a_zero_pivot(dev):
    L = torch.eye(256, device=dev)[None].clone()
    L[0, 130, 130] = 0.0
    W = chol.tile_tri_inv(L)
    assert not torch.isfinite(W[0, 128:, 128:]).all()
    assert torch.isfinite(W[0, :128, :128]).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("p", [15, 16, 63, 64, 127])
def test_k2_non_finite_rows_from_a_zero_pivot_at_a_sub_panel_border(dev, dtype, p):
    """A zero pivot at local row p of the second of three tiles, as the
    Pallas kernel's row recurrence gives it: every entry of that tile's rows
    from p on is non-finite, its rows above p and the other tiles finite,
    and W zero off the diagonal tiles."""
    L = torch.linalg.cholesky(_spd_batch(1, 384, dev, dtype, seed=p))
    L[0, 128 + p, 128 + p] = 0.0
    W = chol.tile_tri_inv(L.contiguous())[0]
    tiles = [W[128 * t:128 * (t + 1), 128 * t:128 * (t + 1)] for t in range(3)]
    assert torch.isfinite(tiles[0]).all() and torch.isfinite(tiles[2]).all()
    assert torch.isfinite(tiles[1][:p]).all() and not torch.isfinite(tiles[1][p:]).any()
    off = torch.ones_like(W, dtype=torch.bool)
    for t in range(3):
        off[128 * t:128 * (t + 1), 128 * t:128 * (t + 1)] = False
    assert torch.count_nonzero(W[off]) == 0


def test_mvn_log_prob_on_card_matches_cpu(dev):
    rng = np.random.default_rng(2)
    x = np.sort(rng.uniform(-1, 1, 300))
    K = torch.tensor(np.exp(-0.5 * (x[:, None] - x[None]) ** 2 / 0.3**2) + 0.05 * np.eye(300),
                     dtype=torch.float32)
    d = torch.tensor(rng.normal(size=300), dtype=torch.float32)
    vals = [linalg.mvn_log_prob_centered(K.to(device), d.to(device)).item()
            for device in ("cpu", dev)]
    assert abs(vals[1] - vals[0]) <= 1e-4 * abs(vals[0])


def test_exactgp_fit_and_predict_on_card(dev):
    rng = np.random.default_rng(0)
    X = torch.tensor(rng.uniform(-2, 2, (256, 1)), dtype=torch.float32, device=dev)
    y = torch.sin(2 * X[:, 0]) + 0.1 * torch.tensor(rng.normal(size=256), dtype=torch.float32,
                                                    device=dev)
    gp = gpax_torch.ExactGP(1, "RBF")
    gp.fit(0, X, y, num_warmup=50, num_samples=50, print_summary=False)
    Xn = torch.linspace(-2, 2, 100, device=dev)[:, None]
    mean, draws = gp.predict(1, Xn, noiseless=True)
    assert mean.shape == (100,) and draws.shape == (50, 1, 100)
    assert torch.isfinite(draws).all()
    assert ((mean - torch.sin(2 * Xn[:, 0])) ** 2).mean().sqrt().item() < 0.05


def _spd_batch(B, n, dev, dtype, seed=0):
    """Well-conditioned SPD matrices A·Aᵀ/n + ½I (κ ≤ ~9)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    A = torch.randn((B, n, n), generator=g, device=dev, dtype=dtype)
    K = A @ A.mT / n
    K.diagonal(dim1=-2, dim2=-1).add_(0.5)
    return K


# K3 vs library, relative to max|L| or max|W|: float32 factors of κ(K) ≤ 9
# agree to ~1e-6, float64 ones to ~1e-15
K3_TOL = {torch.float32: 1e-4, torch.float64: 1e-12}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 8])
def test_k3_tiles_match_twin(dev, dtype, B):
    A = _spd_batch(B, 128, dev, dtype, seed=B)
    before = chol.chol_inv_launches
    L, W = chol.tile_chol_inv(A)
    assert chol.chol_inv_launches == before + 1
    L_t, W_t = chol.tile_chol_inv_twin(A)
    assert (L - L_t).abs().max().item() <= K3_TOL[dtype] * L_t.abs().max().item()
    assert (W - W_t).abs().max().item() <= K3_TOL[dtype] * W_t.abs().max().item()
    assert torch.count_nonzero(torch.triu(L, 1)) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,B", [(128, 1), (1024, 1), (1024, 8), (1000, 2)])
def test_chol_inv_on_card_matches_library(dev, dtype, m, B):
    """One K3 launch per 128-leaf whatever the batch; L and W against
    cholesky_ex and solve_triangular(L, I) on the card."""
    K = _spd_batch(B, m, dev, dtype, seed=m)
    before = chol.chol_inv_launches
    L, W = chol.chol_inv(K)
    assert chol.chol_inv_launches == before + -(-m // 128)
    L_ref = torch.linalg.cholesky(K)
    eye = torch.eye(m, device=dev, dtype=dtype)
    W_ref = torch.linalg.solve_triangular(L_ref, eye.expand_as(K), upper=False)
    tol = K3_TOL[dtype] * (10 if dtype == torch.float32 else 1)  # the recursion's GEMMs
    assert (L - L_ref).abs().max().item() <= tol * L_ref.abs().max().item()
    assert (W - W_ref).abs().max().item() <= tol * W_ref.abs().max().item()
    assert (W @ L - eye).abs().max().item() <= (1e-3 if dtype == torch.float32 else 1e-10)


def test_k3_propagates_nan_on_indefinite_input(dev):
    A = _spd_batch(2, 128, dev, torch.float32)
    A[1, 60, 60] = -1.0
    L, W = chol.tile_chol_inv(A)
    assert torch.isfinite(L[0]).all() and torch.isfinite(W[0]).all()
    assert torch.isfinite(L[1, :60, :60]).all()
    assert torch.isnan(L[1, 60:, 60]).all() and not torch.isfinite(W[1, 60:]).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("p", [15, 16, 63, 64, 127])
def test_k3_nan_from_a_bad_pivot_at_a_sub_panel_border(dev, dtype, p):
    """A bad pivot at row p of the second tile of a batch, at each border
    of the blocked routine's 16-column sub-panels: L zero above the
    diagonal, its columns before p finite and every lower entry from p on
    NaN; every entry of W's rows from p on non-finite, above the diagonal
    too, and its rows above p finite; the first tile untouched."""
    A = _spd_batch(2, 128, dev, dtype, seed=p)
    A[1, p, p] = -1.0
    L, W = chol.tile_chol_inv(A)
    assert torch.isfinite(L[0]).all() and torch.isfinite(W[0]).all()
    assert torch.count_nonzero(torch.triu(L[1], 1)) == 0
    assert torch.isfinite(L[1, :, :p]).all()
    low = torch.ones_like(L[1, p:, p:], dtype=torch.bool).tril()
    assert torch.isnan(L[1, p:, p:][low]).all()
    assert torch.isfinite(W[1, :p]).all() and not torch.isfinite(W[1, p:]).any()


def test_chol_inv_backward_on_card_matches_cpu(dev):
    K = _spd_batch(1, 300, "cpu", torch.float32)[0]
    rng = np.random.default_rng(0)
    y = torch.tensor(rng.normal(size=300), dtype=torch.float32)
    grads = []
    for device in ("cpu", dev):
        Kd = K.detach().clone().to(device).requires_grad_(True)
        L, W = chol.chol_inv(Kd)
        (((W @ y.to(device)) ** 2).sum() + torch.log(L.diagonal()).sum()).backward()
        grads.append(Kd.grad.cpu())
    # float32 twin vs K3 with the same matmuls: 1e-3 of max|∂K|
    assert (grads[1] - grads[0]).abs().max() <= 1e-3 * grads[0].abs().max()


def test_visparsegp_fits_numpy_input_on_the_card_by_default(dev):
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 4, 400).astype(np.float32)
    y = (np.sin(3 * X) * np.exp(-0.3 * X) + 0.05 * rng.normal(size=400)).astype(np.float32)
    m = gpax_torch.viSparseGP(1, "RBF")
    k3, k1 = chol.chol_inv_launches, gram.launches
    m.fit(0, X, y, inducing_points_ratio=0.05, inducing_points_selection="uniform",
          num_steps=300, step_size=0.05, print_summary=False)
    assert m.X_train.device.type == "cuda" and m.Xu.device.type == "cuda"
    assert chol.chol_inv_launches > k3 and gram.launches > k1
    grid = np.linspace(0, 4, 201, dtype=np.float32)
    mean, var = m.predict_in_batches(1, grid, batch_size=64)
    truth = np.sin(3 * grid) * np.exp(-0.3 * grid)
    assert torch.isfinite(mean).all() and torch.isfinite(var).all()
    assert np.sqrt(np.mean((mean.numpy() - truth) ** 2)) < 0.03


def _rbf_gram(x, ls, ks, jitter):
    K = ks * torch.exp(-0.5 * ((x[:, None] - x[None, :]) / ls) ** 2)
    K.diagonal().add_(jitter)
    return K


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("spacing,ls,ks,m", [(0.004, 1.15, 2.0, 1000), (0.04, 0.8, 0.9, 100)])
def test_k3_on_an_ill_conditioned_rbf_tile_matches_float64(dev, dtype, spacing, ls, ks, m):
    """The sparse GP's first leaf: an RBF gram of 128 inducing points 4/m
    apart with the float32 jitter 4·m·eps, κ(K) 5e5-9e5. K3 in either dtype
    is within 2·128·eps·κ(L) (twice the first-order bound of a
    factorization and a triangular inversion) of the float64 factor and
    inverse, relative to their max."""
    x = spacing * torch.arange(128, dtype=torch.float64, device=dev)
    K64 = _rbf_gram(x, ls, ks, 4 * m * torch.finfo(torch.float32).eps)
    L64 = torch.linalg.cholesky(K64)
    W64 = torch.linalg.solve_triangular(L64, torch.eye(128, dtype=torch.float64, device=dev),
                                        upper=False)
    kappa = (torch.linalg.matrix_norm(L64, 2) * torch.linalg.matrix_norm(W64, 2)).item()
    tol = 2 * 128 * torch.finfo(dtype).eps * kappa
    L, W = chol.tile_chol_inv(K64.to(dtype)[None].contiguous())
    assert (L[0].double() - L64).abs().max().item() <= tol * L64.abs().max().item()
    assert (W[0].double() - W64).abs().max().item() <= tol * W64.abs().max().item()


def test_sparse_factor_holds_a_near_singular_m1000_gram(dev):
    """An RBF gram of bench.py's m = 1000 inducing points (ℓ = 1.5,
    k_scale 2, κ ~ 1e6-1e7 with the float32 jitter 4·m·eps), as near
    singular as the m = 1000 fit's Kuu: the sparse GP's float64 factor
    equals a float64 Cholesky of the same jittered K and its inverse to
    float32 rounding, 1e-6 of max."""
    rng = np.random.default_rng(0)
    X = torch.tensor(rng.uniform(0, 4, 20000), dtype=torch.float32, device=dev)[:, None]
    Xu = torch.sort(initialize_inducing_points(X, 0.05, "uniform"), 0).values
    K = gpax_torch.kernels.RBFKernel(Xu, Xu, {"k_length": torch.tensor([1.5], device=dev),
                                             "k_scale": torch.tensor(2.0, device=dev)})
    L, W = linalg.safe_chol_inv_f64(K)
    eye = torch.eye(1000, dtype=torch.float64, device=dev)
    L64 = torch.linalg.cholesky(K.double() + 4 * 1000 * torch.finfo(torch.float32).eps * eye)
    W64 = torch.linalg.solve_triangular(L64, eye, upper=False)
    assert (L.double() - L64).abs().max().item() <= 1e-6 * L64.abs().max().item()
    assert (W.double() - W64).abs().max().item() <= 1e-6 * W64.abs().max().item()


# K4/K5 vs their twins, relative to max|L| and max|Wᵀ|, and the residuals
# ‖W·L − I‖, ‖L·Lᵀ − K‖/‖K‖ (max norms), on A·Aᵀ/n + ½I (κ ≤ ~9): sums of
# up to n terms round to ~n·eps·κ, 2e-3 in float32 and 2e-12 in float64 at
# n = 2048, and typically far less
PANEL_TOL = {torch.float32: 1e-3, torch.float64: 1e-11}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,B", [(128, 1), (256, 1), (384, 3), (1000, 2), (2048, 1), (1024, 4)])
def test_k4_k5_match_twins_and_factor(dev, dtype, n, B):
    K = _spd_batch(B, n, dev, dtype, seed=n + B)
    c4, c5 = panel_chol.cholesky_launches, panel_chol.tri_inv_launches
    L, W = panel_chol.panel_chol_factors(K)
    # one launch each, whatever the batch
    assert (panel_chol.cholesky_launches, panel_chol.tri_inv_launches) == (c4 + 1, c5 + 1)
    L_t = panel_chol.panel_cholesky_twin(K)
    WT_t = panel_chol.panel_tri_inv_t_twin(L_t)
    tol = PANEL_TOL[dtype]
    assert (L - L_t).abs().max().item() <= tol * L_t.abs().max().item()
    assert (W.mT - WT_t).abs().max().item() <= tol * WT_t.abs().max().item()
    assert torch.count_nonzero(torch.triu(L, 1)) == 0
    assert torch.count_nonzero(torch.triu(W, 1)) == 0
    eye = torch.eye(n, device=dev, dtype=dtype)
    assert (W @ L - eye).abs().max().item() <= tol
    assert (L @ L.mT - K).abs().max().item() <= tol * K.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k4_k5_propagate_nan_on_indefinite_input(dev, dtype):
    K = _spd_batch(2, 300, dev, dtype)
    K[1, 200, 200] = -1.0
    L, W = panel_chol.panel_chol_factors(K)
    assert torch.isfinite(L[0]).all() and torch.isfinite(W[0]).all()
    assert torch.isfinite(L[1, :128, :128]).all()  # the panels before the bad pivot
    assert not torch.isfinite(L[1, 200:, 200]).any() and not torch.isfinite(W[1, 200:, :200]).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("q", [0, 15, 16, 31, 32, 127])
def test_k4_nan_from_a_bad_pivot_at_a_sub_panel_border(dev, dtype, q):
    """A bad pivot at local index q of the second tile: the columns before
    it stay finite, every lower entry of the columns from it on is NaN."""
    K = _spd_batch(1, 384, dev, dtype, seed=q)
    p = panel_chol.TILE + q
    K[0, p, p] = -1.0
    L = panel_chol.panel_cholesky(K)[0]
    assert torch.isfinite(L[:, :p]).all()
    low = torch.ones_like(L[p:, p:], dtype=torch.bool).tril()
    assert torch.isnan(L[p:, p:][low]).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k4_phase_split(dev, dtype):
    """Three non-negative phase sums, counted as a launch, whose total lies
    within the CUDA-event time around the launch."""
    K = _spd_batch(1, 1024, dev, dtype, seed=5)
    panel_chol.cholesky_phase_ms(K)  # the build and the first launch
    c4 = panel_chol.cholesky_launches
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    split = panel_chol.cholesky_phase_ms(K)
    end.record()
    torch.cuda.synchronize()
    assert panel_chol.cholesky_launches == c4 + 1
    assert len(split) == 3 and all(t >= 0 for t in split)
    assert 0 < sum(split) <= start.elapsed_time(end)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k5_phase_split(dev, dtype):
    """Three non-negative phase sums, counted as a launch, whose total is
    within 10 % of the CUDA-event time of a launch on the same L."""
    L = torch.linalg.cholesky(_spd_batch(1, 4096, dev, dtype, seed=6)).contiguous()
    panel_chol.tri_inv_phase_ms(L)  # the build and the first launch
    c5 = panel_chol.tri_inv_launches
    split = panel_chol.tri_inv_phase_ms(L)
    assert panel_chol.tri_inv_launches == c5 + 1
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        panel_chol.panel_tri_inv_t_padded(L)
    end.record()
    torch.cuda.synchronize()
    t = start.elapsed_time(end) / 5
    assert len(split) == 3 and all(x >= 0 for x in split)
    assert abs(sum(split) - t) <= 0.1 * t


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("q", [0, 15, 16, 63, 64, 127])
def test_k5_non_finite_rows_from_a_zero_pivot(dev, dtype, q):
    """A zero pivot at local index q of the second of three diagonal tiles
    of L (q = 0 a 128-panel border, 15/16 and 63/64 16-column sub-panel
    borders, 127 the tile's last row): the rows of W = L⁻¹ from the pivot
    on are non-finite in every column up to the end of the pivot's panel
    and the rows above it finite, as the Pallas kernel's row recurrence
    gives them; the twin's rows with a non-finite entry are the same rows."""
    L = torch.linalg.cholesky(_spd_batch(1, 384, dev, dtype, seed=q))
    p = 128 + q
    L[0, p, p] = 0.0
    W = panel_chol.panel_tri_inv_t(L)[0].mT
    W_t = panel_chol.panel_tri_inv_t_twin(L)[0].mT
    assert torch.isfinite(W[:p]).all() and not torch.isfinite(W[p:, :256]).any()
    assert torch.equal(torch.isfinite(W).all(1), torch.isfinite(W_t).all(1))


def test_k5_float32_at_8192_matches_twin(dev):
    """K5 at the size of its float32 timing: Wᵀ against the twin relative to
    max|Wᵀ|, and ‖W·L − I‖_max, within chip_smoke.py's tolerance
    max(1e-4, 2·n·eps·κ), κ = ‖|L|·|W|‖_max."""
    n = 8192
    L = torch.linalg.cholesky(_spd_batch(1, n, dev, torch.float32, seed=n))
    WT = panel_chol.panel_tri_inv_t(L)
    WT_t = panel_chol.panel_tri_inv_t_twin(L)
    W = WT.mT
    kappa = (L[0].abs() @ W[0].abs()).amax().item()
    tol = max(1e-4, 2 * n * torch.finfo(torch.float32).eps * kappa)
    assert (WT - WT_t).abs().max().item() <= tol * WT_t.abs().max().item()
    assert (W[0] @ L[0] - torch.eye(n, device=dev)).abs().max().item() <= tol


def test_k4_k5_reject_what_they_do_not_take(dev):
    with pytest.raises(ValueError):
        panel_chol.panel_cholesky_padded(torch.eye(100, device=dev)[None])
    with pytest.raises(ValueError):
        panel_chol.panel_tri_inv_t_padded(torch.eye(128, device=dev, dtype=torch.float16)[None])


@pytest.mark.parametrize("kind", ["rbf", "matern52"])
def test_fused_density_on_card_matches_cpu(dev, kind):
    """The fused likelihood op launches K1 once and K2 once on the card and
    agrees with the CPU twins: value to 1e-4, θ-gradients to 5e-3 of their
    max (float32 grams 1e-6 apart, amplified by κ(K) ~ 1e4)."""
    rng = np.random.default_rng(3)
    X = torch.tensor(rng.uniform(-2, 2, (400, 2)), dtype=torch.float32)
    y = torch.tensor(np.sin(2 * X[:, 0].numpy()) + 0.1 * rng.normal(size=400),
                     dtype=torch.float32)
    out = []
    for device in ("cpu", dev):
        p = [torch.tensor(v, device=device, requires_grad=True) for v in ([0.8, 1.3], 1.5, 0.2)]
        k1, k2 = gram.launches, chol.launches
        lp = fused_density.gp_mvn_log_prob(X.to(device), *p, y.to(device), kind)
        grads = torch.autograd.grad(lp, p)
        if device != "cpu":
            assert (gram.launches, chol.launches) == (k1 + 1, k2 + 1)
        out.append((lp.item(), torch.cat([g.reshape(-1) for g in grads]).cpu()))
    (u0, g0), (u1, g1) = out
    assert abs(u1 - u0) <= 1e-4 * abs(u0)
    assert (g1 - g0).abs().max() <= 5e-3 * g0.abs().max()


def test_exactgp_fit_on_the_fused_route_on_card(dev):
    rng = np.random.default_rng(0)
    X = torch.tensor(rng.uniform(-2, 2, (256, 1)), dtype=torch.float32, device=dev)
    y = torch.sin(2 * X[:, 0]) + 0.1 * torch.tensor(rng.normal(size=256), dtype=torch.float32,
                                                    device=dev)
    gpax_torch.set_config(use_fused_likelihood="always")
    try:
        gp = gpax_torch.ExactGP(1, "RBF")
        k1, k2 = gram.launches, chol.launches
        gp.fit(0, X, y, num_warmup=50, num_samples=50, print_summary=False)
        assert gram.launches > k1 and chol.launches > k2
    finally:
        gpax_torch.set_config(use_fused_likelihood="auto")
    Xn = torch.linspace(-2, 2, 100, device=dev)[:, None]
    mean, _ = gp.predict(1, Xn, noiseless=True)
    assert ((mean - torch.sin(2 * Xn[:, 0])) ** 2).mean().sqrt().item() < 0.05


def test_batched_mvn_route_launches_k2_once_for_the_batch(dev):
    """A (B, n, n) covariance goes through ``mvn_log_prob_centered``: one K2
    launch for every diagonal tile of the batch, a log-density per matrix
    equal to the CPU's, and the closed-form backward."""
    Ks = torch.stack([_spd_batch(1, 200, dev, torch.float32, seed=s)[0] for s in range(3)])
    diff = torch.randn((3, 200), generator=torch.Generator(device=dev).manual_seed(1),
                       device=dev)
    out = []
    for device in ("cpu", dev):
        K = Ks.to(device).requires_grad_(True)
        k2 = chol.launches
        lp = gpax_torch.distributions.MultivariateNormal(
            torch.zeros(200, device=device), covariance_matrix=K).log_prob(diff.to(device))
        if device != "cpu":
            assert chol.launches == k2 + 1
        assert lp.shape == (3,)
        (g,) = torch.autograd.grad(lp.sum(), K)
        out.append((lp.detach().cpu(), g.cpu()))
    (l0, g0), (l1, g1) = out
    assert (l1 - l0).abs().max() <= 1e-4 * l0.abs().max()
    assert (g1 - g0).abs().max() <= 1e-4 * g0.abs().max()


def test_vidkl_ensemble_step_launches_k1_once_for_all_models(dev):
    """viDKL's batched ensemble: each SVI step makes ONE K1 launch for the
    B models' grams (and one K2 launch and one host sync for their factors),
    so two fits differing by 5 steps differ by 5 of each."""
    from gpax_torch.utils import host_syncs, reset_host_syncs

    rng = np.random.default_rng(0)
    X = rng.normal(size=(64, 20)).astype(np.float32)
    y = np.sin(X[:, 0]).astype(np.float32)
    seen = []
    for steps in (5, 10):
        model = gpax_torch.viDKL(20, z_dim=2)
        k1, k2 = gram.launches, chol.launches
        reset_host_syncs()
        model.fit_predict(0, X, y, X[:4], num_steps=steps, n_models=3, print_summary=False,
                          progress_bar=False)
        torch.cuda.synchronize()
        seen.append((gram.launches - k1, chol.launches - k2, host_syncs()))
        assert model.loss.shape == (3, steps) and bool(torch.isfinite(model.loss).all())
    assert [b - a for a, b in zip(*seen)] == [5, 5, 5]


@pytest.mark.parametrize("kind", ["rbf", "matern52"])
def test_batched_fused_density_on_card_matches_cpu(dev, kind):
    """The fused op over a leading batch of 4 chains' hyperparameters
    launches K1 once and K2 once for the batch on the card and agrees with
    its CPU twins chain by chain, within the tolerances of the unbatched
    case (value 1e-4, θ-gradients 5e-3 of their max)."""
    rng = np.random.default_rng(4)
    X = torch.tensor(rng.uniform(-2, 2, (400, 2)), dtype=torch.float32)
    y = torch.tensor(np.sin(2 * X[:, 0].numpy()) + 0.1 * rng.normal(size=400),
                     dtype=torch.float32)
    vals = (rng.uniform(0.6, 1.2, (4, 2)), rng.uniform(1.0, 2.0, 4), rng.uniform(0.1, 0.3, 4))
    out = []
    for device in ("cpu", dev):
        p = [torch.tensor(v, dtype=torch.float32, device=device, requires_grad=True)
             for v in vals]
        k1, k2 = gram.launches, chol.launches
        lp = fused_density.gp_mvn_log_prob(X.to(device), *p, y.to(device), kind)
        grads = torch.autograd.grad(lp.sum(), p)
        if device != "cpu":
            assert (gram.launches, chol.launches) == (k1 + 1, k2 + 1)
        assert lp.shape == (4,)
        out.append((lp.detach().cpu(), [g.cpu() for g in grads]))
    (u0, g0), (u1, g1) = out
    assert (u1 - u0).abs().max() <= 1e-4 * u0.abs().max()
    for a, b in zip(g1, g0):
        assert (a - b).abs().max() <= 5e-3 * b.abs().max()


def test_lockstep_chains_launch_k1_and_k2_once_a_lockstep_leapfrog(dev):
    """Two vectorized chains of ExactGP on the card: K1 and K2 launch once
    per batched potential, so their counts follow the lockstep leapfrogs
    (plus the few evaluations outside the tree), not the chains'."""
    rng = np.random.default_rng(0)
    X = torch.tensor(rng.uniform(-2, 2, (256, 1)), dtype=torch.float32, device=dev)
    y = torch.sin(2 * X[:, 0]) + 0.1 * torch.tensor(rng.normal(size=256), dtype=torch.float32,
                                                    device=dev)
    gp = gpax_torch.ExactGP(1, "RBF")
    k1, k2 = gram.launches, chol.launches
    gp.fit(0, X, y, num_warmup=30, num_samples=30, num_chains=2, chain_method="vectorized",
           print_summary=False)
    lock = gp.mcmc.num_lockstep_leapfrogs
    for launched in (gram.launches - k1, chol.launches - k2):
        assert lock <= launched <= lock + 30
    assert gp.mcmc.num_leapfrogs > lock
    assert gp.get_samples(chain_dim=True)["noise"].shape == (2, 30)


def test_structured_lockstep_fused_leapfrog_launches_k1_and_k2_once(dev):
    """A structured ExactGP (a mean function written for one draw, a
    Uniform latent through the sigmoid) with two vectorized chains on the
    fused route: the batched potential is trusted, and K1 and K2 launch
    once per lockstep leapfrog for both chains."""
    rng = np.random.default_rng(0)
    X = torch.tensor(np.sort(rng.uniform(0, 1.2, 256))[:, None], dtype=torch.float32,
                     device=dev)
    y = (1.2 * torch.sin(5 * X[:, 0]) * torch.exp(-0.8 * X[:, 0])
         + 0.05 * torch.tensor(rng.normal(size=256), dtype=torch.float32, device=dev))

    def osc(x, p):
        return (p["A"] * torch.sin(p["w"] * x) * torch.exp(-p["d"] * x)).squeeze()

    def osc_prior():
        return {"A": gpax_torch.ppl.sample("A", gpax_torch.distributions.LogNormal(0.0, 0.5)),
                "w": gpax_torch.ppl.sample("w", gpax_torch.distributions.Uniform(3.0, 7.0)),
                "d": gpax_torch.ppl.sample("d", gpax_torch.distributions.LogNormal(0.0, 0.5))}

    gp = gpax_torch.ExactGP(1, "Matern", mean_fn=osc, mean_fn_prior=osc_prior)
    assert gp._fused_likelihood_ok(X, {"k_length": None, "k_scale": None})
    k1, k2 = gram.launches, chol.launches
    gp.fit(0, X, y, num_warmup=30, num_samples=30, num_chains=2, chain_method="vectorized",
           print_summary=False, progress_bar=False)
    assert not gp.mcmc.chain_by_chain
    lock = gp.mcmc.num_lockstep_leapfrogs
    for launched in (gram.launches - k1, chol.launches - k2):
        assert lock <= launched <= lock + 30
    w = gp.get_samples()["w"]
    assert w.device.type == "cuda" and bool(((w > 3.0) & (w < 7.0)).all())


def test_gamma_and_uniform_sample_on_the_card(dev):
    """Gamma and Uniform draw on the card with a CUDA generator, their
    parameters where they were made (0-d CPU tensors, or bounds taken from
    data on the card), and score there."""
    g = torch.Generator(device=dev).manual_seed(0)
    X = torch.linspace(1.0, 5.0, 9, device=dev)
    for d in (gpax_torch.distributions.Gamma(2.0, 3.0), gpax_torch.priors.gamma_dist(r=2.0,
                                                                                      input_vec=X),
              gpax_torch.distributions.Uniform(3.0, 7.0), gpax_torch.priors.uniform_dist(
                  input_vec=X)):
        draws = d.sample(g, (20000,))
        assert draws.device.type == "cuda" and draws.shape == (20000,)
        assert bool(torch.isfinite(d.log_prob(draws)).all())
        assert abs(draws.mean().item() - d.mean.item()) < 0.05 * abs(d.mean.item())


def test_load_model_default_device_is_the_card(dev, tmp_path):
    """load_model with device=None puts the draws and the data on the card,
    and predicts there."""
    rng = np.random.default_rng(0)
    X = rng.uniform(-1, 1, 32).astype(np.float32)
    y = np.sin(3 * X).astype(np.float32)
    gp = gpax_torch.ExactGP(1, "RBF")
    gp.fit(0, X, y, num_warmup=20, num_samples=20, print_summary=False, progress_bar=False,
           device="cpu")
    path = str(tmp_path / "gp")
    gpax_torch.utils.save_model(path, gp)
    gp2 = gpax_torch.utils.load_model(path, gpax_torch.ExactGP(1, "RBF"))
    assert gp2.X_train.device.type == "cuda"
    assert gp2.get_samples()["noise"].device.type == "cuda"
    mean, _ = gp2.predict(1, np.linspace(-1, 1, 7))
    assert mean.device.type == "cuda" and bool(torch.isfinite(mean).all())
