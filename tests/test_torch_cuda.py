"""CUDA kernels K1 and K2 against their plain twins, on the card.

These tests need an NVIDIA GPU with nvcc (marker ``cuda``) and skip
elsewhere. The file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import gpax_torch
from gpax_torch.ops import chol, gram, linalg

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("kind", ["rbf", "matern52"])
@pytest.mark.parametrize("n,m,d,B", [(1000, 1000, 1, 1), (517, 333, 8, 3), (64, 64, 70, 2)])
def test_k1_matches_twin(dev, kind, n, m, d, B):
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
    X = torch.zeros((1, 8, 1), dtype=torch.float64, device=dev)
    with pytest.raises(ValueError):
        gram.gram_unscaled(X, X, torch.zeros((1, 8), dtype=torch.float64, device=dev))


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
