"""The 128-tile kernels K2 (triangular inverse) and K3 (Cholesky and
inverse), their plain twins, and the blocked schemes built on them.

Counterpart of ``gpax_tpu/ops/chol.py``: ``blocked_trtri`` on K2
(``_tile_tri_inv_kernel``, ``_trtri_rec``) and ``chol_inv`` on K3
(``_tile_chol_inv_kernel``, ``_chol_inv_rec``, ``_pad_spd``, the custom VJP).

W = L⁻¹ is built as on the TPU: identity padding to a multiple of TILE, the
inverses of the diagonal tiles, then the recursion W21 = −W22·(L21·W11) in
``torch.matmul`` (TF32 off), in L's dtype: float32 as on the TPU, or the
float64 of the factor path in ``ops/linalg.py``. Unlike the TPU, all diagonal
tiles of all matrices in the batch are inverted by ONE K2 launch
(``gpax_torch/csrc/trtri.cu``) before the recursion starts, since each leaf
depends only on L's own diagonal tile.

``chol_inv`` cannot do the same: each leaf of its recursion factors the
Schur complement left by the leaves before it, so an m-matrix takes
⌈m/128⌉ K3 launches (``gpax_torch/csrc/cholinv.cu``) in order, each covering
the current leaf of every matrix in the batch.
"""

from __future__ import annotations

import torch

from ..utils.monitor import span
from . import build

TILE = 128

launches = 0  # K2 launches in this process (the twin never counts)
chol_inv_launches = 0  # K3 launches in this process (the twin never counts)

# the C entries of K2 and K3 for each dtype they take
_ENTRIES = {torch.float32: "gpax_tile_tri_inv_f32", torch.float64: "gpax_tile_tri_inv_f64"}
_CHOL_ENTRIES = {torch.float32: "gpax_tile_chol_inv_f32",
                 torch.float64: "gpax_tile_chol_inv_f64"}


def blocked_eligible(n: int, dtype) -> bool:
    """Whether a factor of size n in ``dtype`` takes the blocked scheme
    (K2's ``blocked_trtri``, K3's ``chol_inv``): True for float32 and
    float64 at every n. The JAX package gates its Pallas path on a TPU, a
    size threshold and float32 (``chol.py:292-306``); the port takes K2 and
    K3 at every n in both dtypes, the kernel or its twin by the tensor's
    device, never by a threshold."""
    return dtype in (torch.float32, torch.float64)


def tile_tri_inv_twin(L: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: ``solve_triangular(L_tile, I)`` per tile."""
    B, n, _ = L.shape
    T = n // TILE
    tiles = L.view(B, T, TILE, T, TILE).diagonal(dim1=1, dim2=3)  # (B, TILE, TILE, T)
    tiles = tiles.permute(0, 3, 1, 2)
    eye = torch.eye(TILE, dtype=L.dtype, device=L.device).expand_as(tiles)
    inv = torch.linalg.solve_triangular(tiles, eye, upper=False)
    W = torch.zeros_like(L)
    W.view(B, T, TILE, T, TILE).diagonal(dim1=1, dim2=3).copy_(inv.permute(0, 2, 3, 1))
    return W


def tile_tri_inv(L: torch.Tensor) -> torch.Tensor:
    """For lower-triangular L (B, n, n) with n a multiple of TILE, float32 or
    float64: a W whose diagonal TILE×TILE blocks are the inverses of L's and
    which is zero elsewhere. K2 on a CUDA tensor, the twin on a CPU tensor."""
    if L.device.type == "cpu":
        return tile_tri_inv_twin(L)
    global launches
    if L.device.type != "cuda" or L.dtype not in _ENTRIES or L.ndim != 3 \
            or not L.is_contiguous():
        raise ValueError("tile_tri_inv: L must be a contiguous (B, n, n) float32 "
                         "or float64 CUDA tensor")
    B, n, n2 = L.shape
    if n != n2 or n % TILE:
        raise ValueError(f"tile_tri_inv: shape {tuple(L.shape)} is not square "
                         f"with a multiple of {TILE}")
    W = torch.zeros_like(L)
    if W.numel() == 0:
        return W
    lib = build.library()
    err = getattr(lib, _ENTRIES[L.dtype])(
        L.data_ptr(), W.data_ptr(), B, n,
        torch.cuda.current_stream(L.device).cuda_stream)
    build.check(err, "tile_tri_inv")
    launches += 1
    return W


def _trtri_rec(L: torch.Tensor, W: torch.Tensor, lo: int, hi: int) -> None:
    """Fill W's strictly-lower blocks in [lo, hi) in place, given its
    diagonal tiles (the recursion of ``chol.py:259-267``)."""
    n = hi - lo
    if n <= TILE:
        return
    mid = lo + TILE * ((n // TILE) // 2)
    _trtri_rec(L, W, lo, mid)
    _trtri_rec(L, W, mid, hi)
    W[:, mid:hi, lo:mid] = -(W[:, mid:hi, mid:hi]
                             @ (L[:, mid:hi, lo:mid] @ W[:, lo:mid, lo:mid]))


def blocked_trtri(L: torch.Tensor) -> torch.Tensor:
    """W = L⁻¹ for lower-triangular L (…, n, n): K2 on the diagonal tiles,
    matmuls everywhere else. Not differentiable on its own (callers wrap it,
    see ``ops.linalg.mvn_log_prob_centered``). The span ``gpax.inverse``
    covers it: K2, its zero fill of W and the recursion's products."""
    with span("gpax.inverse"):
        batch, n = L.shape[:-2], L.shape[-1]
        Lb = L.reshape(-1, n, n)
        n_pad = -(-n // TILE) * TILE
        if n_pad != n:
            Lp = Lb.new_zeros((Lb.shape[0], n_pad, n_pad))
            Lp[:, :n, :n] = Lb
            Lp[:, n:, n:].diagonal(dim1=-2, dim2=-1).fill_(1.0)
        else:
            Lp = Lb.contiguous()
        W = tile_tri_inv(Lp)
        _trtri_rec(Lp, W, 0, n_pad)
        return W[:, :n, :n].reshape(batch + (n, n))


def tile_chol_inv_twin(A: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3: ``cholesky_ex`` and
    ``solve_triangular(L, I)`` per tile. A factorization that fails gives a
    NaN L and W, as the kernel's square root does (``cholesky_ex`` itself would
    hand back a finite partial factor)."""
    L, info = torch.linalg.cholesky_ex(A)
    L = torch.where((info == 0)[..., None, None], L, torch.nan)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand_as(L)
    return L, torch.linalg.solve_triangular(L, eye, upper=False)


def tile_chol_inv(A: torch.Tensor):
    """(L, W = L⁻¹) of SPD tiles A (B, TILE, TILE), float32 or float64. K3 on a
    CUDA tensor, the twin on a CPU tensor. NaN on indefinite input."""
    if A.device.type == "cpu":
        return tile_chol_inv_twin(A)
    global chol_inv_launches
    if A.device.type != "cuda" or A.dtype not in _CHOL_ENTRIES or not A.is_contiguous() \
            or A.ndim != 3 or A.shape[1:] != (TILE, TILE):
        raise ValueError(f"tile_chol_inv: A must be a contiguous (B, {TILE}, {TILE}) "
                         "float32 or float64 CUDA tensor")
    L = torch.empty_like(A)
    W = torch.empty_like(A)
    if A.numel() == 0:
        return L, W
    lib = build.library()
    err = getattr(lib, _CHOL_ENTRIES[A.dtype])(
        A.data_ptr(), L.data_ptr(), W.data_ptr(), A.shape[0],
        torch.cuda.current_stream(A.device).cuda_stream)
    build.check(err, "tile_chol_inv")
    chol_inv_launches += 1
    return L, W


def _chol_inv_rec(K: torch.Tensor, L: torch.Tensor, W: torch.Tensor) -> None:
    """Write (L, W = L⁻¹) of K (B, n, n), n a multiple of TILE, into the
    views L and W (``chol.py:141-153``): L11, W11 of K11 first, then
    L21 = K21·W11ᵀ, the Schur complement K22 − L21·L21ᵀ, its L22, W22, and
    W21 = −W22·L21·W11."""
    n = K.shape[-1]
    if n <= TILE:
        Lt, Wt = tile_chol_inv(K.contiguous())
        L.copy_(Lt)
        W.copy_(Wt)
        return
    h = TILE * ((n // TILE) // 2)
    _chol_inv_rec(K[:, :h, :h], L[:, :h, :h], W[:, :h, :h])
    L21 = K[:, h:, :h] @ W[:, :h, :h].mT
    L[:, h:, :h] = L21
    _chol_inv_rec(K[:, h:, h:] - L21 @ L21.mT, L[:, h:, h:], W[:, h:, h:])
    W[:, h:, :h] = -(W[:, h:, h:] @ (L21 @ W[:, :h, :h]))


def _pad_spd(K: torch.Tensor, n_pad: int) -> torch.Tensor:
    """K (B, n, n) padded to (B, n_pad, n_pad) as block_diag(K, I): the
    factor and inverse of the padding are identity blocks that slice away
    exactly (``chol.py:156-164``)."""
    B, n, _ = K.shape
    if n_pad == n:
        return K
    Kp = K.new_zeros((B, n_pad, n_pad))
    Kp[:, :n, :n] = K
    Kp[:, n:, n:].diagonal(dim1=-2, dim2=-1).fill_(1.0)
    return Kp


def _phi(M: torch.Tensor) -> torch.Tensor:
    """tril(M) with its diagonal halved: the Cholesky pullback's projection."""
    out = torch.tril(M)
    out.diagonal(dim1=-2, dim2=-1).mul_(0.5)
    return out


class _CholInv(torch.autograd.Function):
    """``chol_inv``'s forward on K3 and the matmul-only pullback of
    ``chol.py:197-211``: L̄ ← tril(L̄) − tril(Wᵀ·tril(W̄)·Wᵀ),
    P = Φ(Lᵀ·L̄), K̄ = sym(Wᵀ·P·W)."""

    @staticmethod
    def forward(ctx, K):
        batch, n = K.shape[:-2], K.shape[-1]
        n_pad = -(-n // TILE) * TILE
        Kb = _pad_spd(K.reshape(-1, n, n), n_pad)
        L = Kb.new_zeros(Kb.shape)
        W = Kb.new_zeros(Kb.shape)
        _chol_inv_rec(Kb, L, W)
        L = L[:, :n, :n].reshape(batch + (n, n))
        W = W[:, :n, :n].reshape(batch + (n, n))
        ctx.save_for_backward(L, W)
        return L, W

    @staticmethod
    def backward(ctx, Lb, Wb):
        L, W = ctx.saved_tensors
        Wt = W.mT
        Lbar = torch.tril(Lb) - torch.tril(Wt @ (torch.tril(Wb) @ Wt))
        Kb = Wt @ (_phi(L.mT @ Lbar) @ W)
        return 0.5 * (Kb + Kb.mT)


def chol_inv(K: torch.Tensor):
    """(L, W = L⁻¹) of SPD K (…, n, n) by the blocked all-matmul scheme:
    K3 on each 128-leaf, matmuls elsewhere; differentiable through the
    closed-form pullback. NaN-propagating on indefinite input, like the
    library Cholesky in JAX, so ``safe_chol_inv``'s escalation composes."""
    return _CholInv.apply(K)
