"""Blocked triangular inverse: kernel K2 (the 128-tile inverse) and its twin.

Counterpart of the ``blocked_trtri`` part of ``gpax_tpu/ops/chol.py``
(``_tile_tri_inv_kernel``, ``_trtri_rec``, ``blocked_trtri``). ``chol_inv``
and its tile kernel (K3) wait for the SVI slice.

W = L⁻¹ is built as on the TPU: identity padding to a multiple of TILE, the
inverses of the diagonal tiles, then the recursion W21 = −W22·(L21·W11) in
``torch.matmul`` (TF32 off), in L's dtype: float32 as on the TPU, or the
float64 of the factor path in ``ops/linalg.py``. Unlike the TPU, all diagonal
tiles of all matrices in the batch are inverted by ONE K2 launch
(``gpax_torch/csrc/trtri.cu``) before the recursion starts, since each leaf
depends only on L's own diagonal tile.
"""

from __future__ import annotations

import torch

from . import build

TILE = 128

launches = 0  # K2 launches in this process (the twin never counts)

# K2's C entry for each dtype it takes
_ENTRIES = {torch.float32: "gpax_tile_tri_inv_f32", torch.float64: "gpax_tile_tri_inv_f64"}


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
    see ``ops.linalg.mvn_log_prob_centered``)."""
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
