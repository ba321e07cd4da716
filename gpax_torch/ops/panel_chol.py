"""Single-launch panel Cholesky (K4) and panel triangular inverse (K5), their
plain twins, and ``panel_chol_factors`` built on them.

Counterpart of ``scripts/panel_chol.py``: ``panel_cholesky``
(``_panel_chol_kernel``), ``panel_tri_inv_t`` (``_panel_tri_inv_kernel``)
and ``panel_chol_factors``, with the same semantics: identity padding to a
multiple of 128, a batch over leading dims, NaN on indefinite input,
``panel_tri_inv_t`` returning Wᵀ = L⁻ᵀ (upper triangular) and
``panel_chol_factors`` returning (L, W = L⁻¹). Each function is one kernel
launch on a CUDA tensor (``gpax_torch/csrc/panel_chol.cu``, a cooperative
persistent launch over the whole batch) and its twin on a CPU tensor.

As in the JAX package, these are a tested alternative to the factor path of
``ops/linalg.py`` (``cholesky_ex`` + ``blocked_trtri``) and are not wired
into it: no model reaches them.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build
from .chol import _pad_spd

TILE = 128       # panel width
_PRODUCT_ROWS = 64  # rows of the kernels' product tile: the scratch holds one per block

cholesky_launches = 0  # K4 launches in this process (the twin never counts)
tri_inv_launches = 0   # K5 launches in this process (the twin never counts)

_ENTRIES = {  # (K4, K5) C entries for each dtype they take
    torch.float32: ("gpax_panel_cholesky_f32", "gpax_panel_tri_inv_t_f32"),
    torch.float64: ("gpax_panel_cholesky_f64", "gpax_panel_tri_inv_t_f64"),
}
_grid = {}  # (kernel, dtype, device index) -> blocks of one cooperative launch


def panel_cholesky_twin(K: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4: ``cholesky_ex`` of K (…, n, n). A
    factorization that fails gives NaN, not the finite partial factor
    ``cholesky_ex`` hands back."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info == 0)[..., None, None], L, torch.nan)


def panel_tri_inv_t_twin(L: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5: ``solve_triangular(L, I)ᵀ`` of
    lower-triangular L (…, n, n)."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand_as(L)
    return torch.linalg.solve_triangular(L, eye, upper=False).mT


def _blocks(kernel: int, A: torch.Tensor) -> int:
    key = (kernel, A.dtype, A.device.index)
    if key not in _grid:
        blocks = ctypes.c_int(0)
        with torch.cuda.device(A.device):
            err = build.library().gpax_panel_grid(kernel, int(A.dtype == torch.float64),
                                                  ctypes.byref(blocks))
        build.check(err, "panel kernels' cooperative grid")
        _grid[key] = blocks.value
    return _grid[key]


def _launch(kernel: int, A: torch.Tensor,
            phase_ns: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of K4 (kernel 0) or K5 (kernel 1) on A (B, n, n), n a
    multiple of TILE: a zero-filled output, and the scratch it needs (the
    diagonal tiles' inverses, one at a time for K4 and all of them for K5;
    one partial-sum tile per block). ``phase_ns``: 4 zeroed int64 on A's
    device, the first 3 of which receive the nanoseconds of the kernel's
    phases."""
    global cholesky_launches, tri_inv_launches
    name = ("panel_cholesky", "panel_tri_inv_t")[kernel]
    if A.device.type != "cuda" or A.dtype not in _ENTRIES or A.ndim != 3 \
            or not A.is_contiguous():
        raise ValueError(f"{name}: the matrices must be a contiguous (B, n, n) float32 or "
                         "float64 CUDA tensor")
    B, n, n2 = A.shape
    if n != n2 or n % TILE:
        raise ValueError(f"{name}: shape {tuple(A.shape)} is not square with a multiple "
                         f"of {TILE}")
    out = torch.zeros_like(A)
    if out.numel() == 0:
        return out
    blocks = _blocks(kernel, A)
    Wd = A.new_empty((B * (1 if kernel == 0 else n // TILE), TILE, TILE))
    part = A.new_empty((blocks, _PRODUCT_ROWS, TILE))
    err = getattr(build.library(), _ENTRIES[A.dtype][kernel])(
        A.data_ptr(), out.data_ptr(), Wd.data_ptr(), part.data_ptr(), B, n, blocks,
        torch.cuda.current_stream(A.device).cuda_stream,
        None if phase_ns is None else phase_ns.data_ptr())
    build.check(err, name)
    if kernel == 0:
        cholesky_launches += 1
    else:
        tri_inv_launches += 1
    return out


def panel_cholesky_padded(K: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factors of SPD K (B, n, n), n a multiple of TILE,
    float32 or float64: K4 on a CUDA tensor (one launch for the batch), the
    twin on a CPU tensor."""
    if K.device.type == "cpu":
        return panel_cholesky_twin(K)
    return _launch(0, K)


def panel_tri_inv_t_padded(L: torch.Tensor) -> torch.Tensor:
    """Wᵀ = L⁻ᵀ of lower-triangular L (B, n, n), n a multiple of TILE,
    float32 or float64: K5 on a CUDA tensor (one launch for the batch), the
    twin on a CPU tensor."""
    if L.device.type == "cpu":
        return panel_tri_inv_t_twin(L)
    return _launch(1, L)


def _padded_call(fn, A: torch.Tensor) -> torch.Tensor:
    """fn on A (…, n, n) padded to a multiple of TILE as block_diag(A, I)
    (``panel_chol.py:214-220``, ``:266-270``), sliced back."""
    batch, n = A.shape[:-2], A.shape[-1]
    n_pad = -(-n // TILE) * TILE
    out = fn(_pad_spd(A.reshape(-1, n, n), n_pad).contiguous())
    return out[:, :n, :n].reshape(batch + (n, n))


def panel_cholesky(K: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of SPD K (…, n, n), the whole left-looking panel
    factorization in one launch (``panel_chol.py:223-256``). NaN on
    indefinite input."""
    return _padded_call(panel_cholesky_padded, K)


def _phase_ms(kernel: int, A: torch.Tensor) -> Tuple[float, float, float]:
    """One launch of K4 (kernel 0) or K5 (kernel 1) on A (…, n, n), padded as
    the public call pads it and counted like any other, timed by phase on
    the device's clock: the ms in the products (split-K reduction
    included), in the diagonal tiles and in the panel TRSM, each read by
    block 0 after the grid barrier that ends the phase. Raises on a CPU
    tensor: only the kernel has phases."""
    name = ("cholesky_phase_ms", "tri_inv_phase_ms")[kernel]
    if A.device.type != "cuda":
        raise RuntimeError(f"{name}: the phases are the CUDA kernel's; the matrix must "
                           "be a CUDA tensor")
    phase_ns = torch.zeros(4, dtype=torch.int64, device=A.device)
    _padded_call(lambda P: _launch(kernel, P, phase_ns), A)
    return tuple(float(t) / 1e6 for t in phase_ns[:3].tolist())


def cholesky_phase_ms(K: torch.Tensor) -> Tuple[float, float, float]:
    """K4's phases on K (…, n, n) (:func:`_phase_ms`): the Schur-update
    products, the diagonal tiles' factorization and inversion, the panel
    TRSM."""
    return _phase_ms(0, K)


def tri_inv_phase_ms(L: torch.Tensor) -> Tuple[float, float, float]:
    """K5's phases on lower-triangular L (…, n, n) (:func:`_phase_ms`): the
    products, the diagonal tiles' inverses, the panel TRSM."""
    return _phase_ms(1, L)


def panel_tri_inv_t(L: torch.Tensor) -> torch.Tensor:
    """Wᵀ = L⁻ᵀ (upper triangular) of lower-triangular L (…, n, n) in one
    launch (``panel_chol.py:259-294``)."""
    return _padded_call(panel_tri_inv_t_padded, L)


def panel_chol_factors(K: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, W = L⁻¹) of SPD K (…, n, n) by the two panel kernels, two launches
    in all (``panel_chol.py:297-301``)."""
    L = panel_cholesky(K)
    return L, panel_tri_inv_t(L).mT
