"""Mesh-split blocked Cholesky: one model's large-n factorization across
devices (counterpart of ``gpax_tpu/parallel/distributed_chol.py``).

The all-matmul recursive 2×2 blocking of ``ops/chol.py`` at coarse (leaf ≥
1024) granularity::

    L11, W11 = rec(K11)                    ← leaf: the port's factor path
    L21      = K21 · W11ᵀ                  ← large product, split over the mesh
    L22, W22 = rec(K22 − L21·L21ᵀ)         ← Schur update: split product
    W21      = −W22 · (L21 · W11)          ← split products

Each large product is split by the rows of its left operand, one
contiguous block per mesh device, with the right operand copied to every
device; the blocks are gathered on the mesh's first device. The JAX
package leaves the split and the collectives to XLA through sharding
constraints; torch has no such partitioner, so the split is explicit.

The leaf is the port's own factor path: ``cholesky_ex`` and
``blocked_trtri`` (K2 on a CUDA tensor), in float64 whatever K's dtype, as
every factor of the port is (``ops/linalg.py``). A factorization that fails yields NaN, as in JAX, so
the jitter escalation of :func:`make_sharded_mvn_log_prob` composes.

``make_sharded_mvn_log_prob`` wraps the factorization into the NUTS
likelihood with the closed-form matmul-only backward of
``ops.linalg.mvn_log_prob_centered``, its WᵀW split over the mesh too, in
the config's ``wtw_precision`` and ``mvn_dk_gauge`` (a symmetric consumer,
as ``distributed_chol.py:175-179``). It
is taken by ``MultivariateNormal.log_prob`` inside ``with
sharded_linalg(mesh):``, for one matrix and one vector; ExactGP's fused
likelihood steps aside there.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch

from ..ops.chol import blocked_trtri
from ..ops.linalg import _add_diag, _eps, _escalated_jitter, wtw_compensated
from ..utils.utils import host_bool
from .mesh import Mesh

_LOG_2PI = math.log(2.0 * math.pi)

# ---------------------------------------------------------------------------
# Active-mesh context: lets model likelihoods opt into the split linalg
# without threading a mesh through every distribution call site.
# ---------------------------------------------------------------------------

_ACTIVE: list = []


@contextlib.contextmanager
def sharded_linalg(mesh: Mesh, axis_name: Optional[str] = None, leaf: int = 2048):
    """Context under which MVN likelihoods factor their covariance across
    ``mesh``: ``with sharded_linalg(mesh): gp.fit(...)`` runs the O(n³)
    per-leapfrog work split over the mesh's devices."""
    if axis_name is None:
        axis_name = mesh.axis_names[0]
    _ACTIVE.append((mesh, axis_name, leaf))
    try:
        yield
    finally:
        _ACTIVE.pop()


def active_sharded_linalg():
    return _ACTIVE[-1] if _ACTIVE else None


# ---------------------------------------------------------------------------
# Split recursive factorization
# ---------------------------------------------------------------------------

def _mm(A: torch.Tensor, B: torch.Tensor, devices, product=torch.matmul) -> torch.Tensor:
    """product(A, B) (A·B) with A's rows split over ``devices`` (B copied to
    each), gathered on the first."""
    if len(devices) == 1:
        return product(A, B)
    home = devices[0]
    parts = [product(a.to(d), B.to(d)).to(home)
             for a, d in zip(torch.tensor_split(A, len(devices)), devices)]
    return torch.cat(parts, 0)


def _leaf(K: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, W = L⁻¹) of one float64 leaf; NaN where the factorization fails."""
    L, info = torch.linalg.cholesky_ex(K)
    L = torch.where(info != 0, torch.nan, L)
    return L, blocked_trtri(L)


def _rec(K: torch.Tensor, leaf: int, devices) -> Tuple[torch.Tensor, torch.Tensor]:
    n = K.shape[-1]
    if n <= leaf:
        return _leaf(K)
    h = leaf * ((n // leaf) // 2)
    K21 = K[h:, :h]
    L11, W11 = _rec(K[:h, :h], leaf, devices)
    L21 = _mm(K21, W11.mT, devices)
    L22, W22 = _rec(K[h:, h:] - _mm(L21, L21.mT, devices), leaf, devices)
    W21 = -_mm(W22, _mm(L21, W11, devices), devices)
    L = K.new_zeros((n, n))
    W = K.new_zeros((n, n))
    L[:h, :h], L[h:, :h], L[h:, h:] = L11, L21, L22
    W[:h, :h], W[h:, :h], W[h:, h:] = W11, W21, W22
    return L, W


def _pad_spd(K: torch.Tensor, n_pad: int) -> torch.Tensor:
    """block_diag(K, I) of size n_pad: the padding factors to identity
    blocks that slice away exactly."""
    n = K.shape[-1]
    if n_pad == n:
        return K
    Kp = K.new_zeros((n_pad, n_pad))
    Kp[:n, :n] = K
    Kp[n:, n:].diagonal().fill_(1.0)
    return Kp


def _chol_inv64(K: torch.Tensor, devices, leaf: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float64 (L, W) of K (n, n) on the mesh's first device."""
    n = K.shape[-1]
    n_pad = -(-n // leaf) * leaf
    L, W = _rec(_pad_spd(K.to(devices[0], torch.float64), n_pad), leaf, devices)
    return L[:n, :n], W[:n, :n]


def sharded_chol_inv(K: torch.Tensor, mesh: Mesh, axis_name: Optional[str] = None,
                     leaf: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, W = L⁻¹) of an SPD matrix (n, n) with every large product split
    over ``mesh``, computed in float64 and returned in K's dtype on K's
    device. NaN-propagating on indefinite input, like the single-device
    paths, so jitter-escalation probes compose unchanged."""
    L, W = _chol_inv64(K, mesh.device_list(), leaf)
    return L.to(K.device, K.dtype), W.to(K.device, K.dtype)


# ---------------------------------------------------------------------------
# Split MVN log-density with the closed-form matmul-only backward
# ---------------------------------------------------------------------------

def _factor(K: torch.Tensor, devices, leaf: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float64 (L, W) of K + 4·n·eps·I (eps of K's dtype), or of K plus the
    escalated jitter where that factorization fails (read on the host: one
    sync per factorization, as in ``ops/linalg.py``)."""
    n, eps = K.shape[-1], _eps(K.dtype)
    K64 = K.to(devices[0], torch.float64)
    L, W = _chol_inv64(_add_diag(K64, 4.0 * n * eps), devices, leaf)
    if not host_bool(torch.isfinite(L).all()):
        L, W = _chol_inv64(_add_diag(K64, _escalated_jitter(K64, eps)), devices, leaf)
    return L, W


class _ShardedMVNLogProb(torch.autograd.Function):
    @staticmethod
    def forward(ctx, K, diff, devices, leaf):
        L, W = _factor(K, devices, leaf)
        alpha = W @ diff.to(W.device, W.dtype)
        n = K.shape[-1]
        logdet = torch.log(torch.abs(L.diagonal())).sum()
        ctx.save_for_backward(W, alpha)
        ctx.metas = (K.dtype, K.device, diff.dtype, diff.device, devices)
        lp = -0.5 * ((alpha * alpha).sum() + n * _LOG_2PI) - logdet
        return lp.to(K.device, K.dtype)

    @staticmethod
    def backward(ctx, g):
        W, alpha = ctx.saved_tensors
        K_dtype, K_device, diff_dtype, diff_device, devices = ctx.metas
        g = g.to(W.device, W.dtype)
        # a factorization that fails even so gives zero cotangents
        W = torch.where(torch.isfinite(W), W, 0.0)
        alpha = torch.where(torch.isfinite(alpha), alpha, 0.0)
        beta = W.mT @ alpha
        # ∂logp/∂K = ½(ββᵀ − K⁻¹), K⁻¹ = WᵀW split by Wᵀ's rows, in the
        # config's wtw_precision; dK meets only symmetric ∂K/∂θ
        dK = beta[:, None] * beta[None, :]
        dK.sub_(wtw_compensated(W, symmetric_consumer=True,
                                matmul=lambda a, b, product: _mm(a, b, devices, product))
                ).mul_(0.5 * g)
        return (dK.to(K_device, K_dtype), (-g * beta).to(diff_device, diff_dtype),
                None, None)


def make_sharded_mvn_log_prob(mesh: Mesh, axis_name: Optional[str] = None,
                              leaf: int = 2048):
    """log N(diff | 0, K + jitter·I) for K (n, n) and diff (n,), whose
    factorization and backward are split over ``mesh``. The numerics of
    ``ops.linalg.mvn_log_prob_centered``: the θ-independent base jitter
    4·n·eps (eps of K's dtype), the escalated jitter where that factor
    fails, float64 factors, WᵀW in the config's ``wtw_precision``, and zero
    cotangents from a factorization that fails even so."""
    devices = mesh.device_list()

    def log_prob(K: torch.Tensor, diff: torch.Tensor) -> torch.Tensor:
        return _ShardedMVNLogProb.apply(K, diff, devices, leaf)

    return log_prob
