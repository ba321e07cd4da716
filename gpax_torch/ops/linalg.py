"""Cholesky-centric linear algebra for GP posteriors.

Counterpart of ``gpax_tpu/ops/linalg.py``. Every factor path takes the same
route on both devices: the library Cholesky (``torch.linalg.cholesky_ex``,
cuSOLVER on the card) for L, then ``blocked_trtri`` (kernel K2 on a CUDA
tensor, its twin on a CPU tensor) for W = L⁻¹, so every downstream solve is
a matmul.

The factor path works in float64 for a float32 gram (the config's
``wtw_precision="float64"``, a departure from the JAX package's float32
factor): the Cholesky factor, K2's inverse of it, and the density and its
backward WᵀW are all float64. Measured on an H100 at n = 4096 (PERF.md,
``scripts/torch_precision_probe.py``): an all-float32 path has potential
errors of 0.8-4 and d/dlog(k_scale) errors of −2.3 to −4.3 (true 1.3 to
4.9) at log k_scale 1.5-2.5, which starve NUTS of the restoring force in
k_scale and send its trajectories into grams that float32 cannot factor;
a float64 factor path leaves errors of at most 0.6, which come from the
float32 gram. On that card float64 GEMMs run on the tensor cores, no slower
than float32 ones without TF32.

``torch.linalg.cholesky`` raises on a non-PD input where JAX returns NaN, so
failure is read from ``cholesky_ex``'s ``info`` and never from the factor's
values: on failure ``cholesky_ex`` may hand back a partial factor that is
finite.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..utils.utils import host_bool
from .chol import blocked_trtri

_LOG_2PI = math.log(2.0 * math.pi)


def _eps(dtype) -> float:
    return float(torch.finfo(dtype).eps)


def _add_diag(K: torch.Tensor, j) -> torch.Tensor:
    """K + j·I without an n×n identity (j a float or a batch-shaped tensor)."""
    out = K.clone()
    out.diagonal(dim1=-2, dim2=-1).add_(j if isinstance(j, float) else j[..., None])
    return out


def _escalated_jitter(K: torch.Tensor, eps: float) -> torch.Tensor:
    """The escalation's jitter max(0.05, 1000·n·eps)·mean(diag K), per matrix."""
    scale = torch.clamp(K.diagonal(dim1=-2, dim2=-1).mean(-1), min=1e-12)
    return max(0.05, 1000.0 * K.shape[-1] * eps) * scale


def _chol_tri_factors_ld(K: torch.Tensor, base_jitter: float = 0.0
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(L, W=L⁻¹, log|L|) of K + jitter·I, all float64 (``linalg.py:71-114``).

    The base jitter max(4·n·eps, base_jitter), with eps of K's dtype, is a
    θ-independent constant. Matrices whose factorization fails are refactored
    with the escalated jitter max(0.05, 1000·n·eps)·mean(diag K). Where JAX
    branches on device with ``lax.cond``, this reads ``info`` on the host: one
    host sync per factorization (per batch of matrices), accepted for now and
    counted by ``utils.host_syncs``. W comes from ``blocked_trtri``: K2 on
    the diagonal tiles, float64 matmuls elsewhere.
    """
    n = K.shape[-1]
    eps = _eps(K.dtype)
    K = K.to(torch.float64)
    j_base = max(4.0 * n * eps, base_jitter)
    L, info = torch.linalg.cholesky_ex(_add_diag(K, j_base))
    bad = info != 0
    if host_bool(bad.any()):
        L_big, info_big = torch.linalg.cholesky_ex(_add_diag(K, _escalated_jitter(K, eps)))
        # a factorization that fails even so yields NaN, as in JAX
        L_big = torch.where((info_big != 0)[..., None, None], torch.nan, L_big)
        L = torch.where(bad[..., None, None], L_big, L)
    ld = torch.log(torch.abs(L.diagonal(dim1=-2, dim2=-1))).sum(-1)
    return L, blocked_trtri(L), ld


def chol_tri_factors(K: torch.Tensor, base_jitter: float = 0.0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, W=L⁻¹) of K + jitter·I in K's dtype, for non-differentiated
    consumers (predictive paths); batched over leading dims."""
    L, W, _ = _chol_tri_factors_ld(K, base_jitter)
    return L.to(K.dtype), W.to(K.dtype)


def _unbroadcast(x: torch.Tensor, shape) -> torch.Tensor:
    extra = x.ndim - len(shape)
    if extra > 0:
        x = x.sum(dim=tuple(range(extra)))
    dims = tuple(i for i, (a, b) in enumerate(zip(x.shape, shape)) if a != b)
    if dims:
        x = x.sum(dim=dims, keepdim=True)
    return x.reshape(shape)


class _MVNLogProb(torch.autograd.Function):
    @staticmethod
    def forward(ctx, K, diff):
        _, W, logdet = _chol_tri_factors_ld(K)
        alpha = (W @ diff.to(W.dtype).unsqueeze(-1)).squeeze(-1)
        n = K.shape[-1]
        ctx.save_for_backward(W, alpha)
        ctx.metas = (K.shape, K.dtype, diff.shape, diff.dtype)
        return (-0.5 * ((alpha * alpha).sum(-1) + n * _LOG_2PI) - logdet).to(K.dtype)

    @staticmethod
    def backward(ctx, g):
        W, alpha = ctx.saved_tensors
        K_shape, K_dtype, diff_shape, diff_dtype = ctx.metas
        g = g.to(W.dtype)
        beta = (W.mT @ alpha.unsqueeze(-1)).squeeze(-1)
        # ∂logp/∂K = ½(ββᵀ − K⁻¹) with K⁻¹ = WᵀW, formed in float64: in
        # float32 the cancellation against ββᵀ biases d/dlog(k_scale)
        dK = beta.unsqueeze(-1) * beta.unsqueeze(-2)
        dK.sub_(W.mT @ W).mul_(0.5 * g[..., None, None])
        ddiff = -g[..., None] * beta
        # failed factorizations yield zero, not NaN, cotangents
        dK = torch.nan_to_num_(dK, nan=0.0, posinf=0.0, neginf=0.0).to(K_dtype)
        ddiff = torch.nan_to_num(ddiff, nan=0.0, posinf=0.0, neginf=0.0).to(diff_dtype)
        return _unbroadcast(dK, K_shape), _unbroadcast(ddiff, diff_shape)


def mvn_log_prob_centered(K: torch.Tensor, diff: torch.Tensor) -> torch.Tensor:
    """log N(diff | 0, K + jitter·I) with a matmul-only backward
    (``linalg.py:174-243``): forward is one Cholesky, K2's blocked inverse
    and a matvec; backward is ½g(ββᵀ − WᵀW), β = Wᵀα,
    with non-finite outputs zeroed. Both run in float64 and return K's and
    diff's dtypes. The per-leapfrog op of NUTS over GP hyperparameters."""
    return _MVNLogProb.apply(K, diff)


def safe_cholesky(K: torch.Tensor, base_jitter: float = 0.0) -> torch.Tensor:
    """Gradient-safe Cholesky with jitter escalation (``linalg.py:246-277``).

    A probe factorization under ``no_grad`` picks, per matrix, the base
    jitter max(4·n·eps, base_jitter) or the escalated
    max(0.05, 1000·n·eps)·mean(diag K); the differentiable factorization then
    runs once. A factorization that still fails returns NaN, as JAX does, so
    callers can detect it from the values. No host sync.
    """
    n = K.shape[-1]
    j_base = max(4.0 * n * _eps(K.dtype), base_jitter)
    j_big = _escalated_jitter(K, _eps(K.dtype))
    with torch.no_grad():
        _, info = torch.linalg.cholesky_ex(_add_diag(K.detach(), j_base))
    j = torch.where(info == 0, torch.full_like(j_big, j_base), j_big)
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    L, info = torch.linalg.cholesky_ex(K + j[..., None, None] * eye)
    return torch.where((info == 0)[..., None, None], L, torch.nan)


def robust_mvn_sample(rng_key: torch.Generator, mean: torch.Tensor,
                      cov: torch.Tensor, n: int = 1) -> torch.Tensor:
    """n draws from N(mean, cov) with guaranteed-finite output
    (``linalg.py:297-314``): symmetrize, escalate jitter, and where the
    factorization still fails sample from the clipped diagonal instead.
    Batched over leading dims; returns (n, …, m)."""
    cov = 0.5 * (cov + cov.mT)
    L = safe_cholesky(cov)
    ok = torch.isfinite(L).all(-1).all(-1)
    diag_L = torch.diag_embed(torch.sqrt(torch.clamp(
        cov.diagonal(dim1=-2, dim2=-1), min=1e-12)))
    L = torch.where(ok[..., None, None], L, diag_L)
    eps = torch.randn((n,) + tuple(mean.shape), generator=rng_key,
                      dtype=mean.dtype, device=mean.device)
    return mean + (L @ eps.unsqueeze(-1)).squeeze(-1)


def gp_predictive_moments(k_XX, k_pX, k_pp, y) -> Tuple[torch.Tensor, torch.Tensor]:
    """GP posterior mean = k_pX K⁻¹ y and cov = k_pp − k_pX K⁻¹ k_pXᵀ via
    W = L⁻¹ (``linalg.py:328-350``); batched over leading dims."""
    _, W = chol_tri_factors(k_XX)
    A = W @ k_pX.mT
    v = (W @ y.unsqueeze(-1)).squeeze(-1)
    mean = (A.mT @ v.unsqueeze(-1)).squeeze(-1)
    cov = k_pp - A.mT @ A
    return mean, cov


def gp_predictive_mean_var(k_XX, k_pX, k_pp_diag, y) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and diagonal predictive variance only (``linalg.py:353-368``)."""
    _, W = chol_tri_factors(k_XX)
    A = W @ k_pX.mT
    v = (W @ y.unsqueeze(-1)).squeeze(-1)
    mean = (A.mT @ v.unsqueeze(-1)).squeeze(-1)
    var = k_pp_diag - (A * A).sum(-2)
    return mean, var


def mvn_sample_from_cov(rng_key: torch.Generator, mean: torch.Tensor,
                        cov: torch.Tensor, n: int = 1) -> torch.Tensor:
    """n draws from N(mean, cov) via one Cholesky, shape (n, m)
    (``linalg.py:371-376``)."""
    L = safe_cholesky(cov)
    eps = torch.randn((n, mean.shape[0]), generator=rng_key,
                      dtype=mean.dtype, device=mean.device)
    return mean[None, :] + eps @ L.mT
