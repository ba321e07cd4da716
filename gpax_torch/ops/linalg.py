"""Cholesky-centric linear algebra for GP posteriors.

Counterpart of ``gpax_tpu/ops/linalg.py``. Every factor path takes the same
route on both devices: the library Cholesky (``torch.linalg.cholesky_ex``,
cuSOLVER on the card) for L, then ``blocked_trtri`` (kernel K2 on a CUDA
tensor, its twin on a CPU tensor) for W = L⁻¹, so every downstream solve is
a matmul.

The factor path works in float64 for a float32 gram, a departure from the
JAX package's float32 factor: the Cholesky factor, K2's inverse of it and
the density are float64 in every mode. The backward's K⁻¹ = WᵀW takes the
config's ``wtw_precision`` (:func:`wtw_compensated`): ``"float64"`` (the
port's default) or one of the JAX package's float32 modes, ``"highest"``,
``"compensated"`` and ``"default"``. Measured on an H100 at n = 4096 (PERF.md,
``scripts/torch_precision_probe.py``): an all-float32 path has potential
errors of 0.8-4 and d/dlog(k_scale) errors of −2.3 to −4.3 (true 1.3 to
4.9) at log k_scale 1.5-2.5, which starve NUTS of the restoring force in
k_scale and send its trajectories into grams that float32 cannot factor;
a float64 factor path leaves errors of at most 0.6, which come from the
float32 gram. On that card float64 GEMMs run on the tensor cores, no slower
than float32 ones without TF32.

``safe_chol_inv`` takes ``chol_inv`` instead, kernel K3 on each 128-leaf, in
K's dtype; ``safe_chol_inv_f64`` (the sparse GP's factor, see
``models/sparse_gp.py``) runs it in float64 with the jitters of K's dtype.

``torch.linalg.cholesky`` raises on a non-PD input where JAX returns NaN, so
failure is read from ``cholesky_ex``'s ``info`` and never from the factor's
values: on failure ``cholesky_ex`` may hand back a partial factor that is
finite.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..config import get_config
from ..utils.utils import host_bool
from .chol import blocked_trtri, chol_inv

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


def _chol_tri_factors_ld(K: torch.Tensor, base_jitter: Optional[float] = 0.0
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(L, W=L⁻¹, log|L|) of K + jitter·I, all float64 (``linalg.py:71-114``).

    The base jitter max(4·n·eps, base_jitter), with eps of K's dtype, is a
    θ-independent constant. ``base_jitter=None`` adds none: K already
    carries its base regularization on the diagonal (the fused likelihood's
    contract, ``ops/fused_density.py``). Matrices whose factorization fails
    are refactored with the escalated jitter max(0.05, 1000·n·eps)·mean(diag
    K). Where JAX branches on device with ``lax.cond``, this reads ``info``
    on the host: one host sync per factorization (per batch of matrices),
    accepted for now and counted by ``utils.host_syncs``. W comes from
    ``blocked_trtri``: K2 on the diagonal tiles, float64 matmuls elsewhere.
    """
    n = K.shape[-1]
    eps = _eps(K.dtype)
    K = K.to(torch.float64)
    K_base = K if base_jitter is None else _add_diag(K, max(4.0 * n * eps, base_jitter))
    L, info = torch.linalg.cholesky_ex(K_base)
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


def split_bf16(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) bf16 halves of a float32 x: hi = rn(x), lo = rn(x − hi), so
    hi + lo carries x to 2⁻¹⁶ relative (bf16 keeps 8 significant bits)."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of bf16 operands with fp32 accumulation and an fp32 result,
    batched over leading dims. On a CUDA tensor the tensor cores' bf16
    product with an fp32 output (``out_dtype``): a bf16 result would round
    away what the hi/lo split keeps. On a CPU tensor the fp32 product of the
    bf16 values, exact per product as on the card."""
    if a.device.type != "cuda":
        return a.float() @ b.float()
    if a.ndim == b.ndim == 2:
        return torch.mm(a, b, out_dtype=torch.float32)
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a3 = a.expand(batch + a.shape[-2:]).reshape((-1,) + a.shape[-2:])
    b3 = b.expand(batch + b.shape[-2:]).reshape((-1,) + b.shape[-2:])
    return torch.bmm(a3, b3, out_dtype=torch.float32).reshape(
        batch + (a.shape[-2], b.shape[-1]))


def wtw_compensated(W: torch.Tensor, symmetric_consumer: bool = False,
                    matmul=None) -> torch.Tensor:
    """K⁻¹ = WᵀW in the config's ``wtw_precision`` (``linalg.py:133-172``),
    returned in W's dtype:

    - ``"float64"``: the float64 product (the port's default);
    - ``"highest"``: the fp32 product of W in float32 (TF32 off);
    - ``"default"``: one bf16 product, bf16(W)ᵀbf16(W) with fp32 sums;
    - ``"compensated"``: W in float32 split by :func:`split_bf16`,
      hiᵀhi + (hiᵀlo + (hiᵀlo)ᵀ), loᵀlo dropped: at most 3·2⁻¹⁶ of a
      diagonal entry off; for a ``symmetric_consumer`` under the config's
      ``mvn_dk_gauge="symmetric_equivalent"``, hiᵀhi + 2·hiᵀlo, which has
      the same symmetric part for one product fewer.

    The bf16 products go through :func:`bf16_matmul`. ``matmul(a, b,
    product)``, where given, computes ``product(a, b)`` for each product (the
    mesh's row split in ``parallel/distributed_chol.py``)."""
    cfg = get_config()
    mode = cfg.wtw_precision
    if matmul is None:
        def matmul(a, b, product):
            return product(a, b)
    if mode == "float64":
        W64 = W.to(torch.float64)
        return matmul(W64.mT, W64, torch.matmul).to(W.dtype)
    Wf = W.to(torch.float32)
    if mode == "highest":
        return matmul(Wf.mT, Wf, torch.matmul).to(W.dtype)
    if mode == "default":
        hi = Wf.to(torch.bfloat16)
        return matmul(hi.mT, hi, bf16_matmul).to(W.dtype)
    if mode != "compensated":
        raise ValueError(f"wtw_precision={mode!r}")
    hi, lo = split_bf16(Wf)
    main = matmul(hi.mT, hi, bf16_matmul)
    cross = matmul(hi.mT, lo, bf16_matmul)
    if symmetric_consumer and cfg.mvn_dk_gauge == "symmetric_equivalent":
        return main.add_(cross, alpha=2.0).to(W.dtype)
    return main.add_(cross + cross.mT).to(W.dtype)


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
        # ∂logp/∂K = ½(ββᵀ − K⁻¹) with K⁻¹ = WᵀW in the config's
        # wtw_precision: float64 by default, since in float32 the
        # cancellation against ββᵀ biases d/dlog(k_scale). dK is contracted
        # only against the symmetric ∂K/∂θ, so the symmetric-equivalent
        # gauge applies
        dK = beta.unsqueeze(-1) * beta.unsqueeze(-2)
        dK.sub_(wtw_compensated(W, symmetric_consumer=True)).mul_(0.5 * g[..., None, None])
        ddiff = -g[..., None] * beta
        # failed factorizations yield zero, not NaN, cotangents
        dK = torch.nan_to_num_(dK, nan=0.0, posinf=0.0, neginf=0.0).to(K_dtype)
        ddiff = torch.nan_to_num(ddiff, nan=0.0, posinf=0.0, neginf=0.0).to(diff_dtype)
        return _unbroadcast(dK, K_shape), _unbroadcast(ddiff, diff_shape)


def mvn_log_prob_centered(K: torch.Tensor, diff: torch.Tensor) -> torch.Tensor:
    """log N(diff | 0, K + jitter·I) with a matmul-only backward
    (``linalg.py:174-243``): forward is one Cholesky, K2's blocked inverse
    and a matvec; backward is ½g(ββᵀ − WᵀW), β = Wᵀα,
    with non-finite outputs zeroed. Both run in float64, but for WᵀW in the
    config's ``wtw_precision`` (:func:`wtw_compensated`), and return K's and
    diff's dtypes. Under ``"compensated"`` WᵀW and the
    ``"symmetric_equivalent"`` gauge, dK is not symmetric: only its
    symmetric part is K's cotangent. The per-leapfrog op of NUTS over GP
    hyperparameters."""
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


def _chol_with_inv(K: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, W=L⁻¹) of K (``linalg.py:40-47``). The port always takes
    ``chol_inv`` (K3 on a CUDA tensor): kernels are chosen by device, never
    by the JAX package's size threshold."""
    return chol_inv(K)


def safe_chol_inv(K: torch.Tensor, base_jitter: float = 0.0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, W=L⁻¹) with ``safe_cholesky``'s jitter escalation
    (``linalg.py:280-294``): a no-grad library probe picks, per matrix,
    j_base or j_big, then ``chol_inv(K + j·I)`` runs once and is
    differentiated. No host sync. A factor that fails even so is NaN."""
    return _safe_chol_inv(K, K, base_jitter)


def safe_chol_inv_f64(K: torch.Tensor, base_jitter: float = 0.0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``safe_chol_inv`` with the probe and ``chol_inv`` in float64 (K3's
    float64 instantiation) but the jitters of K's dtype; L and W come back
    in K's dtype."""
    L, W = _safe_chol_inv(K, K.to(torch.float64), base_jitter)
    return L.to(K.dtype), W.to(K.dtype)


def _safe_chol_inv(K: torch.Tensor, Kf: torch.Tensor, base_jitter: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The escalation of ``safe_chol_inv`` on Kf (K itself or K in a wider
    dtype), with the jitters of K's dtype."""
    n = K.shape[-1]
    j_base = max(4.0 * n * _eps(K.dtype), base_jitter)
    j_big = _escalated_jitter(K, _eps(K.dtype))
    with torch.no_grad():
        _, info = torch.linalg.cholesky_ex(_add_diag(Kf.detach(), j_base))
    j = torch.where(info == 0, torch.full_like(j_big, j_base), j_big)
    return _chol_with_inv(_add_diag(Kf, j.to(Kf.dtype)))


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


def cho_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve K x = B given K = L Lᵀ (``linalg.py:317-320``), batched over
    L's leading dims. B is a vector per matrix (one dim fewer than L) or a
    matrix of right-hand sides."""
    vec = B.ndim == L.ndim - 1
    Bm = B.unsqueeze(-1) if vec else B
    x = torch.linalg.solve_triangular(L.mT, torch.linalg.solve_triangular(L, Bm, upper=False),
                                      upper=True)
    return x.squeeze(-1) if vec else x


def tri_solve(L: torch.Tensor, B: torch.Tensor, lower: bool = True,
              trans: bool = False) -> torch.Tensor:
    """Solve op(L) x = B for triangular L, op(L) = Lᵀ if ``trans``
    (``linalg.py:323-325``), by the library triangular solve as in the JAX
    package, batched over L's leading dims. B is a vector per matrix (one
    dim fewer than L) or a matrix of right-hand sides."""
    A = L.mT if trans else L
    vec = B.ndim == L.ndim - 1
    x = torch.linalg.solve_triangular(A, B.unsqueeze(-1) if vec else B,
                                      upper=lower if trans else not lower)
    return x.squeeze(-1) if vec else x


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
