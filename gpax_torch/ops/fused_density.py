"""Fused GP marginal likelihood: gram → Cholesky → MVN density as one
``autograd.Function`` with closed-form hyperparameter gradients.

Counterpart of ``gpax_tpu/ops/fused_density.py``. The composed route
(``kernels`` → ``MultivariateNormal`` → ``linalg.mvn_log_prob_centered``)
chains two autograd nodes and materializes the K-cotangent between them;
here the backward goes straight from the density to the parameters:

    β  = Wᵀα,            C = ½·g·(ββᵀ − WᵀW)          (cotangent w.r.t. K)
    wₛ = 2·C ∘ k_scale ∘ map'(r²)                       (C and map' symmetric)
    ∂ℓ/∂k_length_a = −Σᵢ dXsᵢₐ·Xsᵢₐ / ℓₐ,   dXs = 2(rowsum(wₛ)∘Xs − wₛXs)
    ∂ℓ/∂k_scale    = Σ C ∘ map(r²)
    ∂ℓ/∂noise_eff  = diag(C),      ∂ℓ/∂diff = −g·β

The forward runs kernel K1 (``ops.gram.gram_unscaled`` without the noise
term) for m = map(r²), K = k_scale·m + diag(noise_eff) in float32, and the
factor path of ``ops.linalg._chol_tri_factors_ld(K, None)``: the library
Cholesky in float64 and ``blocked_trtri`` on kernel K2. It keeps m, W and α
for the backward; for RBF map' = −m/2 needs no recompute, Matérn-5/2
recomputes r².

Precision: W, α, β, C and the map chain after it are float64, as in the
composed route's ``_MVNLogProb``; WᵀW takes the config's
``wtw_precision`` through ``linalg.wtw_compensated`` (float64 by default),
as the JAX backward does (``fused_density.py:111-117``), never as a
symmetric consumer: C must be symmetric here. The gram stays
``"highest"`` whatever ``gram_precision`` says, as the JAX fused op calls
its Pallas gram without a precision.
"""

from __future__ import annotations

import math

import torch

from . import gram as _gram
from .gram import _maps
from .linalg import _LOG_2PI, _chol_tri_factors_ld, _unbroadcast, wtw_compensated


def _guard(x: torch.Tensor, ok: torch.Tensor, batch, like: torch.Tensor) -> torch.Tensor:
    """x (P, …) where finite and the matrix's factorization succeeded (ok,
    (P,)), else zero, reduced to like's shape and dtype."""
    x = torch.where(torch.isfinite(x), ok.reshape(ok.shape + (1,) * (x.ndim - 1)) * x, 0.0)
    return _unbroadcast(x.reshape(tuple(batch) + x.shape[1:]), like.shape).to(like.dtype)


class _GPMVNLogProb(torch.autograd.Function):
    """Inputs: X (n, d); k_length (…, d or 1), k_scale (…), noise_eff
    (…, n or 1) and diff (…, n), whose leading dims broadcast to ``batch``."""

    @staticmethod
    def forward(ctx, X, k_length, k_scale, noise_eff, diff, kind, batch):
        n, P = X.shape[0], math.prod(batch)
        ls = k_length.expand(batch + k_length.shape[-1:]).reshape(P, 1, -1)
        Xs = (X / ls).to(torch.float32).contiguous()                 # (P, n, d)
        noise_vec = noise_eff.to(torch.float32).expand(batch + (n,)).reshape(P, n).contiguous()
        ks = k_scale.expand(batch).reshape(P)
        # m = map(r²) kept for the backward: for RBF, dm = −m/2 needs no
        # gram recompute. One K1 launch and one factorization for the batch
        m = _gram.gram_unscaled(Xs, Xs, noise_vec, kind, False)
        K = ks.to(torch.float32)[:, None, None] * m
        K.diagonal(dim1=-2, dim2=-1).add_(noise_vec)
        # K carries the θ-independent base regularization through noise_eff
        # (this op's contract), so no base jitter is added again
        _, W, logdet = _chol_tri_factors_ld(K, None)
        del K
        alpha = (W @ diff.to(W.dtype).expand(batch + (n,)).reshape(P, n, 1))[..., 0]
        ctx.save_for_backward(Xs, W, alpha, m, ls, ks, k_length, k_scale, noise_eff, diff)
        ctx.kind, ctx.batch = kind, batch
        ctx.x_meta = (X.shape, X.dtype)
        lp = -0.5 * ((alpha * alpha).sum(-1) + n * _LOG_2PI) - logdet
        return lp.to(X.dtype).reshape(batch)

    @staticmethod
    def backward(ctx, g):
        Xs, W, alpha, m, ls, ks, k_length, k_scale, noise_eff, diff = ctx.saved_tensors
        batch = ctx.batch
        g = g.to(W.dtype).reshape(-1)                                # (P,)
        # a factorization that failed even after escalation gives zero, not
        # NaN, gradients, matrix by matrix; the guard is applied to the
        # small outputs only
        ok = torch.isfinite(alpha.sum(-1)).to(W.dtype)
        beta = (W.mT @ alpha[..., None])[..., 0]
        # every output is linear in C = ½g·D, D = ββᵀ − WᵀW, so D is formed
        # in place over WᵀW and ½g scales the small outputs
        D = wtw_compensated(W).baddbmm_(beta[..., :, None], beta[..., None, :], beta=-1.0)
        half_g, ks = 0.5 * g, ks.to(W.dtype)
        # diag(K) = k_scale·map(0) + noise_eff: k_scale's cotangent includes
        # the diagonal map term (m = 1 there, so in D∘m below); noise_eff's
        # is diag(C) alone
        dnoise_eff = half_g[:, None] * D.diagonal(dim1=-2, dim2=-1)
        Xs64 = Xs.to(W.dtype)
        Xs1 = torch.cat([Xs64, Xs64.new_ones(Xs.shape[:-1] + (1,))], -1)
        if ctx.kind == "rbf":
            # map' = −m/2, so wₛ = 2·C∘k_scale·map' = −½g·k_scale·(D∘m): one
            # product D∘m serves dk_scale and dXs
            Pm = D.mul_(m) @ Xs1  # (D∘m)·Xs and the row sums
            dk_scale = half_g * Pm[..., -1].sum(-1)
            w_scale = -half_g * ks
        else:
            _, dm = _maps(_gram.scaled_sq_dist(Xs, Xs), ctx.kind)
            dk_scale = half_g * (D * m).sum((-2, -1))
            Pm = D.mul_(dm) @ Xs1
            w_scale = g * ks
        del D
        # C and map' are symmetric, so the symmetrized weight is just 2w and
        # dXs = 2(rowsum(wₛ)∘Xs − wₛXs) with wₛ = w_scale·(D∘map' or D∘m)
        dXs = 2.0 * w_scale[:, None, None] * (Pm[..., -1:] * Xs64 - Pm[..., :-1])
        dls = -(dXs * Xs64).sum(-2) / ls[:, 0].to(W.dtype)           # (P, d)
        X_shape, X_dtype = ctx.x_meta
        dX = torch.zeros(X_shape, dtype=X_dtype, device=Xs.device) \
            if ctx.needs_input_grad[0] else None
        return (dX,
                _guard(dls, ok, batch, k_length),
                _guard(dk_scale, ok, batch, k_scale),
                _guard(dnoise_eff, ok, batch, noise_eff),
                _guard(-g[:, None] * beta, ok, batch, diff),
                None, None)


def gp_mvn_log_prob(X: torch.Tensor, k_length: torch.Tensor, k_scale: torch.Tensor,
                    noise_eff: torch.Tensor, diff: torch.Tensor,
                    kind: str = "rbf") -> torch.Tensor:
    """log N(diff | 0, k_scale·map(‖(x−x')/ℓ‖²) + diag(noise_eff)) with
    closed-form parameter gradients (``fused_density.py:69-153``). X (n, d)
    is constant data: its cotangent is zero. ``noise_eff`` (per matrix or
    per point) must already hold the observation noise, the jitter and the
    θ-independent base regularization 4·n·eps(float32). ``kind`` is
    ``"rbf"`` or ``"matern52"``.

    The hyperparameters may carry leading batch dims, the shape of
    ``k_scale`` (one set per chain of lockstep NUTS): ``k_length`` is that
    plus (d,) or nothing, ``noise_eff`` that plus (n,) or nothing, ``diff``
    (n,) or that plus (n,). The result has the batch shape, each matrix's
    own density, from one K1 launch, one batched factorization and one K2
    launch."""
    k_length, k_scale, noise_eff = (torch.as_tensor(v, dtype=X.dtype, device=X.device)
                                    for v in (k_length, k_scale, noise_eff))
    nb = k_scale.ndim
    n, d = X.shape
    k_length = k_length.unsqueeze(-1) if k_length.ndim == nb and not (
        nb == 0 and k_length.shape == (d,)) else k_length
    noise_eff = noise_eff.unsqueeze(-1) if noise_eff.ndim == nb else noise_eff
    batch = torch.broadcast_shapes(k_scale.shape, k_length.shape[:-1], noise_eff.shape[:-1],
                                   diff.shape[:-1])
    return _GPMVNLogProb.apply(X, k_length, k_scale, noise_eff, diff, kind, tuple(batch))
