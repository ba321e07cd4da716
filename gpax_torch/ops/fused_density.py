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

Precision: W, α, β, WᵀW, C and the map chain after it are float64, the
port's one ``wtw_precision`` (``"float64"``, see ``ops/linalg.py``), where
the JAX backward forms WᵀW with ``wtw_compensated`` in float32. This is the
departure the composed route's ``_MVNLogProb`` already makes, not a new one.
"""

from __future__ import annotations

import torch

from . import gram as _gram
from .gram import _maps
from .linalg import _LOG_2PI, _chol_tri_factors_ld


def _unbroadcast(x: torch.Tensor, shape) -> torch.Tensor:
    """Reduce a gradient to the (possibly broadcast) primal shape
    (``fused_density.py:43-51``)."""
    shape = tuple(shape)
    if tuple(x.shape) == shape:
        return x
    if len(shape) == 0:
        return x.sum()
    if shape[0] == 1 and x.shape[0] != 1:
        return x.sum().reshape(shape)
    return x.reshape(shape)


def _guard(x: torch.Tensor, ok: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """x where finite and the factorization succeeded, else zero, in like's
    dtype."""
    return torch.where(torch.isfinite(x), ok * x, 0.0).to(like.dtype)


class _GPMVNLogProb(torch.autograd.Function):
    @staticmethod
    def forward(ctx, X, k_length, k_scale, noise_eff, diff, kind):
        n = X.shape[0]
        Xs = (X / k_length).to(torch.float32).contiguous()
        noise_vec = noise_eff.to(torch.float32).expand(n).contiguous()
        # m = map(r²) kept for the backward: for RBF, dm = −m/2 needs no
        # gram recompute
        m = _gram.gram_unscaled(Xs[None], Xs[None], noise_vec[None], kind, False)[0]
        K = k_scale.to(torch.float32) * m
        K.diagonal().add_(noise_vec)
        # K carries the θ-independent base regularization through noise_eff
        # (this op's contract), so no base jitter is added again
        _, W, logdet = _chol_tri_factors_ld(K, None)
        del K
        alpha = W @ diff.to(W.dtype)
        ctx.save_for_backward(Xs, W, alpha, m, k_length, k_scale, noise_eff, diff)
        ctx.kind = kind
        ctx.x_meta = (X.shape, X.dtype)
        lp = -0.5 * ((alpha * alpha).sum() + n * _LOG_2PI) - logdet
        return lp.to(X.dtype)

    @staticmethod
    def backward(ctx, g):
        Xs, W, alpha, m, k_length, k_scale, noise_eff, diff = ctx.saved_tensors
        g = g.to(W.dtype)
        # a factorization that failed even after escalation gives zero, not
        # NaN, gradients; the guard is applied to the small outputs only
        ok = torch.isfinite(alpha.sum()).to(W.dtype)
        beta = W.mT @ alpha
        # every output is linear in C = ½g·D, D = ββᵀ − WᵀW, so D is formed
        # in place over WᵀW and ½g scales the small outputs
        D = (W.mT @ W).addr_(beta, beta, beta=-1.0)
        half_g, ks = 0.5 * g, k_scale.to(W.dtype)
        # diag(K) = k_scale·map(0) + noise_eff: k_scale's cotangent includes
        # the diagonal map term (m = 1 there, so in D∘m below); noise_eff's
        # is diag(C) alone
        dnoise_eff = half_g * D.diagonal()
        Xs64 = Xs.to(W.dtype)
        ones = Xs64.new_ones((Xs.shape[0], 1))
        if ctx.kind == "rbf":
            # map' = −m/2, so wₛ = 2·C∘k_scale·map' = −½g·k_scale·(D∘m): one
            # product D∘m serves dk_scale and dXs
            Dm = D * m
            del D
            P = Dm @ torch.cat([Xs64, ones], 1)  # (D∘m)·Xs and the row sums
            dk_scale = half_g * P[:, -1].sum()
            w_scale = -half_g * ks
        else:
            _, dm = _maps(_gram.scaled_sq_dist(Xs, Xs), ctx.kind)
            dk_scale = half_g * (D * m).sum()
            P = (D * dm) @ torch.cat([Xs64, ones], 1)
            w_scale = g * ks
        # C and map' are symmetric, so the symmetrized weight is just 2w and
        # dXs = 2(rowsum(wₛ)∘Xs − wₛXs) with wₛ = w_scale·(D∘map' or D∘m)
        dXs = 2.0 * w_scale * (P[:, -1:] * Xs64 - P[:, :-1])
        ls = k_length.to(W.dtype)
        if ls.ndim:
            dk_length = -(dXs * Xs64).sum(0) / ls.reshape(-1)
        else:
            dk_length = -(dXs * Xs64).sum() / ls
        ddiff = -g * beta
        X_shape, X_dtype = ctx.x_meta
        dX = torch.zeros(X_shape, dtype=X_dtype, device=Xs.device) \
            if ctx.needs_input_grad[0] else None
        return (dX,
                _guard(_unbroadcast(dk_length, k_length.shape), ok, k_length),
                _guard(_unbroadcast(dk_scale, k_scale.shape), ok, k_scale),
                _guard(_unbroadcast(dnoise_eff, noise_eff.shape), ok, noise_eff),
                _guard(ddiff, ok, diff),
                None)


def gp_mvn_log_prob(X: torch.Tensor, k_length: torch.Tensor, k_scale: torch.Tensor,
                    noise_eff: torch.Tensor, diff: torch.Tensor,
                    kind: str = "rbf") -> torch.Tensor:
    """log N(diff | 0, k_scale·map(‖(x−x')/ℓ‖²) + diag(noise_eff)) with
    closed-form parameter gradients (``fused_density.py:69-153``). X (n, d)
    is constant data: its cotangent is zero. ``noise_eff`` (scalar or (n,))
    must already hold the observation noise, the jitter and the
    θ-independent base regularization 4·n·eps(float32). ``kind`` is
    ``"rbf"`` or ``"matern52"``."""
    return _GPMVNLogProb.apply(X, torch.as_tensor(k_length, dtype=X.dtype, device=X.device),
                               torch.as_tensor(k_scale, dtype=X.dtype, device=X.device),
                               torch.as_tensor(noise_eff, dtype=X.dtype, device=X.device),
                               diff, kind)
