"""Fused gram for stationary GP covariances: kernel K1 and its plain twin.

Counterpart of ``gpax_tpu/ops/pallas_gram.py`` (renamed: the port has no
Pallas). The kernel (``gpax_torch/csrc/gram.cu``) computes, for pre-scaled
inputs, ``map(r²) + diag(noise_eff)`` with r² = ‖xs‖² − 2·xs·zs + ‖zs‖²;
:func:`gram` applies the output scale, folding the diagonal term through it
so that the result equals ``k_scale·map(r²) + (noise + jitter)·I``.

Dispatch is by device alone: :func:`gram_unscaled` launches K1 on a CUDA
tensor and uses the plain twin on a CPU tensor. The backward
(:class:`_Gram`) is closed-form matmul math in torch, as the JAX package
leaves it to XLA (``pallas_gram.py:204-245``).

The compensated (hi/lo split) cross term of the JAX package is not ported:
it returns when the H100 has measured 3xTF32 against fp32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..config import get_config
from . import build

_SQRT5 = math.sqrt(5.0)
_KINDS = {"rbf": 0, "matern52": 1}

launches = 0  # K1 launches in this process (the twin never counts)


def _map(r2: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "rbf":
        return torch.exp(-0.5 * r2)
    if kind == "matern52":
        s5r = _SQRT5 * torch.sqrt(torch.clamp(r2, min=1e-10))
        return (1.0 + s5r + (5.0 / 3.0) * r2) * torch.exp(-s5r)
    raise ValueError(kind)


def scaled_sq_dist(Xs: torch.Tensor, Zs: torch.Tensor) -> torch.Tensor:
    """max(‖xs‖² − 2·Xs·Zsᵀ + ‖zs‖², 0) over the last two dims (matmul form)."""
    x2 = (Xs * Xs).sum(-1)
    z2 = (Zs * Zs).sum(-1)
    cross = Xs @ Zs.mT
    return torch.clamp(x2[..., :, None] - 2.0 * cross + z2[..., None, :], min=0.0)


def gram_twin(Xs, Zs, noise_eff, kind: str = "rbf", add_noise: bool = True):
    """Plain PyTorch version of K1 (the formula of ``kernels.py:59-117``)."""
    k = _map(scaled_sq_dist(Xs, Zs), kind)
    if add_noise:
        k.diagonal(dim1=-2, dim2=-1).add_(noise_eff)
    return k


def gram_unscaled(Xs: torch.Tensor, Zs: torch.Tensor, noise_eff: torch.Tensor,
                  kind: str = "rbf", add_noise: bool = True) -> torch.Tensor:
    """``map(r²) + diag(noise_eff)`` for Xs (B, n, d), Zs (B, m, d) and
    noise_eff (B, n): K1 on a CUDA tensor, the twin on a CPU tensor."""
    if Xs.device.type == "cpu":
        return gram_twin(Xs, Zs, noise_eff, kind, add_noise)
    global launches
    if Xs.device.type != "cuda":
        raise ValueError(f"gram: unsupported device {Xs.device}")
    for name, t, nd in (("Xs", Xs, 3), ("Zs", Zs, 3), ("noise_eff", noise_eff, 2)):
        if t.device != Xs.device or t.dtype != torch.float32 or t.ndim != nd \
                or not t.is_contiguous():
            raise ValueError(f"gram: {name} must be a contiguous {nd}-D float32 "
                             f"tensor on {Xs.device}")
    B, n, d = Xs.shape
    m = Zs.shape[1]
    if Zs.shape != (B, m, d) or noise_eff.shape != (B, n):
        raise ValueError(f"gram: shapes {tuple(Xs.shape)}, {tuple(Zs.shape)}, "
                         f"{tuple(noise_eff.shape)} do not match")
    out = torch.empty((B, n, m), dtype=torch.float32, device=Xs.device)
    if out.numel() == 0:
        return out
    lib = build.library()
    err = lib.gpax_gram_f32(
        Xs.data_ptr(), Zs.data_ptr(), noise_eff.data_ptr(), out.data_ptr(),
        B, n, m, d, _KINDS[kind], int(add_noise),
        torch.cuda.current_stream(Xs.device).cuda_stream)
    build.check(err, "gram")
    launches += 1
    return out


class _Gram(torch.autograd.Function):
    """K1 forward with the closed-form backward of ``pallas_gram.py:204-245``:
    w = ḡ∘map'(r²), dXs = 2(rowsum(w)·Xs − w Zs), dZs = 2(colsum(w)·Zs − wᵀXs),
    dnoise_eff = diag(ḡ); map' = −½map for RBF, −(5/6)(1+√5r)e^(−√5r) for
    Matérn-5/2."""

    @staticmethod
    def forward(ctx, Xs, Zs, noise_eff, kind, add_noise, symmetric):
        ctx.save_for_backward(Xs, Zs)
        ctx.kind, ctx.add_noise, ctx.symmetric = kind, add_noise, symmetric
        return gram_unscaled(Xs, Zs, noise_eff, kind, add_noise)

    @staticmethod
    def backward(ctx, g):
        Xs, Zs = ctx.saved_tensors
        r2 = scaled_sq_dist(Xs, Zs)
        if ctx.kind == "rbf":
            dmap = -0.5 * torch.exp(-0.5 * r2)
        else:
            s5r = _SQRT5 * torch.sqrt(torch.clamp(r2, min=1e-10))
            dmap = torch.where(r2 > 1e-10,
                               -(5.0 / 6.0) * (1.0 + s5r) * torch.exp(-s5r), 0.0)
        w = g * dmap
        n = Xs.shape[-2]
        if ctx.symmetric:
            # X ≡ Z (the k_XX leapfrog case): Xs was passed twice, autograd sums
            # both cotangents, and the combined form costs one matmul:
            # dX = 2(rowsum(wₛ)·Xs − wₛXs), wₛ = w + wᵀ
            ws = w + w.mT
            dXs = 2.0 * (ws.sum(-1, keepdim=True) * Xs - ws @ Xs)
            dZs = None
        else:
            dXs = 2.0 * (w.sum(-1, keepdim=True) * Xs - w @ Zs)
            dZs = 2.0 * (w.sum(-2)[..., None] * Zs - w.mT @ Xs)
        if ctx.add_noise:
            dnoise = g.diagonal(dim1=-2, dim2=-1)
            dnoise = torch.nn.functional.pad(dnoise, (0, n - dnoise.shape[-1]))
        else:
            dnoise = None
        return dXs, dZs, dnoise, None, None, None


def gram(X: torch.Tensor, Z: torch.Tensor, k_length, k_scale, noise=0.0,
         kind: str = "rbf", jitter: Optional[float] = None) -> torch.Tensor:
    """Kernel-signature-compatible fused gram (``pallas_gram.py:251-305``).

    ``k_scale·map(‖(x−z)/ℓ‖²)`` with ``(noise + jitter)·I`` added when X and Z
    have the same shape (the reference diagonal rule); ``jitter`` defaults to
    the config's ``default_jitter``. Hyperparameters may
    carry leading batch dims (the shape of ``k_scale``; ``k_length`` is that
    plus ``(d,)``, ``noise`` that plus nothing or ``(n,)``), so a chunk of
    posterior draws is one K1 launch. X (…, n, d) and Z (…, m, d).
    """
    symmetric = X is Z
    ls = torch.as_tensor(k_length, dtype=X.dtype, device=X.device)
    ks = torch.as_tensor(k_scale, dtype=X.dtype, device=X.device)
    if ls.ndim:
        ls = ls.unsqueeze(-2)
    Xs = X / ls
    # alias the scaled operand when X ≡ Z so the symmetric backward applies
    Zs = Xs if symmetric else Z / ls
    add_noise = X.shape == Z.shape
    (n, d), m = X.shape[-2:], Z.shape[-2]
    batch = torch.broadcast_shapes(Xs.shape[:-2], Zs.shape[:-2], ks.shape)
    if add_noise:
        if jitter is None:
            jitter = get_config().default_jitter
        nz = torch.as_tensor(noise, dtype=X.dtype, device=X.device)
        if nz.ndim <= ks.ndim:
            nz = nz.unsqueeze(-1)  # one noise per draw, not per point
        noise_eff = (nz + jitter) / ks.unsqueeze(-1)
    else:
        noise_eff = torch.zeros((), dtype=X.dtype, device=X.device)
    noise_eff = noise_eff.expand(batch + (n,)).reshape(-1, n).contiguous()
    Xb = Xs.expand(batch + (n, d)).reshape(-1, n, d).contiguous()
    Zb = Xb if symmetric else Zs.expand(batch + (m, d)).reshape(-1, m, d).contiguous()
    k = _Gram.apply(Xb, Zb, noise_eff, kind, add_noise, symmetric)
    return ks[..., None, None] * k.reshape(batch + (n, m))
