"""GP covariance kernels (counterpart of ``gpax_tpu/kernels/kernels.py``).

Every kernel has the signature ``k(X, Z, params, noise=0, jitter=None) ->
(…, n, m)``, with ``jitter=None`` meaning the config's ``default_jitter``
(1e-6 unless set), and adds ``noise + jitter`` to the diagonal only when
``X.shape == Z.shape`` (the reference's train/train rule, kept even where it
puts noise on a cross-covariance whose test set has the training set's
shape). Hyperparameters may carry leading batch dims (one set per posterior
draw), which predict uses to build a chunk of draws' grams at once.

RBF and Matérn-5/2 go through ``ops.gram.gram``: kernel K1 on a CUDA
tensor, its plain twin on a CPU tensor. The NNGP kernel is plain torch, as
the JAX package's is plain jnp (``kernels.py:133-217``): ``depth`` matrix
updates of the infinite-width recursion.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Union

import torch

from ..config import get_config
from ..ops.gram import gram, scaled_sq_dist

kernel_fn_type = Callable[..., torch.Tensor]


def _lengthscale(ls, like: torch.Tensor) -> torch.Tensor:
    ls = torch.as_tensor(ls, dtype=like.dtype, device=like.device)
    return ls.unsqueeze(-2) if ls.ndim else ls


def _add_diag_noise(k, X, Z, noise, jitter, batch_ndim: int = 0):
    """Noise lands on the diagonal only for same-shaped inputs. ``noise`` has
    the hyperparameters' batch shape (``batch_ndim`` dims), optionally
    followed by (n,)."""
    if X.shape != Z.shape:
        return k
    if jitter is None:
        jitter = get_config().default_jitter
    nz = torch.as_tensor(noise, dtype=k.dtype, device=k.device)
    if nz.ndim <= batch_ndim:
        nz = nz.unsqueeze(-1)  # one noise per draw, not per point
    return k + torch.diag_embed((nz + jitter).expand(k.shape[:-1]))


def square_scaled_distance(X: torch.Tensor, Z: torch.Tensor,
                           lengthscale: Union[torch.Tensor, float] = 1.0) -> torch.Tensor:
    """‖(x − z)/ℓ‖² for all pairs, in matmul form, clipped at 0 (fp32
    matmuls: the config pins TF32 off)."""
    ls = _lengthscale(lengthscale, X)
    return scaled_sq_dist(X / ls, Z / ls)


def RBFKernel(X: torch.Tensor, Z: torch.Tensor, params: Dict[str, torch.Tensor],
              noise=0, jitter: Optional[float] = None, **kwargs) -> torch.Tensor:
    """Squared-exponential kernel with ARD lengthscales ('k_length') and
    output scale ('k_scale')."""
    return gram(X, Z, params["k_length"], params["k_scale"], noise,
                kind="rbf", jitter=jitter)


def MaternKernel(X: torch.Tensor, Z: torch.Tensor, params: Dict[str, torch.Tensor],
                 noise=0, jitter: Optional[float] = None, **kwargs) -> torch.Tensor:
    """Matérn-5/2 kernel, with r = sqrt(max(r², 1e-10)): identical values off
    the diagonal to the reference's sqrt(r² + eps), and an exactly-zero
    gradient below the floor instead of fp32 rounding noise amplified by
    0.5/sqrt(eps)."""
    return gram(X, Z, params["k_length"], params["k_scale"], noise,
                kind="matern52", jitter=jitter)


def PeriodicKernel(X: torch.Tensor, Z: torch.Tensor, params: Dict[str, torch.Tensor],
                   noise=0, jitter: Optional[float] = None, **kwargs) -> torch.Tensor:
    """Exp-sine-squared kernel with 'period'; materializes (…, n, m, d)."""
    diff = X.unsqueeze(-2) - Z.unsqueeze(-3)
    period = torch.as_tensor(params["period"], dtype=X.dtype, device=X.device)
    ls = torch.as_tensor(params["k_length"], dtype=X.dtype, device=X.device)
    ks = torch.as_tensor(params["k_scale"], dtype=X.dtype, device=X.device)
    s = torch.sin(math.pi * diff / period[..., None, None, None]) \
        / (ls[..., None, None, :] if ls.ndim else ls)
    k = ks[..., None, None] * torch.exp(-2.0 * (s * s).sum(-1))
    return _add_diag_noise(k, X, Z, noise, jitter, ks.ndim)


# ---------------------------------------------------------------------------
# NNGP (infinite-width network) kernel: matrix-level recursion
# ---------------------------------------------------------------------------

def _hyper(v, like: torch.Tensor, trailing: int) -> torch.Tensor:
    """A hyperparameter with leading batch dims, followed by ``trailing``
    unit dims to broadcast over a matrix (2) or a vector (1)."""
    v = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    return v.reshape(v.shape + (1,) * trailing)


def _nngp_base(X, Z, var_b, var_w):
    d = X.shape[-1]
    return _hyper(var_b, X, 2) + _hyper(var_w, X, 2) * (X @ Z.mT) / d


def _nngp_base_diag(X, var_b, var_w):
    d = X.shape[-1]
    return _hyper(var_b, X, 1) + _hyper(var_w, X, 1) * (X * X).sum(-1) / d


def _nngp_erf_layer(K, kx, kz, var_b, var_w):
    """One erf-activation layer for the cross gram K (…, n, m) and the
    self-variances kx (…, n), kz (…, m) (``kernels.py:146-162``)."""
    eps = 1e-7
    denom = torch.sqrt((1.0 + 2.0 * kx)[..., :, None] * (1.0 + 2.0 * kz)[..., None, :])
    frac = torch.clamp(2.0 * K / denom, -1.0 + eps, 1.0 - eps)
    K_new = _hyper(var_b, K, 2) + (2.0 * _hyper(var_w, K, 2) / math.pi) * torch.arcsin(frac)

    def diag_update(kv):
        fr = torch.clamp(2.0 * kv / (1.0 + 2.0 * kv), -1.0 + eps, 1.0 - eps)
        return _hyper(var_b, kv, 1) + (2.0 * _hyper(var_w, kv, 1) / math.pi) * torch.arcsin(fr)

    return K_new, diag_update(kx), diag_update(kz)


def _nngp_relu_layer(K, kx, kz, var_b, var_w):
    """One ReLU (arc-cosine) layer (``kernels.py:165-181``)."""
    eps = 1e-7
    sq = torch.sqrt(kx[..., :, None] * kz[..., None, :])
    frac = torch.clamp(K / sq, -1.0 + eps, 1.0 - eps)
    theta = torch.arccos(frac)
    K_new = _hyper(var_b, K, 2) + _hyper(var_w, K, 2) / (2.0 * math.pi) * sq * (
        torch.sin(theta) + (math.pi - theta) * frac)

    def diag_update(kv):
        # theta = arccos(clip(1)) -> arccos(1 - eps): the clipped scalar path
        fr = torch.clamp(torch.ones_like(kv), -1.0 + eps, 1.0 - eps)
        th = torch.arccos(fr)
        return _hyper(var_b, kv, 1) + _hyper(var_w, kv, 1) / (2.0 * math.pi) * kv * (
            torch.sin(th) + (math.pi - th) * fr)

    return K_new, diag_update(kx), diag_update(kz)


def _nngp_pair(layer, x1, x2, var_b, var_w, depth):
    x1, x2 = torch.as_tensor(x1), torch.as_tensor(x2)
    K = _nngp_base(x1[None], x2[None], var_b, var_w)
    kx = _nngp_base_diag(x1[None], var_b, var_w)
    kz = _nngp_base_diag(x2[None], var_b, var_w)
    for _ in range(depth):
        K, kx, kz = layer(K, kx, kz, var_b, var_w)
    return K[..., 0, 0]


def nngp_erf(x1, x2, var_b, var_w, depth: int = 3):
    """Single-pair NNGP value (erf)."""
    return _nngp_pair(_nngp_erf_layer, x1, x2, var_b, var_w, depth)


def nngp_relu(x1, x2, var_b, var_w, depth: int = 3):
    """Single-pair NNGP value (relu)."""
    return _nngp_pair(_nngp_relu_layer, x1, x2, var_b, var_w, depth)


def NNGPKernel(activation: str = "erf", depth: int = 3) -> kernel_fn_type:
    """Infinite-width-network kernel factory (params 'var_b', 'var_w', which
    may carry leading batch dims): ``depth`` matrix updates of the gram."""
    layer = _nngp_relu_layer if activation == "relu" else _nngp_erf_layer

    def nngp_kernel_fn(X, Z, params, noise=0, jitter: Optional[float] = None, **kwargs):
        var_b, var_w = params["var_b"], params["var_w"]
        K = _nngp_base(X, Z, var_b, var_w)
        kx = _nngp_base_diag(X, var_b, var_w)
        kz = _nngp_base_diag(Z, var_b, var_w)
        for _ in range(depth):
            K, kx, kz = layer(K, kx, kz, var_b, var_w)
        return _add_diag_noise(K, X, Z, noise, jitter, torch.as_tensor(var_b).ndim)

    return nngp_kernel_fn


def get_kernel(kernel: Union[str, kernel_fn_type] = "RBF", **kwargs) -> kernel_fn_type:
    """String registry; callables pass through unchanged. ``kwargs`` go to
    the NNGP kernel's factory (``activation``, ``depth``)."""
    registry = {"RBF": RBFKernel, "Matern": MaternKernel, "Periodic": PeriodicKernel,
                "NNGP": NNGPKernel(**kwargs)}
    if isinstance(kernel, str):
        if kernel not in registry:
            raise KeyError(
                f"Unknown kernel '{kernel}'. Available: {sorted(registry)} "
                f"(or pass a callable with signature k(X, Z, params, noise, jitter)).")
        return registry[kernel]
    return kernel
