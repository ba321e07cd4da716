"""GP covariance kernels (counterpart of ``gpax_tpu/kernels/kernels.py``).

Every kernel has the signature ``k(X, Z, params, noise=0, jitter=None) ->
(…, n, m)``, with ``jitter=None`` meaning the config's ``default_jitter``
(1e-6 unless set), and adds ``noise + jitter`` to the diagonal only when
``X.shape == Z.shape`` (the reference's train/train rule, kept even where it
puts noise on a cross-covariance whose test set has the training set's
shape). Hyperparameters may carry leading batch dims (one set per posterior
draw), which predict uses to build a chunk of draws' grams at once.

RBF and Matérn-5/2 go through ``ops.gram.gram``: kernel K1 on a CUDA
tensor, its plain twin on a CPU tensor. The NNGP kernel waits for a later
slice.
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


def get_kernel(kernel: Union[str, kernel_fn_type] = "RBF", **kwargs) -> kernel_fn_type:
    """String registry; callables pass through unchanged."""
    registry = {"RBF": RBFKernel, "Matern": MaternKernel, "Periodic": PeriodicKernel}
    if isinstance(kernel, str):
        if kernel == "NNGP":
            raise NotImplementedError("the NNGP kernel is not ported yet")
        if kernel not in registry:
            raise KeyError(
                f"Unknown kernel '{kernel}'. Available: {sorted(registry)} "
                f"(or pass a callable with signature k(X, Z, params, noise, jitter)).")
        return registry[kernel]
    return kernel
