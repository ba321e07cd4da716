"""Adapters for user-supplied mean and kernel functions (counterpart of
``gpax_tpu/utils/fn.py``), as plain closures without ``exec``:

* ``set_fn(f)``: ``f(x, a, b, ...)`` -> ``g(x, params)`` reading
  ``params['a']``, ...;
* ``set_kernel_fn(f)``: ``f(X, Z, h1, h2, ...)`` -> ``k(X, Z, params,
  noise=0, jitter=1e-6, **kw)``, adding (noise + jitter)·I when
  ``X.shape == Z.shape`` (the kernel contract of ``kernels.py``);
* ``_set_noise_kernel_fn(k)``: a kernel that reads the ``k_noise_*``
  hyperparameters where ``k`` reads ``k_*`` (VarNoiseGP's noise kernel).
"""

from __future__ import annotations

import inspect
from functools import wraps
from typing import Callable, List, Optional

import torch

__all__ = ["set_fn", "set_kernel_fn", "_set_noise_kernel_fn"]


def set_fn(func: Callable) -> Callable:
    """Convert ``f(x, a, b)`` into ``f(x, params)`` reading a/b from the dict."""
    param_names = list(inspect.signature(func).parameters.keys())[1:]

    @wraps(func)
    def wrapped(x, params):
        return func(x, *(params[name] for name in param_names))

    return wrapped


def set_kernel_fn(func: Callable, independent_vars: List[str] = ["X", "Z"],
                  jit_decorator: bool = True, docstring: Optional[str] = None) -> Callable:
    """Convert a plain kernel ``f(X, Z, h1, h2, ...)`` into the kernel
    signature, adding the diagonal noise. ``jit_decorator`` is accepted for
    the JAX package's signature and has nothing to do here."""
    sig = inspect.signature(func)
    hyper_names = [k for k, v in sig.parameters.items()
                   if v.default is inspect.Parameter.empty and k not in independent_vars]

    def kernel_fn(X, Z, params, noise=0, jitter: float = 1e-6, **kwargs):
        k = func(X, Z, *(params[name] for name in hyper_names))
        if X.shape == Z.shape:
            k = k + torch.diag_embed(torch.as_tensor(noise + jitter, dtype=k.dtype,
                                                     device=k.device).expand(k.shape[:-1]))
        return k

    kernel_fn.__name__ = func.__name__
    kernel_fn.__qualname__ = func.__name__
    if docstring:
        kernel_fn.__doc__ = docstring
    return kernel_fn


def _set_noise_kernel_fn(func: Callable) -> Callable:
    """A kernel that reads 'k_noise_*' keys where ``func`` reads 'k_*'."""

    @wraps(func)
    def noise_kernel_fn(X, Z, params, noise=0, jitter=1e-6, **kwargs):
        remapped = {}
        for key, val in params.items():
            if key.startswith("k_noise_"):
                remapped["k_" + key[len("k_noise_"):]] = val
            else:
                remapped.setdefault(key, val)
        return func(X, Z, remapped, noise, jitter, **kwargs)

    noise_kernel_fn.__name__ = getattr(func, "__name__", "kernel") + "_noise"
    return noise_kernel_fn
