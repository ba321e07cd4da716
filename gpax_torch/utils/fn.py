"""Adapters for user-supplied mean and kernel functions (counterpart of
``gpax_tpu/utils/fn.py``), as plain closures without ``exec``:

* ``set_fn(f)``: ``f(x, a, b, ...)`` -> ``g(x, params)`` reading
  ``params['a']``, ...;
* ``set_kernel_fn(f)``: ``f(X, Z, h1, h2, ...)`` -> ``k(X, Z, params,
  noise=0, jitter=1e-6, **kw)``, adding (noise + jitter)·I when
  ``X.shape == Z.shape`` (the kernel contract of ``kernels.py``);
* ``_set_noise_kernel_fn(k)``: a kernel that reads the ``k_noise_*``
  hyperparameters where ``k`` reads ``k_*`` (VarNoiseGP's noise kernel);
* ``call_batched(fn, X, params, batch_ndim)``: a user function written for
  one draw of its parameters, called on a batch of draws.
"""

from __future__ import annotations

import inspect
from functools import wraps
from typing import Callable, Dict, List, Optional

import torch

__all__ = ["set_fn", "set_kernel_fn", "_set_noise_kernel_fn", "call_batched"]


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


def call_batched(fn: Callable, X: torch.Tensor, params: Optional[Dict] = None,
                 batch_ndim: int = 0, x_batched: bool = False,
                 squeeze: bool = False) -> torch.Tensor:
    """``fn(X, params)`` (``fn(X)`` when ``params`` is None) for a user
    function written for one draw, when the draws carry ``batch_ndim``
    leading batch dims: lockstep chains (C,), a chunk of predictive draws
    (S,), or both. The JAX package vmaps such a function; so does this,
    with ``torch.func.vmap`` once per batch dim, ``X`` shared unless
    ``x_batched`` (a sampled X, such as UIGP's X', carries the same dims),
    and gradients flow to each draw's parameters. A function that vmap
    cannot run (a ``.item()``, control flow on data) is called draw by
    draw and stacked. ``squeeze`` drops each draw's unit dims, as the
    models' ``.squeeze()`` of one draw's mean does. With ``batch_ndim`` 0
    it is the plain call."""
    if batch_ndim == 0:
        out = fn(X) if params is None else fn(X, params)
        return out.squeeze() if squeeze else out
    call = (lambda x, p: fn(x)) if params is None else fn
    params = {} if params is None else params
    f = call
    dims = (0 if x_batched else None,
            {k: (0 if torch.is_tensor(v) else None) for k, v in params.items()})
    for _ in range(batch_ndim):
        f = torch.func.vmap(f, in_dims=dims)
    try:
        out = f(X, params)
    except RuntimeError:  # vmap's refusal; a real fault raises again in the loop
        out = _loop(call, X, params, batch_ndim, x_batched)
    if squeeze:
        lead = tuple(out.shape[:batch_ndim])
        out = out.reshape(lead + tuple(s for s in out.shape[batch_ndim:] if s != 1))
    return out


def _loop(call: Callable, X, params: Dict, batch_ndim: int, x_batched: bool):
    """``call`` draw by draw over the leading batch dim, stacked."""
    leaves = [v for v in params.values() if torch.is_tensor(v)]
    size = leaves[0].shape[0] if leaves else X.shape[0]
    outs = []
    for i in range(size):
        p = {k: (v[i] if torch.is_tensor(v) else v) for k, v in params.items()}
        x = X[i] if x_batched else X
        outs.append(call(x, p) if batch_ndim == 1 else
                    _loop(call, x, p, batch_ndim - 1, x_batched))
    return torch.stack(outs)
