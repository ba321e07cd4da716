"""Functional NN modules with nested-dict parameters (counterpart of
``gpax_tpu/nn/modules.py``).

A module is an object with ``init(generator, x) -> params`` and
``apply(params, x) -> out``; params are nested dicts of tensors in the JAX
package's layout, ``{"linear_i": {"w": (d_in, d_out), "b": (d_out,)}}`` and
HWIO conv weights, so weights cross between the packages with no
transposes. The modules are not ``torch.nn.Module`` subclasses: their
parameters live in the dict a caller hands to ``apply`` (a guide's, an
optimizer's, a posterior draw's), and ``torch.nn.Module.apply`` means
something else.

Every parameter may carry leading batch dims, one set of weights per model
of an ensemble or per channel: ``apply`` then returns ``(B, n, out)``, each
model's output on the same x, in one batched matmul (or grouped
convolution) a layer.

Integration with the PPL:
  * ``random_module(name, module, input_shape)`` registers every weight leaf
    as a latent site (Normal(0, 1) weights, Cauchy(0, 1) biases);
  * ``module_param(name, module, input_shape)`` registers the whole param
    tree as one optimizable ``param`` site (MLE).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import distributions as dist
from .. import ppl

_PROTO_SEED = 0  # the prototype's generator: JAX's PRNGKey(0)


class Module:
    """Functional module: subclasses define ``init`` and ``apply``."""

    def init(self, generator: torch.Generator, x: torch.Tensor):
        raise NotImplementedError

    def apply(self, params, x: torch.Tensor):
        raise NotImplementedError


class FunctionalModule(Module):
    """Adapter wrapping a plain ``(init_fn, apply_fn)`` pair as a Module, so
    any user network plugs into viDKL/viMTDKL without subclassing:
    ``init_fn(generator, x) -> params`` (a nested dict of tensors),
    ``apply_fn(params, x) -> (n, z_dim)``."""

    def __init__(self, init_fn: Callable, apply_fn: Callable):
        self._init_fn = init_fn
        self._apply_fn = apply_fn

    def init(self, generator, x):
        return self._init_fn(generator, x)

    def apply(self, params, x):
        return self._apply_fn(params, x)


def as_module(nn) -> Module:
    """A Module as given, an ``(init, apply)`` pair, or any object with
    ``.init``/``.apply`` callables, wrapped in a :class:`FunctionalModule`."""
    if isinstance(nn, Module):
        return nn
    if isinstance(nn, (tuple, list)) and len(nn) == 2 and all(callable(f) for f in nn):
        return FunctionalModule(*nn)
    if callable(getattr(nn, "init", None)) and callable(getattr(nn, "apply", None)):
        return FunctionalModule(nn.init, nn.apply)
    raise TypeError(
        "nn must be a Module, an (init_fn, apply_fn) pair, or an object with "
        f".init/.apply callables; got {type(nn)!r}")


def _trunc_normal(generator, shape, scale: float) -> torch.Tensor:
    w = torch.empty(shape)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return scale * w


def _linear_init(generator, d_in: int, d_out: int) -> Dict[str, torch.Tensor]:
    return {"w": _trunc_normal(generator, (d_in, d_out), 1.0 / math.sqrt(d_in)),
            "b": torch.zeros(d_out)}


def dense(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h·w + b; w (…, d_in, d_out) and b (…, d_out) may carry batch dims,
    which lead the output."""
    if w.ndim == 2:
        return F.linear(h, w.mT, b)
    return torch.matmul(h, w) + b.unsqueeze(-2)


class MLP(Module):
    """Dense feature extractor: hidden ReLU layers and a linear head, 64-64-z
    by default; inputs are flattened to (n, -1)."""

    def __init__(self, embedim: int = 2, hidden_dim: Sequence[int] = (64, 64),
                 activation: Callable = torch.relu):
        self.embedim = embedim
        self.hidden_dim = tuple(hidden_dim)
        self.activation = activation

    def _dims(self, d_in: int) -> List[Tuple[int, int]]:
        dims = [d_in, *self.hidden_dim, self.embedim]
        return list(zip(dims[:-1], dims[1:]))

    def init(self, generator, x):
        d_in = x.reshape(x.shape[0], -1).shape[-1]
        return {f"linear_{i}": _linear_init(generator, a, b)
                for i, (a, b) in enumerate(self._dims(d_in))}

    def apply(self, params, x):
        h = x.reshape(x.shape[0], -1)
        n = len(params)
        for i in range(n):
            p = params[f"linear_{i}"]
            h = dense(h, p["w"], p["b"])
            if i < n - 1:
                h = self.activation(h)
        return h


class ConvNet(Module):
    """Small conv feature extractor for image patches: per entry of
    ``channels`` a 3×3 SAME convolution, ReLU and a 2×2 VALID max-pool, then
    a dense ReLU layer and a linear head. Inputs are NHWC, (n, H, W, C) or
    (n, H, W)."""

    def __init__(self, embedim: int = 2, channels: Sequence[int] = (8, 16),
                 dense_dim: int = 64, activation: Callable = torch.relu):
        self.embedim = embedim
        self.channels = tuple(channels)
        self.dense_dim = dense_dim
        self.activation = activation

    def init(self, generator, x):
        x = x if x.ndim == 4 else x[..., None]
        params = {}
        c_in = x.shape[-1]
        for i, c_out in enumerate(self.channels):
            params[f"conv_{i}"] = {
                "w": _trunc_normal(generator, (3, 3, c_in, c_out), 1.0 / math.sqrt(9 * c_in)),
                "b": torch.zeros(c_out)}
            c_in = c_out
        d_flat = self._forward_convs(params, x.to(torch.get_default_dtype())).shape[-1]
        params["dense_0"] = _linear_init(generator, d_flat, self.dense_dim)
        params["head"] = _linear_init(generator, self.dense_dim, self.embedim)
        return params

    def _forward_convs(self, params, x):
        """The conv stack on NHWC x: returns the flattened NHWC features,
        (n, f), or (B, n, f) for weights with a batch dim B, whose models run
        as the B groups of one grouped convolution a layer."""
        h = (x if x.ndim == 4 else x[..., None]).permute(0, 3, 1, 2)  # NCHW
        w0 = params["conv_0"]["w"] if "conv_0" in params else None
        B = w0.shape[0] if w0 is not None and w0.ndim == 5 else None
        if B is not None:
            h = h.repeat(1, B, 1, 1)  # channel b·C + c is model b's channel c
        i = 0
        while f"conv_{i}" in params:
            p = params[f"conv_{i}"]
            lead = p["w"].ndim - 4
            w = p["w"].permute(*range(lead), lead + 3, lead + 2, lead, lead + 1)  # HWIO->OIHW
            if B is None:
                h = F.conv2d(h, w, p["b"], padding=1)
            else:
                h = F.conv2d(h, w.reshape((-1,) + w.shape[-3:]), p["b"].reshape(-1),
                             padding=1, groups=B)
            h = F.max_pool2d(self.activation(h), 2, 2)
            i += 1
        n, _, H, W = h.shape
        if B is None:
            return h.permute(0, 2, 3, 1).reshape(n, -1)
        return h.reshape(n, B, -1, H, W).permute(1, 0, 3, 4, 2).reshape(B, n, -1)

    def apply(self, params, x):
        h = self._forward_convs(params, x)
        h = self.activation(dense(h, params["dense_0"]["w"], params["dense_0"]["b"]))
        return dense(h, params["head"]["w"], params["head"]["b"])


def _flatten_with_path(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """('<prefix>/<key>/…', leaf) pairs in sorted key order (dicts) or index
    order (lists and tuples), as ``gpax_tpu``'s flattening names them."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += _flatten_with_path(v, f"{prefix}/{k}" if prefix else k)
    return out


def _unflatten(proto, values, prefix: str = ""):
    """``proto``'s nesting with the leaf at each path taken from ``values``."""
    if isinstance(proto, dict):
        return {k: _unflatten(v, values, f"{prefix}/{k}" if prefix else str(k))
                for k, v in proto.items()}
    if isinstance(proto, (list, tuple)):
        return type(proto)(_unflatten(v, values, f"{prefix}/{i}" if prefix else str(i))
                           for i, v in enumerate(proto))
    return values[prefix]


def _prototype(module: Module, input_shape: Tuple[int, ...]):
    """``module.init`` on zeros of ``input_shape`` from the fixed generator,
    made once per module and input shape (a model evaluation per SVI step
    would otherwise re-initialize the network each time)."""
    cache = module.__dict__.setdefault("_prototypes", {})
    key = tuple(input_shape)
    if key not in cache:
        cache[key] = module.init(torch.Generator().manual_seed(_PROTO_SEED),
                                 torch.zeros(key))
    return cache[key]


def random_module(name: str, module: Module, input_shape: Tuple[int, ...]):
    """Bayesian NN: every parameter leaf becomes a latent site named
    '<name>/<layer>/<param>' with a Normal(0, 1) prior, or Cauchy(0, 1) where
    the leaf's name starts with 'b'. Returns ``apply(x)`` closed over the
    sampled (or substituted) params."""
    proto = _prototype(module, input_shape)
    sampled = {}
    for path, leaf in _flatten_with_path(proto, name):
        pname = path.rsplit("/", 1)[-1]
        d = (dist.Cauchy(0.0, 1.0) if pname.startswith("b") else dist.Normal(0.0, 1.0)
             ).expand(leaf.shape)
        sampled[path] = ppl.sample(path, d.to_event(leaf.ndim) if leaf.ndim else d)
    params = _unflatten(proto, sampled, name)
    return lambda x: module.apply(params, x)


def module_param(name: str, module: Module, input_shape: Tuple[int, ...]):
    """MLE NN: the whole parameter tree is one optimizable ``param`` site
    named '<name>$params', initialized from the fixed generator's prototype
    (on the CPU; ``SVI`` moves it to the data's device). Returns ``apply(x)``
    closed over the (possibly substituted) params."""
    params = ppl.param(f"{name}$params", _prototype(module, input_shape))
    return lambda x: module.apply(params, x)
