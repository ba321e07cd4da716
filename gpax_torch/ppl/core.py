"""Effect-handler probabilistic-programming core (counterpart of
``gpax_tpu/ppl/core.py``).

Models are plain Python functions that call :func:`sample`,
:func:`deterministic`, :func:`param` and :func:`factor` inside optional
:class:`plate` contexts; inference interprets them by stacking the handlers
:class:`seed`, :class:`trace`, :class:`substitute`, :class:`condition` and
:class:`block`. Randomness comes from the ``torch.Generator`` of a
:class:`seed` handler, which every latent site draws from in turn.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, Optional

import torch

from ..distributions import Distribution

_PPL_STACK = []    # active Messengers, innermost last
_PLATE_STACK = []  # active plates, outermost first
_BATCH_STACK = []  # batch shapes of the log densities being evaluated, innermost last


class _PlateCtx:
    __slots__ = ("name", "size")

    def __init__(self, name, size):
        self.name = name
        self.size = size


class plate:
    """Batch-dimension context: latent sites sampled inside acquire a leading
    dim of ``size`` (outer plates give dims further left), unless the site's
    distribution already broadcasts over that dim."""

    def __init__(self, name: str, size: int):
        self.ctx = _PlateCtx(name, size)

    def __enter__(self):
        _PLATE_STACK.append(self.ctx)
        return self

    def __exit__(self, *exc):
        _PLATE_STACK.pop()
        return False


class Messenger:
    def __init__(self, fn: Optional[Callable] = None):
        self.fn = fn

    def __enter__(self):
        _PPL_STACK.append(self)
        return self

    def __exit__(self, *exc):
        if _PPL_STACK[-1] is not self:
            raise RuntimeError("effect handlers exited out of order")
        _PPL_STACK.pop()
        return False

    def process_message(self, msg: Dict[str, Any]):
        pass

    def postprocess_message(self, msg: Dict[str, Any]):
        pass

    def __call__(self, *args, **kwargs):
        with self:
            return self.fn(*args, **kwargs)


def _apply_stack(msg: Dict[str, Any]) -> Dict[str, Any]:
    for handler in reversed(_PPL_STACK):
        handler.process_message(msg)
    if msg["type"] == "sample" and msg["value"] is None:
        key = msg["rng_key"]
        if key is None:
            raise RuntimeError(
                f"Latent site '{msg['name']}' needs a generator: wrap the model in "
                f"gpax_torch.ppl.seed(model, rng_seed) or substitute a value.")
        msg["value"] = msg["fn"].sample(key, msg["sample_shape"])
    for handler in _PPL_STACK:
        handler.postprocess_message(msg)
    return msg


def _plate_sample_shape(fn: Distribution):
    """Extra leading dims a distribution needs so its draw covers active plates."""
    plate_shape = tuple(p.size for p in _PLATE_STACK)
    need = len(plate_shape) - len(fn.batch_shape)
    return plate_shape[:need] if need > 0 else ()


def _msg(type_, name, fn=None, value=None, is_observed=True, **extra):
    msg = {"type": type_, "name": name, "fn": fn, "value": value,
           "is_observed": is_observed, "rng_key": None, "sample_shape": (),
           "plates": ()}
    msg.update(extra)
    return msg


def sample(name: str, fn: Distribution, obs=None, rng_key=None, sample_shape=()):
    """Draw (or observe) a random variable (``numpyro.sample``)."""
    if not _PPL_STACK:
        if obs is not None:
            return obs
        if rng_key is None:
            raise RuntimeError(f"sample('{name}') outside an inference context needs rng_key=")
        return fn.sample(rng_key, sample_shape)
    msg = _msg("sample", name, fn, obs, obs is not None, rng_key=rng_key,
               sample_shape=tuple(sample_shape) + _plate_sample_shape(fn),
               plates=tuple(_PLATE_STACK))
    return _apply_stack(msg)["value"]


def deterministic(name: str, value):
    """Record a deterministic site (``numpyro.deterministic``)."""
    if not _PPL_STACK:
        return value
    return _apply_stack(_msg("deterministic", name, value=value))["value"]


def param(name: str, init_value=None, constraint=None):
    """Learnable parameter site (``numpyro.param``)."""
    if not _PPL_STACK:
        return init_value
    msg = _msg("param", name, is_observed=False, init_value=init_value,
               constraint=constraint)
    out = _apply_stack(msg)["value"]
    return init_value if out is None else out


def factor(name: str, log_factor):
    """Add an arbitrary log-probability term (``numpyro.factor``)."""
    if _PPL_STACK:
        _apply_stack(_msg("factor", name, value=log_factor))


class seed(Messenger):
    """Give every unobserved sample site the handler's generator."""

    def __init__(self, fn: Optional[Callable] = None, rng_seed=None):
        super().__init__(fn)
        if rng_seed is None:
            raise ValueError("seed handler needs rng_seed")
        if isinstance(rng_seed, int):
            rng_seed = torch.Generator().manual_seed(rng_seed)
        self.key = rng_seed

    def process_message(self, msg):
        if msg["type"] == "sample" and not msg["is_observed"] and msg["rng_key"] is None:
            msg["rng_key"] = self.key


class trace(Messenger):
    """Record every site into an OrderedDict keyed by name."""

    def __init__(self, fn: Optional[Callable] = None):
        super().__init__(fn)
        self.sites: "OrderedDict[str, Dict]" = OrderedDict()

    def __enter__(self):
        self.sites = OrderedDict()
        return super().__enter__()

    def postprocess_message(self, msg):
        if msg["name"] in self.sites and msg["type"] != "param":
            raise ValueError(f"Duplicate site name '{msg['name']}' in model trace")
        self.sites[msg["name"]] = dict(msg)

    def get_trace(self, *args, **kwargs):
        with self:
            self.fn(*args, **kwargs)
        return self.sites


class substitute(Messenger):
    """Replace site values (latent samples and params) by entries of ``data``."""

    def __init__(self, fn: Optional[Callable] = None, data: Optional[Dict] = None,
                 substitute_fn: Optional[Callable] = None):
        super().__init__(fn)
        self.data = data if data is not None else {}
        self.substitute_fn = substitute_fn

    def process_message(self, msg):
        if msg["type"] in ("sample", "param"):
            if msg["name"] in self.data:
                msg["value"] = self.data[msg["name"]]
            elif self.substitute_fn is not None:
                val = self.substitute_fn(msg)
                if val is not None:
                    msg["value"] = val


class condition(Messenger):
    """Fix sample sites to observed values."""

    def __init__(self, fn: Optional[Callable] = None, data: Optional[Dict] = None):
        super().__init__(fn)
        self.data = data or {}

    def process_message(self, msg):
        if msg["type"] == "sample" and msg["name"] in self.data:
            msg["value"] = self.data[msg["name"]]
            msg["is_observed"] = True


class block(Messenger):
    """Hide sites from outer handlers."""

    def __init__(self, fn: Optional[Callable] = None, hide_fn: Optional[Callable] = None,
                 hide: Optional[list] = None):
        super().__init__(fn)
        if hide_fn is None:
            hide_set = set(hide or [])
            hide_fn = lambda msg: msg["name"] in hide_set if hide_set else True  # noqa: E731
        self.hide_fn = hide_fn

    def process_message(self, msg):
        if self.hide_fn(msg):
            msg["_blocked"] = True


def batch_ndim() -> int:
    """The number of leading batch dims that the latents carry in the log
    density being evaluated: 1 under a batched potential of lockstep chains
    or an ensemble's ELBO, 0 anywhere else. A model hands it to
    ``utils.fn.call_batched`` to call a user function written for one
    draw."""
    return len(_BATCH_STACK[-1]) if _BATCH_STACK else 0


def sum_batched(x: torch.Tensor, batch_shape=(), name: str = "") -> torch.Tensor:
    """Sum of ``x`` over every dim after the leading ``batch_shape``: one
    value per model of a batch (a scalar for ``batch_shape=()``). A 0-d
    ``x`` is returned as it is, to broadcast; any other ``x`` must lead with
    ``batch_shape``."""
    x = torch.as_tensor(x)
    k = len(batch_shape)
    if k == 0 or x.ndim == 0:
        return x.sum()
    if tuple(x.shape[:k]) != tuple(batch_shape):
        raise ValueError(f"site '{name}': a log-probability of shape {tuple(x.shape)} "
                         f"does not lead with the batch shape {tuple(batch_shape)}")
    return x.sum(tuple(range(k, x.ndim))) if x.ndim > k else x


def log_density(model: Callable, model_args=(), model_kwargs=None,
                params: Optional[Dict] = None, batch_shape=()):
    """Sum of log-probabilities of all sample and factor sites given latent
    values. Returns ``(log_joint, trace)``. With a ``batch_shape``, the
    latents carry it as leading dims (one set per model of a batch) and the
    log joint has that shape, each model's own."""
    model_kwargs = model_kwargs or {}
    _BATCH_STACK.append(tuple(batch_shape))
    try:
        sites = trace(substitute(model, data=params or {})).get_trace(*model_args,
                                                                      **model_kwargs)
    finally:
        _BATCH_STACK.pop()
    log_joint = torch.zeros(())
    for name, site in sites.items():
        if site["type"] == "sample":
            lp = site["fn"].log_prob(site["value"])
        elif site["type"] == "factor":
            lp = site["value"]
        else:
            continue
        log_joint = log_joint + sum_batched(lp, batch_shape, name)
    return log_joint, sites
