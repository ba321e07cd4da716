"""Prior placement helpers and distribution factories (counterpart of
``gpax_tpu/priors/priors.py``):

* ``place_*_prior(name, ...)`` samples a named latent inside a model;
* ``*_dist(...)`` builds a distribution to pass as ``noise_prior_dist`` and
  the like, with data-driven defaults for the gamma shape and the uniform
  bounds;
* ``auto_*`` reads a deterministic function's signature and returns a
  program that samples one latent per parameter.

Bounds taken from data stay on the data's device; the distributions take
them to the device of the values or draws they meet.
"""

from __future__ import annotations

import inspect
from typing import Callable, Dict

import torch

from .. import distributions as dist
from ..ppl import sample

__all__ = [
    "place_normal_prior",
    "place_lognormal_prior",
    "place_halfnormal_prior",
    "place_uniform_prior",
    "place_gamma_prior",
    "normal_dist",
    "lognormal_dist",
    "halfnormal_dist",
    "gamma_dist",
    "uniform_dist",
    "auto_priors",
    "auto_normal_priors",
    "auto_lognormal_priors",
    "auto_normal_kernel_priors",
    "auto_lognormal_kernel_priors",
]


def place_normal_prior(param_name: str, loc: float = 0.0, scale: float = 1.0):
    """Sample a named latent from Normal(loc, scale)."""
    return sample(param_name, normal_dist(loc, scale))


def place_lognormal_prior(param_name: str, loc: float = 0.0, scale: float = 1.0):
    """Sample a named latent from LogNormal(loc, scale)."""
    return sample(param_name, lognormal_dist(loc, scale))


def place_halfnormal_prior(param_name: str, scale: float = 1.0):
    """Sample a named latent from HalfNormal(scale)."""
    return sample(param_name, halfnormal_dist(scale))


def place_uniform_prior(param_name: str, low: float = None, high: float = None, X=None):
    """Sample a named latent from Uniform(low, high); bounds may come from X."""
    return sample(param_name, uniform_dist(low, high, X))


def place_gamma_prior(param_name: str, c: float = None, r: float = None, X=None):
    """Sample a named latent from Gamma(c, r); the shape may come from X's range."""
    return sample(param_name, gamma_dist(c, r, X))


def normal_dist(loc: float = None, scale: float = None) -> dist.Normal:
    """Normal distribution factory (defaults 0, 1)."""
    return dist.Normal(loc if loc is not None else 0.0, scale if scale is not None else 1.0)


def lognormal_dist(loc: float = None, scale: float = None) -> dist.LogNormal:
    """LogNormal distribution factory (defaults 0, 1)."""
    return dist.LogNormal(loc if loc is not None else 0.0,
                          scale if scale is not None else 1.0)


def halfnormal_dist(scale: float = None) -> dist.HalfNormal:
    """HalfNormal distribution factory (default scale 1)."""
    return dist.HalfNormal(scale if scale is not None else 1.0)


def _data(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.as_tensor(x, dtype=torch.get_default_dtype())


def gamma_dist(c: float = None, r: float = None, input_vec=None) -> dist.Gamma:
    """Gamma factory; without a shape ``c`` it is half the range of the
    input vector (a numpy array or a tensor on any device)."""
    if c is None:
        if input_vec is None:
            raise ValueError("Provide either c or an input array")
        x = _data(input_vec)
        c = (x.max() - x.min()) / 2
    return dist.Gamma(c, r if r is not None else 1.0)


def uniform_dist(low: float = None, high: float = None, input_vec=None) -> dist.Uniform:
    """Uniform factory; a missing bound is the input vector's min or max."""
    if (low is None or high is None) and input_vec is None:
        raise ValueError("If 'low' or 'high' is not provided, an input array must be provided.")
    x = _data(input_vec) if input_vec is not None else None
    low = low if low is not None else x.min()
    high = high if high is not None else x.max()
    return dist.Uniform(low, high)


def auto_priors(func: Callable, params_begin_with: int, dist_type: str = "normal",
                loc: float = 0.0, scale: float = 1.0) -> Callable:
    """A program sampling one (log)normal latent per parameter of ``func``,
    skipping its first ``params_begin_with`` parameters."""
    place_prior = place_lognormal_prior if dist_type == "lognormal" else place_normal_prior
    params_names = list(inspect.signature(func).parameters.keys())[params_begin_with:]

    def sample_priors() -> Dict[str, torch.Tensor]:
        return {name: place_prior(name, loc, scale) for name in params_names}

    return sample_priors


def auto_normal_priors(func: Callable, loc: float = 0.0, scale: float = 1.0) -> Callable:
    """Normal priors over the parameters of a deterministic function f(x, ...)."""
    return auto_priors(func, 1, "normal", loc, scale)


def auto_lognormal_priors(func: Callable, loc: float = 0.0, scale: float = 1.0) -> Callable:
    """LogNormal priors over the parameters of a deterministic function f(x, ...)."""
    return auto_priors(func, 1, "lognormal", loc, scale)


def auto_normal_kernel_priors(kernel_fn: Callable, loc: float = 0.0,
                              scale: float = 1.0) -> Callable:
    """Normal priors over the hyperparameters of a kernel k(X, Z, ...)."""
    return auto_priors(kernel_fn, 2, "normal", loc, scale)


def auto_lognormal_kernel_priors(kernel_fn: Callable, loc: float = 0.0,
                                 scale: float = 1.0) -> Callable:
    """LogNormal priors over the hyperparameters of a kernel k(X, Z, ...)."""
    return auto_priors(kernel_fn, 2, "lognormal", loc, scale)
