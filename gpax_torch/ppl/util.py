"""Model introspection for inference (counterpart of ``gpax_tpu/ppl/util.py``):
``initialize_model`` (its eager path, ``util.py:224-244``),
``make_potential_fn``, ``init_to_median`` and ``Predictive``. The JAX
package's deferred-init machinery exists for the XLA compile and has no
counterpart in eager PyTorch."""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from ..distributions import biject_to
from .core import log_density, seed, substitute, trace


class ModelInfo(NamedTuple):
    potential_fn: Callable[[Dict[str, torch.Tensor]], torch.Tensor]
    init_unconstrained: Dict[str, torch.Tensor]
    transforms: Dict[str, object]
    constrain_fn: Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]
    prototype_trace: Dict[str, dict]
    deterministic_sites: tuple = ()


def get_latent_sites(model, rng_key, model_args=(), model_kwargs=None) -> Dict[str, dict]:
    """One seeded forward trace; returns all non-observed sample sites."""
    model_kwargs = model_kwargs or {}
    tr = trace(seed(model, rng_key)).get_trace(*model_args, **model_kwargs)
    return {name: site for name, site in tr.items()
            if site["type"] == "sample" and not site["is_observed"]}


def constrain(transforms: Dict, unconstrained: Dict) -> Dict:
    return {k: transforms[k](v) for k, v in unconstrained.items()}


def unconstrain(transforms: Dict, constrained: Dict) -> Dict:
    return {k: transforms[k].inv(v) for k, v in constrained.items()}


def transform_log_det(transforms: Dict, unconstrained: Dict, constrained: Dict):
    out = torch.zeros(())
    for k, z in unconstrained.items():
        out = out + transforms[k].log_abs_det_jacobian(z, constrained[k]).sum()
    return out


def make_potential_fn(model, transforms: Dict, model_args=(), model_kwargs=None):
    """U(z) = −[log p(constrain(z), data) + log|det J|]; differentiable by autograd."""
    model_kwargs = model_kwargs or {}

    def potential_fn(unconstrained: Dict[str, torch.Tensor]) -> torch.Tensor:
        params = constrain(transforms, unconstrained)
        ld, _ = log_density(model, model_args, model_kwargs, params)
        return -(ld + transform_log_det(transforms, unconstrained, params))

    return potential_fn


def init_to_median(model, rng_key, model_args=(), model_kwargs=None, num_samples: int = 10,
                   latent_sites: Optional[Dict[str, dict]] = None) -> Dict[str, torch.Tensor]:
    """Each latent at the median of ``num_samples`` prior draws.

    ``torch.quantile(…, 0.5)``, not ``torch.median``: for an even count
    ``jnp.median`` averages the two middle draws, ``torch.median`` returns
    the lower one."""
    model_kwargs = model_kwargs or {}
    if latent_sites is None:
        latent_sites = get_latent_sites(model, rng_key, model_args, model_kwargs)
    init = {}
    for name, site in latent_sites.items():
        draws = site["fn"].sample(rng_key, (num_samples,) + tuple(site["sample_shape"]))
        init[name] = torch.quantile(draws, 0.5, dim=0)
    return init


def initialize_model(model, rng_key, model_args=(), model_kwargs=None,
                     init_strategy: str = "median", num_init_samples: int = 10) -> ModelInfo:
    """Model structure, transforms, potential and initial latent values."""
    model_kwargs = model_kwargs or {}
    if init_strategy not in ("median", "prior"):
        raise ValueError(f"unknown init strategy {init_strategy}")
    tr = trace(seed(model, rng_key)).get_trace(*model_args, **model_kwargs)
    latent_sites = {n: s for n, s in tr.items()
                    if s["type"] == "sample" and not s["is_observed"]}
    transforms = {n: biject_to(s["fn"].support) for n, s in latent_sites.items()}
    if init_strategy == "median":
        init_constrained = init_to_median(model, rng_key, model_args, model_kwargs,
                                          num_init_samples, latent_sites)
    else:
        init_constrained = {n: s["value"] for n, s in latent_sites.items()}
    potential_fn = make_potential_fn(model, transforms, model_args, model_kwargs)

    def constrain_fn(z):
        return constrain(transforms, z)

    deterministic = tuple(n for n, s in tr.items() if s["type"] == "deterministic")
    return ModelInfo(potential_fn, unconstrain(transforms, init_constrained), transforms,
                     constrain_fn, tr, deterministic_sites=deterministic)


class Predictive:
    """Prior/posterior predictive sampler (``numpyro.infer.Predictive``).

    With ``posterior_samples``: substitutes each posterior draw in turn and
    runs the model forward. Without: draws ``num_samples`` prior traces.
    Outputs are stacked along a leading draw axis.
    """

    def __init__(self, model, posterior_samples: Optional[Dict] = None,
                 num_samples: Optional[int] = None, return_sites: Optional[list] = None):
        if posterior_samples is None and num_samples is None:
            raise ValueError("Provide posterior_samples or num_samples")
        self.model = model
        self.posterior_samples = posterior_samples
        self.num_samples = num_samples
        self.return_sites = return_sites

    def __call__(self, rng_key: torch.Generator, *args, **kwargs):
        def single(sample_dict):
            sites = trace(seed(substitute(self.model, data=sample_dict), rng_seed=rng_key)
                          ).get_trace(*args, **kwargs)
            return {name: site["value"] for name, site in sites.items()
                    if (self.return_sites is None or name in self.return_sites)
                    and site["type"] in ("sample", "deterministic")
                    and name not in sample_dict}

        if self.posterior_samples is not None:
            n = len(next(iter(self.posterior_samples.values())))
            draws = [{k: v[i] for k, v in self.posterior_samples.items()} for i in range(n)]
        else:
            draws = [{} for _ in range(self.num_samples)]
        outs = [single(d) for d in draws]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
