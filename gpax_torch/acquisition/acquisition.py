"""User-facing acquisition functions (counterpart of
``gpax_tpu/acquisition/acquisition.py``).

On a fully Bayesian model (``model.mcmc`` set) ``EI``, ``UCB``, ``POI`` and
``UE`` score the predictive moments of the whole posterior: the exact
mixture moments of ``predict_moments`` where the model's posterior has the
plain GP form (``_exact_moments_ok``), else the mean and variance of
``predict``'s function draws; on a point-estimate model, its ``predict``.
An optional penalty is subtracted. ``KG`` averages the fantasy knowledge
gradient of every posterior draw; ``Thompson`` draws one function.

The candidates go to the device of the model's training data, or to
``device`` when given, which is then passed on to ``predict*`` with the
other keyword arguments (``samples``, ``jitter``, …).

Each call is the root span ``gpax.acq.<name>`` while a profiler runs
(``utils.monitor.span``): the spans of the factors it makes carry its id.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.monitor import spanned
from ..utils.utils import resolve_device
from .base_acq import ei, key_on, kg, poi, ucb, ue
from .penalties import compute_penalty


def _on_device(model, X, device):
    """(X as (m, d) on the model's device, that device); ``device`` (if
    given) moves the model's training data there first."""
    dev = model.X_train.device if device is None else resolve_device(device)
    model._to_device(dev)
    X = torch.as_tensor(X, dtype=model.dtype, device=dev)
    return (X[:, None] if X.ndim < 2 else X), dev


def _compute_mean_and_var(rng_key, model, X, n, noiseless, **kwargs
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Predictive (mean, variance) of the fully Bayesian mixture, or of the
    point estimate."""
    if getattr(model, "mcmc", None) is not None:
        if getattr(model, "_exact_moments_ok", False) and hasattr(model, "predict_moments"):
            return model.predict_moments(rng_key, X, noiseless=noiseless, **kwargs)
        _, y_sampled = model.predict(rng_key, X, n=n, noiseless=noiseless, **kwargs)
        y_sampled = y_sampled.reshape(-1, y_sampled.shape[-1])
        return y_sampled.mean(0), y_sampled.var(0, correction=0)
    return model.predict(rng_key, X, noiseless=noiseless, **kwargs)


def _check_penalty(penalty, recent_points):
    if penalty and not isinstance(recent_points, (np.ndarray, torch.Tensor)):
        raise ValueError("Please provide an array of recently visited points")


def _penalized(acq, X, penalty, recent_points, grid_indices, penalty_factor):
    if not penalty:
        return acq
    return acq - compute_penalty(X if grid_indices is None else grid_indices, recent_points,
                                 penalty, penalty_factor).to(acq.device)


def _moment_acq(rng_key, model, X, n, noiseless, penalty, recent_points, grid_indices,
                penalty_factor, device, kwargs, score):
    _check_penalty(penalty, recent_points)
    X, dev = _on_device(model, X, device)
    acq = score(_compute_mean_and_var(rng_key, model, X, n, noiseless, device=dev, **kwargs))
    return _penalized(acq, X, penalty, recent_points, grid_indices, penalty_factor)


@spanned("gpax.acq.EI", root=True)
def EI(rng_key, model, X, best_f: Optional[float] = None, maximize: bool = False,
       n: int = 1, noiseless: bool = False, penalty: Optional[str] = None,
       recent_points=None, grid_indices=None, penalty_factor: float = 1.0,
       device=None, **kwargs) -> torch.Tensor:
    """Expected improvement (over the posterior when the model is fully
    Bayesian)."""
    return _moment_acq(rng_key, model, X, n, noiseless, penalty, recent_points, grid_indices,
                       penalty_factor, device, kwargs, lambda mo: ei(mo, best_f, maximize))


@spanned("gpax.acq.UCB", root=True)
def UCB(rng_key, model, X, beta: float = 0.25, maximize: bool = False, n: int = 1,
        noiseless: bool = False, penalty: Optional[str] = None, recent_points=None,
        grid_indices=None, penalty_factor: float = 1.0, device=None,
        **kwargs) -> torch.Tensor:
    """Upper confidence bound."""
    return _moment_acq(rng_key, model, X, n, noiseless, penalty, recent_points, grid_indices,
                       penalty_factor, device, kwargs, lambda mo: ucb(mo, beta, maximize))


@spanned("gpax.acq.POI", root=True)
def POI(rng_key, model, X, best_f: Optional[float] = None, xi: float = 0.01,
        maximize: bool = False, n: int = 1, noiseless: bool = False,
        penalty: Optional[str] = None, recent_points=None, grid_indices=None,
        penalty_factor: float = 1.0, device=None, **kwargs) -> torch.Tensor:
    """Probability of improvement."""
    return _moment_acq(rng_key, model, X, n, noiseless, penalty, recent_points, grid_indices,
                       penalty_factor, device, kwargs, lambda mo: poi(mo, best_f, xi, maximize))


@spanned("gpax.acq.UE", root=True)
def UE(rng_key, model, X, n: int = 1, noiseless: bool = False,
       penalty: Optional[str] = None, recent_points=None, grid_indices=None,
       penalty_factor: float = 1.0, device=None, **kwargs) -> torch.Tensor:
    """Uncertainty-based exploration (σ)."""
    return _moment_acq(rng_key, model, X, n, noiseless, penalty, recent_points, grid_indices,
                       penalty_factor, device, kwargs, ue)


@spanned("gpax.acq.KG", root=True)
def KG(rng_key, model, X, n: int = 1, maximize: bool = False, noiseless: bool = False,
       penalty: Optional[str] = None, recent_points=None, grid_indices=None,
       penalty_factor: float = 1.0, device=None, **kwargs) -> torch.Tensor:
    """Knowledge gradient: once on a point-estimate model; on a fully
    Bayesian one, for every posterior draw in turn ((draws, m))."""
    _check_penalty(penalty, recent_points)
    X, dev = _on_device(model, X, device)
    samples = {k: torch.as_tensor(v, device=dev) for k, v in model.get_samples().items()}
    key = key_on(rng_key, dev)
    if getattr(model, "mcmc", None) is None:
        acq = kg(model, X, samples, key, n, maximize, noiseless, **kwargs)
    else:
        num = len(next(iter(samples.values())))
        acq = torch.stack([kg(model, X, {k: v[i] for k, v in samples.items()}, key, n,
                              maximize, noiseless, **kwargs) for i in range(num)])
    return _penalized(acq, X, penalty, recent_points, grid_indices, penalty_factor)


@spanned("gpax.acq.Thompson", root=True)
def Thompson(rng_key, model, X, n: int = 1, noiseless: bool = False, device=None,
             **kwargs) -> torch.Tensor:
    """Thompson sampling: the function draw of one random posterior draw, or
    one function from a point-estimate model's posterior."""
    X, dev = _on_device(model, X, device)
    if isinstance(rng_key, int):
        rng_key = torch.Generator().manual_seed(rng_key)
    if getattr(model, "mcmc", None) is not None:
        posterior_samples = model.get_samples()
        idx = torch.randint(len(posterior_samples["k_length"]), (1,), generator=rng_key)
        samples = {k: v[idx.to(v.device)] for k, v in posterior_samples.items()}
        _, tsample = model.predict(rng_key, X, samples, n, noiseless=noiseless, device=dev,
                                   **kwargs)
        if n > 1:
            tsample = tsample.mean(1).squeeze()
        return tsample
    _, tsample = model.sample_from_posterior(rng_key, X, n=1, noiseless=noiseless, **kwargs)
    return tsample
