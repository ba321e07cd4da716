"""Moment-level acquisition functions (counterpart of
``gpax_tpu/acquisition/base_acq.py``).

``ei``, ``ucb``, ``ue`` and ``poi`` take predictive (mean, variance); the
reference's quirks are kept: ``ucb`` is negated for minimization and ``ue``
returns σ. Without ``best_f``, the best mean is taken over the last axis, so
a (q, m) batch of moments scores each row against its own best, as the JAX
package's q-functions do row by row. ``kg`` is the knowledge gradient by
fantasy observations: it never mutates the caller's model, and evaluates the
fantasy posteriors on a shallow copy that carries the augmented training
sets, one per candidate, as a leading batch dim of one gram and one factor
(``fantasy_kg`` takes the fantasy draws as input).
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import torch

from .. import distributions as dist
from ..utils.utils import get_keys, spawn


def _best(mean: torch.Tensor, maximize: bool) -> torch.Tensor:
    return mean.amax(-1, keepdim=True) if maximize else mean.amin(-1, keepdim=True)


def ei(moments: Tuple[torch.Tensor, torch.Tensor], best_f: Optional[float] = None,
       maximize: bool = False, **kwargs) -> torch.Tensor:
    """Expected improvement from predictive (mean, variance)."""
    mean, var = moments
    if best_f is None:
        best_f = _best(mean, maximize)
    sigma = torch.sqrt(var)
    u = (mean - best_f) / sigma
    if not maximize:
        u = -u
    normal = dist.Normal(torch.zeros_like(u), torch.ones_like(u))
    return sigma * (torch.exp(normal.log_prob(u)) + u * normal.cdf(u))


def ucb(moments: Tuple[torch.Tensor, torch.Tensor], beta: float = 0.25,
        maximize: bool = False, **kwargs) -> torch.Tensor:
    """Upper confidence bound mean + √(β·var), negated for minimization so
    that the caller always takes the argmax."""
    mean, var = moments
    delta = torch.sqrt(beta * var)
    if maximize:
        return mean + delta
    return -(mean - delta)


def ue(moments: Tuple[torch.Tensor, torch.Tensor], **kwargs) -> torch.Tensor:
    """Uncertainty-based exploration: σ (the reference returns σ, not σ²)."""
    _, var = moments
    return torch.sqrt(var)


def poi(moments: Tuple[torch.Tensor, torch.Tensor], best_f: Optional[float] = None,
        xi: float = 0.01, maximize: bool = False, **kwargs) -> torch.Tensor:
    """Probability of improvement."""
    mean, var = moments
    if best_f is None:
        best_f = _best(mean, maximize)
    u = (mean - best_f - xi) / torch.sqrt(var)
    if not maximize:
        u = -u
    return dist.Normal(torch.zeros_like(u), torch.ones_like(u)).cdf(u)


def key_on(rng_key, device: torch.device) -> torch.Generator:
    """A generator on ``device`` from ``rng_key`` (an integer seed, a CPU
    generator, or a generator already on that device)."""
    if isinstance(rng_key, torch.Generator) and rng_key.device == torch.device(device):
        return rng_key
    return spawn(rng_key, device)


def fantasy_kg(model, X_new: torch.Tensor, sample: tuple, y_sim: torch.Tensor,
               mean: torch.Tensor, maximize: bool = True, noiseless: bool = True,
               **kwargs) -> torch.Tensor:
    """Knowledge gradient of the fantasy draws ``y_sim`` (n, m) at the m
    candidates ``X_new``, given the current posterior mean there.

    Candidate j's training set is the model's plus (x_j, y_sim[i, j]); all
    n·m fantasy posteriors come from one ``get_mvn_posterior`` on a shallow
    copy of the model whose training inputs are (m, N+1, d) and targets
    (n, m, N+1)."""
    X_train, y_train = model.X_train, model.y_train
    m, n = X_new.shape[0], y_sim.shape[0]
    fantasy = copy.copy(model)
    fantasy.X_train = torch.cat([X_train.expand((m,) + X_train.shape), X_new[:, None]], 1)
    fantasy.y_train = torch.cat([y_train.expand((n, m) + y_train.shape), y_sim[..., None]], -1)
    mean_aug, _ = fantasy.get_mvn_posterior(X_new, *sample, noiseless=noiseless, **kwargs)
    y_fant = mean_aug.amax(-1) if maximize else mean_aug.amin(-1)
    u = y_fant - (mean.max() if maximize else mean.min())
    if not maximize:
        u = -u
    return u.mean(0)


def kg(model, X_new: torch.Tensor, sample: Dict[str, torch.Tensor], rng_key=None,
       n: int = 10, maximize: bool = True, noiseless: bool = True, **kwargs) -> torch.Tensor:
    """Knowledge gradient by fantasy observations: ``n`` joint draws at the
    candidates from the posterior of ``sample``, then :func:`fantasy_kg`.
    ``rng_key``: an integer seed or a generator (default: ``get_keys()[0]``)."""
    if rng_key is None:
        rng_key = get_keys()[0]
    if not isinstance(sample, (tuple, list)):
        sample = (sample,)
    mean, cov = model.get_mvn_posterior(X_new, *sample, noiseless=noiseless, **kwargs)
    y_sim = dist.MultivariateNormal(mean, covariance_matrix=cov).sample(
        key_on(rng_key, mean.device), (n,))
    return fantasy_kg(model, X_new, sample, y_sim, mean, maximize, noiseless, **kwargs)
