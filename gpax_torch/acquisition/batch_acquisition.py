"""Batch (q-) acquisition functions (counterpart of
``gpax_tpu/acquisition/batch_acquisition.py``).

Each draws ``subsample_size`` posterior draws without replacement (a
permutation draw) and scores the candidates under each, giving (q, m). With
``maximize_distance`` it redraws ``n_evals`` times and keeps the draw whose
argmax indices have the largest norm, evaluating on ``indices`` instead of X
when they are given: both quirks of the reference, kept. The moments of the
q draws come at once, as one batch of grams and factors, from
``get_predictive_mean_var`` where the model's posterior has the plain GP
form, else from the diagonal of ``get_mvn_posterior``. ``qKG`` draws fresh
fantasies on every call. The JAX package's compiled-program cache has no
counterpart here.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .acquisition import _on_device
from .base_acq import ei, key_on, kg, poi, ucb


def _batch_moments_fn(model, noiseless, kwargs):
    """(params with a leading draw dim, X) -> (mean, var), each (q, m)."""
    if getattr(model, "_exact_moments_ok", False) and hasattr(model, "get_predictive_mean_var"):
        def moments(params, Xq):
            return model.get_predictive_mean_var(Xq, params, noiseless=noiseless, **kwargs)
        return moments

    def moments(params, Xq):
        mean, cov = model.get_mvn_posterior(Xq, params, noiseless, **kwargs)
        return mean, cov.diagonal(dim1=-2, dim2=-1)
    return moments


def _run_batch(rng_key, model, X, per_subsample_fn, maximize_distance, subsample_size,
               n_evals, indices, device):
    """``per_subsample_fn(sub_samples, Xq, key) -> (q, m)`` on random
    posterior subsets (``key``: a generator on the model's device for
    acquisitions that draw), with the n_evals redraws of
    ``maximize_distance``."""
    if getattr(model, "mcmc", None) is None:
        raise ValueError("The model needs to be fully Bayesian")
    X, dev = _on_device(model, X, device)
    if maximize_distance and indices is not None:
        X, _ = _on_device(model, indices, dev)
    samples = {k: torch.as_tensor(v, device=dev) for k, v in model.get_samples().items()}
    num_post = len(next(iter(samples.values())))
    if isinstance(rng_key, int):
        rng_key = torch.Generator().manual_seed(rng_key)
    key = key_on(rng_key, dev)

    def acq_of():
        idx = torch.randperm(num_post, generator=rng_key)[:subsample_size].to(dev)
        return per_subsample_fn({k: v[idx] for k, v in samples.items()}, X, key)

    if not maximize_distance:
        return acq_of()
    acqs = [acq_of() for _ in range(n_evals)]
    dists = [torch.linalg.vector_norm(a.argmax(-1).float()).item() for a in acqs]
    return acqs[max(range(n_evals), key=dists.__getitem__)]


def _compute_batch_acquisition(rng_key, model, X, single_acq_fn: Callable,
                               maximize_distance: bool = False, subsample_size: int = 1,
                               n_evals: int = 10, indices=None, device=None) -> torch.Tensor:
    """A caller's per-draw acquisition ``single_acq_fn(sample, X) -> (m,)``
    over random posterior subsets: (q, m)."""

    def per_subsample(sub, Xq, key):
        q = len(next(iter(sub.values())))
        return torch.stack([single_acq_fn({k: v[i] for k, v in sub.items()}, Xq)
                            for i in range(q)])

    return _run_batch(rng_key, model, X, per_subsample, maximize_distance, subsample_size,
                      n_evals, indices, device)


def _moment_batch_acq(rng_key, model, X, moment_to_acq, noiseless, maximize_distance,
                      subsample_size, n_evals, indices, device, kwargs):
    moments = _batch_moments_fn(model, noiseless, kwargs)

    def per_subsample(sub, Xq, key):
        return moment_to_acq(moments(sub, Xq))

    return _run_batch(rng_key, model, X, per_subsample, maximize_distance, subsample_size,
                      n_evals, indices, device)


def qEI(rng_key, model, X, best_f: Optional[float] = None, maximize: bool = False,
        noiseless: bool = False, maximize_distance: bool = False, subsample_size: int = 1,
        n_evals: int = 10, indices=None, device=None, **kwargs) -> torch.Tensor:
    """Batch expected improvement over random posterior subsets."""
    return _moment_batch_acq(rng_key, model, X, lambda mo: ei(mo, best_f, maximize),
                             noiseless, maximize_distance, subsample_size, n_evals, indices,
                             device, kwargs)


def qUCB(rng_key, model, X, beta: float = 0.25, maximize: bool = False,
         noiseless: bool = False, maximize_distance: bool = False, subsample_size: int = 1,
         n_evals: int = 10, indices=None, device=None, **kwargs) -> torch.Tensor:
    """Batch upper confidence bound."""
    return _moment_batch_acq(rng_key, model, X, lambda mo: ucb(mo, beta, maximize),
                             noiseless, maximize_distance, subsample_size, n_evals, indices,
                             device, kwargs)


def qPOI(rng_key, model, X, best_f: Optional[float] = None, maximize: bool = False,
         noiseless: bool = False, maximize_distance: bool = False, subsample_size: int = 1,
         n_evals: int = 10, indices=None, device=None, **kwargs) -> torch.Tensor:
    """Batch probability of improvement. As in the JAX package, ``maximize``
    lands in ``poi``'s ``xi`` (its third argument) and ``poi`` minimizes."""
    return _moment_batch_acq(rng_key, model, X, lambda mo: poi(mo, best_f, float(maximize)),
                             noiseless, maximize_distance, subsample_size, n_evals, indices,
                             device, kwargs)


def qKG(rng_key, model, X, n: int = 1, maximize: bool = False, noiseless: bool = False,
        maximize_distance: bool = False, subsample_size: int = 1, n_evals: int = 10,
        indices=None, device=None, **kwargs) -> torch.Tensor:
    """Batch knowledge gradient: the fantasy KG of each draw of the subset,
    with fresh fantasies on every call."""

    def per_subsample(sub, Xq, key):
        q = len(next(iter(sub.values())))
        return torch.stack([kg(model, Xq, {k: v[i] for k, v in sub.items()}, key, n,
                               maximize, noiseless, **kwargs) for i in range(q)])

    return _run_batch(rng_key, model, X, per_subsample, maximize_distance, subsample_size,
                      n_evals, indices, device)
