"""Vector-valued (per-task) exact GP (counterpart of
``gpax_tpu/models/vgp.py``).

X has shape (tasks, n, d) and y (tasks, n); each task has its own kernel
hyperparameters and noise under nested plates. The task axis is the gram's
batch dim: one K1 launch builds every task's gram, and the MVN likelihood
factors them in one batched float64 Cholesky with one K2 launch. With
lockstep chains the batch is (chains, tasks).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from .. import distributions as dist
from .. import ppl
from ..config import get_config
from ..ops.linalg import gp_predictive_moments
from ..utils.utils import resolve_device
from .gp import ExactGP


class vExactGP(ExactGP):
    """Exact GP over vector-valued targets with a leading task dimension."""

    _exact_moments_ok = False  # task-batched data layout
    _draw_site = ("noise", 1)  # one noise a task

    def __init__(self, input_dim: int, kernel="RBF",
                 mean_fn: Optional[Callable] = None,
                 kernel_prior: Optional[Callable] = None,
                 mean_fn_prior: Optional[Callable] = None,
                 noise_prior: Optional[Callable] = None,
                 noise_prior_dist: Optional[dist.Distribution] = None,
                 lengthscale_prior_dist: Optional[dist.Distribution] = None,
                 dtype: Optional[torch.dtype] = None) -> None:
        super().__init__(input_dim, kernel, mean_fn, kernel_prior, mean_fn_prior,
                         noise_prior, noise_prior_dist, lengthscale_prior_dist, dtype)

    def model(self, X: torch.Tensor, y: Optional[torch.Tensor] = None, **kwargs) -> None:
        task_dim = X.shape[0]
        f_loc = torch.zeros(X.shape[:2], dtype=X.dtype, device=X.device)
        if self.kernel_prior:
            kernel_params = self.kernel_prior()
        else:
            kernel_params = self._sample_kernel_params(task_dim=task_dim)
        if self.noise_prior:
            noise = self.noise_prior()
        else:
            noise = self._sample_noise(task_dim)
        if self.mean_fn is not None:
            f_loc = f_loc + self._mean_at(X, self._mean_prior(), ppl.batch_ndim())
        jitter = kwargs.get("jitter")
        if jitter is None:
            jitter = get_config().default_jitter
        # every task's gram in one batched kernel call
        k = self.kernel(X, X, kernel_params, noise, jitter=jitter)
        ppl.sample("y", dist.MultivariateNormal(loc=f_loc, covariance_matrix=k), obs=y)

    def _sample_noise(self, task_dim: Optional[int] = None) -> torch.Tensor:
        noise_dist = self.noise_prior_dist
        if noise_dist is None:
            noise_dist = dist.LogNormal(0.0, 1.0)
        with ppl.plate("noise_plate", task_dim):
            return ppl.sample("noise", noise_dist)

    def _sample_kernel_params(self, output_scale: bool = True,
                              task_dim: Optional[int] = None) -> Dict[str, torch.Tensor]:
        length_dist = self.lengthscale_prior_dist
        if length_dist is None:
            length_dist = dist.LogNormal(0.0, 1.0)
        with ppl.plate("plate_1", task_dim):
            with ppl.plate("lengthscale", self.kernel_dim):
                length = ppl.sample("k_length", length_dist)
        with ppl.plate("plate_2", task_dim):
            scale = ppl.sample("k_scale", dist.LogNormal(0.0, 1.0))
            period = (ppl.sample("period", dist.LogNormal(0.0, 1.0))
                      if self.kernel_name == "Periodic" else None)
        return {"k_length": length, "k_scale": scale, "period": period}

    def get_mvn_posterior(self, X_new: torch.Tensor, params: Dict[str, torch.Tensor],
                          noiseless: bool = False, **kwargs
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-task predictive posteriors for a chunk of draws (params
        (S, tasks, …)): mean (S, tasks, m), covariance (S, tasks, m, m)
        (``vgp.py:97-121``). A hyperparameter with one value per draw
        is shared by the tasks."""
        task_dim = X_new.shape[0]
        jitter = kwargs.get("jitter")
        if jitter is None:
            jitter = get_config().default_jitter
        draws = params  # the mean function takes one draw's params, not the tasks'
        params = {k: (v.unsqueeze(-1).expand(v.shape + (task_dim,)) if v.ndim == 1 else v)
                  for k, v in params.items() if v is not None}
        noise = params["noise"]
        noise_p = noise * (1 - int(noiseless))
        k_pp = self.kernel(X_new, X_new, params, noise_p, jitter=jitter)
        k_pX = self.kernel(X_new, self.X_train, params, jitter=0.0)
        k_XX = self.kernel(self.X_train, self.X_train, params, noise, jitter=jitter)
        mean, cov = gp_predictive_moments(k_XX, k_pX, k_pp, self._residual(draws))
        return self._add_mean(mean, X_new, draws), cov

    def _chunk_size(self, num_samples: int, m: int, with_test_cov: bool) -> int:
        """ExactGP's chunk of draws, for the tasks' grams together."""
        tasks = self.X_train.shape[0]
        return max(1, super()._chunk_size(num_samples, m * tasks, with_test_cov) // tasks)

    def predict_in_batches(self, rng_key, X_new, batch_size: int = 100,
                           samples: Optional[Dict[str, torch.Tensor]] = None,
                           n: int = 1, filter_nans: bool = False,
                           predict_fn: Optional[Callable] = None,
                           noiseless: bool = False, device=None, **kwargs
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched over the points axis (dim 1); concatenates along the last
        axis."""
        if isinstance(rng_key, int):
            rng_key = torch.Generator().manual_seed(rng_key)
        dev = self._to_device(device)
        if predict_fn is None:
            def predict_fn(xi):
                return self.predict(rng_key, xi, samples, n, filter_nans, noiseless,
                                    dev, **kwargs)
        outs = [predict_fn(xi) for xi in
                torch.split(self._set_data(X_new, device=dev), batch_size, dim=1)]
        return (torch.cat([o[0].cpu() for o in outs], -1),
                torch.cat([o[1].cpu() for o in outs], -1))

    def _set_data(self, X, y=None, device=None):
        """X as (tasks, n, d) and y as (tasks, n), on ``device`` (None: the
        CUDA card)."""
        X = torch.as_tensor(X, dtype=self.dtype, device=resolve_device(device))
        X = X[..., None] if X.ndim == 2 else X
        if y is not None:
            y = torch.as_tensor(y, dtype=self.dtype, device=X.device)
            if y.shape[0] != X.shape[0]:
                raise AssertionError("Task dimensions must be identical in inputs and targets")
            return X, y
        return X
