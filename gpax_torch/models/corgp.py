"""Coregionalized GP, single-latent ICM (counterpart of
``gpax_tpu/models/corgp.py``).

``MultitaskKernel`` with the task index in the last input column; the task
count is read from that column on the model's first trace of a training
set; rank 1 by default; W ~ Normal(0, 10), v ~ LogNormal(0, 1); per-task
LogNormal noise; the data kernel has no output scale.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .. import distributions as dist
from .. import ppl
from ..kernels import MultitaskKernel
from .gp import ExactGP


class CoregGP(ExactGP):
    """Fully Bayesian coregionalized multi-task GP."""

    _exact_moments_ok = False
    _default_dense_mass = True

    def __init__(self, input_dim: int, data_kernel="RBF",
                 mean_fn: Optional[Callable] = None,
                 data_kernel_prior: Optional[Callable] = None,
                 mean_fn_prior: Optional[Callable] = None,
                 noise_prior: Optional[Callable] = None,
                 task_kernel_prior: Optional[Callable] = None,
                 rank: int = 1, **kwargs) -> None:
        super().__init__(input_dim, None, mean_fn, None, mean_fn_prior, noise_prior)
        self.num_tasks: Optional[int] = None
        self._tasks_of: Optional[torch.Tensor] = None  # the X num_tasks was read from
        self.rank = rank
        self.kernel = MultitaskKernel(data_kernel, **kwargs)
        self.data_kernel_prior = data_kernel_prior
        self.task_kernel_prior = task_kernel_prior
        self.kernel_name = data_kernel if isinstance(data_kernel, str) else None

    def model(self, X: torch.Tensor, y: Optional[torch.Tensor] = None, **kwargs) -> None:
        # one host read a training set: every potential evaluation of a fit
        # traces the model on the same X
        if X is not self._tasks_of:
            self.num_tasks = int(torch.unique(X[:, -1]).numel())
            self._tasks_of = X
        f_loc = torch.zeros(X.shape[0], dtype=X.dtype, device=X.device)
        if self.data_kernel_prior:
            data_kernel_params = self.data_kernel_prior()
        else:
            data_kernel_params = self._sample_kernel_params(output_scale=False)
        if self.task_kernel_prior:
            task_kernel_params = self.task_kernel_prior()
        else:
            task_kernel_params = self._sample_task_kernel_params(self.num_tasks, self.rank, X)
        kernel_params = {**data_kernel_params, **task_kernel_params}
        if self.noise_prior:
            noise = self.noise_prior()
        else:
            zeros = X.new_zeros(self.num_tasks)
            noise = ppl.sample("noise", dist.LogNormal(zeros, torch.ones_like(zeros)).to_event(1))
        k = self.kernel(X, X, kernel_params, noise)
        if self.mean_fn is not None:
            args = [X]
            if self.mean_fn_prior is not None:
                args += [self.mean_fn_prior()]
            f_loc = f_loc + self.mean_fn(*args).squeeze()
        ppl.sample("y", dist.MultivariateNormal(loc=f_loc, covariance_matrix=k), obs=y)

    def _sample_task_kernel_params(self, n_tasks: int, rank: int,
                                   X: torch.Tensor) -> Dict[str, torch.Tensor]:
        zeros = X.new_zeros((n_tasks, rank))
        W = ppl.sample("W", dist.Normal(zeros, 10 * torch.ones_like(zeros)).to_event(2))
        zeros = X.new_zeros(n_tasks)
        v = ppl.sample("v", dist.LogNormal(zeros, torch.ones_like(zeros)).to_event(1))
        return {"W": W, "v": v}
