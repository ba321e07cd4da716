"""Multi-task / multi-fidelity GP on a linear model of coregionalization
(counterpart of ``gpax_tpu/models/mtgp.py``).

An LCM kernel over ``num_latents`` latent GPs; ``shared_input_space``
chooses the Kronecker form (``MultivariateKernel``, y ordered point-major,
num_tasks values a point) or the indexed form (``MultitaskKernel``, the task
index in the last input column). The task count is inferred from that column
when not given, the rank defaults to num_tasks − 1, W ~ Normal(0, 10) and
v ~ LogNormal(0, 1) under a latent plate, the noise is per task and
LogNormal, and the data kernel has no output scale unless asked
(``output_scale``). Its posterior departs from the plain GP's form, so the
acquisitions take the sampled-moments path (``_exact_moments_ok``), and
NUTS adapts a dense mass matrix by default: the ICM's (W, v) posterior is
correlated.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .. import distributions as dist
from .. import ppl
from ..kernels import LCMKernel
from ..utils.utils import device_memory_budget
from .gp import ExactGP


class MultiTaskGP(ExactGP):
    """Fully Bayesian multi-task GP over an LCM kernel."""

    _exact_moments_ok = False
    _default_dense_mass = True
    _draw_site = ("noise", 1)  # one noise a task

    def __init__(self, input_dim: int, data_kernel="RBF",
                 num_latents: Optional[int] = None, shared_input_space: bool = False,
                 num_tasks: Optional[int] = None, rank: Optional[int] = None,
                 mean_fn: Optional[Callable] = None,
                 data_kernel_prior: Optional[Callable] = None,
                 mean_fn_prior: Optional[Callable] = None,
                 noise_prior: Optional[Callable] = None,
                 noise_prior_dist: Optional[dist.Distribution] = None,
                 lengthscale_prior_dist: Optional[dist.Distribution] = None,
                 W_prior_dist: Optional[dist.Distribution] = None,
                 v_prior_dist: Optional[dist.Distribution] = None,
                 output_scale: bool = False, **kwargs) -> None:
        super().__init__(input_dim, None, mean_fn, None, mean_fn_prior, noise_prior)
        if shared_input_space:
            if num_tasks is None:
                raise ValueError("Please specify num_tasks")
        elif num_latents is None:
            raise ValueError("Please specify num_latents")
        self.num_tasks = num_tasks
        self.num_latents = num_tasks if num_latents is None else num_latents
        self.rank = rank
        self.kernel = LCMKernel(data_kernel, shared_input_space, num_tasks, **kwargs)
        self.data_kernel_name = data_kernel if isinstance(data_kernel, str) else None
        self.data_kernel_prior = data_kernel_prior
        self.noise_prior_dist = noise_prior_dist
        self.lengthscale_prior_dist = lengthscale_prior_dist
        self.W_prior_dist = W_prior_dist
        self.v_prior_dist = v_prior_dist
        self.shared_input = shared_input_space
        self.output_scale = output_scale

    def model(self, X: torch.Tensor, y: Optional[torch.Tensor] = None, **kwargs) -> None:
        if not self.shared_input and self.num_tasks is None:
            self.num_tasks = int(torch.unique(self.X_train[:, -1]).numel())
        if self.rank is None:
            self.rank = self.num_tasks - 1
        rows = self.num_tasks * X.shape[0] if self.shared_input else X.shape[0]
        f_loc = torch.zeros(rows, dtype=X.dtype, device=X.device)
        if self.data_kernel_prior:
            data_kernel_params = self.data_kernel_prior()
        else:
            data_kernel_params = self._sample_kernel_params(X)
        kernel_params = {**data_kernel_params, **self._sample_task_kernel_params(X)}
        noise = self.noise_prior() if self.noise_prior else self._sample_noise(X)
        k = self.kernel(X, X, kernel_params, noise, **kwargs)
        if self.mean_fn is not None:
            f_loc = f_loc + self._mean_at(X, self._mean_prior(), ppl.batch_ndim())
        ppl.sample("y", dist.MultivariateNormal(loc=f_loc, covariance_matrix=k), obs=y)

    def _sample_noise(self, X: torch.Tensor) -> torch.Tensor:
        """Per-task noise, LogNormal(0, 1) unless ``noise_prior_dist``; the
        prior's tensors live on X's device."""
        noise_dist = self.noise_prior_dist
        if noise_dist is None:
            zeros = X.new_zeros(self.num_tasks)
            noise_dist = dist.LogNormal(zeros, torch.ones_like(zeros))
        return ppl.sample("noise", noise_dist.to_event(1))

    def _sample_task_kernel_params(self, X: torch.Tensor) -> Dict[str, torch.Tensor]:
        W_dist = self.W_prior_dist
        if W_dist is None:
            zeros = X.new_zeros((self.num_latents, self.num_tasks, self.rank))
            W_dist = dist.Normal(zeros, 10 * torch.ones_like(zeros))
        v_dist = self.v_prior_dist
        if v_dist is None:
            zeros = X.new_zeros((self.num_latents, self.num_tasks))
            v_dist = dist.LogNormal(zeros, torch.ones_like(zeros))
        with ppl.plate("latent_plate_task", self.num_latents):
            W = ppl.sample("W", W_dist.to_event(2))
            v = ppl.sample("v", v_dist.to_event(1))
        return {"W": W, "v": v}

    def _sample_kernel_params(self, X: torch.Tensor) -> Dict[str, torch.Tensor]:
        """k_length (L, d), k_scale (L,) (ones unless ``output_scale``) and,
        for the periodic kernel, period (L,), under the latent plate; with
        several latents they are squeezed as in the JAX package."""
        squeezer = (lambda x: x.squeeze()) if self.num_latents > 1 else (lambda x: x)
        length_dist = self.lengthscale_prior_dist
        if length_dist is None:
            length_dist = dist.LogNormal(0.0, 1.0)
        periodic = self.data_kernel_name == "Periodic"
        with ppl.plate("latent_plate_data", self.num_latents):
            with ppl.plate("ard", self.kernel_dim):
                length = ppl.sample("k_length", length_dist)
            if self.output_scale:
                scale = ppl.sample("k_scale", dist.LogNormal(0.0, 1.0))
            else:
                scale = ppl.deterministic("k_scale", X.new_ones(self.num_latents))
            period = ppl.sample("period", dist.LogNormal(0.0, 1.0)) if periodic else None
        return {"k_length": squeezer(length), "k_scale": squeezer(scale),
                "period": squeezer(period) if periodic else None}

    def _chunk_size(self, num_samples: int, m: int, with_test_cov: bool) -> int:
        """ExactGP's rule on the LCM's gram sizes: num_tasks rows a point in
        the shared-input form, and per latent a data gram, a task gram and
        their product beside each n², n·m and m² word, at the data's
        itemsize."""
        rows = self.X_train.shape[0] * (self.num_tasks if self.shared_input else 1)
        m = m * (self.num_tasks if self.shared_input else 1)
        extra = 3 * self.num_latents
        per = self.X_train.element_size() * ((14 + extra) * rows * rows + (3 + extra) * rows * m
                   + ((8 + extra) * m * m if with_test_cov else m))
        budget = device_memory_budget(self.X_train.device)
        return int(max(1, min(num_samples, budget // max(per, 1))))
