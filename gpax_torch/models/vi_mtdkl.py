"""Multi-task variational deep kernel learning (counterpart of
``gpax_tpu/models/vi_mtdkl.py``).

The network embeds the data columns and the task index column is appended
to the embedding again; an LCM kernel over (z, task) (``MultitaskKernel``,
or the Kronecker ``MultivariateKernel`` with ``shared_input_space``), per
task LogNormal noise, W ~ Normal(0, 10) and v ~ LogNormal(0, 1) under a
latent plate, and the data kernel's output scale pinned near 1 by
Normal(1, 1e-4). The fit, prediction and batching are viDKL's. The JAX
package squeezes k_length and k_scale for several latents; the port's LCM
takes them unsqueezed, which keeps a batch dim of one intact.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .. import distributions as dist
from .. import ppl
from ..kernels import LCMKernel
from .vidkl import viDKL


def _with_task(z: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """The embedding with X's task column appended, broadcast over z's
    batch dims."""
    task = X[..., -1:].to(z.dtype).expand(z.shape[:-1] + (1,))
    return torch.cat([z, task], -1)


class viMTDKL(viDKL):
    """Variational multi-task DKL over an LCM kernel."""

    def __init__(self, input_dim: int, z_dim: int = 2, data_kernel="RBF",
                 num_latents: Optional[int] = None, shared_input_space: bool = False,
                 num_tasks: Optional[int] = None, rank: Optional[int] = None,
                 data_kernel_prior: Optional[Callable] = None,
                 nn=None, nn_prior: bool = True, guide: str = "delta",
                 W_prior_dist: Optional[dist.Distribution] = None,
                 v_prior_dist: Optional[dist.Distribution] = None,
                 task_kernel_prior: Optional[Callable] = None, **kwargs) -> None:
        super().__init__(input_dim, z_dim, None, None, nn, nn_prior, None, guide, **kwargs)
        if shared_input_space:
            if num_tasks is None:
                raise ValueError("Please specify num_tasks")
        elif num_latents is None:
            raise ValueError("Please specify num_latents")
        self.num_tasks = num_tasks
        self.num_latents = num_tasks if num_latents is None else num_latents
        self.rank = rank
        self.kernel = LCMKernel(data_kernel, shared_input_space, num_tasks, **kwargs)
        self.data_kernel_prior = data_kernel_prior
        self.task_kernel_prior = task_kernel_prior
        self.shared_input = shared_input_space
        self.W_prior_dist = W_prior_dist
        self.v_prior_dist = v_prior_dist

    def _embed(self, nn_apply, X: torch.Tensor) -> torch.Tensor:
        if self.shared_input:
            return nn_apply(X)
        return _with_task(nn_apply(X[:, :-1]), X)

    def model(self, X: torch.Tensor, y: Optional[torch.Tensor] = None, **kwargs) -> None:
        if not self.shared_input and self.num_tasks is None:
            self.num_tasks = int(torch.unique(self.X_train[:, -1]).numel())
        if self.rank is None:
            self.rank = self.num_tasks - 1
        z = self._embed(self._feature_extractor(), X)
        rows = self.num_tasks * X.shape[0] if self.shared_input else X.shape[0]
        f_loc = torch.zeros(rows, dtype=z.dtype, device=z.device)
        data_kernel_params = self.data_kernel_prior() if self.data_kernel_prior else \
            self._sample_kernel_params()
        task_kernel_params = self.task_kernel_prior() if self.task_kernel_prior else \
            self._sample_task_kernel_params()
        kernel_params = {**data_kernel_params, **task_kernel_params}
        noise = self.noise_prior() if self.noise_prior else self._sample_noise()
        k = self.kernel(z, z, kernel_params, noise, **kwargs)
        ppl.sample("y", dist.MultivariateNormal(loc=f_loc, covariance_matrix=k), obs=y)

    def _sample_noise(self) -> torch.Tensor:
        noise_dist = self.noise_prior_dist
        if noise_dist is None:
            noise_dist = dist.LogNormal(0.0, 1.0).expand((self.num_tasks,))
        return ppl.sample("noise", noise_dist.to_event(1))

    def _sample_task_kernel_params(self) -> Dict[str, torch.Tensor]:
        L, T, R = self.num_latents, self.num_tasks, self.rank
        W_dist = self.W_prior_dist or dist.Normal(0.0, 10.0).expand((L, T, R))
        v_dist = self.v_prior_dist or dist.LogNormal(0.0, 1.0).expand((L, T))
        with ppl.plate("latent_plate_task", L):
            W = ppl.sample("W", W_dist.to_event(2))
            v = ppl.sample("v", v_dist.to_event(1))
        return {"W": W, "v": v}

    def _sample_kernel_params(self) -> Dict[str, torch.Tensor]:
        with ppl.plate("latent_plate_data", self.num_latents):
            with ppl.plate("ard", self.kernel_dim):
                length = ppl.sample("k_length", dist.LogNormal(0.0, 1.0))
            # the output scale is pinned near 1 (the task kernel absorbs it)
            scale = ppl.sample("k_scale", dist.Normal(1.0, 1e-4))
        return {"k_length": length, "k_scale": scale}

    def _embed_pair(self, X_new, nn_params):
        def apply(X):
            return self.nn_module.apply(nn_params, X)

        return self._embed(apply, self.X_train), self._embed(apply, X_new)
