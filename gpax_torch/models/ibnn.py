"""Infinite-width Bayesian neural network (counterpart of
``gpax_tpu/models/ibnn.py``): ExactGP with the NNGP kernel and
LogNormal(0, 1) priors over ``var_b`` and ``var_w``. The NNGP gram is plain
torch; its MVN factor goes through K2."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .. import distributions as dist
from .. import ppl
from ..kernels import get_kernel
from .gp import ExactGP


class iBNN(ExactGP):
    """HMC-inferred infinite-width BNN."""

    def __init__(self, input_dim: int, depth: int = 3, activation: str = "erf",
                 mean_fn: Optional[Callable] = None,
                 nngp_prior: Optional[Callable] = None,
                 mean_fn_prior: Optional[Callable] = None,
                 noise_prior: Optional[Callable] = None,
                 noise_prior_dist: Optional[dist.Distribution] = None,
                 dtype: Optional[torch.dtype] = None) -> None:
        super().__init__(input_dim, None, mean_fn, nngp_prior, mean_fn_prior,
                         noise_prior, noise_prior_dist, dtype=dtype)
        self.kernel = get_kernel("NNGP", activation=activation, depth=depth)

    def _sample_kernel_params(self) -> Dict:
        var_b = ppl.sample("var_b", dist.LogNormal(0.0, 1.0))
        var_w = ppl.sample("var_w", dist.LogNormal(0.0, 1.0))
        return {"var_b": var_b, "var_w": var_w}
