"""Variational infinite-width Bayesian neural network (counterpart of
``gpax_tpu/models/vi_ibnn.py``): viGP with the NNGP kernel;
var_b ~ HalfNormal(1), var_w ~ LogNormal(0, 10)."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from .. import distributions as dist
from .. import ppl
from ..kernels import get_kernel
from .vigp import viGP


class vi_iBNN(viGP):
    """SVI-inferred infinite-width BNN."""

    def __init__(self, input_dim: int, depth: int = 3, activation: str = "erf",
                 mean_fn: Optional[Callable] = None,
                 nngp_prior: Optional[Callable] = None,
                 mean_fn_prior: Optional[Callable] = None,
                 noise_prior: Optional[Callable] = None,
                 dtype: Optional[torch.dtype] = None) -> None:
        super().__init__(input_dim, None, mean_fn, nngp_prior, mean_fn_prior, noise_prior,
                         dtype=dtype)
        self.kernel = get_kernel("NNGP", activation=activation, depth=depth)

    def _sample_kernel_params(self) -> Dict:
        var_b = ppl.sample("var_b", dist.HalfNormal(1.0))
        var_w = ppl.sample("var_w", dist.LogNormal(0.0, 10.0))
        return {"var_b": var_b, "var_w": var_w}
