"""Fully Bayesian MLP regression, an sPM (counterpart of
``gpax_tpu/models/bnn.py``): tanh MLP with Normal weights and Cauchy
biases, hidden dims [64, 32] by default, X and y made 2-D."""

from __future__ import annotations

from typing import Callable, List, Optional

from .dkl import get_mlp, get_mlp_prior, sample_biases, sample_weights
from .spm import sPM


class BNN(sPM):
    """Fully Bayesian MLP."""

    def __init__(self, input_dim: int, output_dim: int,
                 noise_prior_dist: Optional[Callable] = None,
                 hidden_dim: Optional[List[int]] = None, **kwargs):
        hidden_dim = [64, 32] if not hidden_dim else hidden_dim
        nn = kwargs.get("nn", get_mlp(hidden_dim))
        nn_prior = kwargs.get("nn_prior", get_mlp_prior(input_dim, output_dim, hidden_dim))
        super().__init__(nn, nn_prior, None, noise_prior_dist)

    def _set_data(self, X, y=None, device=None):
        """X as (n, d) and y as (n, k) float32 tensors on ``device`` (None:
        the CUDA card)."""
        out = super()._set_data(X, y, device)
        X = out[0] if y is not None else out
        X = X if X.ndim > 1 else X[:, None]
        if y is not None:
            y = out[1]
            return X, (y[:, None] if y.ndim < 2 else y)
        return X


__all__ = ["BNN", "get_mlp", "get_mlp_prior", "sample_weights", "sample_biases"]
