"""Bayesian linear regression by SVI with a diagonal-normal guide
(counterpart of ``gpax_tpu/models/linreg.py``): beta ~ N(0, 10) per
feature, alpha ~ N(0, 10), sigma ~ HalfCauchy(1), 5000 Adam steps of 0.01.
MeasuredNoiseGP uses it to extrapolate the measured noise to new points.
It runs on the CUDA card unless ``device`` says otherwise.

The guide starts at the prior medians (numpyro's default,
``init_to_median``), where the JAX package starts it at one prior draw:
from a draw far out in N(0, 10) or HalfCauchy(1) the 5000 steps end on a
plateau of large sigma (alpha ≈ 12, sigma ≈ 13 for targets of 0.03), as
three of eight JAX keys and the port's seed 0 do on MeasuredNoiseGP's test
data.
"""

from __future__ import annotations

import torch

from .. import distributions as dist
from .. import ppl
from ..infer import SVI, Adam, AutoDiagonalNormal, Trace_ELBO
from ..ppl.util import init_to_median, unconstrain
from ..utils.utils import resolve_device


class _MedianInitDiagonalNormal(AutoDiagonalNormal):
    """AutoDiagonalNormal whose loc starts at the prior medians."""

    def _init_unconstrained(self, rng_key, model_args=(), model_kwargs=None):
        super()._init_unconstrained(rng_key, model_args, model_kwargs)  # records the sites
        return unconstrain(self._transforms,
                           init_to_median(self.model, rng_key, model_args, model_kwargs))


class LinReg:
    """Simple Bayesian linear regression (SVI, posterior-median estimate)."""

    def __init__(self):
        self.params = None
        self.svi = None

    @staticmethod
    def model(x, y=None):
        ones = torch.ones(x.shape[1], dtype=x.dtype, device=x.device)
        beta = ppl.sample("beta", dist.Normal(0.0 * ones, 10 * ones))
        alpha = ppl.sample("alpha", dist.Normal(0.0, 10.0))
        sigma = ppl.sample("sigma", dist.HalfCauchy(1.0))
        mu = alpha + x @ beta
        with ppl.plate("data", x.shape[0]):
            ppl.sample("obs", dist.Normal(mu, sigma), obs=y)

    def train(self, x, y, learning_rate: float = 0.01, num_iterations: int = 5000,
              device=None, rng_key=0):
        """``num_iterations`` Adam steps on ``device`` (None: the CUDA card)."""
        dev = resolve_device(device)
        dtype = torch.get_default_dtype()  # float64 after enable_x64
        x = torch.as_tensor(x, dtype=dtype, device=dev)
        x = x if x.ndim > 1 else x[:, None]
        y = torch.as_tensor(y, dtype=dtype, device=dev)
        guide = _MedianInitDiagonalNormal(self.model)
        self.svi = SVI(self.model, guide, Adam(learning_rate), Trace_ELBO())
        result = self.svi.run(rng_key, num_iterations, x, y)
        self.params = guide.median(result.params)

    def predict(self, x_new):
        beta = self.params["beta"]
        x_new = torch.as_tensor(x_new, dtype=beta.dtype, device=beta.device)
        x_new = x_new if x_new.ndim > 1 else x_new[:, None]
        return self.params["alpha"] + x_new @ beta

    def get_params(self):
        return self.params
