"""Structured (parametric) probabilistic model with NUTS inference
(counterpart of ``gpax_tpu/models/spm.py``).

The user supplies a deterministic model ``m(X, params)`` and a prior
program; the likelihood is y ~ Normal(m(X, θ), σ). The fit is the port's
NUTS, on the CUDA card unless the caller passes ``device="cpu"``.
The user's model is written for one draw of its parameters: lockstep
chains and ``predict`` map it over the draws with
``utils.fn.call_batched`` (``torch.func.vmap``, or draw by draw where vmap
cannot run it), as the JAX package vmaps it.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, Optional, Tuple

import torch

from .. import distributions as dist
from .. import ppl
from ..infer import MCMC, NUTS
from ..utils.fn import call_batched
from ..utils.utils import resolve_device, spawn

model_type = Callable[[torch.Tensor, Dict[str, torch.Tensor]], torch.Tensor]
prior_type = Callable[[], Dict[str, torch.Tensor]]


class sPM:
    """Bayesian inference over a user-defined parametric model."""

    def __init__(self, model: model_type, model_prior: prior_type,
                 noise_prior: Optional[prior_type] = None,
                 noise_prior_dist: Optional[dist.Distribution] = None) -> None:
        self._model = model
        self.model_prior = model_prior
        if noise_prior is not None:
            warnings.warn("`noise_prior` is deprecated; pass `noise_prior_dist` instead.",
                          FutureWarning)
        self.noise_prior = noise_prior
        self.noise_prior_dist = noise_prior_dist
        self.dtype = torch.get_default_dtype()  # float64 after enable_x64
        self.mcmc: Optional[MCMC] = None

    def model(self, X: torch.Tensor, y: Optional[torch.Tensor] = None) -> None:
        params = self.model_prior()
        batch_ndim = ppl.batch_ndim()
        mu = ppl.deterministic("mu", call_batched(self._model, X, params, batch_ndim))
        sig = self.noise_prior() if self.noise_prior else self._sample_noise()
        if batch_ndim:  # each chain's noise over its own points
            sig = sig.reshape(sig.shape + (1,) * (mu.ndim - sig.ndim))
        ppl.sample("y", dist.Normal(mu, sig), obs=y)

    def _sample_noise(self) -> torch.Tensor:
        noise_dist = self.noise_prior_dist
        if noise_dist is None:
            noise_dist = dist.LogNormal(0.0, 1.0)
        return ppl.sample("noise", noise_dist)

    def fit(self, rng_key, X, y, num_warmup: int = 2000, num_samples: int = 2000,
            num_chains: int = 1, chain_method: str = "sequential",
            progress_bar: bool = True, print_summary: bool = True, device=None) -> None:
        """NUTS over the model's parameters and the noise on ``device`` (None:
        the CUDA card), with the JAX package's tree depth of 10."""
        X, y = self._set_data(X, y, device)
        self.mcmc = MCMC(NUTS(self.model, init_strategy="median"), num_warmup=num_warmup,
                         num_samples=num_samples, num_chains=num_chains,
                         chain_method=chain_method, progress_bar=progress_bar)
        self.mcmc.run(rng_key, X, y)
        if print_summary:
            self._print_summary()

    def get_samples(self, chain_dim: bool = False) -> Dict[str, torch.Tensor]:
        return self.mcmc.get_samples(group_by_chain=chain_dim)

    def get_param_means(self) -> Dict[str, float]:
        samples = self.get_samples()
        return {k: v.mean(0).item() for k, v in samples.items()
                if k != "mu" and v.ndim <= 1}

    def sample_from_prior(self, rng_key, X, num_samples: int = 10, device=None):
        """Prior predictive draws of y at X, on ``device`` (None: the card)."""
        X = self._set_data(X, device=device)
        return ppl.Predictive(self.model, num_samples=num_samples)(
            spawn(rng_key, X.device), X)["y"]

    def sample_single_posterior_predictive(self, rng_key, X_new, params, n_draws):
        """(model mean, mean of ``n_draws`` noisy draws) for one posterior draw."""
        loc = self._model(X_new, params)
        sample = dist.Normal(loc, params["noise"]).sample(rng_key, (n_draws,)).mean(0)
        return loc, sample

    @torch.no_grad()
    def predict(self, rng_key, X_new, samples: Optional[Dict[str, torch.Tensor]] = None,
                n: int = 1, filter_nans: bool = False,
                take_point_predictions_mean: bool = True, device=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Posterior predictive over every draw on ``device`` (None: the CUDA
        card): (the draws' model means, averaged unless
        ``take_point_predictions_mean`` is false; a noisy prediction per draw)."""
        X_new = self._set_data(X_new, device=device)
        if samples is None:
            samples = self.get_samples(chain_dim=False)
        samples = {k: torch.as_tensor(v, device=X_new.device) for k, v in samples.items()}
        key = spawn(rng_key, X_new.device)
        y_pred = call_batched(self._model, X_new, samples, 1)
        sigma = samples["noise"].reshape((-1,) + (1,) * (y_pred.ndim - 1))
        y_sampled = dist.Normal(y_pred, sigma).sample(key, (n,)).mean(0)
        if filter_nans:
            y_sampled = y_sampled[~torch.isnan(y_sampled).flatten(1).any(1)]
        if take_point_predictions_mean:
            y_pred = y_pred.mean(0)
        return y_pred, y_sampled

    def _print_summary(self) -> None:
        self.mcmc.print_summary()

    def _set_data(self, X, y=None, device=None):
        """Float32 tensors on ``device`` (None: the CUDA card)."""
        X = torch.as_tensor(X, dtype=self.dtype, device=resolve_device(device))
        if y is not None:
            return X, torch.as_tensor(y, dtype=self.dtype, device=X.device)
        return X
