"""Heteroskedastic GP (counterpart of ``gpax_tpu/models/hskgp.py``): a
latent noise GP models the per-point log-variance.

The noise GP samples ``log_var ~ MVN(noise_f_loc, K_noise)`` as a latent;
the main GP observes ``y ~ MVN(f_loc, K + diag(exp(log_var)))``, the
per-point variance riding on K1's diagonal. The noise kernel's
hyperparameters carry the ``k_noise_`` prefix (``utils.fn.
_set_noise_kernel_fn``). Each potential builds both grams on K1 and factors
both MVNs through K2; prediction regresses the latent log-variance onto
the new points with the noise kernel and adds ``diag(exp(log_var*))`` to
the main predictive covariance.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import torch

from .. import distributions as dist
from .. import ppl
from ..kernels import get_kernel
from ..ops.linalg import cho_solve, gp_predictive_moments, safe_cholesky
from ..utils.fn import _set_noise_kernel_fn, call_batched
from .gp import ExactGP

kernel_fn_type = Callable[..., torch.Tensor]


class VarNoiseGP(ExactGP):
    """GP with input-dependent (GP-modeled) observational noise."""

    _exact_moments_ok = False  # noise is a latent field, not params["noise"]
    _draw_site = ("log_var", 1)

    def __init__(self, input_dim: int, kernel: Union[str, kernel_fn_type],
                 noise_kernel: Union[str, kernel_fn_type] = "RBF",
                 mean_fn: Optional[Callable] = None,
                 kernel_prior: Optional[Callable] = None,
                 mean_fn_prior: Optional[Callable] = None,
                 noise_kernel_prior: Optional[Callable] = None,
                 lengthscale_prior_dist: Optional[dist.Distribution] = None,
                 noise_mean_fn: Optional[Callable] = None,
                 noise_mean_fn_prior: Optional[Callable] = None,
                 noise_lengthscale_prior_dist: Optional[dist.Distribution] = None,
                 dtype: Optional[torch.dtype] = None) -> None:
        super().__init__(input_dim, kernel, mean_fn, kernel_prior, mean_fn_prior,
                         None, None, lengthscale_prior_dist, dtype)
        noise_kernel_ = get_kernel(noise_kernel)
        self.noise_kernel = (_set_noise_kernel_fn(noise_kernel_)
                             if isinstance(noise_kernel, str) else noise_kernel_)
        self.noise_mean_fn = noise_mean_fn
        self.noise_mean_fn_prior = noise_mean_fn_prior
        self.noise_kernel_prior = noise_kernel_prior
        self.noise_lengthscale_prior_dist = noise_lengthscale_prior_dist

    def model(self, X: torch.Tensor, y: Optional[torch.Tensor] = None, **kwargs) -> None:
        f_loc = torch.zeros(X.shape[0], dtype=X.dtype, device=X.device)
        noise_f_loc = torch.zeros(X.shape[0], dtype=X.dtype, device=X.device)

        # the noise GP: a latent log-variance field
        if self.noise_kernel_prior:
            noise_kernel_params = self.noise_kernel_prior()
        else:
            noise_kernel_params = self._sample_noise_kernel_params()
        if self.noise_mean_fn is not None:
            prior = self.noise_mean_fn_prior
            noise_f_loc = noise_f_loc + torch.log(call_batched(
                self.noise_mean_fn, X, prior() if prior is not None else None,
                ppl.batch_ndim() if prior is not None else 0, squeeze=True))
        k_noise = self.noise_kernel(X, X, noise_kernel_params, 0, **kwargs)
        points_log_var = ppl.sample(
            "log_var", dist.MultivariateNormal(loc=noise_f_loc, covariance_matrix=k_noise))

        # the main GP observing y with per-point noise
        if self.kernel_prior:
            kernel_params = self.kernel_prior()
        else:
            kernel_params = self._sample_kernel_params()
        if self.mean_fn is not None:
            f_loc = f_loc + self._mean_at(X, self._mean_prior(), ppl.batch_ndim())
        # K + diag(exp(log_var)): the per-point variance is the gram's noise
        k = self.kernel(X, X, kernel_params, torch.exp(points_log_var), **kwargs)
        ppl.sample("y", dist.MultivariateNormal(loc=f_loc, covariance_matrix=k), obs=y)

    def _sample_noise_kernel_params(self) -> Dict[str, torch.Tensor]:
        noise_length_dist = self.noise_lengthscale_prior_dist
        if noise_length_dist is None:
            noise_length_dist = dist.LogNormal(0.0, 1.0)
        noise_scale = ppl.sample("k_noise_scale", dist.LogNormal(0.0, 1.0))
        noise_length = ppl.sample("k_noise_length", noise_length_dist)
        return {"k_noise_length": noise_length, "k_noise_scale": noise_scale}

    def _noise_mean(self, X: torch.Tensor, params) -> torch.Tensor:
        """log of the noise mean function at X for a draw or a batch of draws."""
        if self.noise_mean_fn_prior is None:
            return torch.log(self.noise_mean_fn(X)).squeeze()
        return torch.log(call_batched(self.noise_mean_fn, X, params, self._draw_ndim(params),
                                      squeeze=True))

    def get_mvn_posterior(self, X_new: torch.Tensor, params: Dict[str, torch.Tensor],
                          *args, **kwargs) -> Tuple[torch.Tensor, torch.Tensor]:
        """The main GP's posterior plus the noise GP's regressed predictive
        variance, for a chunk of draws (``hskgp.py:104-135``); the noise is
        part of the covariance whatever ``noiseless`` says, as in the JAX
        package."""
        mean, cov = gp_predictive_moments(
            self.kernel(self.X_train, self.X_train, params, 0, **kwargs),
            self.kernel(X_new, self.X_train, params, jitter=0.0),
            self.kernel(X_new, X_new, params, 0, **kwargs), self._residual(params))
        mean = self._add_mean(mean, X_new, params)

        # regress the latent log-variance onto X_new with the noise kernel
        k_pX_noise = self.noise_kernel(X_new, self.X_train, params, jitter=0.0)
        k_XX_noise = self.noise_kernel(self.X_train, self.X_train, params, 0, **kwargs)
        log_var_residual = params["log_var"]
        if self.noise_mean_fn is not None:
            log_var_residual = log_var_residual - self._noise_mean(self.X_train, params)
        L_noise = safe_cholesky(k_XX_noise)
        predicted_log_var = (k_pX_noise @ cho_solve(L_noise, log_var_residual)[..., None]
                             )[..., 0]
        if self.noise_mean_fn is not None:
            predicted_log_var = predicted_log_var + self._noise_mean(X_new, params)
        return mean, cov + torch.diag_embed(torch.exp(predicted_log_var))

    def get_data_var_samples(self) -> torch.Tensor:
        """Inferred per-point training noise (variance) samples, (S, n)."""
        samples = self.mcmc.get_samples()
        log_var = samples["log_var"]
        if self.noise_mean_fn is not None:
            X = self.X_train.squeeze()
            if self.noise_mean_fn_prior is not None:
                mean_ = call_batched(self.noise_mean_fn, X, samples, 1)
            else:
                mean_ = self.noise_mean_fn(X)
            log_var = log_var + torch.log(mean_)
        return torch.exp(log_var)

    def _print_summary(self) -> None:
        from ..infer import diagnostics

        samples = self.get_samples(chain_dim=True)
        diagnostics.print_summary({k: v for k, v in samples.items() if "log_var" not in k})
