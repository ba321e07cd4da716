"""GP with uncertain inputs (counterpart of ``gpax_tpu/models/uigp.py``):
the true inputs X' are latent and inferred jointly with the kernel.

Per-feature input noise ``sigma_x ~ HalfNormal(0.1)`` (which assumes X
normalized to (0, 1), and warns otherwise), latent ``X' ~ Normal(X,
sigma_x)`` under plates, and the GP on X'. X' is latent, so the model takes
the composed likelihood route (``_input_is_constant = False``): K1 builds
the gram on X' and its closed-form backward carries the gradient into X'.
The posterior uses the sampled training X'; prediction samples noisy test
inputs with the learned ``sigma_x`` and averages them.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from .. import distributions as dist
from .. import ppl
from ..ops.linalg import gp_predictive_moments, robust_mvn_sample
from ..utils.utils import resolve_device
from .gp import ExactGP

kernel_fn_type = Callable[..., torch.Tensor]


class UIGP(ExactGP):
    """Uncertain-input GP."""

    _exact_moments_ok = False  # the posterior uses the latent inputs X_prime
    _input_is_constant = False  # the gram's inputs X' are latent

    def __init__(self, input_dim: int, kernel: Union[str, kernel_fn_type] = "RBF",
                 mean_fn: Optional[Callable] = None,
                 kernel_prior: Optional[Callable] = None,
                 mean_fn_prior: Optional[Callable] = None,
                 noise_prior: Optional[Callable] = None,
                 noise_prior_dist: Optional[dist.Distribution] = None,
                 lengthscale_prior_dist: Optional[dist.Distribution] = None,
                 sigma_x_prior_dist: Optional[dist.Distribution] = None,
                 dtype: Optional[torch.dtype] = None) -> None:
        super().__init__(input_dim, kernel, mean_fn, kernel_prior, mean_fn_prior,
                         noise_prior, noise_prior_dist, lengthscale_prior_dist, dtype)
        self.sigma_x_prior_dist = sigma_x_prior_dist

    def model(self, X: torch.Tensor, y: Optional[torch.Tensor] = None, **kwargs) -> None:
        f_loc = torch.zeros(X.shape[0], dtype=X.dtype, device=X.device)
        X_prime = self._sample_x(X)
        if self.kernel_prior:
            kernel_params = self.kernel_prior()
        else:
            kernel_params = self._sample_kernel_params()
        if self.noise_prior:
            noise = self.noise_prior()
        else:
            noise = self._sample_noise()
        if self.mean_fn is not None:
            f_loc = f_loc + self._mean_at(X_prime, self._mean_prior(), ppl.batch_ndim(), x_batched=ppl.batch_ndim() > 0)
        k = self.kernel(X_prime, X_prime, kernel_params, noise, **kwargs)
        ppl.sample("y", dist.MultivariateNormal(loc=f_loc, covariance_matrix=k), obs=y)

    def _sample_x(self, X: torch.Tensor) -> torch.Tensor:
        n_samples, n_features = X.shape
        sigma_x_dist = self.sigma_x_prior_dist
        if sigma_x_dist is None:
            sigma_x_dist = dist.HalfNormal(0.1 * torch.ones(n_features, dtype=X.dtype,
                                                            device=X.device))
        with ppl.plate("feature_variance_plate", self.kernel_dim):
            sigma_x = ppl.sample("sigma_x", sigma_x_dist)
            with ppl.plate("X_prime_plate", n_samples):
                # sigma_x (…, d) broadcasts over the n rows of X
                X_prime = ppl.sample("X_prime", dist.Normal(X, sigma_x.unsqueeze(-2)))
        return X_prime

    def get_mvn_posterior(self, X_new: torch.Tensor, params: Dict[str, torch.Tensor],
                          noiseless: bool = False, **kwargs
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The posterior on the sampled latent training inputs X' of a chunk
        of draws (``uigp.py:77-96``); ``X_new`` is (m, d) or one set per
        draw (S, m, d)."""
        X_train_prime = params["X_prime"]
        noise = params["noise"]
        noise_p = noise * (1 - int(noiseless))
        y_residual = self.y_train
        draws = self._draw_ndim(params)
        if self.mean_fn is not None:
            y_residual = y_residual - self._mean_at(X_train_prime, params, draws,
                                                    x_batched=draws > 0)
        k_pp = self.kernel(X_new, X_new, params, noise_p, **kwargs)
        k_pX = self.kernel(X_new, X_train_prime, params, jitter=0.0)
        k_XX = self.kernel(X_train_prime, X_train_prime, params, noise, **kwargs)
        mean, cov = gp_predictive_moments(k_XX, k_pX, k_pp, y_residual)
        if self.mean_fn is not None:
            mean = mean + self._mean_at(X_new, params, draws,
                                        x_batched=X_new.ndim > X_train_prime.ndim - draws)
        return mean, cov

    def _predict(self, rng_key: torch.Generator, X_new: torch.Tensor,
                 params: Dict[str, torch.Tensor], n: int, noiseless: bool = False,
                 **kwargs) -> Tuple[torch.Tensor, torch.Tensor]:
        """Noisy test inputs drawn with each draw's learned sigma_x and
        averaged, then the posterior there (``uigp.py:98-108``)."""
        X_new_prime = dist.Normal(X_new, params["sigma_x"].unsqueeze(-2)).sample(
            rng_key, sample_shape=(n,)).mean(0)
        y_mean, K = self.get_mvn_posterior(X_new_prime, params, noiseless, **kwargs)
        y_sampled = robust_mvn_sample(rng_key, y_mean, K, n)
        return y_mean, y_sampled.movedim(0, 1)

    def _set_data(self, X, y=None, device=None):
        X = torch.as_tensor(X, dtype=self.dtype, device=resolve_device(device))
        X = X if X.ndim > 1 else X[:, None]
        if y is not None:
            if not (float(X.max()) == 1 and float(X.min()) == 0) and not self.sigma_x_prior_dist:
                warnings.warn(
                    "The default `sigma_x` prior assumes inputs normalized to (0, 1); "
                    "consider passing sigma_x_prior_dist=gpax_torch.distributions."
                    "HalfNormal(scale).", UserWarning)
            return X, torch.as_tensor(y, dtype=self.dtype, device=X.device).squeeze()
        return X

    def _print_summary(self) -> None:
        from ..infer import diagnostics

        samples = self.get_samples(chain_dim=True)
        diagnostics.print_summary({k: v for k, v in samples.items() if "X_prime" not in k})
