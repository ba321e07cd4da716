"""GP with measured per-point noise variances (counterpart of
``gpax_tpu/models/mngp.py``).

The model adds ``diag(measured_noise)`` to the training covariance (on K1's
diagonal) and records the noise site as a deterministic zero; ``fit``
threads the measured noise through MCMC. Prediction extrapolates the noise
to the new points by linear regression ("linreg", :class:`LinReg`) or a
variational GP ("gpreg", :class:`viGP`), and draws from the diagonal of the
predictive covariance only, as the JAX package does.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import torch

from .. import distributions as dist
from .. import ppl
from ..infer import MCMC, NUTS
from ..utils.utils import get_keys, spawn
from .gp import ExactGP
from .linreg import LinReg

kernel_fn_type = Callable[..., torch.Tensor]


class MeasuredNoiseGP(ExactGP):
    """GP whose training-data noise variances were measured, not inferred."""

    _exact_moments_ok = False  # measured noise enters the train covariance

    def __init__(self, input_dim: int, kernel: Union[str, kernel_fn_type] = "RBF",
                 mean_fn: Optional[Callable] = None,
                 kernel_prior: Optional[Callable] = None,
                 mean_fn_prior: Optional[Callable] = None,
                 lengthscale_prior_dist: Optional[dist.Distribution] = None,
                 dtype: Optional[torch.dtype] = None) -> None:
        super().__init__(input_dim, kernel, mean_fn, kernel_prior, mean_fn_prior,
                         None, None, lengthscale_prior_dist, dtype)
        self.measured_noise: Optional[torch.Tensor] = None
        self.noise_predicted: Optional[torch.Tensor] = None

    def model(self, X: torch.Tensor, y: Optional[torch.Tensor] = None,
              measured_noise: Optional[torch.Tensor] = None, **kwargs) -> None:
        f_loc = torch.zeros(X.shape[0], dtype=X.dtype, device=X.device)
        if self.kernel_prior:
            kernel_params = self.kernel_prior()
        else:
            kernel_params = self._sample_kernel_params()
        # noise is observed, not inferred
        ppl.deterministic("noise", torch.zeros((), dtype=X.dtype, device=X.device))
        if self.mean_fn is not None:
            f_loc = f_loc + self._mean_at(X, self._mean_prior(), ppl.batch_ndim())
        # K + diag(measured_noise): the measured variances are the gram's noise
        k = self.kernel(X, X, kernel_params, measured_noise, **kwargs)
        ppl.sample("y", dist.MultivariateNormal(loc=f_loc, covariance_matrix=k), obs=y)

    def fit(self, rng_key, X, y, measured_noise, num_warmup: int = 2000,
            num_samples: int = 2000, num_chains: int = 1, chain_method: str = "sequential",
            progress_bar: bool = True, print_summary: bool = True, device=None,
            **kwargs) -> None:
        """NUTS over the kernel hyperparameters on ``device`` (None: the CUDA
        card) with the measured noise variances (n,) on the diagonal."""
        X, y = self._set_data(X, y, device)
        measured_noise = torch.as_tensor(measured_noise, dtype=self.dtype,
                                         device=X.device).squeeze()
        self.X_train, self.y_train = X, y
        self.measured_noise = measured_noise
        self.mcmc = MCMC(NUTS(self.model, init_strategy="median"), num_warmup=num_warmup,
                         num_samples=num_samples, num_chains=num_chains,
                         chain_method=chain_method, progress_bar=progress_bar)
        self.mcmc.run(rng_key, X, y, measured_noise, **kwargs)
        if print_summary:
            self._print_summary()

    def _predict(self, rng_key, X_new, params, noise_predicted, n, noiseless: bool = False,
                 **kwargs):
        """Draws from the diagonal of the predictive covariance with the
        extrapolated noise added (``mngp.py:87-95``), for a chunk of draws."""
        y_mean, K = self.get_mvn_posterior(X_new, params, noiseless, **kwargs)
        var = K.diagonal(dim1=-2, dim2=-1) + noise_predicted
        sig = torch.sqrt(torch.clamp(var, min=0.0))
        eps = torch.randn((n,) + tuple(y_mean.shape), generator=rng_key, dtype=y_mean.dtype,
                          device=y_mean.device)
        return y_mean, (y_mean + sig * eps).movedim(0, 1)

    def predict(self, rng_key, X_new, samples: Optional[Dict[str, torch.Tensor]] = None,
                n: int = 1, filter_nans: bool = False, noiseless: bool = True,
                device=None, noise_prediction_method: str = "linreg", **kwargs
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean over draws (m,), draws (S, n, m)) on ``device`` (None: the
        CUDA card). The noise at ``X_new`` is extrapolated once and kept."""
        if noise_prediction_method not in ("linreg", "gpreg"):
            raise NotImplementedError(
                "For noise prediction method, select between 'linreg' and 'gpreg'")
        noise_pred_fn = self.linreg if noise_prediction_method == "linreg" else self.gpreg
        dev = self._to_device(device)
        X_new = self._set_data(X_new, device=dev)
        self.measured_noise = self.measured_noise.to(dev)
        if self.noise_predicted is None:
            self.noise_predicted = noise_pred_fn(self.X_train, self.measured_noise, X_new,
                                                 **kwargs)
        noise_predicted = self.noise_predicted.to(dev)
        samples = self._samples_on(samples, dev)
        num_samples = len(next(iter(samples.values())))
        cs = self._chunk_size(num_samples, X_new.shape[0], with_test_cov=True)
        key = spawn(rng_key, dev)
        means, draws = [], []
        for s0 in range(0, num_samples, cs):
            chunk = {k: v[s0:s0 + cs] for k, v in samples.items()}
            mean, sampled = self._predict(key, X_new, chunk, noise_predicted, n, noiseless,
                                          **kwargs)
            means.append(mean)
            draws.append(sampled)
        y_means, y_sampled = torch.cat(means), torch.cat(draws)
        if filter_nans:
            y_sampled = y_sampled[~torch.isnan(y_sampled).flatten(1).any(1)]
        return y_means.mean(0), y_sampled

    def linreg(self, x, y, x_new, **kwargs):
        lreg = LinReg()
        lreg.train(x, y, device=x.device)
        return lreg.predict(x_new)

    def gpreg(self, x, y, x_new, **kwargs):
        from .vigp import viGP

        keys = get_keys()
        vigp = viGP(self.kernel_dim, "RBF")
        vigp.fit(keys[0], x, y, progress_bar=False, print_summary=False, device=x.device)
        return vigp.predict(keys[1], x_new, noiseless=True, device=x.device)[0]
