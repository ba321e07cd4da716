"""Variational-inference GP, MAP or mean-field posterior (counterpart of
``gpax_tpu/models/vigp.py``).

Same constructor (guide='delta'|'normal'), ``fit(rng_key, X, y, num_steps,
step_size)`` with Adam(b1=0.5), ``get_samples()`` returning the guide
median, and ``predict`` returning (mean, variance diagonal). The model is
ExactGP's, so a step runs K1 for the gram and K2 in the MVN likelihood. The
fit is :class:`~gpax_torch.infer.SVI`'s Python loop over steps; like every
entry point it runs on the CUDA card unless ``device`` says otherwise.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from .. import distributions as dist
from ..infer import SVI, Adam, AutoDelta, AutoNormal, Trace_ELBO
from ..utils.utils import split_in_batches
from .gp import ExactGP


class viGP(ExactGP):
    """GP with variational inference: 'delta' guide = MAP, 'normal' = mean-field."""

    def __init__(self, input_dim: int, kernel="RBF",
                 mean_fn: Optional[Callable] = None,
                 kernel_prior: Optional[Callable] = None,
                 mean_fn_prior: Optional[Callable] = None,
                 noise_prior: Optional[Callable] = None,
                 noise_prior_dist: Optional[dist.Distribution] = None,
                 lengthscale_prior_dist: Optional[dist.Distribution] = None,
                 guide: str = "delta", dtype: Optional[torch.dtype] = None) -> None:
        super().__init__(input_dim, kernel, mean_fn, kernel_prior, mean_fn_prior,
                         noise_prior, noise_prior_dist, lengthscale_prior_dist, dtype)
        self.guide_type = AutoNormal if guide == "normal" else AutoDelta
        self.svi: Optional[SVI] = None
        self.kernel_params: Optional[Dict] = None
        self.loss: Optional[torch.Tensor] = None
        self._restored_median: Optional[Dict] = None  # set by utils.load_vi_state

    def _run_svi(self, rng_key, num_steps: int, step_size: float, X, y, progress_bar: bool,
                 **kwargs):
        self.svi = SVI(self.model, self.guide_type(self.model), Adam(step_size, b1=0.5),
                       Trace_ELBO())
        result = self.svi.run(rng_key, num_steps, X, y, progress_bar=progress_bar, **kwargs)
        self.kernel_params = result.params
        self.loss = result.losses
        return result

    def fit(self, rng_key, X, y, num_steps: int = 1000, step_size: float = 5e-3,
            progress_bar: bool = True, print_summary: bool = True, device=None,
            **kwargs) -> None:
        """Optimize the ELBO for ``num_steps`` Adam(lr=step_size, b1=0.5)
        steps on ``device`` (None: the CUDA card)."""
        X, y = self._set_data(X, y, device)
        self.X_train, self.y_train = X, y
        self._run_svi(rng_key, num_steps, step_size, X, y, progress_bar, **kwargs)
        if print_summary:
            self._print_summary()

    def get_samples(self) -> Dict[str, torch.Tensor]:
        """MAP / posterior-median point estimates from the guide."""
        if self.svi is None and self._restored_median is not None:
            return self._restored_median
        return self.svi.guide.median(self.kernel_params)

    @torch.no_grad()
    def predict(self, rng_key, X_new, samples: Optional[Dict[str, torch.Tensor]] = None,
                noiseless: bool = False, device=None, **kwargs
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(predictive mean, predictive variance diagonal) under the point
        estimate, on ``device`` (None: the CUDA card)."""
        dev = self._to_device(device)
        X_new = self._set_data(X_new, device=dev)
        samples = self._samples_on(self.get_samples() if samples is None else samples, dev)
        mean, cov = self.get_mvn_posterior(X_new, samples, noiseless, **kwargs)
        return mean, cov.diagonal(dim1=-2, dim2=-1)

    def predict_in_batches(self, rng_key, X_new, batch_size: int = 100,
                           samples: Optional[Dict[str, torch.Tensor]] = None,
                           predict_fn: Optional[Callable] = None,
                           noiseless: bool = False, device=None, **kwargs
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, var) over a large grid in chunks of ``batch_size`` points,
        each chunk's results parked on the host."""
        dev = self._to_device(device)
        if predict_fn is None:
            def predict_fn(xi):
                return self.predict(rng_key, xi, samples, noiseless, dev, **kwargs)
        outs = [predict_fn(xi) for xi in
                split_in_batches(self._set_data(X_new, device=dev), batch_size)]
        return (torch.cat([o[0].cpu() for o in outs], 0),
                torch.cat([o[1].cpu() for o in outs], 0))

    def _print_summary(self) -> None:
        print("\nInferred GP parameters")
        for k, vals in self.get_samples().items():
            print(f"{k:<16}", torch.round(vals.detach().cpu(), decimals=4))
