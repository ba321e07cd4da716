"""Variational deep kernel learning (counterpart of
``gpax_tpu/models/vidkl.py``).

An NN feature extractor (the 64-64-z ReLU ``MLP`` by default) registered
either as Bayesian latents (Normal weights, Cauchy biases; MAP under the
'delta' guide) or as one MLE param site, a GP on its embedding, and SVI
with Adam(b1=0.5). Each step runs K1 on the embedding's gram, whose
backward carries the gradient into the network through ``dXs``, and K2 in
the float64 factor of the MVN likelihood.

Where the JAX package vmaps the whole SVI fit, over the channels of a 2-D y
(``vidkl.py:118-125``) or over the models of an ensemble
(``vidkl.py:235-254``), the port fits them as one batched program
(``SVI.run`` with a list of generators): every site leads with the batch
dim B, so a step runs the B networks as batched matmuls, ONE K1 launch for
the (B, n, n) grams, one float64 factorization of the batch (one host sync)
and K2 once on its B·n/128 diagonal tiles. As in JAX, the models of an
ensemble draw their initial latents from keys of their own, and every
channel starts from the same key. 'parallel' is the same batched program:
sharding models over several cards (``parallel/``) is not ported.
Everything else runs on the CUDA card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from .. import distributions as dist
from .. import ppl
from ..infer import SVI, Adam, AutoDelta, AutoNormal, Trace_ELBO
from ..nn.modules import MLP, Module, as_module, module_param, random_module
from ..ops.linalg import gp_predictive_moments, mvn_sample_from_cov
from ..utils.utils import get_haiku_dict, resolve_device, spawn, split_in_batches, tree_map
from .gp import ExactGP


def _same_key(rng_key: Union[torch.Generator, int]):
    """A copy of ``rng_key`` in the same state: channels handed copies of
    one key draw the same initial values."""
    if isinstance(rng_key, int):
        return rng_key
    g = torch.Generator(device=rng_key.device)
    g.set_state(rng_key.get_state())
    return g


class viDKL(ExactGP):
    """SVI-trained deep kernel learning with the port's NN modules."""

    # the GP's inputs are the network's embedding: never the fused
    # likelihood, whose X-cotangent is zero (see ExactGP._fused_likelihood_ok)
    _input_is_constant = False

    def __init__(self, input_dim: Union[int, Tuple[int, ...]], z_dim: int = 2,
                 kernel="RBF", kernel_prior: Optional[Callable] = None,
                 nn: Optional[Union[Module, Tuple[Callable, Callable]]] = None,
                 nn_prior: bool = True, latent_prior: Optional[Callable] = None,
                 guide: str = "delta", **kwargs) -> None:
        super().__init__(
            input_dim if isinstance(input_dim, int) else int(np.prod(input_dim)),
            kernel, None, kernel_prior, **kwargs)
        if guide not in ("delta", "normal"):
            raise NotImplementedError("Select guide between 'delta' and 'normal'")
        self.nn_module: Module = as_module(nn) if nn is not None else MLP(z_dim)
        self.nn_prior = nn_prior
        self.kernel_dim = z_dim
        self.data_dim = (input_dim,) if isinstance(input_dim, int) else tuple(input_dim)
        self.latent_prior = latent_prior
        self.guide_type = AutoNormal if guide == "normal" else AutoDelta
        self.kernel_params: Optional[Dict] = None
        self.nn_params: Optional[Dict] = None
        self.loss: Optional[torch.Tensor] = None

    # ------------------------------------------------------------------ model

    def _feature_extractor(self):
        if self.nn_prior:  # MAP over the NN weights
            return random_module("feature_extractor", self.nn_module, (1, *self.data_dim))
        return module_param("feature_extractor", self.nn_module, (1, *self.data_dim))

    def model(self, X: torch.Tensor, y: Optional[torch.Tensor] = None, **kwargs) -> None:
        z = self._feature_extractor()(X)
        if self.latent_prior:
            z = self.latent_prior(z)
        kernel_params = self.kernel_prior() if self.kernel_prior else \
            self._sample_kernel_params()
        noise = self._sample_noise()
        f_loc = torch.zeros(z.shape[-2], dtype=z.dtype, device=z.device)
        # z twice, the same tensor: the gram's symmetric backward
        k = self.kernel(z, z, kernel_params, noise, **kwargs)
        ppl.sample("y", dist.MultivariateNormal(loc=f_loc, covariance_matrix=k), obs=y)

    # -------------------------------------------------------------------- fit

    def _run_fit(self, rng_key, X, y, num_steps: int, step_size: float, **kwargs):
        """SVI on (X, y); ``rng_key`` a key, or a list of B keys for B models
        at once. Returns (nn_params, kernel_params, losses), with a leading
        B on every leaf in the batched case."""
        svi = SVI(self.model, self.guide_type(self.model), Adam(step_size, b1=0.5),
                  Trace_ELBO())
        result = svi.run(rng_key, num_steps, X, y, **kwargs)
        if self.nn_prior:
            params_map = svi.guide.median(result.params)
            nn_params = get_haiku_dict(params_map)
            kernel_params = {k: v for k, v in params_map.items()
                             if not k.startswith("feature_extractor")}
        else:
            nn_params = result.params["feature_extractor$params"]
            kernel_params = svi.guide.median(result.params)
        return nn_params, kernel_params, result.losses

    def single_fit(self, rng_key, X, y, num_steps: int = 1000, step_size: float = 5e-3,
                   print_summary: bool = True, progress_bar: bool = True, device=None,
                   **kwargs) -> Tuple[Dict, Dict, torch.Tensor]:
        """One SVI fit on ``device`` (None: the CUDA card); returns
        (nn_params, kernel_params, losses)."""
        X, y = self._set_data(X, y, device)
        return self._run_fit(rng_key, X, y, num_steps, step_size, **kwargs)

    def fit(self, rng_key, X, y, num_steps: int = 1000, step_size: float = 5e-3,
            print_summary: bool = True, progress_bar: bool = True, device=None,
            **kwargs) -> None:
        """Fit on ``device`` (None: the CUDA card). A 2-D y (channels, n) fits
        one model per channel, all in one batched SVI run, each channel
        starting from the same key (``vidkl.py:181-196``)."""
        X, y = self._set_data(X, y, device)
        self.X_train, self.y_train = X, y
        if y.ndim == 2:
            keys = [_same_key(rng_key) for _ in range(y.shape[0])]
            self.nn_params, self.kernel_params, self.loss = self._run_fit(
                keys, X, y, num_steps, step_size, **kwargs)
            if progress_bar:
                tail = self.loss[:, num_steps - max(1, num_steps // 20):]
                print(f"init loss: {self.loss[:, 0].mean().item():.4f}, "
                      f"final loss (avg): {tail.mean().item():.4f}")
        else:
            self.nn_params, self.kernel_params, self.loss = self._run_fit(
                rng_key, X, y, num_steps, step_size, **kwargs)
        if print_summary:
            self._print_summary()

    # ------------------------------------------------------------- prediction

    def _embed_pair(self, X_new, nn_params):
        """(z_train, z_new) under ``nn_params``."""
        return (self.nn_module.apply(nn_params, self.X_train),
                self.nn_module.apply(nn_params, X_new))

    def get_mvn_posterior(self, X_new: torch.Tensor, nn_params: Dict, k_params: Dict,
                          noiseless: bool = False, y_residual: Optional[torch.Tensor] = None,
                          **kwargs) -> Tuple[torch.Tensor, torch.Tensor]:
        """Predictive mean and covariance at X_new; parameters with a leading
        batch dim (channels or ensemble models) give one of each a model."""
        if y_residual is None:
            y_residual = self.y_train
        noise = k_params["noise"]
        noise_p = noise * (1 - int(noiseless))
        z_train, z_new = self._embed_pair(X_new, nn_params)
        k_pp = self.kernel(z_new, z_new, k_params, noise_p, **kwargs)
        k_pX = self.kernel(z_new, z_train, k_params, jitter=0.0)
        k_XX = self.kernel(z_train, z_train, k_params, noise, **kwargs)
        return gp_predictive_moments(k_XX, k_pX, k_pp, y_residual)

    def _state_on(self, device) -> Tuple[torch.device, Dict, Dict]:
        dev = self._to_device(device)
        return (dev, tree_map(lambda v: v.to(dev), self.nn_params),
                tree_map(lambda v: v.to(dev), self.kernel_params))

    @torch.no_grad()
    def sample_from_posterior(self, rng_key, X_new, n: int = 1000, noiseless: bool = False,
                              device=None, **kwargs) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, n draws (n, m)) of the predictive MVN at X_new."""
        if self.y_train.ndim > 1:
            raise NotImplementedError("Currently does not support a multi-channel regime")
        dev, nn_p, k_p = self._state_on(device)
        X_new = self._set_data(X_new, device=dev)
        y_mean, K = self.get_mvn_posterior(X_new, nn_p, k_p, noiseless, **kwargs)
        return y_mean, mvn_sample_from_cov(spawn(rng_key, dev), y_mean, K, n)

    def get_samples(self) -> Tuple[Dict, Dict]:
        """(nn weights, kernel hyperparameters)."""
        return self.nn_params, self.kernel_params

    @torch.no_grad()
    def predict(self, rng_key, X_new, params: Optional[Tuple[Dict, Dict]] = None,
                noiseless: bool = False, *args, device=None, **kwargs
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, variance) at X_new on ``device`` (None: the CUDA card): (m,)
        each, or (B, m) for B channels or ensemble models. Extra positional
        arguments are ignored, as in the JAX package."""
        dev, nn_p, k_p = self._state_on(device)
        if params is not None:
            nn_p, k_p = (tree_map(lambda v: torch.as_tensor(v, device=dev), p) for p in params)
        X_new = self._set_data(X_new, device=dev)
        mean, cov = self.get_mvn_posterior(X_new, nn_p, k_p, noiseless, **kwargs)
        return mean, cov.diagonal(dim1=-2, dim2=-1)

    def predict_in_batches(self, rng_key, X_new, batch_size: int = 100,
                           params: Optional[Tuple[Dict, Dict]] = None,
                           noiseless: bool = False, device=None, **kwargs
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``predict`` over X_new in chunks of ``batch_size`` points, each
        chunk's results parked on the host."""
        dev = self._to_device(device)
        outs = [self.predict(rng_key, xi, params, noiseless, device=dev, **kwargs)
                for xi in split_in_batches(self._set_data(X_new, device=dev), batch_size)]
        cat = outs[0][0].ndim - 1
        return (torch.cat([o[0].cpu() for o in outs], cat),
                torch.cat([o[1].cpu() for o in outs], cat))

    def fit_predict(self, rng_key, X, y, X_new, num_steps: int = 1000,
                    step_size: float = 5e-3, n_models: int = 1, batch_size: int = 100,
                    noiseless: bool = False, ensemble_method: str = "vectorized",
                    print_summary: bool = True, progress_bar: bool = True, device=None,
                    **kwargs) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fit and predict on ``device`` (None: the CUDA card), as an ensemble
        of ``n_models`` models when it is more than one: one batched SVI run
        from ``n_models`` keys split from ``rng_key``, then the posterior of
        every model at the whole of X_new, (n_models, m) each. The fitted
        ensemble's parameters stay on the model (``get_samples``)."""
        if n_models > 1 and ensemble_method not in ("vectorized", "parallel"):
            raise ValueError("ensemble_method must be 'vectorized' or 'parallel'")
        if isinstance(rng_key, int):
            rng_key = torch.Generator().manual_seed(rng_key)
        keys = [spawn(rng_key) for _ in range(n_models)]
        if n_models == 1:
            self.fit(keys[0], X, y, num_steps, step_size, print_summary, progress_bar,
                     device, **kwargs)
            return self.predict_in_batches(keys[0], X_new, batch_size, None, noiseless,
                                           device, **kwargs)
        X, y = self._set_data(X, y, device)
        if y.ndim == 2:
            raise NotImplementedError("an ensemble of multi-channel fits is not supported")
        self.X_train, self.y_train = X, y
        self.nn_params, self.kernel_params, self.loss = self._run_fit(
            keys, X, y, num_steps, step_size, **kwargs)
        X_new = self._set_data(X_new, device=X.device)
        with torch.no_grad():
            mean, cov = self.get_mvn_posterior(X_new, self.nn_params, self.kernel_params,
                                               noiseless, **kwargs)
        return mean, cov.diagonal(dim1=-2, dim2=-1)

    @torch.no_grad()
    def embed(self, X_new, device=None) -> torch.Tensor:
        """X_new embedded by the trained feature extractor(s): (n, z), or
        (B, n, z) for B channels or ensemble models."""
        dev, nn_p, _ = self._state_on(device)
        return self.nn_module.apply(nn_p, self._set_data(X_new, device=dev))

    # ------------------------------------------------------------- utilities

    def _set_data(self, X, y=None, device=None):
        """Tensors of ``self.dtype`` on ``device`` (None: the CUDA card); a
        1-D X becomes (n, 1), and y keeps its shape: 2-D y is channels."""
        X = torch.as_tensor(X, dtype=self.dtype, device=resolve_device(device))
        X = X if X.ndim > 1 else X[:, None]
        if y is not None:
            return X, torch.as_tensor(y, dtype=self.dtype, device=X.device)
        return X

    def _print_summary(self) -> None:
        if isinstance(self.kernel_params, dict):
            print("\nInferred GP kernel parameters")
            for k, vals in self.kernel_params.items():
                print(f"{k:<16}", torch.round(vals.detach().cpu(), decimals=4))
