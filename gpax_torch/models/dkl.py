"""Fully Bayesian deep kernel learning: NUTS over a tanh MLP's weights and
the GP hyperparameters (counterpart of ``gpax_tpu/models/dkl.py``).

Normal(0, 1) weights and Cauchy(0, 1) biases, hidden dims [64, 32] by
default, and a GP on the z_dim embedding. The MLP's matmuls are float32 with
TF32 off (the config's pin), where the JAX package asks for
``Precision.HIGHEST``. The MLP broadcasts over leading dims of its
parameters, so ``predict`` and ``embed`` run a chunk of posterior draws as
one batched program (K1 on the chunk's grams, K2 on their factors) where
the JAX package vmaps; a user ``nn`` must do the same. The NUTS fit is
ExactGP's, on the CUDA card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from .. import distributions as dist
from .. import ppl
from ..nn.modules import dense
from ..ops.linalg import gp_predictive_moments
from .gp import ExactGP


def sample_weights(name: str, in_channels: int, out_channels: int) -> torch.Tensor:
    """Normal(0, 1) prior over a weight matrix."""
    return ppl.sample(
        name, dist.Normal(0.0, 1.0).expand((in_channels, out_channels)).to_event(2))


def sample_biases(name: str, channels: int) -> torch.Tensor:
    """Cauchy(0, 1) prior over a bias vector."""
    return ppl.sample(name, dist.Cauchy(0.0, 1.0).expand((channels,)).to_event(1))


def get_mlp(architecture: List[int]) -> Callable:
    """tanh MLP taking a flat params dict {'w0', 'b0', …}; the params may
    carry leading batch dims (posterior draws), which lead the output."""

    def mlp(X: torch.Tensor, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        h = X
        for i in range(len(architecture)):
            h = torch.tanh(dense(h, params[f"w{i}"], params[f"b{i}"]))
        last = len(architecture)
        return dense(h, params[f"w{last}"], params[f"b{last}"])

    return mlp


def get_mlp_prior(input_dim: int, output_dim: int, architecture: List[int]) -> Callable:
    """Prior program over all MLP weights and biases."""

    def mlp_prior() -> Dict[str, torch.Tensor]:
        params = {}
        c_in = input_dim
        for i, c_out in enumerate(architecture):
            params[f"w{i}"] = sample_weights(f"w{i}", c_in, c_out)
            params[f"b{i}"] = sample_biases(f"b{i}", c_out)
            c_in = c_out
        last = len(architecture)
        params[f"w{last}"] = sample_weights(f"w{last}", c_in, output_dim)
        params[f"b{last}"] = sample_biases(f"b{last}", output_dim)
        return params

    return mlp_prior


class DKL(ExactGP):
    """HMC-trained deep kernel learning: a GP over a Bayesian MLP's embedding."""

    _exact_moments_ok = False  # the posterior uses the NN embedding
    _input_is_constant = False

    def __init__(self, input_dim: int, z_dim: int = 2, kernel="RBF",
                 kernel_prior: Optional[Callable] = None, nn: Optional[Callable] = None,
                 nn_prior: Optional[Callable] = None,
                 latent_prior: Optional[Callable] = None,
                 hidden_dim: Optional[List[int]] = None, **kwargs) -> None:
        super().__init__(input_dim, kernel, None, kernel_prior, **kwargs)
        hdim = hidden_dim if hidden_dim is not None else [64, 32]
        self.nn = nn if nn else get_mlp(hdim)
        self.nn_prior = nn_prior if nn_prior else get_mlp_prior(input_dim, z_dim, hdim)
        self.kernel_dim = z_dim
        self.latent_prior = latent_prior

    def model(self, X: torch.Tensor, y: Optional[torch.Tensor] = None, **kwargs) -> None:
        """BNN embedding, then the GP likelihood on it."""
        jitter = kwargs.get("jitter", 1e-6)
        nn_params = self.nn_prior()
        z = self.nn(X, nn_params)
        if self.latent_prior:
            z = self.latent_prior(z)
        kernel_params = self.kernel_prior() if self.kernel_prior else \
            self._sample_kernel_params()
        noise = self._sample_noise()
        f_loc = torch.zeros(z.shape[-2], dtype=z.dtype, device=z.device)
        k = self.kernel(z, z, kernel_params, noise, jitter=jitter)
        ppl.sample("y", dist.MultivariateNormal(loc=f_loc, covariance_matrix=k), obs=y)

    def get_mvn_posterior(self, X_new: torch.Tensor, params: Dict[str, torch.Tensor],
                          noiseless: bool = False, **kwargs
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Embed the training and new points with the sampled weights, then
        the GP posterior; a chunk of draws at once."""
        noise = params["noise"]
        noise_p = noise * (1 - int(noiseless))
        z_train = self.nn(self.X_train, params)
        z_new = self.nn(X_new, params)
        k_pp = self.kernel(z_new, z_new, params, noise_p, **kwargs)
        k_pX = self.kernel(z_new, z_train, params, jitter=0.0)
        k_XX = self.kernel(z_train, z_train, params, noise, **kwargs)
        return gp_predictive_moments(k_XX, k_pX, k_pp, self.y_train)

    @torch.no_grad()
    def embed(self, X_new, device=None) -> torch.Tensor:
        """Embeddings of X_new under every posterior draw, (S, n, z_dim), on
        ``device`` (None: the CUDA card)."""
        dev = self._to_device(device)
        samples = self._samples_on(None, dev)
        return self.nn(self._set_data(X_new, device=dev), samples)

    def _print_summary(self) -> None:
        from ..infer import diagnostics

        keep = ("k_scale", "k_length", "noise", "period")
        samples = self.get_samples(chain_dim=True)
        diagnostics.print_summary({k: v for k, v in samples.items() if k in keep})
