"""Fully Bayesian exact GP regression with NUTS (counterpart of
``gpax_tpu/models/gp.py::ExactGP``).

Same constructor, priors (LogNormal(0, 1) noise, ARD lengthscales under an
'ard' plate, LogNormal output scale, 'period' for the periodic kernel) and
``fit``/``predict`` lifecycle as the JAX package; ``fit`` runs one chain,
sequential chains or chains in lockstep. Every entry point runs on
the CUDA card unless the caller passes ``device="cpu"`` (or another device):
``device=None`` means the card, inputs of any kind are moved there, and
without a card it raises. The likelihood takes one of two routes, chosen by
``_fused_likelihood_ok`` and the config's ``use_fused_likelihood``: the
fused op ``ops.fused_density.gp_mvn_log_prob`` (K1, the float64 factor with
K2's blocked inverse, closed-form θ-gradients), or the composed path:
kernel (K1 for RBF/Matérn) → ``MultivariateNormal`` →
``ops.linalg.mvn_log_prob_centered`` (Cholesky, K2's blocked inverse,
closed-form backward). ``predict`` builds the grams and factors of a chunk
of posterior draws at once; chunks are sized from the device's free memory.

``predict`` and ``predict_moments`` are differentiable in ``X_new``, which
``acquisition.optimize_acq`` uses. Not ported: the TPU auto-segmenting and
the XLA program cache.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from .. import distributions as dist
from .. import ppl
from ..config import get_config, resolve_dtype
from ..infer import MCMC, NUTS
from ..kernels import get_kernel
from ..ops.fused_density import gp_mvn_log_prob
from ..ops.linalg import gp_predictive_mean_var, gp_predictive_moments, robust_mvn_sample
from ..parallel.distributed_chol import active_sharded_linalg
from ..utils.fn import call_batched
from ..utils.utils import device_memory_budget, resolve_device, spawn, split_in_batches

kernel_fn_type = Callable[..., torch.Tensor]

# rows of the test-diagonal chunks in get_predictive_mean_var
_DIAG_CHUNK = 256


class ExactGP:
    """Fully Bayesian exact GP.

    Args:
        input_dim: number of input feature dimensions (ARD lengthscale size).
        kernel: 'RBF' | 'Matern' | 'Periodic' or a kernel callable with
            signature ``k(X, Z, params, noise=0, jitter=None)``.
        mean_fn: optional deterministic mean function ``m(X)`` or ``m(X, params)``,
            written for one draw of ``params``: lockstep chains and chunks of
            predictive draws map it over their draws (``utils.fn.call_batched``).
        kernel_prior: optional custom prior program returning kernel params.
        mean_fn_prior: optional prior program returning mean-fn params.
        noise_prior: deprecated prior program for the noise.
        noise_prior_dist: prior over the noise variance (default LogNormal(0, 1)).
        lengthscale_prior_dist: prior over lengthscales (default LogNormal(0, 1)).
        dtype: dtype of the data and hyperparameters; None takes the
            mode's default at construction: float32, or float64 after
            ``enable_x64()``. K1 takes both; the fused likelihood only
            float32, so a float64 model takes the composed route. The factor
            path runs float64 whatever it is.
    """

    _exact_moments_ok = True
    _default_dense_mass = False
    _data_attrs = ("X_train", "y_train")  # moved together between devices
    # ExactGP.model treats X as constant data: the fused likelihood returns a
    # zero cotangent for X. A subclass whose X depends on parameters (latent
    # inputs) must set this False or override model, or its gradients
    # through the inputs vanish. Read by _fused_likelihood_ok.
    _input_is_constant = True

    def __init__(
        self,
        input_dim: int,
        kernel: Union[str, kernel_fn_type] = "RBF",
        mean_fn: Optional[Callable] = None,
        kernel_prior: Optional[Callable] = None,
        mean_fn_prior: Optional[Callable] = None,
        noise_prior: Optional[Callable] = None,
        noise_prior_dist: Optional[dist.Distribution] = None,
        lengthscale_prior_dist: Optional[dist.Distribution] = None,
        dtype: Optional[torch.dtype] = None,
    ) -> None:
        if noise_prior is not None:
            warnings.warn("`noise_prior` is deprecated; pass `noise_prior_dist` (a "
                          "distribution instance) instead.", FutureWarning)
        if kernel_prior is not None:
            warnings.warn("`kernel_prior` remains available for complex priors; for "
                          "lengthscales only, prefer `lengthscale_prior_dist`.", UserWarning)
        self.kernel_dim = input_dim
        self.kernel = get_kernel(kernel)
        self.kernel_name = kernel if isinstance(kernel, str) else None
        self.mean_fn = mean_fn
        self.kernel_prior = kernel_prior
        self.mean_fn_prior = mean_fn_prior
        self.noise_prior = noise_prior
        self.noise_prior_dist = noise_prior_dist
        self.lengthscale_prior_dist = lengthscale_prior_dist
        self.dtype = resolve_dtype(dtype)
        self.X_train: Optional[torch.Tensor] = None
        self.y_train: Optional[torch.Tensor] = None
        self.mcmc: Optional[MCMC] = None

    # ------------------------------------------------------------------ model

    def model(self, X: torch.Tensor, y: Optional[torch.Tensor] = None,
              noise_mask: Optional[torch.Tensor] = None, **kwargs) -> None:
        """Generative program: kernel/noise/mean priors + MVN likelihood.
        ``noise_mask`` ((n,), optional) is added to the sampled noise; padded
        rows carry a large value so they carry almost no information."""
        f_loc = torch.zeros(X.shape[0], dtype=X.dtype, device=X.device)
        kernel_params = self.kernel_prior() if self.kernel_prior else self._sample_kernel_params()
        noise = self.noise_prior() if self.noise_prior else self._sample_noise()
        if noise_mask is not None:
            # per point: (n,), or (C, n) for a batch of lockstep chains
            noise = (noise[..., None] if torch.as_tensor(noise).ndim else noise) + noise_mask
        if self.mean_fn is not None:
            f_loc = f_loc + self._mean_at(X, self._mean_prior(), ppl.batch_ndim())
        if y is not None and self._fused_likelihood_ok(X, kernel_params):
            # one autograd node from the gram to the density, closed-form
            # θ-gradients (ops/fused_density.py)
            jitter = kwargs.get("jitter")
            if jitter is None:
                jitter = get_config().default_jitter
            # noise + jitter (the kernels' diagonal) + the θ-independent
            # base regularization the composed factor path adds
            noise_eff = noise + jitter + 4.0 * X.shape[0] * torch.finfo(torch.float32).eps
            kind = "rbf" if self.kernel_name == "RBF" else "matern52"
            lp = gp_mvn_log_prob(X.to(torch.float32), kernel_params["k_length"],
                                 kernel_params["k_scale"], noise_eff, y - f_loc, kind)
            ppl.factor("y_log_lik", lp)
        else:
            k = self.kernel(X, X, kernel_params, noise, **kwargs)
            ppl.sample("y", dist.MultivariateNormal(loc=f_loc, covariance_matrix=k), obs=y)

    def _fused_likelihood_ok(self, X: torch.Tensor, kernel_params) -> bool:
        """Whether ``model`` takes the fused likelihood (``gp.py:186-212``):
        outside ``parallel.sharded_linalg`` (whose mesh-split factorization
        owns the density there), the RBF/Matérn hyperparameterization on 2-D
        float32 data with X constant (so a float64 model, as under
        ``enable_x64``, takes the composed route), and then
        ``use_fused_likelihood="always"``, or ``"auto"`` on a CUDA tensor
        with n ≤ ``fused_likelihood_max_n``."""
        cfg = get_config()
        if cfg.use_fused_likelihood == "never":
            return False
        if not getattr(type(self), "_input_is_constant", False):
            return False  # latent-input subclass: X needs real gradients
        if active_sharded_linalg() is not None:
            return False  # the mesh-split factorization owns the density
        if self.kernel_name not in ("RBF", "Matern"):
            return False
        if set(kernel_params) - {"k_length", "k_scale", "period"} or \
                kernel_params.get("period") is not None:
            return False
        if X.ndim != 2 or torch.promote_types(X.dtype, torch.float32) != torch.float32:
            return False
        if cfg.use_fused_likelihood == "always":
            return True
        return X.device.type == "cuda" and X.shape[0] <= cfg.fused_likelihood_max_n

    def _sample_noise(self) -> torch.Tensor:
        noise_dist = self.noise_prior_dist
        if noise_dist is None:
            noise_dist = dist.LogNormal(0.0, 1.0)
        return ppl.sample("noise", noise_dist)

    def _sample_kernel_params(self, output_scale: bool = True) -> Dict[str, torch.Tensor]:
        length_dist = self.lengthscale_prior_dist
        if length_dist is None:
            length_dist = dist.LogNormal(0.0, 1.0)
        with ppl.plate("ard", self.kernel_dim):
            length = ppl.sample("k_length", length_dist)
        if output_scale:
            scale = ppl.sample("k_scale", dist.LogNormal(0.0, 1.0))
        else:
            scale = ppl.deterministic("k_scale", torch.ones((), dtype=self.dtype))
        params = {"k_length": length, "k_scale": scale}
        if self.kernel_name == "Periodic":
            params["period"] = ppl.sample("period", dist.LogNormal(0.0, 1.0))
        else:
            params["period"] = None
        return params

    # ------------------------------------------------------------------ fit

    def fit(
        self,
        rng_key: Union[torch.Generator, int],
        X,
        y,
        num_warmup: int = 2000,
        num_samples: int = 2000,
        num_chains: int = 1,
        chain_method: str = "sequential",
        progress_bar: bool = True,
        print_summary: bool = True,
        device=None,
        pad_to_multiple: Optional[int] = None,
        segment_size: Optional[int] = None,
        dense_mass: Optional[bool] = None,
        max_tree_depth: int = 10,
        target_accept_prob: float = 0.8,
        segment_callback: Optional[Callable] = None,
        deadline: Optional[float] = None,
        warmup_depth_cap: Optional[tuple] = None,
        **kwargs,
    ) -> None:
        """Run NUTS over the GP hyperparameters on ``device`` (None: the CUDA
        card). ``**kwargs`` threads ``jitter`` to the kernel.

        ``pad_to_multiple`` pads the training set to the next multiple with
        rows far outside the data and a large masked noise, so an
        active-learning loop sees few distinct sizes; prediction uses the
        unpadded data. ``num_chains`` > 1 chains run one after another
        under ``chain_method="sequential"``, and in lockstep under
        "vectorized" or "parallel" (``infer.nuts.run_nuts_segmented_chains``:
        one batched potential per leapfrog for all chains, on the data's
        one device). ``segment_size`` runs NUTS in segments of that many
        transitions, with the same draws as the unsegmented run from the
        same generator. On one chain or lockstep chains,
        ``segment_callback`` gets each segment's telemetry, ``deadline`` (a
        ``time.perf_counter()`` value) truncates the draws once warmup is
        done or freezes adaptation when it passes during warmup, and
        ``warmup_depth_cap`` = (cap, n_steps) caps the tree depth of the
        first n_steps warmup transitions; without ``segment_size``, or on
        several sequential chains, they are ignored with a ``UserWarning``,
        as in the JAX package.
        """
        X, y = self._set_data(X, y, device)
        self.X_train, self.y_train = X, y

        fit_args = (X, y)
        if pad_to_multiple:
            n = X.shape[0]
            pad = (-n) % pad_to_multiple
            if pad:
                span = X.amax(0) - X.amin(0) + 1.0
                far = X.amax(0) + 1e3 * span
                steps = torch.arange(pad, dtype=X.dtype, device=X.device)[:, None]
                X_fit = torch.cat([X, far + steps * span])
                y_fit = torch.cat([y, y.new_zeros(pad)])
                noise_mask = torch.cat([X.new_zeros(n), X.new_full((pad,), 1e2)])
                fit_args = (X_fit, y_fit, noise_mask)

        if dense_mass is None:
            dense_mass = self._default_dense_mass
        self.mcmc = MCMC(
            NUTS(self.model, init_strategy="median", dense_mass=dense_mass,
                 max_tree_depth=max_tree_depth, target_accept_prob=target_accept_prob),
            num_warmup=num_warmup, num_samples=num_samples, num_chains=num_chains,
            chain_method=chain_method, progress_bar=progress_bar,
            segment_size=segment_size)
        self.mcmc.segment_callback = segment_callback
        self.mcmc.deadline = deadline
        self.mcmc.warmup_depth_cap = warmup_depth_cap
        self.mcmc.run(rng_key, *fit_args, **kwargs)
        if print_summary:
            self._print_summary()

    def get_samples(self, chain_dim: bool = False) -> Dict[str, torch.Tensor]:
        """Posterior samples (flattened across chains unless ``chain_dim``)."""
        return self.mcmc.get_samples(group_by_chain=chain_dim)

    # ------------------------------------------------------------ prediction

    def _mean_prior(self) -> Optional[Dict[str, torch.Tensor]]:
        """The mean function's sampled parameters (None without a prior)."""
        return self.mean_fn_prior() if self.mean_fn_prior is not None else None

    def _mean_at(self, X: torch.Tensor, params, batch_ndim: int,
                 x_batched: bool = False) -> torch.Tensor:
        """The mean function at X, squeezed, for draws of its parameters that
        carry ``batch_ndim`` leading batch dims. The user's function is
        written for one draw; ``utils.fn.call_batched`` maps it over the
        draws, as the JAX package's vmap does. ``params`` of None (no
        ``mean_fn_prior``) calls ``mean_fn(X)``."""
        if self.mean_fn_prior is None:
            params = None
        return call_batched(self.mean_fn, X, params,
                            batch_ndim if params is not None or x_batched else 0,
                            x_batched, squeeze=True)

    # a site with one value per draw, and its event ndim: the leading dims
    # that the predictive params carry beyond it are a batch of draws
    _draw_site = ("noise", 0)

    def _draw_ndim(self, params) -> int:
        name, event_ndim = self._draw_site
        return torch.as_tensor(params[name]).ndim - event_ndim

    def _residual(self, params) -> torch.Tensor:
        y = self.y_train
        if self.mean_fn is not None:
            y = y - self._mean_at(self.X_train, params, self._draw_ndim(params))
        return y

    def _add_mean(self, mean, X_new, params) -> torch.Tensor:
        if self.mean_fn is not None:
            mean = mean + self._mean_at(X_new, params, self._draw_ndim(params))
        return mean

    def get_mvn_posterior(self, X_new: torch.Tensor, params: Dict[str, torch.Tensor],
                          noiseless: bool = False, **kwargs
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Predictive MVN for posterior draws of the hyperparameters; the
        params may carry a leading batch dim (several draws at once)."""
        noise = params["noise"]
        noise_p = noise * (1 - int(noiseless))
        k_pp = self.kernel(X_new, X_new, params, noise_p, **kwargs)
        k_pX = self.kernel(X_new, self.X_train, params, jitter=0.0)
        k_XX = self.kernel(self.X_train, self.X_train, params, noise, **kwargs)
        mean, cov = gp_predictive_moments(k_XX, k_pX, k_pp, self._residual(params))
        return self._add_mean(mean, X_new, params), cov

    def _predict(self, rng_key: torch.Generator, X_new: torch.Tensor,
                 params: Dict[str, torch.Tensor], n: int, noiseless: bool = False,
                 **kwargs) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mean (S, …, m) and n function draws (S, n, …, m) for a chunk of
        S posterior draws."""
        y_mean, K = self.get_mvn_posterior(X_new, params, noiseless, **kwargs)
        y_sampled = robust_mvn_sample(rng_key, y_mean, K, n)
        return y_mean, y_sampled.movedim(0, 1)

    def _chunk_size(self, num_samples: int, m: int, with_test_cov: bool) -> int:
        """Posterior draws per chunk: live float32 words per draw are about
        fourteen n² (the float32 gram and its float32 factors, the float64
        gram, its jittered copy, factor, inverse and recursion temporaries,
        and their padded copies when n is no multiple of 128), three n·m
        (k_pX and its solves) and, with the test covariance, eight m² (k_pp,
        the covariance, its symmetrized and jittered copies, factor); twice
        that on float64 data (x64 mode), every word counted at 8 bytes."""
        n = self.X_train.shape[0]
        per = self.X_train.element_size() * (14 * n * n + 3 * n * m
                                             + (8 * m * m if with_test_cov else m))
        budget = device_memory_budget(self.X_train.device)
        return int(max(1, min(num_samples, budget // max(per, 1))))

    def _samples_on(self, samples, device) -> Dict[str, torch.Tensor]:
        if samples is None:
            samples = self.get_samples(chain_dim=False)
        return {k: torch.as_tensor(v, dtype=self.dtype, device=device)
                for k, v in samples.items()}

    def predict(self, rng_key: Union[torch.Generator, int], X_new,
                samples: Optional[Dict[str, torch.Tensor]] = None, n: int = 1,
                filter_nans: bool = False, noiseless: bool = False, device=None,
                **kwargs) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fully Bayesian prediction over all posterior draws on ``device``
        (None: the CUDA card), in chunks of draws whose size comes from the
        device's free memory.

        Returns (posterior mean averaged over draws, draws (S, n, m))."""
        dev = self._to_device(device)
        X_new = self._set_data(X_new, device=dev)
        samples = self._samples_on(samples, dev)
        num_samples = len(next(iter(samples.values())))
        cs = self._chunk_size(num_samples, X_new.shape[0], with_test_cov=True)
        key = spawn(rng_key, dev)
        means, draws = [], []
        for s0 in range(0, num_samples, cs):
            chunk = {k: v[s0:s0 + cs] for k, v in samples.items()}
            mean, sampled = self._predict(key, X_new, chunk, n, noiseless, **kwargs)
            means.append(mean)
            draws.append(sampled)
        y_means, y_sampled = torch.cat(means), torch.cat(draws)
        if filter_nans:
            y_sampled = y_sampled[~torch.isnan(y_sampled).flatten(1).any(1)]
        return y_means.mean(0), y_sampled

    def predict_in_batches(self, rng_key: Union[torch.Generator, int], X_new,
                           batch_size: int = 100,
                           samples: Optional[Dict[str, torch.Tensor]] = None,
                           n: int = 1, filter_nans: bool = False,
                           predict_fn: Optional[Callable] = None,
                           noiseless: bool = False, device=None, **kwargs
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Prediction over a large grid in chunks of ``batch_size`` points,
        each chunk's results parked on the host."""
        if isinstance(rng_key, int):
            rng_key = torch.Generator().manual_seed(rng_key)
        dev = self._to_device(device)
        if predict_fn is None:
            def predict_fn(xi):
                return self.predict(rng_key, xi, samples, n, filter_nans, noiseless,
                                    dev, **kwargs)
        outs = [predict_fn(xi) for xi in
                split_in_batches(self._set_data(X_new, device=dev), batch_size)]
        return (torch.cat([o[0].cpu() for o in outs], 0),
                torch.cat([o[1].cpu() for o in outs], -1))

    def get_predictive_mean_var(self, X_new: torch.Tensor, params: Dict[str, torch.Tensor],
                                noiseless: bool = False, **kwargs
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, diagonal variance) for posterior draw(s): O(n²m), never the
        m×m test covariance. k(x*, x*) comes from diagonal blocks of
        ``_DIAG_CHUNK`` test points."""
        jitter = kwargs.get("jitter")
        if jitter is None:
            jitter = get_config().default_jitter
        noise = params["noise"]
        noise_p = noise * (1 - int(noiseless))
        k_pX = self.kernel(X_new, self.X_train, params, jitter=0.0)
        k_XX = self.kernel(self.X_train, self.X_train, params, noise, **kwargs)
        k_pp_diag = torch.cat([
            self.kernel(xc, xc, params, jitter=0.0).diagonal(dim1=-2, dim2=-1)
            for xc in torch.split(X_new, _DIAG_CHUNK)], -1)
        nz = torch.as_tensor(noise_p)
        k_pp_diag = k_pp_diag + (nz[..., None] if nz.ndim else nz) + jitter
        mean, var = gp_predictive_mean_var(k_XX, k_pX, k_pp_diag, self._residual(params))
        return self._add_mean(mean, X_new, params), var

    def predict_moments(self, rng_key, X_new, samples: Optional[Dict[str, torch.Tensor]] = None,
                        noiseless: bool = False, device=None, **kwargs
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Exact moments of the fully Bayesian predictive mixture on
        ``device`` (None: the CUDA card):
        mean = E_s[mean_s], var = E_s[var_s] + Var_s[mean_s]."""
        dev = self._to_device(device)
        X_new = self._set_data(X_new, device=dev)
        samples = self._samples_on(samples, dev)
        num_samples = len(next(iter(samples.values())))
        cs = self._chunk_size(num_samples, X_new.shape[0], with_test_cov=False)
        means, variances = [], []
        for s0 in range(0, num_samples, cs):
            chunk = {k: v[s0:s0 + cs] for k, v in samples.items()}
            mean, var = self.get_predictive_mean_var(X_new, chunk, noiseless, **kwargs)
            means.append(mean)
            variances.append(var)
        means, variances = torch.cat(means), torch.cat(variances)
        return means.mean(0), variances.mean(0) + means.var(0, correction=0)

    def sample_from_prior(self, rng_key: Union[torch.Generator, int], X,
                          num_samples: int = 10, device=None) -> torch.Tensor:
        """Prior predictive draws of y at X, on ``device`` (None: the card)."""
        X = self._set_data(X, device=device)
        return ppl.Predictive(self.model, num_samples=num_samples)(
            spawn(rng_key, X.device), X)["y"]

    # ------------------------------------------------------------- utilities

    def _set_data(self, X, y=None, device=None):
        """Tensors of ``self.dtype`` on ``device`` (None: the CUDA card; see
        ``utils.resolve_device``), whatever the inputs' kind or device; X as
        (n, d), y as (n,)."""
        X = torch.as_tensor(X, dtype=self.dtype, device=resolve_device(device))
        X = X if X.ndim > 1 else X[:, None]
        if y is not None:
            return X, torch.as_tensor(y, dtype=self.dtype, device=X.device).squeeze()
        return X

    def _set_training_data(self, X_train_new=None, y_train_new=None, device=None) -> None:
        """Replace the training data (numpy arrays or tensors) and move it,
        with the rest of ``_data_attrs``, to ``device`` (None: the card)."""
        if X_train_new is not None:
            self.X_train = X_train_new
        if y_train_new is not None:
            self.y_train = y_train_new
        dev = resolve_device(device)
        for name in self._data_attrs:
            if getattr(self, name, None) is not None:
                setattr(self, name, torch.as_tensor(getattr(self, name), dtype=self.dtype,
                                                    device=dev))

    def _to_device(self, device) -> torch.device:
        """Resolve an entry point's ``device`` (None: the card) and move the
        training data there if it lies elsewhere."""
        dev = resolve_device(device)
        if self.X_train is not None and self.X_train.device != dev:
            self._set_training_data(device=dev)
        return dev

    def _print_summary(self) -> None:
        self.mcmc.print_summary()
