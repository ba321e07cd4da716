"""Sparse variational GP (Titsias VFE) with trainable inducing points
(counterpart of ``gpax_tpu/models/sparse_gp.py``).

The collapsed VFE bound: a ``LowRankMultivariateNormal`` likelihood and a
clipped trace correction, the inducing inputs Xu a ``param`` site optimized
with the guide. Every factorization of an m×m matrix (Kuu in each SVI step,
Kuu and the capacitance B in predict) is ``safe_chol_inv``: kernel K3 on each
128-leaf, so every triangular solve is a matmul. Cost O(n·m² + m³), never
O(n³).

Those factorizations run in float64 (``safe_chol_inv_f64``: K3's float64
instantiation, with the float32 jitters) on the float32 grams, a departure
from the JAX package's float32, and so does the likelihood's capacitance
(``distributions.LowRankMultivariateNormal``). Measured on an H100 (PERF.md,
``python -m gpax_torch.probes.sparse_precision``): at bench.py's data with
n = 20000 and m = 1000 inducing points, Kuu + jitter reaches κ 2.9e6 with
its smallest eigenvalue just above the jitter. The library's float32
Cholesky still factors it, but ``chol_inv``'s recursion, which forms
L21 = K21·W11ᵀ through the explicit inverse, does not in float32: the fit
turned non-finite at step 288 with K3 at the leaves and at step 239 with
the library's Cholesky there. In float64 it runs its 1000 steps (RMSE
0.0013).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from .. import distributions as dist
from .. import ppl
from ..ops.linalg import safe_chol_inv_f64
from ..utils.utils import initialize_inducing_points
from .vigp import viGP


class viSparseGP(viGP):
    """Variational sparse GP: VFE bound, SVI-optimized inducing points."""

    _data_attrs = ("X_train", "y_train", "Xu")
    # every m×m factorization: float64 on the float32 grams (module note)
    _chol_inv = staticmethod(safe_chol_inv_f64)

    def __init__(self, input_dim: int, kernel="RBF",
                 mean_fn: Optional[Callable] = None,
                 kernel_prior: Optional[Callable] = None,
                 mean_fn_prior: Optional[Callable] = None,
                 noise_prior: Optional[Callable] = None,
                 noise_prior_dist: Optional[dist.Distribution] = None,
                 lengthscale_prior_dist: Optional[dist.Distribution] = None,
                 guide: str = "delta", dtype: Optional[torch.dtype] = None) -> None:
        super().__init__(input_dim, kernel, mean_fn, kernel_prior, mean_fn_prior,
                         noise_prior, noise_prior_dist, lengthscale_prior_dist, guide, dtype)
        self.Xu: Optional[torch.Tensor] = None

    def model(self, X: torch.Tensor, y: Optional[torch.Tensor] = None,
              Xu: Optional[torch.Tensor] = None, **kwargs) -> None:
        """Collapsed VFE program: y ~ LowRankMVN(f_loc, W, noise·I) with the
        trace factor −(tr(K_ff − Q_ff) / noise) / 2 (Titsias 2009)."""
        if Xu is not None:
            Xu = ppl.param("Xu", Xu)
        f_loc = torch.zeros(X.shape[0], dtype=X.dtype, device=X.device)
        kernel_params = self.kernel_prior() if self.kernel_prior else self._sample_kernel_params()
        noise = self.noise_prior() if self.noise_prior else self._sample_noise()
        D = torch.as_tensor(noise, dtype=X.dtype, device=X.device).expand(X.shape[0])
        if self.mean_fn is not None:
            f_loc = f_loc + self._mean_at(X, self._mean_prior(), ppl.batch_ndim())

        Kuu = self.kernel(Xu, Xu, kernel_params, **kwargs)
        _, Wuu = self._chol_inv(Kuu)
        Kuf = self.kernel(Xu, X, kernel_params)
        W = (Wuu @ Kuf).mT                                    # (n, m)
        # k(x, x) for every training point as ONE batched kernel call (a
        # batch of n 1×1 grams, one K1 launch), never the n×n gram
        Xd = X[:, None, :]
        Kff_diag = self.kernel(Xd, Xd, kernel_params, jitter=0.0)[:, 0, 0]
        Qff_diag = W.square().sum(-1)
        trace_term = torch.clamp((Kff_diag - Qff_diag).sum() / noise, min=0.0)
        ppl.factor("trace_term", -trace_term / 2.0)
        ppl.sample("y", dist.LowRankMultivariateNormal(loc=f_loc, cov_factor=W, cov_diag=D),
                   obs=y)

    def fit(self, rng_key, X, y, inducing_points_ratio: float = 0.1,
            inducing_points_selection: str = "random", num_steps: int = 1000,
            step_size: float = 5e-3, progress_bar: bool = True, print_summary: bool = True,
            device=None, **kwargs) -> None:
        """SVI over the hyperparameters AND the inducing locations, on
        ``device`` (None: the CUDA card)."""
        X, y = self._set_data(X, y, device)
        Xu = initialize_inducing_points(X, inducing_points_ratio, inducing_points_selection,
                                        rng_key)
        self.X_train, self.y_train = X, y
        result = self._run_svi(rng_key, num_steps, step_size, X, y, progress_bar, Xu=Xu,
                               **kwargs)
        self.Xu = result.params["Xu"]
        if print_summary:
            self._print_summary()

    def get_mvn_posterior(self, X_new: torch.Tensor, params: Dict[str, torch.Tensor],
                          noiseless: bool = False, **kwargs
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """VFE predictive (``sparse_gp.py:117-169``). With the whitened
        cross-covariances V = Luu⁻¹K_uf and Vs = Luu⁻¹K_us and the capacitance
        B = I_m + V D⁻¹ Vᵀ (D = noise):

            mean = VsᵀB⁻¹V D⁻¹ y,   cov = K_ss − VsᵀVs + VsᵀB⁻¹Vs

        Two ``safe_chol_inv`` (Kuu and B, through K3 in float64); matmuls
        elsewhere."""
        noise = params["noise"]
        noise_p = noise * (1 - int(noiseless))
        y_residual = self._residual(params)

        Kuu = self.kernel(self.Xu, self.Xu, params, **kwargs)
        _, Wuu = self._chol_inv(Kuu)
        V = Wuu @ self.kernel(self.Xu, self.X_train, params, jitter=0.0)    # (m, n)
        Vs = Wuu @ self.kernel(self.Xu, X_new, params, jitter=0.0)          # (m, s)

        Vd = V / noise.expand(V.shape[-1])[None, :]
        B = Vd @ V.mT
        B.diagonal(dim1=-2, dim2=-1).add_(1.0)
        _, Wb = self._chol_inv(B)                                          # Lb⁻¹

        G = Wb @ Vs                                                         # (m, s)
        r = Wb @ (Vd @ y_residual)                                          # (m,)
        mean = G.mT @ r

        Kss = self.kernel(X_new, X_new, params, noise_p, **kwargs)
        cov = Kss - Vs.mT @ Vs + G.mT @ G
        return self._add_mean(mean, X_new, params), cov
