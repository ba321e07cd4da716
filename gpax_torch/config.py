"""Numeric policy of the port (counterpart of ``gpax_tpu/config.py``).

GP grams, Cholesky factors and the WᵀW backward need full fp32 matmuls: TF32
keeps about three decimal digits, which is below the noise diagonals and
breaks the factorization. Importing this module pins PyTorch's fp32 matmul
and convolution precision to full fp32 — the port's form of the JAX
package's ``jax_default_matmul_precision="highest"`` rule.

The JAX package's other precision modes (``compensated`` and ``default``
WᵀW, ``hmc_wtw_precision``, the compensated gram) and its dispatch
thresholds were measured on a TPU; they return only after the H100 has
measured them. The port's one WᵀW mode, ``"float64"``, departs from the JAX
package's float32 ``"highest"``: see ``ops/linalg.py``. Kernels are chosen
by device, not by a switch.

``use_fused_likelihood`` chooses a route, not a kernel: ExactGP's fused
likelihood (``ops/fused_density.py``) and its composed one both launch K1
and K2 on a CUDA tensor and take their twins on a CPU tensor.

``enable_x64`` is the JAX package's (and the reference gpax's) double
precision mode, with one source of truth as ``jax_enable_x64`` has: torch's
default dtype. It turns float64 every tensor the port makes without a
dtype of its own (the models' data, priors, samples, guides) and every
tensor user code builds from Python floats. The card then runs K1's float64
instantiation and the float64 factor path; a model keeps the dtype it was
built with.
"""

from __future__ import annotations

import dataclasses

import torch

# the one mode of each precision field that is ported
_PORTED_MODES = {"gram_precision": "highest", "wtw_precision": "float64"}
_FUSED_MODES = ("auto", "always", "never")


@dataclasses.dataclass(frozen=True)
class Config:
    """Framework-wide numeric policy.

    Attributes:
        default_jitter: diagonal jitter the kernels add to same-shaped grams
            when the caller passes none.
        gram_precision: cross-term precision of the gram; only ``"highest"``
            (fp32 FMAs in kernel K1).
        wtw_precision: precision of the factor path and the backward's
            K⁻¹ = WᵀW; only ``"float64"``: Cholesky, K2's inverse and WᵀW in
            float64 (``ops/linalg.py`` says why).
        use_fused_likelihood: ExactGP's likelihood route (``models/gp.py``,
            ``_fused_likelihood_ok``): ``"auto"`` takes the fused op on a
            CUDA tensor with n ≤ ``fused_likelihood_max_n``, ``"always"``
            wherever it applies (the CPU tests), ``"never"`` the composed
            route.
        fused_likelihood_max_n: the largest n at which ``"auto"`` takes the
            fused route.
    """

    default_jitter: float = 1e-6
    gram_precision: str = "highest"
    wtw_precision: str = "float64"
    use_fused_likelihood: str = "auto"
    # The largest n at which the fused route's likelihood+grad was faster in
    # chip_smoke.py's table (fused and composed in turns, n = 512 to 8192)
    # on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit, in each of
    # three runs: fused/composed 0.898, 0.963, 0.994, 0.949, 0.903; 0.940,
    # 0.845, 1.135, 0.998, 0.919; 0.814, 1.016, 1.112, 0.975, 0.908. At
    # 1024-4096 the routes are within the turns' spread; at 512 and 8192
    # the fused one wins. 8192 is also the largest n measured: above it
    # "auto" keeps the composed route.
    fused_likelihood_max_n: int = 8192


_config = Config()


def pin_fp32_matmul() -> None:
    """Full-fp32 matmuls and convolutions, TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def enable_x64(use_x64: bool = True) -> None:
    """Double precision by default (``gpax.utils.enable_x64``): torch's
    default dtype becomes float64, or float32 again with ``False``. The
    fp32 matmul pins stay as they are."""
    torch.set_default_dtype(torch.float64 if use_x64 else torch.float32)
    pin_fp32_matmul()


def is_x64() -> bool:
    return torch.get_default_dtype() == torch.float64


def resolve_dtype(dtype=None) -> torch.dtype:
    """``dtype``, or the mode's default (float64 after ``enable_x64``, else
    float32) when it is None."""
    return torch.get_default_dtype() if dtype is None else dtype


def get_config() -> Config:
    return _config


def set_config(**kwargs) -> Config:
    global _config
    for name, mode in _PORTED_MODES.items():
        if kwargs.get(name, mode) != mode:
            raise NotImplementedError(
                f"{name}={kwargs[name]!r}: only {mode!r} is ported; the other "
                "modes wait for H100 measurements")
    if kwargs.get("use_fused_likelihood", "auto") not in _FUSED_MODES:
        raise ValueError(f"use_fused_likelihood={kwargs['use_fused_likelihood']!r}: "
                         f"one of {_FUSED_MODES}")
    _config = dataclasses.replace(_config, **kwargs)
    pin_fp32_matmul()
    return _config


pin_fp32_matmul()
