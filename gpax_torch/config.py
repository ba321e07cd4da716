"""Numeric policy of the port (counterpart of ``gpax_tpu/config.py``).

GP grams, Cholesky factors and the WᵀW backward need full fp32 matmuls: TF32
keeps about three decimal digits, which is below the noise diagonals and
breaks the factorization. Importing this module pins PyTorch's fp32 matmul
and convolution precision to full fp32 — the port's form of the JAX
package's ``jax_default_matmul_precision="highest"`` rule.

The JAX package's precision modes are the user's choice through
:func:`set_config`, as there; the port's defaults keep the full-precision
arithmetic that the H100 was measured with (PERF.md):

- ``gram_precision``: the gram's cross term, ``"highest"`` (fp32 FMAs in
  K1) or ``"compensated"`` (each float32 operand split into bf16 hi + lo,
  hi·hi + (hi·lo + lo·hi) on the tensor cores with fp32 accumulation:
  K1's ``gpax_gram_f32c``). A float64 gram (x64 mode) is float64 in
  either mode, and the fused likelihood's gram is ``"highest"`` in either.
- ``wtw_precision``: the backward's K⁻¹ = WᵀW (``ops.linalg.
  wtw_compensated``), ``"float64"`` (the port's own, the default),
  ``"highest"`` (fp32), ``"compensated"`` (hi/lo bf16 products with fp32
  results) or ``"default"`` (one bf16 product). The factor path itself
  (Cholesky, K2) stays float64 in every mode: see ``ops/linalg.py``.
- ``mvn_dk_gauge``: under ``"compensated"``, ``"symmetric_equivalent"``
  lets the composed and sharded backwards return hiᵀhi + 2·hiᵀlo, a dK
  with the right symmetric part, where ``"exact"`` returns the symmetric
  one.
- ``hmc_wtw_precision``: a ``wtw_precision`` that ``MCMC.run`` sets for
  the run and restores after it; None (the port's default) sets none.

The JAX package's dispatch fields (``matmul_precision``, ``use_pallas``,
``pallas_min_elems``, ``use_pallas_chol``, ``pallas_chol_min_n``) are not
ported: the port picks kernels by device and pins fp32 matmuls, and
:func:`set_config` refuses them.

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
from typing import Optional

import torch

_FUSED_MODES = ("auto", "always", "never")
_WTW_MODES = ("float64", "highest", "compensated", "default")
# the values each mode field takes
_MODES = {"gram_precision": ("highest", "compensated"), "wtw_precision": _WTW_MODES,
          "mvn_dk_gauge": ("exact", "symmetric_equivalent"),
          "hmc_wtw_precision": (None,) + _WTW_MODES, "use_fused_likelihood": _FUSED_MODES}
# the JAX package's dispatch fields, which the port leaves out
_NOT_PORTED = {
    name: "the port picks its kernels by device (a CUDA tensor launches the kernel, "
          "a CPU tensor takes its twin) and pins fp32 matmuls; no switch or size "
          "threshold chooses them"
    for name in ("matmul_precision", "use_pallas", "pallas_min_elems", "use_pallas_chol",
                 "pallas_chol_min_n")}


@dataclasses.dataclass(frozen=True)
class Config:
    """Framework-wide numeric policy.

    Attributes:
        default_jitter: diagonal jitter the kernels add to same-shaped grams
            when the caller passes none.
        gram_precision: cross-term precision of the gram: ``"highest"``
            (fp32 FMAs in kernel K1) or ``"compensated"`` (bf16 hi/lo
            products on the tensor cores, K1's compensated instantiation).
        wtw_precision: precision of the backward's K⁻¹ = WᵀW:
            ``"float64"`` (the port's own), ``"highest"``, ``"compensated"``
            or ``"default"``; the factor path is float64 in every mode
            (``ops/linalg.py`` says why).
        mvn_dk_gauge: ``"symmetric_equivalent"`` or ``"exact"``, the gauge
            of the composed backward's dK under ``"compensated"`` WᵀW.
        hmc_wtw_precision: the ``wtw_precision`` of an ``MCMC.run``, or
            None to keep ``wtw_precision`` there too.
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
    mvn_dk_gauge: str = "symmetric_equivalent"
    # the JAX package's default is "default" (one bf16 pass); the port's
    # waits for its benchmark
    hmc_wtw_precision: Optional[str] = None
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
    """Replace the named fields. A mode outside its field's values raises
    ``ValueError``, a dispatch field of the JAX package
    ``NotImplementedError``, an unknown name ``TypeError``."""
    global _config
    for name, value in kwargs.items():
        if name in _NOT_PORTED:
            raise NotImplementedError(f"{name} is not ported: {_NOT_PORTED[name]}")
        if name in _MODES and value not in _MODES[name]:
            raise ValueError(f"{name}={value!r}: one of {_MODES[name]}")
    _config = dataclasses.replace(_config, **kwargs)
    pin_fp32_matmul()
    return _config


pin_fp32_matmul()
