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
"""

from __future__ import annotations

import dataclasses

import torch

# the one mode of each precision field that is ported
_PORTED_MODES = {"gram_precision": "highest", "wtw_precision": "float64"}


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
    """

    default_jitter: float = 1e-6
    gram_precision: str = "highest"
    wtw_precision: str = "float64"


_config = Config()


def pin_fp32_matmul() -> None:
    """Full-fp32 matmuls and convolutions, TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def get_config() -> Config:
    return _config


def set_config(**kwargs) -> Config:
    global _config
    for name, mode in _PORTED_MODES.items():
        if kwargs.get(name, mode) != mode:
            raise NotImplementedError(
                f"{name}={kwargs[name]!r}: only {mode!r} is ported; the other "
                "modes wait for H100 measurements")
    _config = dataclasses.replace(_config, **kwargs)
    pin_fp32_matmul()
    return _config


pin_fp32_matmul()
