"""gpax_torch: the PyTorch/CUDA port of gpax_tpu for an NVIDIA H100.

It imports ``torch`` and never ``jax``. This slice runs the fully Bayesian
ExactGP path: NUTS over the kernel hyperparameters, then prediction. Its
two hand-written Hopper kernels, the fused gram (K1, ``ops/gram.py``) and
the triangular tile inverse (K2, ``ops/chol.py``), launch on CUDA tensors;
on CPU tensors their plain PyTorch twins run instead. Importing the package
pins fp32 matmuls to full precision (``config.py``).
"""

from . import config  # noqa: F401  (first: pins fp32 matmul precision)
from . import distributions, infer, kernels, ops, ppl, utils
from .config import get_config, set_config
from .models import ExactGP

__version__ = "0.1.0"

__all__ = [
    "__version__",
    "config",
    "distributions",
    "infer",
    "kernels",
    "ops",
    "ppl",
    "utils",
    "get_config",
    "set_config",
    "ExactGP",
]
