"""gpax_torch: the PyTorch/CUDA port of gpax_tpu for an NVIDIA H100.

It imports ``torch`` and never ``jax``. It runs the fully Bayesian
ExactGP path (NUTS over the kernel hyperparameters, then prediction) and
the SVI family: ``viGP`` and the sparse ``viSparseGP``. Its three
hand-written Hopper kernels, the fused gram (K1, ``ops/gram.py``), the
triangular tile inverse (K2) and the tile Cholesky and inverse (K3, both
``ops/chol.py``), launch on CUDA tensors; on CPU tensors their plain
PyTorch twins run instead. The models' entry points run on the CUDA card
unless the caller passes ``device="cpu"``. Importing the package pins fp32
matmuls to full precision (``config.py``).
"""

from . import config  # noqa: F401  (first: pins fp32 matmul precision)
from . import distributions, infer, kernels, ops, ppl, utils
from .config import get_config, set_config
from .models import ExactGP, viGP, viSparseGP

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
    "viGP",
    "viSparseGP",
]
