"""gpax_torch: the PyTorch/CUDA port of gpax_tpu for an NVIDIA H100.

It imports ``torch`` and never ``jax``. It runs the fully Bayesian
ExactGP path (NUTS over the kernel hyperparameters, in segments if asked,
one chain or several in lockstep, then prediction), the task-batched
``vExactGP``, ``VarNoiseGP``, ``UIGP``, ``MeasuredNoiseGP`` (with
``LinReg``), the NNGP-kernel ``iBNN`` and ``vi_iBNN``, the multi-task
``MultiTaskGP`` and ``CoregGP``, the
acquisition functions of Bayesian optimization (``acquisition``), the
SVI family: ``viGP`` and the sparse ``viSparseGP``, and the NN-coupled
models on its own NN modules (``nn``): ``viDKL`` with its batched
ensembles and channels, ``viMTDKL``, the NUTS-fitted ``DKL``, and ``sPM``
and ``BNN``; with their priors (``priors``), hypothesis learning
(``hypo``, ``sample_next``), checkpoints and monitoring (``utils``). Its
hand-written Hopper kernels, the fused gram (K1, ``ops/gram.py``), the
triangular tile inverse (K2) and the tile Cholesky and inverse (K3, both
``ops/chol.py``), launch on CUDA tensors; on CPU tensors their plain
PyTorch twins run instead. The models' entry points run on the CUDA card
unless the caller passes ``device="cpu"``. Importing the package pins fp32
matmuls to full precision (``config.py``); ``enable_x64()`` makes float64
the default, as in the JAX package, and the card then runs K1's float64
instantiation. ``parallel`` splits prediction and acquisition grids and the
large-n factorization over a mesh of devices.
"""

from . import config  # noqa: F401  (first: pins fp32 matmul precision)
from . import acquisition, distributions, infer, kernels, nn, ops, ppl, priors, utils
from . import hypo
from .config import enable_x64, get_config, set_config
from .hypo import sample_next
from .models import (
    BNN,
    DKL,
    UIGP,
    CoregGP,
    ExactGP,
    LinReg,
    MeasuredNoiseGP,
    MultiTaskGP,
    VarNoiseGP,
    iBNN,
    sPM,
    vExactGP,
    vi_iBNN,
    viDKL,
    viGP,
    viMTDKL,
    viSparseGP,
)

__version__ = "0.1.0"

__all__ = [
    "__version__",
    "config",
    "acquisition",
    "distributions",
    "infer",
    "kernels",
    "nn",
    "ops",
    "ppl",
    "priors",
    "utils",
    "hypo",
    "enable_x64",
    "get_config",
    "set_config",
    "ExactGP",
    "vExactGP",
    "VarNoiseGP",
    "UIGP",
    "MeasuredNoiseGP",
    "LinReg",
    "iBNN",
    "vi_iBNN",
    "MultiTaskGP",
    "CoregGP",
    "viGP",
    "viSparseGP",
    "viDKL",
    "DKL",
    "viMTDKL",
    "sPM",
    "BNN",
    "sample_next",
]
