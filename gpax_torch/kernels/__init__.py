from .kernels import (
    MaternKernel,
    NNGPKernel,
    PeriodicKernel,
    RBFKernel,
    get_kernel,
    nngp_erf,
    nngp_relu,
    square_scaled_distance,
)
from .mtkernels import LCMKernel, MultitaskKernel, MultivariateKernel, index_kernel

__all__ = [
    "RBFKernel",
    "MaternKernel",
    "PeriodicKernel",
    "NNGPKernel",
    "nngp_erf",
    "nngp_relu",
    "get_kernel",
    "square_scaled_distance",
    "index_kernel",
    "MultitaskKernel",
    "MultivariateKernel",
    "LCMKernel",
]
