from .kernels import MaternKernel, PeriodicKernel, RBFKernel, get_kernel, square_scaled_distance
from .mtkernels import LCMKernel, MultitaskKernel, MultivariateKernel, index_kernel

__all__ = [
    "RBFKernel",
    "MaternKernel",
    "PeriodicKernel",
    "get_kernel",
    "square_scaled_distance",
    "index_kernel",
    "MultitaskKernel",
    "MultivariateKernel",
    "LCMKernel",
]
