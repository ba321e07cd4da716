from .kernels import MaternKernel, PeriodicKernel, RBFKernel, get_kernel, square_scaled_distance

__all__ = [
    "RBFKernel",
    "MaternKernel",
    "PeriodicKernel",
    "get_kernel",
    "square_scaled_distance",
]
