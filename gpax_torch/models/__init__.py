from .gp import ExactGP
from .sparse_gp import viSparseGP
from .vigp import viGP

__all__ = ["ExactGP", "viGP", "viSparseGP"]
