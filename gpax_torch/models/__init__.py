from .corgp import CoregGP
from .gp import ExactGP
from .mtgp import MultiTaskGP
from .sparse_gp import viSparseGP
from .vigp import viGP

__all__ = ["ExactGP", "MultiTaskGP", "CoregGP", "viGP", "viSparseGP"]
