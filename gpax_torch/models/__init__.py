from .bnn import BNN
from .corgp import CoregGP
from .dkl import DKL
from .gp import ExactGP
from .mtgp import MultiTaskGP
from .sparse_gp import viSparseGP
from .spm import sPM
from .vi_mtdkl import viMTDKL
from .vidkl import viDKL
from .vigp import viGP

__all__ = ["ExactGP", "MultiTaskGP", "CoregGP", "viGP", "viSparseGP", "viDKL", "DKL",
           "viMTDKL", "sPM", "BNN"]
