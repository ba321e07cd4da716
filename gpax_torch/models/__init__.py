from .bnn import BNN
from .corgp import CoregGP
from .dkl import DKL
from .gp import ExactGP
from .hskgp import VarNoiseGP
from .ibnn import iBNN
from .linreg import LinReg
from .mngp import MeasuredNoiseGP
from .mtgp import MultiTaskGP
from .sparse_gp import viSparseGP
from .spm import sPM
from .uigp import UIGP
from .vgp import vExactGP
from .vi_ibnn import vi_iBNN
from .vi_mtdkl import viMTDKL
from .vidkl import viDKL
from .vigp import viGP

__all__ = ["ExactGP", "vExactGP", "VarNoiseGP", "UIGP", "MeasuredNoiseGP", "LinReg",
           "MultiTaskGP", "CoregGP", "viGP", "viSparseGP", "viDKL", "DKL", "viMTDKL",
           "iBNN", "vi_iBNN", "sPM", "BNN"]
