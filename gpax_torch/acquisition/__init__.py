from .acquisition import EI, KG, POI, Thompson, UCB, UE
from .base_acq import ei, kg, poi, ucb, ue
from .batch_acquisition import qEI, qKG, qPOI, qUCB
from .optimize import optimize_acq
from .penalties import compute_penalty

__all__ = [
    "UCB", "EI", "POI", "UE", "KG", "Thompson",
    "qEI", "qPOI", "qUCB", "qKG",
    "optimize_acq", "compute_penalty",
    "ei", "ucb", "poi", "ue", "kg",
]
