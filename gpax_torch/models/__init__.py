from .gp import ExactGP

__all__ = ["ExactGP"]
