from . import constraints
from .distributions import (
    Cauchy,
    Distribution,
    HalfCauchy,
    HalfNormal,
    Independent,
    LogNormal,
    LowRankMultivariateNormal,
    MultivariateNormal,
    Normal,
)
from .transforms import ExpTransform, IdentityTransform, Transform, biject_to

__all__ = [
    "constraints",
    "biject_to",
    "Transform",
    "IdentityTransform",
    "ExpTransform",
    "Distribution",
    "Normal",
    "LogNormal",
    "HalfNormal",
    "HalfCauchy",
    "Cauchy",
    "Independent",
    "MultivariateNormal",
    "LowRankMultivariateNormal",
]
