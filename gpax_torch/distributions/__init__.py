from . import constraints
from .distributions import (
    Cauchy,
    Delta,
    Distribution,
    Exponential,
    Gamma,
    HalfCauchy,
    HalfNormal,
    Independent,
    LogNormal,
    LowRankMultivariateNormal,
    MultivariateNormal,
    Normal,
    Uniform,
)
from .transforms import ExpTransform, IdentityTransform, SigmoidTransform, Transform, biject_to

__all__ = [
    "constraints",
    "biject_to",
    "Transform",
    "IdentityTransform",
    "ExpTransform",
    "SigmoidTransform",
    "Distribution",
    "Normal",
    "LogNormal",
    "HalfNormal",
    "Cauchy",
    "HalfCauchy",
    "Gamma",
    "Exponential",
    "Uniform",
    "Delta",
    "Independent",
    "MultivariateNormal",
    "LowRankMultivariateNormal",
]
