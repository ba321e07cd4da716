"""Support constraints (counterpart of ``gpax_tpu/distributions/constraints.py``):
real, real_vector, positive, nonnegative and the open interval."""

from __future__ import annotations

import torch


class Constraint:
    event_dim: int = 0

    def __call__(self, value):
        raise NotImplementedError

    def __repr__(self):
        return self.__class__.__name__


class _Real(Constraint):
    def __call__(self, value):
        return torch.isfinite(value)


class _RealVector(Constraint):
    event_dim = 1

    def __call__(self, value):
        return torch.isfinite(value).all(-1)


class _Positive(Constraint):
    def __call__(self, value):
        return value > 0


class _Nonnegative(Constraint):
    def __call__(self, value):
        return value >= 0


class Interval(Constraint):
    """The open interval (low, high); the bounds are floats or tensors."""

    def __init__(self, low, high):
        self.low = low
        self.high = high

    def __call__(self, value):
        return (value > self.low) & (value < self.high)

    def __repr__(self):
        return f"Interval({self.low}, {self.high})"


real = _Real()
real_vector = _RealVector()
positive = _Positive()
nonnegative = _Nonnegative()
unit_interval = Interval(0.0, 1.0)


def interval(low, high) -> Interval:
    return Interval(low, high)
