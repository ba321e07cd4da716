"""Support constraints (counterpart of ``gpax_tpu/distributions/constraints.py``;
the supports of this slice: real, real_vector, positive)."""

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


real = _Real()
real_vector = _RealVector()
positive = _Positive()
