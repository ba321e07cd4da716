"""Distributions of the ExactGP path (counterpart of
``gpax_tpu/distributions/distributions.py``).

Shapes follow the numpyro convention::

    sample(key, sample_shape).shape == sample_shape + batch_shape + event_shape
    log_prob(value).shape           == broadcast(value batch dims, batch_shape)

``key`` is a ``torch.Generator``; draws are made on its device.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from . import constraints

_LOG_2PI = math.log(2.0 * math.pi)


def _bshape(*shapes) -> Tuple[int, ...]:
    return tuple(torch.broadcast_shapes(*shapes))


def _as(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=x.dtype if torch.is_tensor(x) else torch.float32)


def _randn(key: torch.Generator, shape, like: torch.Tensor) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=key, device=key.device, dtype=like.dtype)


class Distribution:
    """Base class. Subclasses set ``batch_shape``/``event_shape`` in __init__."""

    support = constraints.real
    batch_shape: Tuple[int, ...] = ()
    event_shape: Tuple[int, ...] = ()

    @property
    def event_dim(self) -> int:
        return len(self.event_shape)

    def sample(self, key: torch.Generator, sample_shape=()):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    @property
    def mean(self):
        raise NotImplementedError

    @property
    def variance(self):
        raise NotImplementedError


class Normal(Distribution):
    support = constraints.real

    def __init__(self, loc=0.0, scale=1.0):
        self.loc = _as(loc)
        self.scale = _as(scale)
        self.batch_shape = _bshape(self.loc.shape, self.scale.shape)

    def sample(self, key, sample_shape=()):
        eps = _randn(key, tuple(sample_shape) + self.batch_shape, self.loc)
        return self.loc + self.scale * eps

    def log_prob(self, value):
        z = (value - self.loc) / self.scale
        return -0.5 * z * z - torch.log(self.scale) - 0.5 * _LOG_2PI

    @property
    def mean(self):
        return self.loc.expand(self.batch_shape)

    @property
    def variance(self):
        return (self.scale**2).expand(self.batch_shape)


class LogNormal(Distribution):
    support = constraints.positive

    def __init__(self, loc=0.0, scale=1.0):
        self.loc = _as(loc)
        self.scale = _as(scale)
        self.batch_shape = _bshape(self.loc.shape, self.scale.shape)

    def sample(self, key, sample_shape=()):
        eps = _randn(key, tuple(sample_shape) + self.batch_shape, self.loc)
        return torch.exp(self.loc + self.scale * eps)

    def log_prob(self, value):
        logv = torch.log(value)
        z = (logv - self.loc) / self.scale
        return -0.5 * z * z - torch.log(self.scale) - 0.5 * _LOG_2PI - logv

    @property
    def mean(self):
        return torch.exp(self.loc + 0.5 * self.scale**2).expand(self.batch_shape)

    @property
    def variance(self):
        s2 = self.scale**2
        return ((torch.exp(s2) - 1.0) * torch.exp(2.0 * self.loc + s2)).expand(self.batch_shape)


class HalfNormal(Distribution):
    support = constraints.positive

    def __init__(self, scale=1.0):
        self.scale = _as(scale)
        self.batch_shape = tuple(self.scale.shape)

    def sample(self, key, sample_shape=()):
        eps = _randn(key, tuple(sample_shape) + self.batch_shape, self.scale)
        return torch.abs(self.scale * eps)

    def log_prob(self, value):
        z = value / self.scale
        return 0.5 * math.log(2.0 / math.pi) - torch.log(self.scale) - 0.5 * z * z

    @property
    def mean(self):
        return (self.scale * math.sqrt(2.0 / math.pi)).expand(self.batch_shape)

    @property
    def variance(self):
        return (self.scale**2 * (1.0 - 2.0 / math.pi)).expand(self.batch_shape)


class MultivariateNormal(Distribution):
    """MVN parameterized by covariance matrix or its Cholesky factor.

    ``log_prob`` of a 2-D covariance routes to
    ``ops.linalg.mvn_log_prob_centered`` (one factorization, K2's blocked
    inverse, closed-form backward); otherwise it solves with the factor.
    """

    support = constraints.real_vector

    def __init__(self, loc=0.0, covariance_matrix=None, scale_tril=None):
        if (covariance_matrix is None) == (scale_tril is None):
            raise ValueError("Provide exactly one of covariance_matrix / scale_tril")
        self._covariance = covariance_matrix
        self._scale_tril = scale_tril
        mat = scale_tril if scale_tril is not None else covariance_matrix
        loc = torch.as_tensor(loc, dtype=mat.dtype, device=mat.device)
        self.loc = loc.expand(_bshape(loc.shape, mat.shape[:-1]))
        self.event_shape = (mat.shape[-1],)
        self.batch_shape = _bshape(self.loc.shape[:-1], mat.shape[:-2])

    @property
    def scale_tril(self):
        if self._scale_tril is None:
            # jitter-escalating Cholesky: a numerically indefinite fp32 gram
            # gets a slightly regularized factor instead of a failure
            from ..ops.linalg import safe_cholesky

            self._scale_tril = safe_cholesky(self._covariance)
        return self._scale_tril

    def sample(self, key, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape + self.event_shape
        eps = _randn(key, shape, self.loc)
        return self.loc + (self.scale_tril @ eps.unsqueeze(-1)).squeeze(-1)

    def log_prob(self, value):
        diff = value - self.loc
        if self._covariance is not None and self._covariance.ndim == 2:
            from ..ops.linalg import mvn_log_prob_centered

            return mvn_log_prob_centered(self._covariance, diff)
        L = self.scale_tril
        batch = _bshape(diff.shape[:-1], L.shape[:-2])
        w = torch.linalg.solve_triangular(
            L.expand(batch + L.shape[-2:]),
            diff.expand(batch + diff.shape[-1:]).unsqueeze(-1), upper=False)[..., 0]
        maha = (w * w).sum(-1)
        logdet = torch.log(torch.abs(L.diagonal(dim1=-2, dim2=-1))).sum(-1)
        return -0.5 * (maha + self.event_shape[0] * _LOG_2PI) - logdet

    @property
    def mean(self):
        return self.loc.expand(self.batch_shape + self.event_shape)

    @property
    def variance(self):
        return (self.scale_tril**2).sum(-1).expand(self.batch_shape + self.event_shape)

    @property
    def covariance_matrix(self):
        return self.scale_tril @ self.scale_tril.mT
