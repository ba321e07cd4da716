"""Distributions of the ExactGP and sparse GP paths (counterpart of
``gpax_tpu/distributions/distributions.py``).

Shapes follow the numpyro convention::

    sample(key, sample_shape).shape == sample_shape + batch_shape + event_shape
    log_prob(value).shape           == broadcast(value batch dims, batch_shape)

``key`` is a ``torch.Generator``; draws are made on its device.
"""

from __future__ import annotations

import copy
import math
from typing import Tuple

import torch

from . import constraints

_LOG_2PI = math.log(2.0 * math.pi)


def _bshape(*shapes) -> Tuple[int, ...]:
    return tuple(torch.broadcast_shapes(*shapes))


def _as(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=x.dtype if torch.is_tensor(x) else torch.get_default_dtype())


def _randn(key: torch.Generator, shape, like: torch.Tensor) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=key, device=key.device, dtype=like.dtype)


def _batched_tri_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``solve_triangular(L, b[..., None])[..., 0]`` with L's and b's batch
    dims broadcast against each other (``distributions.py:32-44``)."""
    batch = _bshape(b.shape[:-1], L.shape[:-2])
    return torch.linalg.solve_triangular(
        L.expand(batch + L.shape[-2:]), b.expand(batch + b.shape[-1:]).unsqueeze(-1),
        upper=False)[..., 0]


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

    def to_event(self, n: int = 1) -> "Independent":
        return Independent(self, n)

    def expand(self, batch_shape) -> "Distribution":
        """The same distribution over ``batch_shape``, its parameters
        broadcast lazily. Scalar parameters stay 0-d tensors, which combine
        with values on any device, so a prior made without knowing the
        data's device serves a model on the card."""
        batch_shape = tuple(batch_shape)
        if _bshape(self.batch_shape, batch_shape) != batch_shape:
            raise ValueError(f"cannot expand batch shape {self.batch_shape} to {batch_shape}")
        new = copy.copy(self)
        new.batch_shape = batch_shape
        return new

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

    def cdf(self, value):
        # erfc, not ndtr: torch's float32 ndtr loses the lower tail (4 %
        # off at -5, 0 at -6), which JAX's norm.cdf keeps
        return 0.5 * torch.special.erfc((self.loc - value) / (self.scale * math.sqrt(2.0)))

    def icdf(self, q):
        return self.loc + self.scale * torch.special.ndtri(q)

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


class HalfCauchy(Distribution):
    support = constraints.positive

    def __init__(self, scale=1.0):
        self.scale = _as(scale)
        self.batch_shape = tuple(self.scale.shape)

    def sample(self, key, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        eps = torch.empty(shape, dtype=self.scale.dtype, device=key.device).cauchy_(
            generator=key)
        return torch.abs(self.scale * eps)

    def log_prob(self, value):
        z = value / self.scale
        return math.log(2.0 / math.pi) - torch.log(self.scale) - torch.log1p(z * z)


class Cauchy(Distribution):
    support = constraints.real

    def __init__(self, loc=0.0, scale=1.0):
        self.loc = _as(loc)
        self.scale = _as(scale)
        self.batch_shape = _bshape(self.loc.shape, self.scale.shape)

    def sample(self, key, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        eps = torch.empty(shape, dtype=self.loc.dtype, device=key.device).cauchy_(
            generator=key)
        return self.loc + self.scale * eps

    def log_prob(self, value):
        z = (value - self.loc) / self.scale
        return -math.log(math.pi) - torch.log(self.scale) - torch.log1p(z * z)

    @property
    def mean(self):
        return torch.full(self.batch_shape, math.nan, dtype=self.loc.dtype)


def _on(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A parameter on ``like``'s device: bounds taken from data on the card
    meet values or draws on another device."""
    return t if t.device == like.device else t.to(like.device)


class Gamma(Distribution):
    """Gamma(concentration, rate) (``distributions.py:223-249``); draws by
    ``torch._standard_gamma`` with the key on its device."""

    support = constraints.positive

    def __init__(self, concentration, rate=1.0):
        self.concentration = _as(concentration)
        self.rate = _as(rate)
        self.batch_shape = _bshape(self.concentration.shape, self.rate.shape)

    def sample(self, key, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        conc = _on(self.concentration, torch.empty(0, device=key.device))
        draws = torch._standard_gamma(conc.expand(shape).contiguous(), generator=key)
        return draws / _on(self.rate, draws)

    def log_prob(self, value):
        c, r = _on(self.concentration, value), _on(self.rate, value)
        return c * torch.log(r) + (c - 1.0) * torch.log(value) - r * value - torch.lgamma(c)

    @property
    def mean(self):
        return (self.concentration / self.rate).expand(self.batch_shape)

    @property
    def variance(self):
        return (self.concentration / self.rate**2).expand(self.batch_shape)


class Exponential(Distribution):
    """Exponential(rate) (``distributions.py:252-270``)."""

    support = constraints.positive

    def __init__(self, rate=1.0):
        self.rate = _as(rate)
        self.batch_shape = tuple(self.rate.shape)

    def sample(self, key, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        eps = torch.empty(shape, dtype=self.rate.dtype, device=key.device).exponential_(
            generator=key)
        return eps / _on(self.rate, eps)

    def log_prob(self, value):
        rate = _on(self.rate, value)
        return torch.log(rate) - rate * value

    @property
    def mean(self):
        return (1.0 / self.rate).expand(self.batch_shape)


class Uniform(Distribution):
    """Uniform(low, high) (``distributions.py:273-295``), supported on the
    interval of its own bounds (so NUTS takes it through the sigmoid).
    ``log_prob`` is −log(high − low) on [low, high], the bounds included,
    and −inf outside."""

    def __init__(self, low=0.0, high=1.0):
        self.low = _as(low)
        self.high = _as(high)
        self.batch_shape = _bshape(self.low.shape, self.high.shape)
        self.support = constraints.interval(self.low, self.high)

    def sample(self, key, sample_shape=()):
        shape = tuple(sample_shape) + self.batch_shape
        u = torch.rand(shape, generator=key, device=key.device, dtype=self.low.dtype)
        low, high = _on(self.low, u), _on(self.high, u)
        return low + (high - low) * u

    def log_prob(self, value):
        low, high = _on(self.low, value), _on(self.high, value)
        inside = (value >= low) & (value <= high)
        return torch.where(inside, -torch.log(high - low), -math.inf)

    @property
    def mean(self):
        return (0.5 * (self.low + self.high)).expand(self.batch_shape)


class Delta(Distribution):
    """A point mass at ``value`` with ``log_density`` (``distributions.py:298-321``);
    its rightmost ``event_dim`` dims are the event."""

    support = constraints.real

    def __init__(self, value=0.0, log_density=0.0, event_dim: int = 0):
        self.value = _as(value)
        self.log_density = _as(log_density)
        shape = tuple(self.value.shape)
        cut = len(shape) - event_dim
        self.batch_shape = shape[:cut]
        self.event_shape = shape[cut:]

    def sample(self, key, sample_shape=()):
        return self.value.expand(tuple(sample_shape) + tuple(self.value.shape))

    def log_prob(self, value):
        lp = self.log_density.expand(self.batch_shape)
        if self.event_dim:
            return lp
        return lp.expand(_bshape(torch.as_tensor(value).shape, self.value.shape))

    @property
    def mean(self):
        return self.value


class MultivariateNormal(Distribution):
    """MVN parameterized by covariance matrix or its Cholesky factor.

    ``log_prob`` given a covariance, 2-D or batched (…, n, n), routes to
    ``ops.linalg.mvn_log_prob_centered`` (one float64 factorization of the
    whole batch, K2's blocked inverse, closed-form backward) and returns one
    value per matrix; inside ``parallel.sharded_linalg`` one matrix and one
    vector take the mesh-split factorization instead. Given ``scale_tril``
    it solves with the factor.
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
        if self._covariance is not None:
            from ..ops.linalg import mvn_log_prob_centered
            from ..parallel.distributed_chol import (
                active_sharded_linalg, make_sharded_mvn_log_prob,
            )

            ctx = active_sharded_linalg()
            if ctx is not None and self._covariance.ndim == 2 and diff.ndim == 1:
                # model-parallel likelihood: factorization and backward split
                # over the active mesh (parallel/distributed_chol.py)
                mesh, axis_name, leaf = ctx
                return make_sharded_mvn_log_prob(mesh, axis_name, leaf)(self._covariance, diff)
            return mvn_log_prob_centered(self._covariance, diff)
        L = self.scale_tril
        w = _batched_tri_solve(L, diff)
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


class LowRankMultivariateNormal(Distribution):
    """N(loc, W·Wᵀ + D) with W (…, n, m) and D diagonal (…, n): Woodbury and
    determinant-lemma ``log_prob`` in O(n·m² + m³), never O(n³)
    (``distributions.py:436-495``; the sparse GP's likelihood).

    The m×m capacitance I + Wᵀ·D⁻¹·W is formed, factored by the library
    Cholesky (``cholesky_ex``, as JAX uses ``jnp.linalg.cholesky``) and
    solved in float64 whatever W's dtype, and ``log_prob`` returns the
    value's dtype, a departure from the JAX package's float32: κ(C) grows as
    ‖W‖²/D, and the sparse GP's fit at m = 1000 reaches κ(C) 3.4e6, where a
    float32 capacitance turned the fit non-finite at step 992 (PERF.md).
    Failure is read from ``info`` and gives NaN, as JAX's does.
    """

    support = constraints.real_vector

    def __init__(self, loc, cov_factor, cov_diag):
        self.cov_factor = cov_factor
        self.cov_diag = torch.as_tensor(cov_diag, dtype=cov_factor.dtype,
                                        device=cov_factor.device)
        self.loc = torch.as_tensor(loc, dtype=cov_factor.dtype, device=cov_factor.device)
        n = cov_factor.shape[-2]
        self.event_shape = (n,)
        self.batch_shape = _bshape(self.loc.shape[:-1], cov_factor.shape[:-2],
                                   self.cov_diag.shape[:-1])

    def sample(self, key, sample_shape=()):
        n, m = self.cov_factor.shape[-2:]
        shape = tuple(sample_shape) + self.batch_shape
        eps_m = _randn(key, shape + (m,), self.cov_factor)
        eps_n = _randn(key, shape + (n,), self.cov_factor)
        return (self.loc + (self.cov_factor @ eps_m.unsqueeze(-1)).squeeze(-1)
                + torch.sqrt(self.cov_diag) * eps_n)

    def log_prob(self, value):
        diff = (value - self.loc).double()
        D, W = self.cov_diag.double(), self.cov_factor.double()
        C = W.mT @ (W / D[..., :, None])
        C.diagonal(dim1=-2, dim2=-1).add_(1.0)
        L_C, info = torch.linalg.cholesky_ex(C)
        L_C = torch.where((info == 0)[..., None, None], L_C, torch.nan)
        Dinv_diff = diff / D
        w = _batched_tri_solve(L_C, (W.mT @ Dinv_diff.unsqueeze(-1)).squeeze(-1))
        maha = (diff * Dinv_diff).sum(-1) - (w * w).sum(-1)
        logdet = (2.0 * torch.log(torch.abs(L_C.diagonal(dim1=-2, dim2=-1))).sum(-1)
                  + torch.log(D).sum(-1))
        return (-0.5 * (maha + logdet + self.event_shape[0] * _LOG_2PI)).to(value.dtype)

    @property
    def mean(self):
        return self.loc.expand(self.batch_shape + self.event_shape)

    @property
    def variance(self):
        return (self.cov_factor**2).sum(-1) + self.cov_diag


class Independent(Distribution):
    """Reinterprets the rightmost ``n`` batch dims of ``base`` as event dims
    (``distributions.py:324-351``)."""

    def __init__(self, base: Distribution, reinterpreted_batch_ndims: int = 1):
        self.base = base
        self.reinterpreted_batch_ndims = n = reinterpreted_batch_ndims
        cut = len(base.batch_shape) - n
        self.batch_shape = tuple(base.batch_shape[:cut])
        self.event_shape = tuple(base.batch_shape[cut:]) + tuple(base.event_shape)
        self.support = base.support

    def sample(self, key, sample_shape=()):
        return self.base.sample(key, sample_shape)

    def log_prob(self, value):
        lp = self.base.log_prob(value)
        return lp.sum(tuple(range(-self.reinterpreted_batch_ndims, 0))) \
            if self.reinterpreted_batch_ndims else lp

    @property
    def mean(self):
        return self.base.mean
