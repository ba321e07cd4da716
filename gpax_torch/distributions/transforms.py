"""Bijections between unconstrained reals and constrained supports
(counterpart of ``gpax_tpu/distributions/transforms.py``). NUTS integrates
latents in unconstrained space."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import constraints


class Transform:
    """y = f(x) with x unconstrained; ``log_abs_det_jacobian`` is elementwise."""

    def __call__(self, x):
        raise NotImplementedError

    def inv(self, y):
        raise NotImplementedError

    def log_abs_det_jacobian(self, x, y):
        raise NotImplementedError


class IdentityTransform(Transform):
    def __call__(self, x):
        return x

    def inv(self, y):
        return y

    def log_abs_det_jacobian(self, x, y):
        return torch.zeros_like(x)


class ExpTransform(Transform):
    def __call__(self, x):
        return torch.exp(x)

    def inv(self, y):
        return torch.log(y)

    def log_abs_det_jacobian(self, x, y):
        return x


class SigmoidTransform(Transform):
    """x -> low + (high - low)·sigmoid(x) (``transforms.py:51-68``). The
    bounds, floats or tensors on any device, are taken to the latent's
    device and dtype where they meet it."""

    def __init__(self, low=0.0, high=1.0):
        self.low = low
        self.high = high

    def _bounds(self, like: torch.Tensor):
        return tuple(torch.as_tensor(b, dtype=like.dtype, device=like.device)
                     for b in (self.low, self.high))

    def __call__(self, x):
        low, high = self._bounds(x)
        return low + (high - low) * torch.sigmoid(x)

    def inv(self, y):
        low, high = self._bounds(y)
        # the JAX package's clip; 1 - 1e-12 rounds to 1 in float32 there too
        p = torch.clamp((y - low) / (high - low), 1e-12, 1.0 - 1e-12)
        return torch.log(p) - torch.log1p(-p)

    def log_abs_det_jacobian(self, x, y):
        low, high = self._bounds(x)
        return torch.log(high - low) + F.logsigmoid(x) + F.logsigmoid(-x)


def biject_to(constraint) -> Transform:
    if constraint is constraints.real or constraint is constraints.real_vector:
        return IdentityTransform()
    if constraint is constraints.positive or constraint is constraints.nonnegative:
        return ExpTransform()
    if isinstance(constraint, constraints.Interval):
        return SigmoidTransform(constraint.low, constraint.high)
    raise NotImplementedError(f"No bijector registered for constraint {constraint!r}")
