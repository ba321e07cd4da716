"""Bijections between unconstrained reals and constrained supports
(counterpart of ``gpax_tpu/distributions/transforms.py``). NUTS integrates
latents in unconstrained space."""

from __future__ import annotations

import torch

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


def biject_to(constraint) -> Transform:
    if constraint is constraints.real or constraint is constraints.real_vector:
        return IdentityTransform()
    if constraint is constraints.positive:
        return ExpTransform()
    raise NotImplementedError(f"No bijector registered for constraint {constraint!r}")
