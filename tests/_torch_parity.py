"""Shared helpers of the gpax_torch parity tests.

Inputs are made with numpy from a seed and handed to a JAX function and to
its port in gpax_torch; values and gradients are compared with a stated
tolerance. JAX runs on the CPU (tests/conftest.py); torch runs on one thread,
since Tier-1 runs several pytest workers on a few cores.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(1)


def to_np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(actual, expected, rtol: float, atol: float = 0.0) -> None:
    np.testing.assert_allclose(to_np(actual), to_np(expected), rtol=rtol, atol=atol)


def value_and_grads(jax_fn, torch_fn, args, argnums):
    """Run ``jax_fn`` and ``torch_fn`` on the same numpy ``args`` (float32).

    Returns ((jax value, torch value), [(jax grad, torch grad) for each of
    ``argnums``]), the gradients being those of the outputs' sum."""
    args = [np.asarray(a, np.float32) for a in args]
    jargs = [jnp.asarray(a) for a in args]
    jval = jax_fn(*jargs)
    jgrads = jax.grad(lambda *a: jnp.sum(jax_fn(*a)), argnums=tuple(argnums))(*jargs)
    targs = [torch.tensor(a, requires_grad=i in argnums) for i, a in enumerate(args)]
    tval = torch_fn(*targs)
    tgrads = torch.autograd.grad(tval.sum(), [targs[i] for i in argnums],
                                 allow_unused=True, materialize_grads=True)
    return (np.asarray(jval), to_np(tval)), [(np.asarray(j), to_np(t))
                                            for j, t in zip(jgrads, tgrads)]


def spd(n: int, seed: int = 0) -> np.ndarray:
    """Well-conditioned SPD matrix A·Aᵀ/n + ½I (as tests/test_chol.py)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n)).astype(np.float32)
    return (A @ A.T / n + 0.5 * np.eye(n, dtype=np.float32)).astype(np.float32)
