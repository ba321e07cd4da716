"""Continuous optimization of an acquisition function (counterpart of
``gpax_tpu/acquisition/optimize.py``): a random multi-start, the best start
kept, then a bounded quasi-Newton refinement."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..utils.utils import resolve_device


def ensure_array(x) -> torch.Tensor:
    """A float32 tensor of a tensor, list, tuple, number or numpy array (a
    number becomes a 1-vector)."""
    if not torch.is_tensor(x):
        if isinstance(x, (float, int)):
            x = torch.tensor([x])
        elif isinstance(x, (list, tuple, np.ndarray)):
            x = torch.as_tensor(np.asarray(x))
        else:
            raise TypeError(f"Expected a list, tuple, float, or array; got {type(x)}")
    return x.to(torch.float32)


def optimize_acq(rng_key, model, acq_fn: Callable, num_initial_guesses: int,
                 lower_bound, upper_bound, num_steps: int = 100,
                 backend: str = "optax", **kwargs) -> torch.Tensor:
    """Maximize ``acq_fn(rng_key, model, X, **kwargs)`` within box bounds.

    ``num_initial_guesses`` uniform points, the best of them kept, then
    ``num_steps`` iterations of a projected L-BFGS on the model's device
    (``torch.optim.LBFGS`` with a strong-Wolfe line search, the point clamped
    to the box after each step; the backend keeps the JAX package's name
    "optax"), or, with ``backend="scipy"``, SciPy's L-BFGS-B on the host
    with torch's gradient. Every evaluation gets the same seed drawn from
    ``rng_key``, so the objective is deterministic. Returns the point (d,).
    """
    if isinstance(rng_key, int):
        rng_key = torch.Generator().manual_seed(rng_key)
    seed = int(torch.randint(2**62, (), generator=rng_key))
    device = kwargs.get("device")
    dev = model.X_train.device if device is None else resolve_device(device)
    lower_bound = ensure_array(lower_bound).to(dev)
    upper_bound = ensure_array(upper_bound).to(dev)

    def neg_acq(x: torch.Tensor) -> torch.Tensor:
        return -acq_fn(seed, model, x[None], **kwargs).reshape(())

    u = torch.rand((num_initial_guesses, lower_bound.shape[0]), generator=rng_key).to(dev)
    initial_guesses = lower_bound + u * (upper_bound - lower_bound)
    with torch.no_grad():
        initial_acq_vals = acq_fn(seed, model, initial_guesses, **kwargs)
    best = initial_guesses[initial_acq_vals.argmax()]

    if backend == "scipy":
        from scipy.optimize import minimize

        def fun(x):
            xt = torch.tensor(x, dtype=torch.float32, device=dev, requires_grad=True)
            v = neg_acq(xt)
            (g,) = torch.autograd.grad(v, xt)
            return float(v.detach()), g.double().cpu().numpy()

        res = minimize(fun, best.double().cpu().numpy(), jac=True, method="L-BFGS-B",
                       bounds=list(zip(lower_bound.tolist(), upper_bound.tolist())))
        return torch.as_tensor(res.x, dtype=torch.float32, device=dev)

    x = best.clone().requires_grad_(True)
    # one iteration a step, so the box projection follows each; max_eval
    # leaves the line search its own 25 evaluations (its budget is
    # max_eval less the step's first evaluation)
    opt = torch.optim.LBFGS([x], max_iter=1, max_eval=26, line_search_fn="strong_wolfe")

    def closure():
        opt.zero_grad()
        v = neg_acq(x)
        v.backward()
        return v

    for _ in range(num_steps):
        opt.step(closure)
        with torch.no_grad():
            x.clamp_(lower_bound, upper_bound)
    return x.detach()
