"""HMC building blocks (counterpart of ``gpax_tpu/infer/hmc_util.py``):
leapfrog integrator, dual-averaging step-size adaptation, Welford
(co)variance for the mass matrix, and the Stan-style warmup schedule.

States are NamedTuples of tensors on the sampler's device, with a leading
chain dim (C,) when chains run in lockstep; the schedule is host-side
Python, since the sampler's loop is a Python loop.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..config import resolve_dtype
from ..utils.utils import host_bool


class DualAveragingState(NamedTuple):
    log_step: torch.Tensor       # current log eps
    log_step_avg: torch.Tensor   # averaged log eps
    grad_sum: torch.Tensor       # sum of (target_accept - accept_prob)
    t: torch.Tensor              # iteration counter
    mu: torch.Tensor             # shrinkage target = log(10 * eps0)


def da_init(step_size: torch.Tensor) -> DualAveragingState:
    log_eps = torch.log(torch.as_tensor(step_size))
    zero = torch.zeros_like(log_eps)
    return DualAveragingState(log_eps, zero, zero, zero, math.log(10.0) + log_eps)


def da_update(state: DualAveragingState, accept_prob: torch.Tensor,
              target_accept: float = 0.8, gamma: float = 0.05,
              t0: float = 10.0, kappa: float = 0.75) -> DualAveragingState:
    t = state.t + 1.0
    grad_sum = state.grad_sum + (target_accept - accept_prob)
    # Nesterov dual averaging: x_t = mu - sqrt(t)/gamma * (1/(t+t0)) * grad_sum
    log_step = state.mu - (torch.sqrt(t) / gamma) * grad_sum / (t + t0)
    eta = t ** (-kappa)
    log_step_avg = eta * log_step + (1.0 - eta) * state.log_step_avg
    return DualAveragingState(log_step, log_step_avg, grad_sum, t, state.mu)


class WelfordState(NamedTuple):
    mean: torch.Tensor           # (…, dim)
    m2: torch.Tensor             # (…, dim) diagonal or (…, dim, dim) full second moment
    count: torch.Tensor          # (…)


def welford_init(dim: int, dtype=None, dense: bool = False,
                 device=None, batch_shape=()) -> WelfordState:
    """Empty sums, one set per chain of ``batch_shape``, in ``dtype`` (None:
    the default dtype)."""
    dtype = resolve_dtype(dtype)
    batch_shape = tuple(batch_shape)
    m2_shape = batch_shape + ((dim, dim) if dense else (dim,))
    return WelfordState(torch.zeros(batch_shape + (dim,), dtype=dtype, device=device),
                        torch.zeros(m2_shape, dtype=dtype, device=device),
                        torch.zeros(batch_shape, dtype=dtype, device=device))


def welford_update(state: WelfordState, x: torch.Tensor) -> WelfordState:
    count = state.count + 1.0
    delta = x - state.mean
    mean = state.mean + delta / count[..., None]
    if state.m2.ndim == state.mean.ndim + 1:  # dense: rank-1 outer update
        m2 = state.m2 + delta[..., :, None] * (x - mean)[..., None, :]
    else:
        m2 = state.m2 + delta * (x - mean)
    return WelfordState(mean, m2, count)


def welford_variance(state: WelfordState, regularize: bool = True) -> torch.Tensor:
    """The next window's inverse mass matrix: (…, dim) diagonal or (…, dim, dim)."""
    if state.m2.ndim == state.mean.ndim + 1:
        n = state.count[..., None, None]
        cov = state.m2 / torch.clamp(n - 1.0, min=1.0)
        eye = torch.eye(state.mean.shape[-1], dtype=state.m2.dtype, device=state.m2.device)
        if regularize:
            # Stan's shrinkage toward (scaled) identity keeps the estimate PD
            cov = (n / (n + 5.0)) * cov + 1e-3 * (5.0 / (n + 5.0)) * eye
        return cov + 1e-10 * eye
    n = state.count[..., None]
    var = state.m2 / torch.clamp(n - 1.0, min=1.0)
    if regularize:
        var = (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))
    return torch.clamp(var, min=1e-10)


def mass_velocity(inv_mass: torch.Tensor, r: torch.Tensor, dense: Optional[bool] = None
                  ) -> torch.Tensor:
    """v = Σ·r for a diagonal or dense symmetric Σ = ``inv_mass``.

    One chain: Σ is (dim,) or (dim, dim) and ``dense`` defaults to
    ``inv_mass.ndim == 2``; ``r`` may carry leading batch axes. A batch of
    chains: Σ is (C, dim) or (C, dim, dim), which only ``dense`` tells
    apart, and ``r`` is (C, …, dim), chain c's rows taking Σ[c]."""
    if dense is None:
        dense = inv_mass.ndim == 2
    chains = inv_mass.ndim - (2 if dense else 1)
    if chains == 0:
        return r @ inv_mass if dense else inv_mass * r
    if dense:
        rr = r.reshape(r.shape[0], -1, r.shape[-1])
        return (rr @ inv_mass).reshape(r.shape)
    extra = r.ndim - inv_mass.ndim
    return inv_mass.reshape(inv_mass.shape[:1] + (1,) * extra + inv_mass.shape[1:]) * r


def leapfrog(potential_grad: Callable, z: torch.Tensor, r: torch.Tensor,
             step_size: torch.Tensor, inv_mass: torch.Tensor,
             grad: torch.Tensor, dense: Optional[bool] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One velocity-Verlet step; returns (z_new, r_new, potential_new,
    grad_new). For C chains z, r and grad are (C, dim) and ``step_size``
    is (C, 1)."""
    r_half = r - 0.5 * step_size * grad
    z_new = z + step_size * mass_velocity(inv_mass, r_half, dense)
    u_new, grad_new = potential_grad(z_new)
    r_new = r_half - 0.5 * step_size * grad_new
    return z_new, r_new, u_new, grad_new


def kinetic_energy(r: torch.Tensor, inv_mass: torch.Tensor,
                   dense: Optional[bool] = None) -> torch.Tensor:
    """½·rᵀΣr, one value per chain."""
    return 0.5 * (r * mass_velocity(inv_mass, r, dense)).sum(-1)


def sample_momentum(key: torch.Generator, inv_mass: torch.Tensor,
                    dense: Optional[bool] = None) -> torch.Tensor:
    """r ~ N(0, M) with M = Σ⁻¹ (Σ = inv_mass), one draw per chain."""
    if dense is None:
        dense = inv_mass.ndim == 2
    shape = inv_mass.shape[:-1] if dense else inv_mass.shape
    xi = torch.randn(shape, generator=key, dtype=inv_mass.dtype, device=inv_mass.device)
    if dense:
        # Σ = LLᵀ ⇒ r = L⁻ᵀξ has covariance Σ⁻¹
        L = torch.linalg.cholesky(inv_mass)
        return torch.linalg.solve_triangular(L.mT, xi[..., None], upper=True)[..., 0]
    return xi / torch.sqrt(inv_mass)


def find_reasonable_step_size(potential_grad: Callable, z: torch.Tensor,
                              inv_mass: torch.Tensor, key: torch.Generator,
                              init_step: float = 1.0, dense: Optional[bool] = None
                              ) -> torch.Tensor:
    """Heuristic initial step size (Hoffman & Gelman Alg. 4), one per chain
    for z (C, dim), or one for z (dim,). Each chain doubles or halves under
    its own mask until its accept test flips; one host read per round tells
    whether any chain still moves."""
    u0, grad0 = potential_grad(z)
    r = sample_momentum(key, inv_mass, dense)
    h0 = u0 + kinetic_energy(r, inv_mass, dense)
    log_half = math.log(0.5)

    def accept_logprob(eps):
        _, r1, u1, _ = leapfrog(potential_grad, z, r, eps[..., None], inv_mass, grad0, dense)
        lp = h0 - (u1 + kinetic_energy(r1, inv_mass, dense))
        # NaN-proof: a diverging step counts as "too big"
        return torch.where(torch.isnan(lp), -math.inf, lp)

    eps = torch.full(z.shape[:-1], init_step, dtype=z.dtype, device=z.device)
    lp = accept_logprob(eps)
    grow = lp > log_half
    moving = torch.ones_like(grow)
    for _ in range(100):
        moving = moving & torch.where(grow, lp > log_half, lp < log_half)
        if not host_bool(moving.any(), "step_size"):
            break
        eps = torch.where(moving, eps * torch.where(grow, 2.0, 0.5), eps)
        lp = torch.where(moving, accept_logprob(eps), lp)
    return torch.clamp(eps, 1e-7, 1e3)


def warmup_schedule(num_warmup: int, init_buffer: int = 75, term_buffer: int = 50,
                    base_window: int = 25):
    """Stan-style adaptation schedule: per warmup step, the flags
    (update_mass_window, is_window_end) as two bool tensors.

    Every mass-matrix update restarts dual averaging, so a window may only
    close if a term buffer of at least 20 steps remains for the step size to
    re-converge; when no window fits, the schedule degrades to step-size-only
    adaptation (``hmc_util.py:172-210``)."""
    no_mass = (torch.zeros(num_warmup, dtype=torch.bool),
               torch.zeros(num_warmup, dtype=torch.bool))
    if num_warmup < 20:
        return no_mass
    if num_warmup < init_buffer + term_buffer + base_window:
        init_buffer = int(0.15 * num_warmup)
        term_buffer = max(20, int(0.1 * num_warmup))
    ends = []
    pos = init_buffer
    w = base_window
    while pos + w + term_buffer <= num_warmup:
        pos += w
        ends.append(pos - 1)
        w *= 2
    if not ends:
        return no_mass
    ends[-1] = num_warmup - term_buffer - 1
    in_window = [init_buffer <= i <= (num_warmup - term_buffer - 1) for i in range(num_warmup)]
    window_end = [i in set(ends) for i in range(num_warmup)]
    return torch.tensor(in_window, dtype=torch.bool), torch.tensor(window_end, dtype=torch.bool)
