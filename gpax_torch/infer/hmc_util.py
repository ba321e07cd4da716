"""HMC building blocks (counterpart of ``gpax_tpu/infer/hmc_util.py``):
leapfrog integrator, dual-averaging step-size adaptation, Welford
(co)variance for the mass matrix, and the Stan-style warmup schedule.

States are NamedTuples of tensors on the sampler's device; the schedule is
host-side Python, since the sampler's loop is a Python loop.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Tuple

import torch

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
    mean: torch.Tensor
    m2: torch.Tensor             # (dim,) diagonal or (dim, dim) full second moment
    count: torch.Tensor


def welford_init(dim: int, dtype=torch.float32, dense: bool = False,
                 device=None) -> WelfordState:
    m2_shape = (dim, dim) if dense else (dim,)
    return WelfordState(torch.zeros((dim,), dtype=dtype, device=device),
                        torch.zeros(m2_shape, dtype=dtype, device=device),
                        torch.zeros((), dtype=dtype, device=device))


def welford_update(state: WelfordState, x: torch.Tensor) -> WelfordState:
    count = state.count + 1.0
    delta = x - state.mean
    mean = state.mean + delta / count
    if state.m2.ndim == state.mean.ndim + 1:  # dense: rank-1 outer update
        m2 = state.m2 + delta[..., :, None] * (x - mean)[..., None, :]
    else:
        m2 = state.m2 + delta * (x - mean)
    return WelfordState(mean, m2, count)


def welford_variance(state: WelfordState, regularize: bool = True) -> torch.Tensor:
    """The next window's inverse mass matrix: (dim,) diagonal or (dim, dim)."""
    n = state.count
    if state.m2.ndim == state.mean.ndim + 1:
        cov = state.m2 / torch.clamp(n - 1.0, min=1.0)
        eye = torch.eye(state.mean.shape[-1], dtype=state.m2.dtype, device=state.m2.device)
        if regularize:
            # Stan's shrinkage toward (scaled) identity keeps the estimate PD
            cov = (n / (n + 5.0)) * cov + 1e-3 * (5.0 / (n + 5.0)) * eye
        return cov + 1e-10 * eye
    var = state.m2 / torch.clamp(n - 1.0, min=1.0)
    if regularize:
        var = (n / (n + 5.0)) * var + 1e-3 * (5.0 / (n + 5.0))
    return torch.clamp(var, min=1e-10)


def mass_velocity(inv_mass: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """v = Σ·r for a diagonal (dim,) or dense symmetric (dim, dim) Σ; ``r``
    may carry leading batch axes."""
    if inv_mass.ndim == 2:
        return r @ inv_mass
    return inv_mass * r


def leapfrog(potential_grad: Callable, z: torch.Tensor, r: torch.Tensor,
             step_size: torch.Tensor, inv_mass: torch.Tensor,
             grad: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One velocity-Verlet step; returns (z_new, r_new, potential_new, grad_new)."""
    r_half = r - 0.5 * step_size * grad
    z_new = z + step_size * mass_velocity(inv_mass, r_half)
    u_new, grad_new = potential_grad(z_new)
    r_new = r_half - 0.5 * step_size * grad_new
    return z_new, r_new, u_new, grad_new


def kinetic_energy(r: torch.Tensor, inv_mass: torch.Tensor) -> torch.Tensor:
    return 0.5 * (r * mass_velocity(inv_mass, r)).sum()


def sample_momentum(key: torch.Generator, inv_mass: torch.Tensor) -> torch.Tensor:
    """r ~ N(0, M) with M = Σ⁻¹ (Σ = inv_mass)."""
    xi = torch.randn(inv_mass.shape[-1:], generator=key, dtype=inv_mass.dtype,
                     device=inv_mass.device)
    if inv_mass.ndim == 2:
        # Σ = LLᵀ ⇒ r = L⁻ᵀξ has covariance Σ⁻¹
        L = torch.linalg.cholesky(inv_mass)
        return torch.linalg.solve_triangular(L.mT, xi[:, None], upper=True)[:, 0]
    return xi / torch.sqrt(inv_mass)


def find_reasonable_step_size(potential_grad: Callable, z: torch.Tensor,
                              inv_mass: torch.Tensor, key: torch.Generator,
                              init_step: float = 1.0) -> torch.Tensor:
    """Heuristic initial step size (Hoffman & Gelman Alg. 4). Each doubling or
    halving reads its accept test on the host."""
    u0, grad0 = potential_grad(z)
    r = sample_momentum(key, inv_mass)
    h0 = u0 + kinetic_energy(r, inv_mass)
    log_half = math.log(0.5)

    def accept_logprob(eps):
        _, r1, u1, _ = leapfrog(potential_grad, z, r, eps, inv_mass, grad0)
        lp = h0 - (u1 + kinetic_energy(r1, inv_mass))
        # NaN-proof: a diverging step counts as "too big"
        return torch.where(torch.isnan(lp), -math.inf, lp)

    eps = torch.as_tensor(init_step, dtype=z.dtype, device=z.device)
    lp = accept_logprob(eps)
    grow = host_bool(lp > log_half)
    for _ in range(100):
        if not host_bool(lp > log_half if grow else lp < log_half):
            break
        eps = eps * (2.0 if grow else 0.5)
        lp = accept_logprob(eps)
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
