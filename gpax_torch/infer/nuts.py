"""Iterative No-U-Turn Sampler (counterpart of ``gpax_tpu/infer/nuts.py``).

The algorithm is the JAX package's:

* multinomial (progressive) sampling within a subtree, biased progressive
  sampling across doublings, and the generalized U-turn criterion
  (Betancourt 2017);
* sub-tree U-turn checks with O(max_depth) checkpoints: after leaf ``n``
  (0-indexed within the subtree) an even leaf is stored at slot
  ``popcount(n >> 1)``, and an odd leaf closes ``t = trailing_ones(n)``
  balanced subtrees, checked against slots
  ``[popcount(n >> 1) - t + 1, popcount(n >> 1)]``;
* diagonal or dense mass adaptation (Welford) on Stan's window schedule,
  with Nesterov dual averaging of the step size.

``lax.while_loop``/``scan`` become Python loops over tensors on the
sampler's device. The tree's stop test reads one flag to the host per
leapfrog, plus one U-turn flag per completed doubling; every read is counted
by ``utils.host_syncs``.

:func:`run_nuts_segmented` runs the plan in segments of transitions with
a per-segment callback, a wall-clock deadline (which truncates the draws
after warmup, and freezes adaptation when it fires during warmup) and a
shallow tree-depth cap for the head of warmup; :func:`run_nuts` is its
one-segment case, so both draw the same numbers from the same generator.
The JAX package's lockstep multi-chain runner is not ported.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, NamedTuple, Optional

import torch

from ..utils.utils import host_bool
from .hmc_util import (
    da_init,
    da_update,
    find_reasonable_step_size,
    kinetic_energy,
    leapfrog,
    mass_velocity,
    sample_momentum,
    warmup_schedule,
    welford_init,
    welford_update,
    welford_variance,
)

MAX_DELTA_ENERGY = 1000.0


class NUTSState(NamedTuple):
    z: torch.Tensor              # flat unconstrained position
    potential: torch.Tensor
    grad: torch.Tensor
    step_size: torch.Tensor
    inv_mass: torch.Tensor
    rng_key: torch.Generator
    # diagnostics of the last transition
    accept_prob: torch.Tensor
    num_steps: int
    diverging: torch.Tensor
    energy: torch.Tensor


def _is_turning(inv_mass, r_left, r_right, r_sum):
    """Generalized U-turn criterion (Betancourt 2017, App. A.4.2)."""
    rho = r_sum - 0.5 * (r_left + r_right)
    return (((mass_velocity(inv_mass, r_left) * rho).sum(-1) <= 0)
            | ((mass_velocity(inv_mass, r_right) * rho).sum(-1) <= 0))


def _popcount(n: int) -> int:
    return bin(n).count("1")


def _uniform(key: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    return torch.rand((), generator=key, dtype=like.dtype, device=like.device)


def _build_subtree(potential_grad, depth, z0, r0, grad0, eps_signed, inv_mass,
                   h0, key, max_depth) -> Dict:
    """Build a balanced subtree of 2**depth leaves starting one leapfrog
    beyond (z0, r0), stopping early on a U-turn or a divergence.

    Returns the new edge (z, r, grad), the proposal, the momentum sum, the
    subtree's log weight and summed accept probability, its leaf count
    ``n``, the ``turning``/``diverging`` flags, and ``stopped``, the host
    value of their OR."""
    dim = z0.shape[0]
    z, r, g = z0, r0, grad0
    z_prop, g_prop = z0, grad0
    u_prop = torch.zeros_like(h0)
    r_sum = torch.zeros_like(r0)
    log_w = torch.full_like(h0, -math.inf)
    sum_accept = torch.zeros_like(h0)
    ck = torch.zeros((max_depth + 1, 2 * dim), dtype=z0.dtype, device=z0.device)
    turning = torch.zeros((), dtype=torch.bool, device=z0.device)
    diverging = turning
    n, stopped = 0, False
    while n < 2**depth:
        z, r1, u1, g = leapfrog(potential_grad, z, r, eps_signed, inv_mass, g)
        energy = u1 + kinetic_energy(r1, inv_mass)
        delta = torch.where(torch.isnan(energy), math.inf, energy) - h0
        diverging = delta > MAX_DELTA_ENERGY
        # progressive multinomial sampling within the subtree
        log_w_new = torch.logaddexp(log_w, -delta)
        take_new = torch.log(_uniform(key, h0)) < (-delta - log_w_new)
        z_prop = torch.where(take_new, z, z_prop)
        g_prop = torch.where(take_new, g, g_prop)
        u_prop = torch.where(take_new, u1, u_prop)
        log_w = log_w_new
        sum_accept = sum_accept + torch.exp(torch.clamp(-delta, max=0.0))
        r_sum_old, r_sum, r = r_sum, r_sum + r1, r1

        slot = _popcount(n >> 1)
        if n % 2 == 0:  # checkpoint row = [r | Σr before this leaf]
            ck[slot] = torch.cat([r1, r_sum_old])
        else:  # odd leaf closes t balanced subtrees: check their checkpoints
            t = _popcount(n ^ (n + 1)) - 1
            rows = ck[slot - t + 1: slot + 1]
            turn = _is_turning(inv_mass, rows[:, :dim], r1, r_sum - rows[:, dim:])
            turning = turning | turn.any()
        n += 1
        if host_bool(turning | diverging):
            stopped = True
            break
    return {"n": n, "z": z, "r": r, "grad": g, "z_prop": z_prop, "grad_prop": g_prop,
            "u_prop": u_prop, "r_sum": r_sum, "log_weight": log_w,
            "sum_accept": sum_accept, "turning": turning, "diverging": diverging,
            "stopped": stopped}


def nuts_step(potential_grad: Callable, state: NUTSState, max_depth: int = 10,
              depth_cap: Optional[int] = None) -> NUTSState:
    """One NUTS transition: doublings in a random direction until a U-turn,
    a divergence or ``max_depth``. ``depth_cap`` (≤ ``max_depth``, which
    stays the checkpoints' bound) caps the doublings of this transition:
    the head of warmup runs shallow trees while dual averaging pulls the
    step size into range (``warmup_depth_cap``)."""
    key, inv_mass, eps = state.rng_key, state.inv_mass, state.step_size
    r0 = sample_momentum(key, inv_mass)
    h0 = state.potential + kinetic_energy(r0, inv_mass)
    left = right = (state.z, r0, state.grad)
    z_prop, g_prop, u_prop = state.z, state.grad, state.potential
    r_sum = r0
    log_w = torch.zeros_like(h0)
    sum_accept = torch.zeros_like(h0)
    diverging = torch.zeros((), dtype=torch.bool, device=h0.device)
    num_leaves = 0
    depth_limit = max_depth if depth_cap is None else min(max_depth, int(depth_cap))
    for depth in range(depth_limit):
        go_right = _uniform(key, h0) < 0.5
        edge = [torch.where(go_right, a, b) for a, b in zip(right, left)]
        sub = _build_subtree(potential_grad, depth, *edge, torch.where(go_right, eps, -eps),
                             inv_mass, h0, key, max_depth)
        num_leaves += sub["n"]
        sum_accept = sum_accept + sub["sum_accept"]
        diverging = sub["diverging"]
        if sub["stopped"]:
            # an invalid subtree contributes neither proposal nor edges
            break
        # biased progressive sampling across doublings
        take_new = torch.log(_uniform(key, h0)) < (sub["log_weight"] - log_w)
        z_prop = torch.where(take_new, sub["z_prop"], z_prop)
        g_prop = torch.where(take_new, sub["grad_prop"], g_prop)
        u_prop = torch.where(take_new, sub["u_prop"], u_prop)
        log_w = torch.logaddexp(log_w, sub["log_weight"])
        subedge = (sub["z"], sub["r"], sub["grad"])
        left = tuple(torch.where(go_right, a, b) for a, b in zip(left, subedge))
        right = tuple(torch.where(go_right, b, a) for a, b in zip(right, subedge))
        r_sum = r_sum + sub["r_sum"]
        # U-turn across the merged tree
        if host_bool(_is_turning(inv_mass, left[1], right[1], r_sum)):
            break
    return NUTSState(z=z_prop, potential=u_prop, grad=g_prop, step_size=eps,
                     inv_mass=inv_mass, rng_key=key,
                     accept_prob=sum_accept / max(num_leaves, 1),
                     num_steps=num_leaves, diverging=diverging, energy=u_prop)


class NUTS:
    """NUTS kernel spec (the constructor role of ``numpyro.infer.NUTS``)."""

    def __init__(self, model, step_size: float = 1.0, max_tree_depth: int = 10,
                 target_accept_prob: float = 0.8, init_strategy: str = "median",
                 dense_mass: bool = False):
        self.model = model
        self.step_size = step_size
        self.max_tree_depth = max_tree_depth
        self.target_accept_prob = target_accept_prob
        self.init_strategy = init_strategy
        self.dense_mass = dense_mass


def ravel(tree: Dict[str, torch.Tensor]):
    """(flat (dim,) tensor, unravel) for a dict of tensors; ``unravel`` maps
    (…, dim) back to a dict with the same leading dims."""
    names = list(tree)
    shapes = [tuple(tree[k].shape) for k in names]
    sizes = [math.prod(s) for s in shapes]
    flat = torch.cat([tree[k].reshape(-1) for k in names])

    def unravel(f: torch.Tensor) -> Dict[str, torch.Tensor]:
        out, off = {}, 0
        for k, s, size in zip(names, shapes, sizes):
            out[k] = f[..., off:off + size].reshape(f.shape[:-1] + s)
            off += size
        return out

    return flat, unravel


def _warmup_xs(num_warmup: int, num_samples: int, max_depth: int = 10,
               warmup_depth_cap=None):
    """Per-step rows of the warmup+sampling loop, as Python lists:
    (is_warmup, is_warmup_next, in_window, window_end, depth_cap).
    ``warmup_depth_cap`` = (cap, n_steps) caps the tree depth of the first
    n_steps warmup transitions at cap; every other step has ``max_depth``."""
    in_window, window_end = (f.tolist() for f in warmup_schedule(num_warmup))
    total = num_warmup + num_samples
    depth_cap = [max_depth] * total
    if warmup_depth_cap is not None:
        cap, n_steps = warmup_depth_cap
        for i in range(min(int(n_steps), num_warmup)):
            depth_cap[i] = int(cap)
    return ([i < num_warmup for i in range(total)],
            [i + 1 < num_warmup for i in range(total)],
            in_window + [False] * num_samples,
            window_end + [False] * num_samples,
            depth_cap)


_SEGMENT_STATS = ("segment_wall_s", "segment_leapfrogs", "warmup_steps_run",
                  "accept_mean_all")


def run_nuts(potential_fn: Callable, init_unconstrained: Dict[str, torch.Tensor],
             rng_key: torch.Generator, num_warmup: int, num_samples: int,
             max_tree_depth: int = 10, target_accept_prob: float = 0.8,
             init_step_size: float = 1.0, collect_warmup: bool = False,
             dense_mass: bool = False, warmup_depth_cap=None):
    """Warmup + sampling for one chain over a dict of unconstrained latents:
    :func:`run_nuts_segmented` in one segment. ``rng_key`` must live on the
    latents' device.

    Returns (flat samples (num_samples, dim), stats dict, unravel). The stats
    (``accept_prob``, ``num_steps``, ``diverging``, ``potential_energy``,
    ``step_size``) cover sampling only unless ``collect_warmup``.
    """
    zs, stats, unravel = run_nuts_segmented(
        potential_fn, init_unconstrained, rng_key, num_warmup, num_samples,
        segment_size=max(num_warmup + num_samples, 1), max_tree_depth=max_tree_depth,
        target_accept_prob=target_accept_prob, init_step_size=init_step_size,
        dense_mass=dense_mass, collect_warmup=collect_warmup,
        warmup_depth_cap=warmup_depth_cap)
    return zs, {k: v for k, v in stats.items() if k not in _SEGMENT_STATS}, unravel


def run_nuts_segmented(potential_fn: Callable, init_unconstrained: Dict[str, torch.Tensor],
                       rng_key: torch.Generator, num_warmup: int, num_samples: int,
                       segment_size: int = 50, max_tree_depth: int = 10,
                       target_accept_prob: float = 0.8, init_step_size: float = 1.0,
                       progress: bool = False, dense_mass: bool = False,
                       collect_warmup: bool = False,
                       segment_callback: Optional[Callable] = None,
                       deadline: Optional[float] = None, warmup_depth_cap=None):
    """Warmup + sampling for one chain in segments of ``segment_size``
    transitions (``gpax_tpu/infer/nuts.py:499-669``). The chain's state,
    dual averaging and Welford sums carry across segment boundaries, so the
    draws are those of one unsegmented run with the same generator.

    After each segment, ``segment_callback`` (if given) gets a dict of
    ``segments_done``, ``n_segments``, ``steps_done``, ``total_steps``,
    ``wall_s`` and the per-segment lists ``segment_wall_s`` and
    ``segment_leapfrogs``; a segment's wall clock ends at a device
    synchronize, so it measures the work and not its enqueue. Then the
    ``deadline`` (a ``time.perf_counter()`` value) is read: past it after
    warmup, the run stops and returns the draws so far; past it during
    warmup, adaptation freezes at this boundary and the rest of the plan
    becomes draws, at the full tree depth (``warmup_depth_cap`` binds only
    warmup). ``warmup_depth_cap`` = (cap, n_steps) caps the tree depth of
    the first n_steps warmup transitions.

    Returns (flat samples, stats dict, unravel): the stats of
    :func:`run_nuts`, plus ``segment_wall_s``, ``segment_leapfrogs`` (every
    transition run, warmup included), ``warmup_steps_run`` and
    ``accept_mean_all`` (the mean accept probability of every transition
    run).
    """
    if segment_size < 1:
        raise ValueError(f"segment_size must be at least 1, got {segment_size}")
    z0, unravel = ravel(init_unconstrained)
    dim, dtype, device = z0.shape[0], z0.dtype, z0.device

    def potential_grad(zf):
        with torch.enable_grad():
            zf = zf.detach().requires_grad_(True)
            u = potential_fn(unravel(zf))
            (g,) = torch.autograd.grad(u, zf)
        return u.detach(), g

    inv_mass = (torch.eye(dim, dtype=dtype, device=device) if dense_mass
                else torch.ones(dim, dtype=dtype, device=device))
    eps0 = find_reasonable_step_size(potential_grad, z0, inv_mass, rng_key, init_step_size)
    u0, g0 = potential_grad(z0)
    state = NUTSState(z=z0, potential=u0, grad=g0, step_size=eps0, inv_mass=inv_mass,
                      rng_key=rng_key, accept_prob=torch.zeros_like(u0), num_steps=0,
                      diverging=torch.zeros((), dtype=torch.bool, device=device), energy=u0)

    da = da_init(eps0)
    da_steps = 0  # host mirror of da.t (reset with da at each window end)
    wf = welford_init(dim, dtype, dense=dense_mass, device=device)
    zs, stats = [], {k: [] for k in ("accept_prob", "num_steps", "diverging",
                                     "potential_energy", "step_size")}
    total = num_warmup + num_samples
    xs = _warmup_xs(num_warmup, num_samples, max_tree_depth, warmup_depth_cap)
    n_segments = -(-total // segment_size)
    num_warmup_eff = num_warmup  # shrinks if the deadline fires during warmup
    seg_wall, seg_leapfrogs = [], []
    t_start = time.perf_counter()
    for s in range(n_segments):
        lo, hi = s * segment_size, min((s + 1) * segment_size, total)
        t0 = time.perf_counter()
        for i in range(lo, hi):
            warm, warm_next, in_win, win_end, cap = (x[i] for x in xs)
            state = nuts_step(potential_grad, state, max_tree_depth, cap)
            if warm:  # dual averaging only advances during warmup
                da = da_update(da, state.accept_prob, target_accept_prob)
                da_steps += 1
            # the live DA iterate while warming up, the averaged one once
            # sampling (the live one if no update ever happened)
            log_eps = da.log_step if warm_next or da_steps == 0 else da.log_step_avg
            state = state._replace(step_size=torch.exp(log_eps))
            if in_win:
                wf = welford_update(wf, state.z)
            if win_end:
                state = state._replace(inv_mass=welford_variance(wf))
                da, da_steps = da_init(torch.exp(da.log_step)), 0
                wf = welford_init(dim, dtype, dense=dense_mass, device=device)
            zs.append(state.z)
            stats["accept_prob"].append(state.accept_prob)
            stats["num_steps"].append(state.num_steps)
            stats["diverging"].append(state.diverging)
            stats["potential_energy"].append(state.potential)
            stats["step_size"].append(state.step_size)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seg_wall.append(time.perf_counter() - t0)
        seg_leapfrogs.append(sum(stats["num_steps"][lo:hi]))
        done = hi
        if progress:
            print(f"  NUTS segment {s + 1}/{n_segments} ({done}/{total} steps)", flush=True)
        if segment_callback is not None:
            segment_callback({
                "segments_done": s + 1, "n_segments": n_segments,
                "steps_done": done, "total_steps": total,
                "wall_s": time.perf_counter() - t_start,
                "segment_wall_s": list(seg_wall),
                "segment_leapfrogs": list(seg_leapfrogs),
            })
        if deadline is not None and time.perf_counter() >= deadline:
            if done < num_warmup_eff:
                # freeze adaptation here; the rest of the plan becomes draws
                # at the full depth (the head's cap binds warmup only)
                num_warmup_eff = done
                for x in xs[:4]:
                    x[done:] = [False] * (total - done)
                xs[4][done:] = [max_tree_depth] * (total - done)
            elif num_warmup_eff < done < total:
                total = done  # return the draws collected so far
                break

    first = 0 if collect_warmup else num_warmup_eff
    out = {k: (torch.tensor(v[first:total], dtype=torch.int64) if k == "num_steps"
               else torch.stack(v[first:total]) if v[first:total] else torch.zeros(0))
           for k, v in stats.items()}
    out["segment_wall_s"] = torch.tensor(seg_wall, dtype=torch.float64)
    out["segment_leapfrogs"] = torch.tensor(seg_leapfrogs, dtype=torch.int64)
    out["warmup_steps_run"] = torch.tensor(num_warmup_eff, dtype=torch.int64)
    out["accept_mean_all"] = (torch.stack(stats["accept_prob"][:total]).mean() if total
                              else torch.tensor(math.nan))
    samples = torch.stack(zs[first:total]) if zs[first:total] else z0.new_zeros((0, dim))
    return samples, out, unravel
