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
sampler's device. Chains run in lockstep (:func:`run_nuts_segmented_chains`,
``gpax_tpu/infer/nuts.py:672-870``): every tensor of the tree leads with the
chain dim, all chains advance the same leaf index, and a chain that has
U-turned or diverged is frozen by its mask while the others go on, its
leapfrogs computed with theirs and discarded. The tree's stop test reads one
flag to the host per lockstep leapfrog (has every chain stopped?), plus one
U-turn flag per completed doubling, and one read of the segment's tree sizes
after its synchronize; every read is counted by ``utils.host_syncs``. While
a profiler runs, each transition is the root span ``gpax.nuts.transition``,
each call of the potential and its gradient (the initial one, the step-size
search's and every leapfrog's) ``gpax.potential_grad``, and each read
``gpax.host_read.<site>`` (``utils.monitor.span``). One chain is the case C = 1
(:func:`run_nuts_segmented`, on an unbatched potential).

Both runners take the plan in segments of transitions with a per-segment
callback, a wall-clock deadline (which truncates the draws after warmup,
and freezes adaptation when it fires during warmup) and a shallow
tree-depth cap for the head of warmup; :func:`run_nuts` is the one-segment
case of :func:`run_nuts_segmented`, so both draw the same numbers from the
same generator.
"""

from __future__ import annotations

import math
import time
import warnings
from typing import Callable, Dict, NamedTuple, Optional

import torch

from ..utils.monitor import span, spanned
from ..utils.utils import host_bool, host_read
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
    """One state per chain: every tensor leads with the chain dim (C,)."""
    z: torch.Tensor              # (C, dim) flat unconstrained position
    potential: torch.Tensor      # (C,)
    grad: torch.Tensor           # (C, dim)
    step_size: torch.Tensor      # (C,)
    inv_mass: torch.Tensor       # (C, dim) diagonal or (C, dim, dim) dense
    rng_key: torch.Generator
    # diagnostics of the last transition
    accept_prob: torch.Tensor    # (C,)
    num_steps: torch.Tensor      # (C,) leapfrogs of each chain's own tree
    diverging: torch.Tensor      # (C,)
    energy: torch.Tensor         # (C,)
    lockstep_steps: int = 0      # batched potential evaluations of the transition


def _is_turning(inv_mass, r_left, r_right, r_sum, dense=None):
    """Generalized U-turn criterion (Betancourt 2017, App. A.4.2)."""
    rho = r_sum - 0.5 * (r_left + r_right)
    return (((mass_velocity(inv_mass, r_left, dense) * rho).sum(-1) <= 0)
            | ((mass_velocity(inv_mass, r_right, dense) * rho).sum(-1) <= 0))


def _popcount(n: int) -> int:
    return bin(n).count("1")


def _uniform(key: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    """One uniform draw per chain (``like`` is (C,))."""
    return torch.rand(like.shape, generator=key, dtype=like.dtype, device=like.device)


def _where(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a where the chain's mask (C,) is set, else b, for (C, …) tensors."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.ndim - 1)), a, b)


def _build_subtree(potential_grad, depth, z0, r0, grad0, eps_signed, inv_mass,
                   h0, key, max_depth, active, dense) -> Dict:
    """Build a balanced subtree of 2**depth leaves for each chain, starting
    one leapfrog beyond its (z0, r0), all chains advancing the same leaf
    index in lockstep.

    A chain takes part while it is ``active`` and has neither U-turned nor
    diverged in this subtree; after that its edge, proposal, weights and
    checkpoints stay frozen. Its leapfrogs are still computed with the
    others' and discarded, as a vmapped while loop does. One host read per
    leapfrog tells whether every chain has stopped.

    Returns, per chain, the new edge (z, r, grad), the proposal, the
    momentum sum, the subtree's log weight and summed accept probability,
    its leaf count ``n``, the ``turning``/``diverging`` flags; and, for all,
    ``all_stopped`` (the host value: every chain stopped early) and
    ``lockstep``, the leapfrogs run."""
    C, dim = z0.shape
    z, r, g = z0, r0, grad0
    z_prop, g_prop = z0, grad0
    u_prop = torch.zeros_like(h0)
    r_sum = torch.zeros_like(r0)
    log_w = torch.full_like(h0, -math.inf)
    sum_accept = torch.zeros_like(h0)
    ck = torch.zeros((C, max_depth + 1, 2 * dim), dtype=z0.dtype, device=z0.device)
    turning = torch.zeros(C, dtype=torch.bool, device=z0.device)
    diverging = turning
    n_leaves = torch.zeros(C, dtype=torch.int64, device=z0.device)
    live = active
    n, all_stopped = 0, False
    while n < 2**depth:
        z1, r1, u1, g1 = leapfrog(potential_grad, z, r, eps_signed[:, None], inv_mass, g, dense)
        energy = u1 + kinetic_energy(r1, inv_mass, dense)
        delta = torch.where(torch.isnan(energy), math.inf, energy) - h0
        # progressive multinomial sampling within the subtree
        log_w_new = torch.logaddexp(log_w, -delta)
        take_new = live & (torch.log(_uniform(key, h0)) < (-delta - log_w_new))
        z_prop = _where(take_new, z1, z_prop)
        g_prop = _where(take_new, g1, g_prop)
        u_prop = torch.where(take_new, u1, u_prop)
        log_w = torch.where(live, log_w_new, log_w)
        sum_accept = sum_accept + torch.where(live, torch.exp(torch.clamp(-delta, max=0.0)), 0.0)
        r_sum_old = r_sum
        r_sum = _where(live, r_sum + r1, r_sum)

        slot = _popcount(n >> 1)
        if n % 2 == 0:  # checkpoint row = [r | Σr before this leaf]
            ck[:, slot] = _where(live, torch.cat([r1, r_sum_old], -1), ck[:, slot])
        else:  # odd leaf closes t balanced subtrees: check their checkpoints
            t = _popcount(n ^ (n + 1)) - 1
            rows = ck[:, slot - t + 1: slot + 1]
            turn = _is_turning(inv_mass, rows[..., :dim], r1[:, None],
                               r_sum[:, None] - rows[..., dim:], dense)
            turning = turning | (live & turn.any(-1))
        diverging = diverging | (live & (delta > MAX_DELTA_ENERGY))
        n_leaves = n_leaves + live.to(torch.int64)
        live = live & ~(turning | diverging)
        # the edge advances while the chain goes on: a stopped chain keeps
        # a point of finite energy to run its discarded leapfrogs from
        z, r, g = _where(live, z1, z), _where(live, r1, r), _where(live, g1, g)
        n += 1
        if not host_bool(live.any(), "nuts_subtree"):
            all_stopped = True
            break
    return {"n": n_leaves, "z": z, "r": r, "grad": g, "z_prop": z_prop, "grad_prop": g_prop,
            "u_prop": u_prop, "r_sum": r_sum, "log_weight": log_w,
            "sum_accept": sum_accept, "turning": turning, "diverging": diverging,
            "all_stopped": all_stopped, "lockstep": n}


def nuts_step(potential_grad: Callable, state: NUTSState, max_depth: int = 10,
              depth_cap: Optional[int] = None, dense: bool = False) -> NUTSState:
    """One NUTS transition of every chain in lockstep: doublings, each
    chain in its own random direction, until it U-turns, diverges or
    reaches ``max_depth``. ``depth_cap`` (≤ ``max_depth``, which stays the
    checkpoints' bound) caps the doublings of this transition: the head of
    warmup runs shallow trees while dual averaging pulls the step size into
    range (``warmup_depth_cap``). A chain that has stopped keeps its
    proposal while the others go on; one host read per doubling (the
    merged trees' U-turn) tells whether any goes on."""
    key, inv_mass, eps = state.rng_key, state.inv_mass, state.step_size
    r0 = sample_momentum(key, inv_mass, dense)
    h0 = state.potential + kinetic_energy(r0, inv_mass, dense)
    left = right = (state.z, r0, state.grad)
    z_prop, g_prop, u_prop = state.z, state.grad, state.potential
    r_sum = r0
    log_w = torch.zeros_like(h0)
    sum_accept = torch.zeros_like(h0)
    diverging = torch.zeros(h0.shape, dtype=torch.bool, device=h0.device)
    num_leaves = torch.zeros(h0.shape, dtype=torch.int64, device=h0.device)
    active = ~diverging
    lockstep = 0
    depth_limit = max_depth if depth_cap is None else min(max_depth, int(depth_cap))
    for depth in range(depth_limit):
        go_right = _uniform(key, h0) < 0.5
        edge = [_where(go_right, a, b) for a, b in zip(right, left)]
        sub = _build_subtree(potential_grad, depth, *edge, torch.where(go_right, eps, -eps),
                             inv_mass, h0, key, max_depth, active, dense)
        num_leaves = num_leaves + sub["n"]
        sum_accept = sum_accept + sub["sum_accept"]
        diverging = torch.where(active, sub["diverging"], diverging)
        lockstep += sub["lockstep"]
        if sub["all_stopped"]:
            # an invalid subtree contributes neither proposal nor edges
            break
        ok = active & ~(sub["turning"] | sub["diverging"])
        # biased progressive sampling across doublings
        take_new = ok & (torch.log(_uniform(key, h0)) < (sub["log_weight"] - log_w))
        z_prop = _where(take_new, sub["z_prop"], z_prop)
        g_prop = _where(take_new, sub["grad_prop"], g_prop)
        u_prop = torch.where(take_new, sub["u_prop"], u_prop)
        log_w = torch.where(ok, torch.logaddexp(log_w, sub["log_weight"]), log_w)
        subedge = (sub["z"], sub["r"], sub["grad"])
        left = tuple(_where(ok & ~go_right, b, a) for a, b in zip(left, subedge))
        right = tuple(_where(ok & go_right, b, a) for a, b in zip(right, subedge))
        r_sum = _where(ok, r_sum + sub["r_sum"], r_sum)
        # U-turn across the merged tree
        active = ok & ~_is_turning(inv_mass, left[1], right[1], r_sum, dense)
        if not host_bool(active.any(), "nuts_doubling"):
            break
    # one chain's leaves are the lockstep count, a host int: ATen divides a
    # card tensor by a host scalar as a product with its reciprocal, which
    # rounds otherwise than a division by a tensor, and that last bit of
    # the accept statistic steers dual averaging and so the whole chain
    leaves = max(lockstep, 1) if h0.shape[0] == 1 else torch.clamp(num_leaves, min=1)
    return NUTSState(z=z_prop, potential=u_prop, grad=g_prop, step_size=eps,
                     inv_mass=inv_mass, rng_key=key,
                     accept_prob=sum_accept / leaves,
                     num_steps=num_leaves, diverging=diverging, energy=u_prop,
                     lockstep_steps=lockstep)


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
    transitions (``gpax_tpu/infer/nuts.py:499-669``): the lockstep runner
    of :func:`run_nuts_segmented_chains` with one chain, on the unbatched
    potential ``potential_fn``. The chain's state, dual averaging and
    Welford sums carry across segment boundaries, so the draws are those of
    one unsegmented run with the same generator.

    The options and stats are those of :func:`run_nuts_segmented_chains`,
    without the chain dim: the samples are (draws, dim) and each per-draw
    stat is (draws,).
    """
    z0, unravel = ravel(init_unconstrained)

    def potential_grad(zf):
        with torch.enable_grad():
            z1 = zf[0].detach().requires_grad_(True)
            u = potential_fn(unravel(z1))
            (g,) = torch.autograd.grad(u, z1)
        return u.detach()[None], g[None]

    zs, stats = _run_lockstep(
        potential_grad, z0[None], rng_key, num_warmup, num_samples, segment_size,
        max_tree_depth, target_accept_prob, init_step_size, progress, dense_mass,
        collect_warmup, segment_callback, deadline, warmup_depth_cap)
    stats.pop("segment_lockstep_leapfrogs")
    return zs[0], {k: (v[0] if k not in _SEGMENT_STATS else v) for k, v in stats.items()}, \
        unravel


def run_nuts_segmented_chains(potential_fn: Callable, init_unconstrained_batch,
                              rng_key: torch.Generator, num_chains: int, num_warmup: int,
                              num_samples: int, segment_size: int = 50,
                              max_tree_depth: int = 10, target_accept_prob: float = 0.8,
                              init_step_size: float = 1.0, progress: bool = False,
                              shard_put: Optional[Callable] = None, warmup_depth_cap=None,
                              dense_mass: bool = False,
                              segment_callback: Optional[Callable] = None,
                              deadline: Optional[float] = None, collect_warmup: bool = False,
                              batched_potential_fn: Optional[Callable] = None):
    """``num_chains`` chains in lockstep (``gpax_tpu/infer/nuts.py:672-870``,
    whose signature this is, ``collect_warmup`` and ``batched_potential_fn``
    added). The chains share the adaptation plan (the warmup flags and the
    depth cap) and keep their own step size, mass matrix, dual averaging
    and Welford sums.

    ``potential_fn`` is one chain's potential, as in the JAX package, where
    it is vmapped. ``batched_potential_fn``, if given, is the same
    potential over latents with a leading chain dim (C, …) → (C,), such as
    ``initialize_model(..., batch_shape=(C,)).potential_fn``: every
    leapfrog is then one call of it for all chains, the gradient that of
    its sum. It is trusted only if, at the initial point, it returns shape
    (C,) and equals the C single-chain potentials (to 1e-4 relative).
    Otherwise, or without it, each leapfrog evaluates ``potential_fn`` and
    its gradient chain by chain, C calls stacked; a rejected batched
    potential says so with a ``UserWarning``. A model whose batch
    broadcasts wrong (its values differ) is caught as well as one that
    raises.

    ``init_unconstrained_batch`` holds each chain's initial latents, (C, …)
    per site, or is a callable ``init_batch(key)`` that returns them and is
    called with ``rng_key``. ``num_chains`` must equal its leading dim.
    ``shard_put`` places the chain dim on a device mesh in the JAX package;
    the port runs lockstep chains on one device and refuses anything but
    None.

    After each segment of ``segment_size`` transitions,
    ``segment_callback`` (if given) gets a dict of ``segments_done``,
    ``n_segments``, ``steps_done``, ``total_steps``, ``num_chains``,
    ``wall_s`` and the per-segment lists ``segment_wall_s`` and
    ``segment_leapfrogs`` (summed over the chains); a segment's wall clock
    ends at a device synchronize, so it measures the work and not its
    enqueue. Then the ``deadline`` (a ``time.perf_counter()`` value) is
    read: past it after warmup, the run stops and returns the draws so far;
    past it during warmup, adaptation freezes at this boundary for every
    chain (the plan rows are shared) and the rest of the plan becomes
    draws, at the full tree depth (``warmup_depth_cap`` binds only warmup).
    ``warmup_depth_cap`` = (cap, n_steps) caps the tree depth of the first
    n_steps warmup transitions.

    Returns (flat samples (C, draws, dim), stats, unravel). The per-draw
    stats ``accept_prob``, ``num_steps``, ``diverging``,
    ``potential_energy`` and ``step_size`` are (C, draws) and cover
    sampling only unless ``collect_warmup``; ``segment_wall_s``,
    ``segment_leapfrogs`` (every transition run, warmup included, summed
    over the chains) and ``segment_lockstep_leapfrogs`` (the rounds of
    potential evaluations) are per segment; ``warmup_steps_run``,
    ``accept_mean_all`` (the mean accept probability of every transition
    run by every chain) and ``chain_by_chain`` (whether the chains'
    potentials ran one by one) are scalars.
    """
    if shard_put is not None:
        raise ValueError("shard_put places the chain dim on a device mesh; gpax_torch runs "
                         "lockstep chains on one device (parallel/ is not ported): pass None")
    batch = (init_unconstrained_batch(rng_key) if callable(init_unconstrained_batch)
             else init_unconstrained_batch)
    names = list(batch)
    z0 = torch.cat([batch[k].reshape(batch[k].shape[0], -1) for k in names], -1)
    if z0.shape[0] != num_chains:
        raise ValueError(f"num_chains={num_chains} but the initial batch holds "
                         f"{z0.shape[0]} chains")
    _, unravel = ravel({k: v[0] for k, v in batch.items()})
    potential_grad, chain_by_chain = _chains_potential_grad(
        potential_fn, batched_potential_fn, z0, unravel)
    zs, stats = _run_lockstep(
        potential_grad, z0, rng_key, num_warmup, num_samples, segment_size,
        max_tree_depth, target_accept_prob, init_step_size, progress, dense_mass,
        collect_warmup, segment_callback, deadline, warmup_depth_cap)
    stats["chain_by_chain"] = torch.tensor(chain_by_chain)
    return zs, stats, unravel


def _chains_potential_grad(potential_fn: Callable, batched_potential_fn: Optional[Callable],
                           z0: torch.Tensor, unravel: Callable):
    """The map (C, dim) → ((C,), (C, dim)) of the chains' potentials and
    gradients, and whether it runs chain by chain: the batched potential's
    if it passes the check at z0 (see :func:`run_nuts_segmented_chains`),
    else C calls of one chain's."""

    def per_chain(zf):
        us, gs = [], []
        for z in zf:
            with torch.enable_grad():
                z1 = z.detach().requires_grad_(True)
                u = potential_fn(unravel(z1))
                (g,) = torch.autograd.grad(u, z1)
            us.append(u.detach())
            gs.append(g)
        return torch.stack(us), torch.stack(gs)

    def batched(zf):
        with torch.enable_grad():
            zf = zf.detach().requires_grad_(True)
            u = batched_potential_fn(unravel(zf))
            (g,) = torch.autograd.grad(u.sum(), zf)
        return u.detach(), g

    if batched_potential_fn is None:
        return per_chain, True
    with torch.no_grad():
        single = torch.stack([potential_fn(unravel(z)) for z in z0])
        try:
            u = batched_potential_fn(unravel(z0))
            why = (f"it returned shape {tuple(u.shape)} for {z0.shape[0]} chains"
                   if tuple(u.shape) != tuple(single.shape) else
                   None if bool(((u - single).abs() <= 1e-4 * (1.0 + single.abs())).all())
                   else f"its values {u.tolist()} differ from the single chains' "
                        f"{single.tolist()}")
        except (RuntimeError, ValueError) as e:
            why = f"it raised {type(e).__name__}: {e}"
    if why is None:
        return batched, False
    name = getattr(batched_potential_fn, "__qualname__", repr(batched_potential_fn))
    warnings.warn(f"{name} cannot carry a leading chain dim of {z0.shape[0]} on its latents "
                  f"({why}); the lockstep chains evaluate it chain by chain, "
                  f"{z0.shape[0]} calls a leapfrog", UserWarning, stacklevel=3)
    return per_chain, True


def _run_lockstep(potential_grad, z0, rng_key, num_warmup, num_samples, segment_size,
                  max_tree_depth, target_accept_prob, init_step_size, progress, dense_mass,
                  collect_warmup, segment_callback, deadline, warmup_depth_cap):
    """The segmented warmup + sampling loop of C chains from z0 (C, dim);
    ``potential_grad`` maps (C, dim) to ((C,), (C, dim))."""
    if segment_size < 1:
        raise ValueError(f"segment_size must be at least 1, got {segment_size}")
    potential_grad = spanned("gpax.potential_grad")(potential_grad)
    (C, dim), dtype, device = z0.shape, z0.dtype, z0.device
    inv_mass = (torch.eye(dim, dtype=dtype, device=device) if dense_mass
                else torch.ones(dim, dtype=dtype, device=device)).expand(
                    (C,) + ((dim, dim) if dense_mass else (dim,))).clone()
    eps0 = find_reasonable_step_size(potential_grad, z0, inv_mass, rng_key, init_step_size,
                                     dense_mass)
    u0, g0 = potential_grad(z0)
    no = torch.zeros(C, dtype=torch.bool, device=device)
    state = NUTSState(z=z0, potential=u0, grad=g0, step_size=eps0, inv_mass=inv_mass,
                      rng_key=rng_key, accept_prob=torch.zeros_like(u0),
                      num_steps=torch.zeros(C, dtype=torch.int64, device=device),
                      diverging=no, energy=u0)

    da = da_init(eps0)
    da_steps = 0  # host mirror of da.t (shared by the chains; reset at each window end)
    wf = welford_init(dim, dtype, dense=dense_mass, device=device, batch_shape=(C,))
    zs, stats = [], {k: [] for k in ("accept_prob", "num_steps", "diverging",
                                     "potential_energy", "step_size")}
    total = num_warmup + num_samples
    xs = _warmup_xs(num_warmup, num_samples, max_tree_depth, warmup_depth_cap)
    n_segments = -(-total // segment_size)
    num_warmup_eff = num_warmup  # shrinks if the deadline fires during warmup
    seg_wall, seg_leapfrogs, seg_lockstep = [], [], []
    t_start = time.perf_counter()
    for s in range(n_segments):
        lo, hi = s * segment_size, min((s + 1) * segment_size, total)
        t0 = time.perf_counter()
        lockstep = 0
        for i in range(lo, hi):
            with span("gpax.nuts.transition", root=True):
                warm, warm_next, in_win, win_end, cap = (x[i] for x in xs)
                state = nuts_step(potential_grad, state, max_tree_depth, cap, dense_mass)
                lockstep += state.lockstep_steps
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
                    wf = welford_init(dim, dtype, dense=dense_mass, device=device,
                                      batch_shape=(C,))
                zs.append(state.z)
                stats["accept_prob"].append(state.accept_prob)
                stats["num_steps"].append(state.num_steps)
                stats["diverging"].append(state.diverging)
                stats["potential_energy"].append(state.potential)
                stats["step_size"].append(state.step_size)
        with host_read("nuts_segment"):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            seg_wall.append(time.perf_counter() - t0)
            seg_leapfrogs.append(int(torch.stack(stats["num_steps"][lo:hi]).sum())
                                 if hi > lo else 0)
        seg_lockstep.append(lockstep)
        done = hi
        if progress:
            print(f"  NUTS segment {s + 1}/{n_segments} ({done}/{total} steps, "
                  f"{C} chains)", flush=True)
        if segment_callback is not None:
            segment_callback({
                "segments_done": s + 1, "n_segments": n_segments,
                "steps_done": done, "total_steps": total, "num_chains": C,
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
    out = {k: (torch.stack(v[first:total], 1) if v[first:total]
               else torch.zeros((C, 0), dtype=torch.int64 if k == "num_steps" else dtype))
           for k, v in stats.items()}
    out["segment_wall_s"] = torch.tensor(seg_wall, dtype=torch.float64)
    out["segment_leapfrogs"] = torch.tensor(seg_leapfrogs, dtype=torch.int64)
    out["segment_lockstep_leapfrogs"] = torch.tensor(seg_lockstep, dtype=torch.int64)
    out["warmup_steps_run"] = torch.tensor(num_warmup_eff, dtype=torch.int64)
    out["accept_mean_all"] = (torch.stack(stats["accept_prob"][:total]).mean() if total
                              else torch.tensor(math.nan))
    samples = (torch.stack(zs[first:total], 1) if zs[first:total]
               else z0.new_zeros((C, 0, dim)))
    return samples, out
