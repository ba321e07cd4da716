"""MCMC runner (counterpart of ``gpax_tpu/infer/mcmc.py``):
``MCMC(NUTS(model), num_warmup, num_samples).run(key, *args)`` then
``get_samples()``, on the data's device; a model without tensor
arguments runs on the constructor's ``device`` (None: the CUDA card).

Several chains under ``chain_method="vectorized"`` run in lockstep
(``nuts.run_nuts_segmented_chains``, ``gpax_tpu/infer/mcmc.py:243-307``):
one batched potential per leapfrog for all chains where the model carries
a leading chain dim on its latents. A model that cannot (its batched
potential raises, or returns other values than its single chains at the
initial point) runs chain by chain inside the lockstep tree, C potentials
a leapfrog, and says so with one ``UserWarning``. "parallel" runs the same
lockstep program on the data's one device, as the JAX package does with
one device.
"sequential" runs the chains one after another (``nuts.run_nuts_segmented``),
and one chain runs that way whatever the ``chain_method``. Chain 0 starts
from the median init and the others from it jittered by U(−1, 1) in the
unconstrained space.

``segment_size`` runs the chains in segments. The options
``segment_callback``, ``deadline`` and ``warmup_depth_cap`` act on a
segmented run of one chain or of lockstep chains; as in the JAX package, a
non-segmented run ignores them with a ``UserWarning``, and so does a
segmented run of several sequential chains.
"""

from __future__ import annotations

import time
import warnings
from typing import Dict, Optional

import torch

from ..ppl import initialize_model, make_potential_fn, seed, substitute
from ..ppl import trace as ppl_trace
from ..utils.utils import resolve_device, spawn
from . import diagnostics
from .nuts import _SEGMENT_STATS, NUTS, ravel, run_nuts_segmented, run_nuts_segmented_chains


def _device_of(args, kwargs, device=None) -> torch.device:
    """The device of the first tensor among the model's arguments; for a
    model without tensor arguments, ``device`` (None: the CUDA card, see
    ``utils.resolve_device``)."""
    for a in (*args, *kwargs.values()):
        if torch.is_tensor(a):
            return a.device
    return resolve_device(device)


def _named(potential_fn, model, num_chains: int):
    """The batched potential, named after the model for the warning of a
    model that runs chain by chain."""
    name = getattr(model, "__qualname__", repr(model))
    potential_fn.__qualname__ = f"the model {name} (batched over {num_chains} chains)"
    return potential_fn


class MCMC:
    def __init__(self, kernel: NUTS, num_warmup: int = 2000, num_samples: int = 2000,
                 num_chains: int = 1, chain_method: str = "sequential",
                 progress_bar: bool = False, jit_model_args: bool = False,
                 segment_size: Optional[int] = None, device=None):
        if chain_method not in ("sequential", "vectorized", "parallel"):
            raise ValueError(f"unknown chain_method {chain_method!r}")
        self.kernel = kernel
        self.num_warmup = num_warmup
        self.num_samples = num_samples
        self.num_chains = num_chains
        self.chain_method = chain_method
        self.progress_bar = progress_bar  # prints segments on a segmented run
        self.segment_size = segment_size
        self.device = device  # of a run whose model takes no tensor argument
        self.segment_callback = None
        self.deadline = None
        self.warmup_depth_cap = None
        self.timing: Dict[str, float] = {}
        self.num_leapfrogs = 0  # warmup + sampling, each chain's own trees, last run
        self.num_lockstep_leapfrogs = 0  # calls of the (batched) potential, last run
        self.chain_by_chain = False  # lockstep chains whose potentials ran one by one
        self._samples_by_chain: Optional[Dict[str, torch.Tensor]] = None
        self._stats: Optional[Dict[str, torch.Tensor]] = None

    def run(self, rng_key, *model_args, extra_fields=(), init_params=None, **model_kwargs):
        single = self.num_chains == 1
        lockstep = not single and self.chain_method != "sequential"
        ignored = [n for n in ("segment_callback", "deadline", "warmup_depth_cap")
                   if getattr(self, n) is not None]
        if ignored and not self.segment_size:
            warnings.warn(
                f"{', '.join(ignored)} require segment_size (the segmented "
                "runner paths); ignored on this non-segmented run", stacklevel=2)
        elif ignored and self.num_chains > 1 and not lockstep:
            warnings.warn(
                "segment_callback/deadline/warmup_depth_cap are not threaded "
                "through chain_method='sequential'; ignored on this run of "
                f"{self.num_chains} chains", stacklevel=2)
        if isinstance(rng_key, int):
            rng_key = torch.Generator().manual_seed(rng_key)
        model = self.kernel.model
        device = _device_of(model_args, model_kwargs, self.device)

        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        self.timing = {}
        t0 = time.perf_counter()
        info = initialize_model(model, spawn(rng_key, device), model_args, model_kwargs,
                                init_strategy=self.kernel.init_strategy,
                                batch_shape=(self.num_chains,) if lockstep else ())
        base = init_params if init_params is not None else info.init_unconstrained
        sync()
        self.timing["initialize_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        run = dict(num_warmup=self.num_warmup, num_samples=self.num_samples,
                   segment_size=self.segment_size or max(self.num_warmup + self.num_samples, 1),
                   max_tree_depth=self.kernel.max_tree_depth,
                   target_accept_prob=self.kernel.target_accept_prob,
                   init_step_size=self.kernel.step_size, dense_mass=self.kernel.dense_mass,
                   progress=self.progress_bar and bool(self.segment_size))
        # the window options reach the runner of a segmented single chain or
        # of segmented lockstep chains only
        window = ({"segment_callback": self.segment_callback, "deadline": self.deadline,
                   "warmup_depth_cap": self.warmup_depth_cap}
                  if (single or lockstep) and self.segment_size else {})
        # the stats a run keeps, as in the JAX package: all on a segmented
        # run of one or lockstep chains, none of the segment ones without
        # segments, and all but the per-segment lists on sequential
        # segmented chains
        drop = (() if (single or lockstep) and self.segment_size
                else ("segment_wall_s", "segment_leapfrogs") if self.segment_size
                else _SEGMENT_STATS)
        flat, unravel = ravel(base)
        if lockstep:
            key = spawn(rng_key, device)
            jitter = 2.0 * torch.rand((self.num_chains,) + flat.shape, generator=key,
                                      dtype=flat.dtype, device=device) - 1.0
            jitter[0] = 0.0  # chain 0 keeps the median init
            single = make_potential_fn(model, info.transforms, model_args, model_kwargs)
            zs, st, _ = run_nuts_segmented_chains(
                single, unravel(flat + jitter), key, self.num_chains, **run, **window,
                batched_potential_fn=_named(info.potential_fn, model, self.num_chains))
            self.num_leapfrogs = int(st["segment_leapfrogs"].sum())
            self.num_lockstep_leapfrogs = int(st.pop("segment_lockstep_leapfrogs").sum())
            self.chain_by_chain = bool(st.pop("chain_by_chain"))
            # run-level stats get a leading dim of one, as one chain's do
            stats = {k: (v[None] if k in _SEGMENT_STATS else v).cpu()
                     for k, v in st.items() if k not in drop}
        else:
            zs, stats, leapfrogs = [], [], 0
            for c in range(self.num_chains):
                key = spawn(rng_key, device)
                fc = flat
                if c > 0:  # chain 0 keeps the median init; the others are jittered
                    fc = flat + 2.0 * torch.rand(flat.shape, generator=key, dtype=flat.dtype,
                                                 device=device) - 1.0
                z, st, _ = run_nuts_segmented(info.potential_fn, unravel(fc), key, **run,
                                              **window)
                leapfrogs += int(st["segment_leapfrogs"].sum())
                zs.append(z)
                stats.append({k: v.cpu() for k, v in st.items() if k not in drop})
            zs = torch.stack(zs)  # (chains, draws, dim)
            stats = {k: torch.stack([s[k] for s in stats]) for k in stats[0]}
            self.num_leapfrogs = self.num_lockstep_leapfrogs = leapfrogs
        sync()
        self.timing["sample_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        samples = info.constrain_fn(unravel(zs))
        if info.deterministic_sites:
            per_draw = []
            for z in zs.reshape(-1, zs.shape[-1]):
                tr = ppl_trace(substitute(seed(model, 0), data=info.constrain_fn(unravel(z)))
                               ).get_trace(*model_args, **model_kwargs)
                per_draw.append({n: tr[n]["value"] for n in info.deterministic_sites})
            for n in info.deterministic_sites:
                v = torch.stack([d[n] for d in per_draw])
                samples[n] = v.reshape(zs.shape[:2] + v.shape[1:])
        sync()
        self.timing["postprocess_s"] = time.perf_counter() - t0
        self._samples_by_chain = samples
        self._stats = stats
        return self

    def get_samples(self, group_by_chain: bool = False) -> Dict[str, torch.Tensor]:
        if self._samples_by_chain is None:
            raise RuntimeError("run() first")
        if group_by_chain:
            return self._samples_by_chain
        return {k: v.reshape((-1,) + v.shape[2:]) for k, v in self._samples_by_chain.items()}

    def get_extra_fields(self, group_by_chain: bool = False) -> Dict[str, torch.Tensor]:
        if self._stats is None:
            raise RuntimeError("run() first")
        if group_by_chain:
            return self._stats
        return {k: v.reshape((-1,) + v.shape[2:]) for k, v in self._stats.items()}

    def print_summary(self, prob: float = 0.9) -> None:
        diagnostics.print_summary(self.get_samples(group_by_chain=True), prob)
