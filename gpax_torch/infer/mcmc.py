"""MCMC runner (counterpart of ``gpax_tpu/infer/mcmc.py``):
``MCMC(NUTS(model), num_warmup, num_samples).run(key, *args)`` then
``get_samples()``. Chains run one after another on the data's device.

The JAX package's segmented runner, its deadline and warmup-depth-cap
options, and its vectorized and parallel chain methods belong to later
slices; asking for them raises ``NotImplementedError`` instead of being
silently ignored.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from ..ppl import initialize_model, seed, substitute
from ..ppl import trace as ppl_trace
from ..utils.utils import spawn
from . import diagnostics
from .nuts import NUTS, ravel, run_nuts


def _device_of(args, kwargs) -> torch.device:
    for a in (*args, *kwargs.values()):
        if torch.is_tensor(a):
            return a.device
    return torch.device("cpu")


class MCMC:
    def __init__(self, kernel: NUTS, num_warmup: int = 2000, num_samples: int = 2000,
                 num_chains: int = 1, chain_method: str = "sequential",
                 progress_bar: bool = False, jit_model_args: bool = False,
                 segment_size: Optional[int] = None):
        if segment_size is not None:
            raise NotImplementedError("segment_size: the segmented runner is not ported")
        if chain_method != "sequential":
            raise NotImplementedError(
                f"chain_method={chain_method!r}: only 'sequential' is ported")
        self.kernel = kernel
        self.num_warmup = num_warmup
        self.num_samples = num_samples
        self.num_chains = num_chains
        self.chain_method = chain_method
        self.progress_bar = progress_bar  # accepted for API parity
        self.segment_callback = None
        self.deadline = None
        self.warmup_depth_cap = None
        self.timing: Dict[str, float] = {}
        self.num_leapfrogs = 0  # warmup + sampling, all chains, last run
        self._samples_by_chain: Optional[Dict[str, torch.Tensor]] = None
        self._stats: Optional[Dict[str, torch.Tensor]] = None

    def run(self, rng_key, *model_args, extra_fields=(), init_params=None, **model_kwargs):
        for name in ("segment_callback", "deadline", "warmup_depth_cap"):
            if getattr(self, name) is not None:
                raise NotImplementedError(f"{name}: the segmented runner is not ported")
        if isinstance(rng_key, int):
            rng_key = torch.Generator().manual_seed(rng_key)
        model = self.kernel.model
        device = _device_of(model_args, model_kwargs)

        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        self.timing = {}
        t0 = time.perf_counter()
        info = initialize_model(model, spawn(rng_key, device), model_args, model_kwargs,
                                init_strategy=self.kernel.init_strategy)
        base = init_params if init_params is not None else info.init_unconstrained
        sync()
        self.timing["initialize_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        zs, stats, leapfrogs = [], [], 0
        for c in range(self.num_chains):
            key = spawn(rng_key, device)
            flat, unravel = ravel(base)
            if c > 0:  # chain 0 keeps the median init; the others are jittered
                flat = flat + 2.0 * torch.rand(flat.shape, generator=key, dtype=flat.dtype,
                                               device=device) - 1.0
            z, st, _ = run_nuts(
                info.potential_fn, unravel(flat), key,
                num_warmup=self.num_warmup, num_samples=self.num_samples,
                max_tree_depth=self.kernel.max_tree_depth,
                target_accept_prob=self.kernel.target_accept_prob,
                init_step_size=self.kernel.step_size, collect_warmup=True,
                dense_mass=self.kernel.dense_mass)
            leapfrogs += int(st["num_steps"].sum())
            zs.append(z[self.num_warmup:])
            stats.append({k: v[self.num_warmup:].cpu() for k, v in st.items()})
        zs = torch.stack(zs)  # (chains, draws, dim)
        sync()
        self.timing["sample_s"] = time.perf_counter() - t0
        self.num_leapfrogs = leapfrogs

        t0 = time.perf_counter()
        _, unravel = ravel(base)
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
        self._stats = {k: torch.stack([s[k] for s in stats]) for k in stats[0]}
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
