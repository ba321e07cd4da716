"""One fully Bayesian fit: NUTS for the whole window.

Set-up makes the data from the seed and warms the fit's own shapes with a
short fit on the same data. The window is one ``model.fit`` with the
configuration's warmup, more draws than the window holds, in segments, and
a deadline at the window's end: the fit stops at the first segment boundary
past it. ``leapfrogs_per_s`` is every leapfrog step the fit ran, warmup's
and sampling's, over the fit call's whole wall time, which ends at a
synchronize. (Draws a second would be the user's unit, but NUTS's tree
sizes are chaotic: runs of one seed and key differ by a fifth in the
transitions a window holds, so the fit's rate is counted in its unit of
work, and the check holds the sampling draws' mean tree size.) A traced run
profiles the segments of the window's last ``trace_seconds``. With
``control``, the check also reads the family's control at the fit's draws.
"""

from __future__ import annotations

import time

import torch

from gpax_torch.utils import host_syncs, reset_host_syncs

from ..harness import spec, trace
from ..harness.result import Run


def _fit(model, key, data, traffic, device, num_warmup, num_samples, depth, deadline=None,
         callback=None):
    model.fit(key, *data, num_warmup=num_warmup, num_samples=num_samples,
              max_tree_depth=depth, segment_size=traffic["segment_size"], deadline=deadline,
              segment_callback=callback, progress_bar=False, print_summary=False,
              device=device)


def run(cell, seed: int, seconds: float, traced: bool, device: str, t_start: float,
        control: bool = False) -> Run:
    cfg, tr = cell.config, cell.traffic
    fam = spec.module("families", cfg["family"])
    data = fam.fit_data(cfg, seed)
    model = fam.build(cfg)
    warm = tr["warmup_fit"]
    _fit(model, torch.Generator().manual_seed(seed + 1), data, tr, device, warm["num_warmup"],
         warm["num_samples"], warm["max_tree_depth"])
    if device == "cuda":
        torch.cuda.synchronize()
    if traced:
        trace.Window.warm()
    window = trace.Window()
    segs = {"profiled_from": None, "wall": [], "leapfrogs": []}

    def on_segment(info):
        segs["wall"], segs["leapfrogs"] = info["segment_wall_s"], info["segment_leapfrogs"]
        if traced and not window.started and time.perf_counter() >= deadline - tr["trace_seconds"]:
            segs["profiled_from"] = info["segments_done"]
            window.start()

    reset_host_syncs()
    t_open = time.perf_counter()
    deadline = t_open + seconds
    _fit(model, torch.Generator().manual_seed(seed), data, tr, device, cfg["num_warmup"],
         tr["num_samples"], cfg["max_tree_depth"], deadline, on_segment)
    if device == "cuda":
        torch.cuda.synchronize()
    t_close = time.perf_counter()
    window.stop()
    syncs = host_syncs()
    fit_s = t_close - t_open
    stats = model.mcmc.get_extra_fields()
    transitions = int(stats["warmup_steps_run"].sum()) + int(stats["num_steps"].numel())
    leapfrogs = int(model.mcmc.num_leapfrogs)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    out = fam.fit_outputs(model, tr, seed, control)
    del model, stats
    if device == "cuda":
        torch.cuda.empty_cache()
    checks, readings = fam.check_fit(cfg, tr, data, out, seed, device, control)

    k = segs["profiled_from"] if segs["profiled_from"] is not None else len(segs["wall"])
    counters = {"transitions": transitions, "leapfrogs": leapfrogs, "host_syncs": syncs,
                "fit_s": fit_s, "draws": len(out["num_steps"]),
                "draw_leapfrogs": int(out["num_steps"].sum()),
                # the segments the profiler did not slow
                "clean_wall_s": float(sum(segs["wall"][:k])),
                "clean_leapfrogs": int(sum(segs["leapfrogs"][:k])),
                "profiled_leapfrogs": int(sum(segs["leapfrogs"][k:]))}
    failed = int((~torch.isfinite(torch.as_tensor(out["potential_energy"]))).sum())
    return Run(end_to_end={"setup_s": t_open - t_start, "leapfrogs_per_s": leapfrogs / fit_s},
               counters=counters, attempted=transitions, failed=failed, checks=checks,
               memory_peak_bytes=peak, trace=window.data, control=readings)
