"""Scoring requests in a closed loop from one client.

Set-up builds the family's ``Scorer`` (its model and posterior state, made
from the seed) and warms it with one request. In the window the client
sends a request, waits for its scores to be ready on the device, and sends
the next, each request's candidates drawn on the device from the seed and
its index, until ``--seconds`` have passed. ``score_points_per_s`` is the
candidates scored over the window, which ends with the last request. A
traced run profiles requests ``trace_from`` to ``trace_from +
trace_requests``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gpax_torch.utils import host_syncs, reset_host_syncs

from ..harness import spec, trace
from ..harness.result import Run


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def run(cell, seed: int, seconds: float, traced: bool, device: str, t_start: float,
        control: bool = False) -> Run:
    cfg, tr = cell.config, cell.traffic
    scorer = spec.module("families", cfg["family"]).Scorer(cfg, tr, seed, device)
    scorer.score(scorer.inputs(-1))
    _sync(device)

    rng = np.random.default_rng([seed, 5])
    sampled = set(rng.choice(tr["check_upto"], size=tr["check_requests"], replace=False).tolist())
    kept, last = {}, None
    if traced:
        trace.Window.warm()
    window = trace.Window()
    lat, points = [], 0
    bad = torch.zeros((), dtype=torch.int64, device=device)
    reset_host_syncs()
    t_open = time.perf_counter()
    i = 0
    while i == 0 or time.perf_counter() < t_open + seconds:
        if traced and i == tr["trace_from"]:
            window.start()
        Xn = scorer.inputs(i)
        t0 = time.perf_counter()
        out = scorer.score(Xn)
        _sync(device)
        lat.append(time.perf_counter() - t0)
        if traced and i == tr["trace_from"] + tr["trace_requests"] - 1:
            window.stop()
        points += Xn.shape[0]
        bad += (~torch.isfinite(out)).any()
        if i in sampled:
            kept[i] = out
        last = (i, out)
        i += 1
    t_close = time.perf_counter()
    window.stop()
    syncs = host_syncs()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    kept[last[0]] = last[1]
    requests = sorted(kept.items())
    failed = int(bad)
    scorer.release()
    if device == "cuda":
        torch.cuda.empty_cache()
    checks, readings = scorer.check(requests, control)
    wall = t_close - t_open
    lo, hi = (tr["trace_from"], tr["trace_from"] + tr["trace_requests"]) if traced else (0, 0)
    clean = [t for k, t in enumerate(lat) if not lo <= k < hi]
    counters = {"requests": i, "points": points, "host_syncs": syncs, "wall_s": wall,
                # the requests the profiler did not slow, and their latencies
                "clean_requests": len(clean), "clean_s": float(sum(clean))}
    return Run(end_to_end={"setup_s": t_open - t_start, "score_points_per_s": points / wall},
               counters=counters, attempted=i, failed=failed, checks=checks,
               memory_peak_bytes=peak, trace=window.data, control=readings)
