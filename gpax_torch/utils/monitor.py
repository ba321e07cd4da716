"""Observability: phase timing, fit metrics, NaN debugging and profiler
hooks (counterpart of ``gpax_tpu/utils/monitor.py``):

* ``profile(logdir)``: a ``torch.profiler`` trace of the block (host, and
  the CUDA card where there is one), written to ``logdir/trace.json``;
* ``timed(label)``: wall-clock phase timing;
* ``fit_report(mcmc)``: wall clock aside, the accept rate, divergences,
  leapfrogs a step, the final step size and each site's R-hat and ESS;
* ``debug_nans(enable)``: autograd anomaly detection, which names the
  operation whose backward produced a NaN.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import numpy as np
import torch


@contextlib.contextmanager
def profile(logdir: str):
    """Trace the block with ``torch.profiler`` (CPU activity, and CUDA where
    a card is present) and write it to ``logdir/trace.json`` (Chrome trace
    format: Perfetto or chrome://tracing). Yields the profiler, whose
    ``key_averages()`` tabulates the time by operation."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class timed(contextlib.ContextDecorator):
    """Wall-clock timer: ``with timed('fit') as t: ...; t.seconds``."""

    def __init__(self, label: str = "", verbose: bool = False):
        self.label = label
        self.verbose = verbose
        self.seconds: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        if self.verbose:
            print(f"[{self.label}] {self.seconds:.3f}s")
        return False


def debug_nans(enable: bool = True) -> None:
    """Turn autograd's anomaly detection on or off (the counterpart of
    ``jax_debug_nans``): a backward that produces NaN raises, naming the
    forward operation. It slows every backward."""
    torch.autograd.set_detect_anomaly(enable)


def fit_report(mcmc) -> Dict[str, object]:
    """Post-fit diagnostics of a fitted ``infer.MCMC``, from its extra fields
    and its draws grouped by chain."""
    from ..infer import diagnostics

    def host(v) -> np.ndarray:
        return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)

    stats = mcmc.get_extra_fields()
    samples = mcmc.get_samples(group_by_chain=True)
    first = next(iter(samples.values()))
    report: Dict[str, object] = {
        "num_chains": int(first.shape[0]),
        "num_samples": int(first.shape[1]),
        "mean_accept_prob": float(np.mean(host(stats["accept_prob"]))),
        "num_divergences": int(np.sum(host(stats["diverging"]))),
        "mean_leapfrogs_per_step": float(np.mean(host(stats["num_steps"]))),
        "final_step_size": float(host(stats["step_size"]).reshape(-1)[-1]),
    }
    rhat = {}
    ess = {}
    for name, arr in samples.items():
        a = host(arr)
        if a.ndim < 2 or not np.issubdtype(a.dtype, np.floating):
            continue
        rhat[name] = float(np.nanmax(np.atleast_1d(diagnostics.gelman_rubin(a))))
        ess[name] = float(np.nanmin(np.atleast_1d(diagnostics.effective_sample_size(a))))
    report["max_rhat"] = rhat
    report["min_ess"] = ess
    return report
