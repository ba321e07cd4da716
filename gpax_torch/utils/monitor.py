"""Observability: phase timing, fit metrics, NaN debugging, profiler
hooks and the program's spans (counterpart of ``gpax_tpu/utils/monitor.py``):

* ``profile(logdir)``: a ``torch.profiler`` trace of the block (host, and
  the CUDA card where there is one), written to ``logdir/trace.json``, and
  the spans the block recorded, to ``logdir/spans.json``;
* ``span(name)``: a named region of the program, recorded only while a
  profiler runs; ``spans()``, ``span_time()``, ``span_records()`` and
  ``clear_spans()`` read and empty the record;
* ``timed(label)``: wall-clock phase timing of the work, synchronized;
* ``fit_report(mcmc)``: wall clock aside, the accept rate, divergences,
  leapfrogs a step, the final step size and each site's R-hat and ESS;
* ``debug_nans(enable)``: autograd anomaly detection, which names the
  operation whose backward produced a NaN.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


# -- spans ------------------------------------------------------------------
#
# A span is on while a torch profiler session runs (``profile`` below, or any
# ``torch.profiler.profile``): it then opens a profiler range of its name, so
# it sits on the profiler's host timeline beside the operations and kernels it
# launched, and it appends a record of its name, id, parent's id, root's id
# and host start and end (``time.perf_counter_ns``) to the list read by
# ``spans()``. With no profiler a span is one check and a shared no-op.
#
# The range is the profiler's fast one (``_RecordFunctionFast``), recorded as
# an operation: its entry in ``key_averages()`` carries the device time of
# every kernel launched under it, each once (on an H100, one float64 GEMM's
# time for ``gpax.wtw``). ``record_function`` would open a user annotation,
# which the CUDA profiler mirrors on the device timeline under the same name;
# the mirror's time runs from the first to the last kernel launched under the
# innermost annotation, idle time included and children's kernels left out,
# and a table keyed by name keeps whichever entry comes last. The fast range
# also costs ~2 µs where ``record_function`` costs ~14 (on a CPU). Its
# keyword ``root`` carries the root id into traces that record inputs.

_tracing = torch._C._autograd._profiler_enabled


class _Off:
    """The span of a run with no profiler, with C-level no-ops: ``with``
    looks both methods up on the type and calls them without ``self``
    (builtins and types do not bind), and the empty string that ``format``
    returns is false, so an exception in the block propagates."""
    __slots__ = ()
    __enter__ = tuple
    __exit__ = "".format


_OFF = _Off()
_record: List["_Span"] = []            # closed spans, in the order they closed
_new_id = itertools.count(1).__next__
_local = threading.local()             # each thread's stack of open spans
_caller: List[Optional[list]] = [None]  # the stack of the thread that last opened one


def _in_backward() -> bool:
    """Whether this thread is running a node of an autograd backward."""
    return torch._C._current_autograd_node() is not None


class _Span:
    __slots__ = ("name", "id", "parent", "root", "t0", "t1", "_is_root", "_rf", "_stack")

    def __init__(self, name: str, root: bool):
        self.name, self._is_root = name, root

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        backward = _in_backward()
        if stack:
            parent = stack[-1]
        elif backward:
            # the autograd engine's thread: the thread that called the
            # backward blocks in it, inside its innermost open span
            caller = _caller[0]
            parent = caller[-1] if caller else None
        else:
            parent = None
        if not backward:
            _caller[0] = stack
        self.id = _new_id()
        self.parent = None if parent is None else parent.id
        self.root = self.id if self._is_root or parent is None else parent.root
        self._stack = stack
        self.t0 = time.perf_counter_ns()
        self._rf = torch._C._profiler._RecordFunctionFast(self.name, (), {"root": self.root})
        self._rf.__enter__()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        self._stack.pop()
        self._rf.__exit__(*exc)
        self.t1 = time.perf_counter_ns()
        self._rf = self._stack = None
        _record.append(self)
        return False


def span(name: str, root: bool = False):
    """``with span(name): ...`` records the block while a profiler runs.

    A span opened inside another on its thread is that span's child; one
    opened on the autograd engine's thread during a backward is the child of
    the innermost span open on the thread that called the backward. A
    ``root`` span (an NUTS transition, an acquisition call) starts a fresh
    root id, which every span under it carries, as does the profiler range's
    keyword ``root``. What the ``with`` binds is not part of the API."""
    if not _tracing():
        return _OFF
    return _Span(name, root)


def spanned(name: str, root: bool = False):
    """Decorator: run the function inside ``span(name, root)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name, root):
                return fn(*args, **kwargs)
        return inner
    return wrap


def _dur_s(r: "_Span") -> float:
    return (r.t1 - r.t0) * 1e-9


def span_records() -> List[Dict[str, object]]:
    """The record: each closed span's name, id, parent id (None at the top),
    root id, and host start and end in ``time.perf_counter_ns``."""
    return [{"name": r.name, "id": r.id, "parent": r.parent, "root": r.root,
             "start_ns": r.t0, "end_ns": r.t1} for r in list(_record)]


def spans() -> Dict[str, Dict[str, float]]:
    """Each recorded name's ``count``, host seconds (``host_s``) and host
    self seconds (``self_s``: its spans' time less what their child spans
    cover)."""
    recs = list(_record)
    children_s: Dict[int, float] = defaultdict(float)
    for r in recs:
        if r.parent is not None:
            children_s[r.parent] += _dur_s(r)
    out: Dict[str, Dict[str, float]] = {}
    for r in recs:
        d = out.setdefault(r.name, {"count": 0, "host_s": 0.0, "self_s": 0.0})
        d["count"] += 1
        d["host_s"] += _dur_s(r)
        d["self_s"] += _dur_s(r) - children_s[r.id]
    return out


def span_time(name: str, outside: Sequence[str] = ()) -> float:
    """Host seconds in the spans named ``name``, less the time covered by
    their descendants whose names start with one of the prefixes
    ``outside`` (each such descendant once, with what lies under it)."""
    recs = list(_record)
    children: Dict[int, list] = defaultdict(list)
    for r in recs:
        if r.parent is not None:
            children[r.parent].append(r)
    prefixes = tuple(outside)
    total = 0.0
    for r in recs:
        if r.name != name:
            continue
        total += _dur_s(r)
        todo = list(children[r.id])
        while todo:
            c = todo.pop()
            if prefixes and c.name.startswith(prefixes):
                total -= _dur_s(c)
            else:
                todo.extend(children[c.id])
    return total


def clear_spans() -> None:
    """Empty the record."""
    _record.clear()


@contextlib.contextmanager
def profile(logdir: str):
    """Trace the block with ``torch.profiler`` (CPU activity, and CUDA where
    a card is present) and write it to ``logdir/trace.json`` (Chrome trace
    format: Perfetto or chrome://tracing), and the spans the block recorded
    to ``logdir/spans.json`` (``{"summary": spans(), "records":
    span_records()}``; the record is emptied on entry). Yields the profiler,
    whose ``key_averages()`` tabulates the time by operation and by span."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    clear_spans()
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
        with open(os.path.join(logdir, "spans.json"), "w") as f:
            json.dump({"summary": spans(), "records": span_records()}, f)


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class timed(contextlib.ContextDecorator):
    """Wall-clock timer of the block's work: ``with timed('fit') as t: ...;
    t.seconds``. Where a CUDA card is initialised it synchronizes on entry
    and on exit, so ``seconds`` is the time the work took on the card, not
    the time its launches took."""

    def __init__(self, label: str = "", verbose: bool = False):
        self.label = label
        self.verbose = verbose
        self.seconds: Optional[float] = None

    def __enter__(self):
        _sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
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
