"""What a driver hands back, and the run's last line."""

from __future__ import annotations

import json
import math
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional

# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "gpax_tpu")


@dataclass
class Run:
    end_to_end: Dict[str, float]          # every end-to-end metric the driver measures
    counters: Dict[str, float]            # for the per-layer readers
    attempted: int
    failed: int
    checks: Dict[str, float]              # each number compared, by name
    memory_peak_bytes: int
    trace: Optional[object] = None        # trace.TraceData of the traced window
    control: Dict[str, float] = field(default_factory=dict)  # --control readings


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def judge(checks: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    """Each number compared beside its limit; a number with no limit, or
    one that is not finite, cannot pass."""
    return {k: {"value": v, "limit": limits.get(k)} for k, v in checks.items()}


def passed(judged: Dict[str, Dict]) -> bool:
    return all(j["limit"] is not None and math.isfinite(j["value"]) and j["value"] <= j["limit"]
               for j in judged.values())


def metrics_of(cell, run: Run, traced: bool) -> Dict[str, Dict]:
    """With ``traced``, the cell's per-layer metrics that found something to
    read; else its end-to-end metrics, each of which the driver measures."""
    if not traced:
        return {m["name"]: {"value": run.end_to_end[m["name"]], "unit": m["unit"]}
                for m in cell.end_to_end}
    from . import spec
    ctx = {"cfg": cell.config, "traffic": cell.traffic, "counters": run.counters,
           "trace": run.trace}
    out = {}
    for m in cell.per_layer:
        v = spec.metric_reader(m["name"], cell.root)(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def build_line(cell, run: Run, traced: bool, kind: str):
    """(the result line without its ``checks``, the numbers compared beside
    their limits)."""
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": run.memory_peak_bytes}
    extra = {}
    if traced and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        extra["breakdown"] = run.trace.breakdown()
    judged = judge(run.checks, cell.limits)
    ok = passed(judged) and run.failed == 0 and run.attempted > 0
    line = {"correct": ok, "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics_of(cell, run, traced), "device": device, **extra}
    return line, judged


def emit(line: Dict, judged: Dict[str, Dict]) -> None:
    """The numbers compared as the last lines on standard error, then the
    result as the last line on standard output, its ``checks`` key last."""
    for k, j in judged.items():
        print(f"check {k}: {j['value']!r} (limit {j['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    line["checks"] = judged
    print(json.dumps(line), flush=True)
