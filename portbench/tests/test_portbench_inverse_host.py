"""The reader of ``inverse_host_ms_per_leapfrog``: the host time of the span
``gpax.inverse`` over the calls of the potential and its gradient, on a
synthetic record as ``test_portbench_spans.py`` makes one, ``None`` without a
trace, a record or spans, and on a tiny traced fit on the CPU."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from gpax_torch.utils import monitor
from portbench.harness import spec

from .conftest import run_in_process, tiny_cell
from .test_portbench_spans import _record

NAME = "inverse_host_ms_per_leapfrog"

# two calls of 3 ms; the inverses, under the factor, 0.5 and 1.5 ms
ROWS = [
    ("gpax.nuts.transition", 1, None, 0.0, 10.0),
    ("gpax.potential_grad", 2, 1, 1.0, 4.0),
    ("gpax.factor", 3, 2, 1.0, 3.0),
    ("gpax.host_read.factor_info", 4, 3, 1.5, 2.0),
    ("gpax.inverse", 5, 3, 2.0, 2.5),
    ("gpax.potential_grad", 6, 1, 5.0, 8.0),
    ("gpax.factor", 7, 6, 5.0, 7.5),
    ("gpax.inverse", 8, 7, 6.0, 7.5),
]
TRACE = SimpleNamespace(op_device_s={"gpax.inverse": 2e-3})


def _read(trace=TRACE):
    ctx = {"cfg": {}, "traffic": {}, "trace": trace, "counters": {"profiled_leapfrogs": 2}}
    return spec.metric_reader(NAME)(ctx)


def test_reads_the_inverse_host_ms_over_the_calls(monkeypatch):
    _record(monkeypatch, ROWS)
    assert _read() == pytest.approx(1.0)  # (0.5 + 1.5) / 2


def test_none_without_a_trace_or_a_record(monkeypatch):
    _record(monkeypatch, ROWS)
    assert _read(trace=None) is None
    _record(monkeypatch, [r for r in ROWS if r[0] != "gpax.inverse"])
    assert _read() is None
    monkeypatch.setattr(monitor, "_record", [])
    assert _read(trace=SimpleNamespace(op_device_s={})) is None


def test_none_on_a_program_without_spans(monkeypatch):
    for attr in ("spans", "span_time"):
        monkeypatch.delattr(monitor, attr)
    assert _read() is None


def test_tiny_traced_fit_reads_the_inverse_within_the_model_step():
    monitor.clear_spans()
    line, _, run = run_in_process(tiny_cell("gp4096.fit"), traced=True, seconds=2.0)
    m = line["metrics"]
    assert 0 < m[NAME]["value"] < m["grad_host_ms_per_leapfrog"]["value"]
    assert monitor.spans()["gpax.inverse"]["count"] >= run.counters["profiled_leapfrogs"]
    monitor.clear_spans()
