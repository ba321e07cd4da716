"""The readers of the program's spans: each on a synthetic record and trace,
``None`` where there is no trace or no record; a tiny traced fit and score
on the CPU, whose host metrics add up to the host time of the transitions
and the segment ends; and, on the card, the device readers against the
kernels of the same trace. The card part is skipped without a CUDA card:

    python -m pytest portbench/tests/test_portbench_spans.py -m cuda
"""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from gpax_torch.utils import monitor
from portbench.harness import spec

from .conftest import run_in_process, tiny_cell

HOST = ("grad_host_ms_per_leapfrog", "tree_host_ms_per_leapfrog", "host_wait_ms_per_leapfrog")
FIT = HOST + ("factor_retry_share.fit", "wtw_ms_per_leapfrog", "inverse_ms_per_leapfrog")
SEED = 2147483659


def _record(monkeypatch, rows):
    """Put spans (name, id, parent id, start ms, end ms) in the record."""
    recs = []
    for name, i, parent, t0, t1 in rows:
        s = monitor._Span(name, parent is None)
        s.id, s.parent, s.root = i, parent, i if parent is None else recs[0].id
        s.t0, s.t1 = int(t0 * 1e6), int(t1 * 1e6)
        recs.append(s)
    monkeypatch.setattr(monitor, "_record", recs)


# one transition of 10 ms with two leapfrogs, and a segment end of 1 ms:
# each call 3 ms, of which 1 ms the factor's read and 0.5 ms the WᵀW; the
# tree's own reads 0.5 ms each; the second factor retried
ROWS = [
    ("gpax.nuts.transition", 1, None, 0.0, 10.0),
    ("gpax.potential_grad", 2, 1, 1.0, 4.0),
    ("gpax.factor", 3, 2, 1.0, 3.0),
    ("gpax.host_read.factor_info", 4, 3, 1.5, 2.5),
    ("gpax.wtw", 5, 2, 3.0, 3.5),
    ("gpax.host_read.nuts_subtree", 6, 1, 4.0, 4.5),
    ("gpax.potential_grad", 7, 1, 5.0, 8.0),
    ("gpax.factor", 8, 7, 5.0, 7.0),
    ("gpax.host_read.factor_info", 9, 8, 5.5, 6.5),
    ("gpax.factor.retry", 10, 8, 6.5, 7.0),
    ("gpax.host_read.nuts_subtree", 11, 1, 8.0, 8.5),
    ("gpax.host_read.nuts_segment", 12, None, 10.0, 11.0),
]
TRACE = SimpleNamespace(op_device_s={"gpax.wtw": 4e-3, "gpax.inverse": 2e-3,
                                     "gpax.factor": 0.9})


def _read(name, trace=TRACE, counters=None):
    ctx = {"cfg": {}, "traffic": {}, "trace": trace,
           "counters": {"profiled_leapfrogs": 2} if counters is None else counters}
    return spec.metric_reader(name)(ctx)


@pytest.mark.parametrize("name,want", [
    ("grad_host_ms_per_leapfrog", 2.0),      # (3 − 1 + 3 − 1) / 2
    ("tree_host_ms_per_leapfrog", 1.5),      # (10 − 6 − 1) / 2
    ("host_wait_ms_per_leapfrog", 2.0),      # (1 + 0.5 + 1 + 0.5 + 1) / 2
    ("factor_retry_share.fit", 50.0),
    ("wtw_ms_per_leapfrog", 2.0),
    ("inverse_ms_per_leapfrog", 1.0),
])
def test_fit_reader_on_a_synthetic_record(monkeypatch, name, want):
    _record(monkeypatch, ROWS)
    assert _read(name) == pytest.approx(want)


def test_host_metrics_add_up_to_the_transitions_and_segment_ends(monkeypatch):
    _record(monkeypatch, ROWS)
    total = sum(_read(n) for n in HOST) * 2
    assert total == pytest.approx(10.0 + 1.0)


def test_factor_ms_per_request_counts_the_acquisition_roots(monkeypatch):
    _record(monkeypatch, [("gpax.acq.EI", 1, None, 0.0, 5.0), ("gpax.factor", 2, 1, 1.0, 2.0),
                          ("gpax.acq.EI", 3, None, 6.0, 9.0)])
    assert _read("factor_ms_per_request") == pytest.approx(450.0)


@pytest.mark.parametrize("name", FIT + ("factor_ms_per_request",))
def test_none_without_a_trace_or_a_record(monkeypatch, name):
    _record(monkeypatch, ROWS)
    assert _read(name, trace=None) is None
    monkeypatch.setattr(monitor, "_record", [])
    assert _read(name, trace=SimpleNamespace(op_device_s={})) is None


@pytest.mark.parametrize("name", FIT + ("factor_ms_per_request",))
def test_none_on_a_program_without_spans(monkeypatch, name):
    """A program that records no span, as before spans were added: the reader
    returns None and does not raise."""
    for attr in ("spans", "span_time"):
        monkeypatch.delattr(monitor, attr)
    assert _read(name, trace=SimpleNamespace(op_device_s={})) is None


def test_tiny_traced_fit_reads_the_host_metrics():
    monitor.clear_spans()
    line, _, run = run_in_process(tiny_cell("gp4096.fit"), traced=True, seconds=2.0)
    m, c = line["metrics"], run.counters
    assert set(HOST) | {"factor_retry_share.fit"} <= set(m)
    summary = monitor.spans()
    assert summary["gpax.potential_grad"]["count"] == c["profiled_leapfrogs"]
    covered = (summary["gpax.nuts.transition"]["host_s"]
               + summary["gpax.host_read.nuts_segment"]["host_s"])
    total = sum(m[n]["value"] for n in HOST) * c["profiled_leapfrogs"] * 1e-3
    assert total == pytest.approx(covered, rel=0.02)
    monitor.clear_spans()


def test_tiny_traced_score_counts_its_profiled_requests():
    monitor.clear_spans()
    cell = tiny_cell("gp4096.score")
    run_in_process(cell, traced=True, seconds=1.0)
    summary = monitor.spans()
    assert summary["gpax.acq.EI"]["count"] == cell.traffic["trace_requests"]
    assert summary["gpax.factor"]["count"] >= cell.traffic["trace_requests"]
    monitor.clear_spans()


@pytest.mark.cuda
def test_device_readers_against_the_kernels_of_the_same_trace():
    """At the cell's size on the card: ``gpax.wtw``'s reading within 10 % of
    its one float64 GEMM's kernel time (the fit's only ``nt`` float64 GEMM,
    one launch a span), and the WᵀW, the inverse and the factor together
    within the busy time."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the device readers read the card's trace")
    monitor.clear_spans()
    line, _, run = run_in_process(spec.load_cell("gp4096.fit"), seed=SEED, seconds=12.0,
                                  traced=True, device="cuda")
    m, c, t = line["metrics"], run.counters, run.trace
    gemm_s, launches = t.kernel_s(r"gemm_f64.*_nt_")
    assert launches == monitor.spans()["gpax.wtw"]["count"]
    wtw = m["wtw_ms_per_leapfrog"]["value"]
    assert wtw == pytest.approx(1e3 * gemm_s / c["profiled_leapfrogs"], rel=0.10)
    busy_ms = 1e3 * t.busy_s / c["profiled_leapfrogs"]
    assert wtw + m["inverse_ms_per_leapfrog"]["value"] < busy_ms
    assert (wtw + m["inverse_ms_per_leapfrog"]["value"]
            + m["factor_ms_per_leapfrog"]["value"]) <= busy_ms
    monitor.clear_spans()
