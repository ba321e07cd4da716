"""The port's spans (``gpax_torch.utils.monitor.span``): nothing recorded and
no profiler range opened while no profiler runs, and at what cost; under
``torch.profiler`` on the CPU, a tiny ExactGP NUTS fit's spans, their
nesting (the backward's WᵀW under the potential-and-gradient call), their
counts against the runner's calls and ``host_syncs``, and their names in
the profiler's table; an EI call as one root; self time and the time
outside given descendants on a synthetic nesting; ``profile``'s
``spans.json``; ``timed``'s synchronize."""

from __future__ import annotations

import json
import threading
import timeit

import numpy as np
import pytest
import torch

import gpax_torch
from gpax_torch import acquisition
from gpax_torch.utils import host_syncs, monitor, reset_host_syncs, samples_from_numpy

NAMES = ("gpax.nuts.transition", "gpax.potential_grad", "gpax.factor", "gpax.inverse",
         "gpax.wtw")


@pytest.fixture(autouse=True)
def _one_thread_and_an_empty_record():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monitor.clear_spans()
    yield
    monitor.clear_spans()
    torch.set_num_threads(n)


def _profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _fit():
    rng = np.random.default_rng(0)
    X = rng.uniform(-1, 1, 32).astype(np.float32)
    m = gpax_torch.ExactGP(1, "RBF")
    m.fit(gpax_torch.utils.get_keys()[0], X, np.sin(3 * X).astype(np.float32), num_warmup=3,
          num_samples=2, max_tree_depth=3, device="cpu", progress_bar=False,
          print_summary=False)
    return m


@pytest.fixture(scope="module")
def traced_fit():
    """(model, span records, summary, host_syncs delta, profiler table keys)
    of the tiny fit under the profiler."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monitor.clear_spans()
    reset_host_syncs()
    with _profiler() as prof:
        m = _fit()
    out = (m, monitor.span_records(), monitor.spans(), host_syncs(),
           {a.key for a in prof.key_averages()})
    monitor.clear_spans()
    torch.set_num_threads(n)
    return out


def _ancestors(rec, byid):
    """The records above ``rec``, innermost first."""
    out = []
    while rec["parent"] is not None:
        rec = byid[rec["parent"]]
        out.append(rec)
    return out


def _raise(*args, **kwargs):
    raise AssertionError("a span opened a profiler range with no profiler running")


def test_no_profiler_records_nothing_and_opens_no_range(monkeypatch):
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    _fit()
    with monitor.span("gpax.test", root=True):
        pass
    assert monitor.span_records() == [] and monitor.spans() == {}


def test_a_span_with_no_profiler_costs_under_half_a_microsecond():
    """The least time of many short loops, less an empty loop's: a short
    loop often runs whole between the other processes of a loaded host."""
    span = monitor.span

    def spans():
        for _ in range(500):
            with span("gpax.test"):
                pass

    def bare():
        for _ in range(500):
            pass

    best = min(timeit.repeat(spans, number=1, repeat=400))
    loop = min(timeit.repeat(bare, number=1, repeat=400))
    assert (best - loop) / 500 < 0.5e-6, (best - loop) / 500


def test_fit_nests_factor_and_inverse_under_the_call_under_the_transition(traced_fit):
    _, recs, _, _, _ = traced_fit
    byid = {r["id"]: r for r in recs}
    chains = {tuple(a["name"] for a in _ancestors(r, byid))
              for r in recs if r["name"] == "gpax.inverse"}
    assert ("gpax.factor", "gpax.potential_grad", "gpax.nuts.transition") in chains
    assert all(c[:2] == ("gpax.factor", "gpax.potential_grad") for c in chains)


def test_backward_wtw_is_under_the_potential_grad_call(traced_fit):
    _, recs, summary, _, _ = traced_fit
    byid = {r["id"]: r for r in recs}
    wtw = [r for r in recs if r["name"] == "gpax.wtw"]
    assert wtw and len(wtw) == summary["gpax.potential_grad"]["count"]
    assert all(byid[r["parent"]]["name"] == "gpax.potential_grad" for r in wtw)


def test_every_span_under_a_transition_carries_its_id(traced_fit):
    _, recs, _, _, _ = traced_fit
    byid = {r["id"]: r for r in recs}
    for r in recs:
        roots = [a for a in [r] + _ancestors(r, byid) if a["name"] == "gpax.nuts.transition"]
        if roots:
            assert r["root"] == roots[-1]["id"]
        if r["name"] == "gpax.nuts.transition":
            assert r["root"] == r["id"] and r["parent"] is None


def test_every_span_name_is_in_the_profiler_table(traced_fit):
    _, _, summary, _, keys = traced_fit
    assert set(NAMES) <= set(summary)
    assert set(summary) <= keys, set(summary) - keys


def test_one_potential_grad_span_a_call_of_the_runner(traced_fit):
    """The runner calls the potential and its gradient once a lockstep
    leapfrog, once at the initial point, and in the step-size search once
    at the initial point and once a round (each round's test is one
    ``step_size`` read)."""
    m, _, summary, _, _ = traced_fit
    rounds = summary["gpax.host_read.step_size"]["count"]
    assert summary["gpax.potential_grad"]["count"] == m.mcmc.num_lockstep_leapfrogs + 2 + rounds
    assert summary["gpax.nuts.transition"]["count"] == 5
    assert summary["gpax.factor"]["count"] == summary["gpax.potential_grad"]["count"]


def test_host_read_spans_count_every_host_sync(traced_fit):
    _, _, summary, syncs, _ = traced_fit
    reads = {k: v["count"] for k, v in summary.items() if k.startswith("gpax.host_read.")}
    assert sum(reads.values()) == syncs
    assert set(reads) >= {"gpax.host_read.nuts_subtree", "gpax.host_read.factor_info",
                          "gpax.host_read.nuts_segment", "gpax.host_read.step_size"}
    assert reads["gpax.host_read.nuts_segment"] == 1


def test_ei_with_injected_samples_is_one_root():
    rng = np.random.default_rng(1)
    X = rng.uniform(-1, 1, 8).astype(np.float32)
    m = gpax_torch.ExactGP(1, "RBF")
    m._set_training_data(X[:, None], np.sin(3 * X).astype(np.float32), device="cpu")
    m.mcmc = object()
    samples = samples_from_numpy({"k_length": rng.uniform(0.3, 1.0, (4, 1)).astype(np.float32),
                                  "k_scale": rng.uniform(0.5, 2.0, 4).astype(np.float32),
                                  "noise": rng.uniform(0.01, 0.1, 4).astype(np.float32)},
                                 device="cpu")
    with _profiler():
        acquisition.EI(gpax_torch.utils.get_keys()[0], m, np.linspace(-1, 1, 10,
                       dtype=np.float32), samples=samples)
    recs = monitor.span_records()
    roots = [r for r in recs if r["name"] == "gpax.acq.EI"]
    assert len(roots) == 1 and roots[0]["parent"] is None
    assert any(r["name"] == "gpax.factor" for r in recs)
    assert all(r["root"] == roots[0]["id"] for r in recs)


def test_self_time_and_time_outside_on_a_synthetic_nesting():
    with _profiler():
        with monitor.span("a", root=True):
            with monitor.span("b"):
                with monitor.span("x.1"):
                    pass
                with monitor.span("c"):
                    with monitor.span("x.2"):
                        pass
            with monitor.span("x.3"):
                pass
        with monitor.span("a", root=True):
            pass
    recs = monitor.span_records()
    d = {}
    for r in recs:
        d.setdefault(r["name"], []).append((r["end_ns"] - r["start_ns"]) * 1e-9)
    summary = monitor.spans()
    assert summary["a"]["count"] == 2
    assert summary["a"]["host_s"] == pytest.approx(sum(d["a"]), abs=1e-12)
    assert summary["a"]["self_s"] == pytest.approx(
        sum(d["a"]) - d["b"][0] - d["x.3"][0], abs=1e-12)
    assert summary["b"]["self_s"] == pytest.approx(d["b"][0] - d["x.1"][0] - d["c"][0],
                                                   abs=1e-12)
    assert summary["x.2"]["self_s"] == summary["x.2"]["host_s"]
    # x.2 lies under c, which is taken out whole: it is not taken out twice
    assert monitor.span_time("a", ("c", "x.")) == pytest.approx(
        sum(d["a"]) - d["x.1"][0] - d["c"][0] - d["x.3"][0], abs=1e-12)
    assert monitor.span_time("a") == pytest.approx(sum(d["a"]), abs=1e-12)
    byid = {r["id"]: r for r in recs}
    first = [r for r in recs if r["name"] == "a"]
    assert {r["root"] for r in recs if r["name"] != "a" or r is first[0]} == {first[0]["id"]}
    assert byid[next(r["parent"] for r in recs if r["name"] == "x.2")]["name"] == "c"


def test_a_span_on_the_backward_thread_nests_under_the_caller(monkeypatch):
    """The autograd engine's threads inherit the caller's profiler state; a
    plain thread does not, so this one is told that a profiler runs."""
    seen = {}

    def backward_thread():
        monkeypatch.setattr(monitor, "_in_backward", lambda: True)
        monkeypatch.setattr(monitor, "_tracing", lambda: True)
        with monitor.span("inner"):
            pass
        seen["ok"] = True

    with _profiler():
        with monitor.span("outer", root=True):
            t = threading.Thread(target=backward_thread)
            t.start()
            t.join()
    recs = {r["name"]: r for r in monitor.span_records()}
    assert seen["ok"]
    assert recs["inner"]["parent"] == recs["outer"]["id"]
    assert recs["inner"]["root"] == recs["outer"]["id"]


def test_profile_writes_spans_json_and_clears_the_record(tmp_path):
    with _profiler():
        with monitor.span("stale"):
            pass
    with monitor.profile(str(tmp_path)):
        with monitor.span("fresh", root=True):
            pass
    out = json.loads((tmp_path / "spans.json").read_text())
    assert set(out["summary"]) == {"fresh"} and out["summary"]["fresh"]["count"] == 1
    assert [r["name"] for r in out["records"]] == ["fresh"]
    assert (tmp_path / "trace.json").exists()


def test_timed_synchronizes_an_initialised_card(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append(a))
    with monitor.timed("work") as t:
        pass
    assert len(calls) == 2 and t.seconds >= 0.0
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    with monitor.timed("work") as t:
        pass
    assert len(calls) == 2 and t.seconds >= 0.0
