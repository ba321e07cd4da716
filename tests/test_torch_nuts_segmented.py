"""The port's segmented NUTS runner against the single-chain cases of
tests/test_round5.py: the deadline freeze and its restored tree depth, the
callback stream, a far deadline, the warmup depth cap, draws bit-identical
to an unsegmented run from the same seed, and one chain under any
chain_method."""

import time

import numpy as np
import pytest
import torch

import gpax_torch
from gpax_torch.infer.nuts import run_nuts_segmented
from gpax_torch.ppl import initialize_model

torch.set_num_threads(1)

FIT = dict(print_summary=False, progress_bar=False, device="cpu")


def _toy(n=24):
    rng = np.random.default_rng(0)
    X = np.linspace(-1, 1, n).astype(np.float32)
    y = (np.sin(3 * X) + 0.05 * rng.normal(size=n)).astype(np.float32)
    return X, y


def _potential():
    X, y = _toy()
    gp = gpax_torch.ExactGP(1, "RBF")
    Xt, yt = gp._set_data(X, y, device="cpu")
    return initialize_model(gp.model, torch.Generator().manual_seed(0), (Xt, yt))


def test_freeze_restores_full_tree_depth():
    """With warmup_depth_cap=(1, 20) every capped transition runs ≤ 1
    leapfrog, so a post-freeze tree of more proves that the freeze restored
    the full depth on the steps it turned into draws."""
    info = _potential()
    zs, stats, _ = run_nuts_segmented(
        info.potential_fn, info.init_unconstrained, torch.Generator().manual_seed(0),
        num_warmup=20, num_samples=40, segment_size=10, max_tree_depth=6,
        warmup_depth_cap=(1, 20), deadline=time.perf_counter() - 1.0)
    assert int(stats["warmup_steps_run"]) == 10
    assert int(stats["num_steps"].max()) > 1, "the depth cap leaked into post-freeze draws"
    assert zs.shape == (10, 3) and bool(torch.isfinite(zs).all())


def test_past_deadline_freezes_and_streams():
    """A past deadline freezes warmup at the first boundary, keeps one
    post-freeze segment as draws and streams the telemetry of each segment."""
    X, y = _toy()
    calls = []
    gp = gpax_torch.ExactGP(1, "RBF")
    gp.fit(0, X, y, num_warmup=20, num_samples=40, segment_size=10,
           segment_callback=calls.append, deadline=time.perf_counter() - 1.0, **FIT)
    st = gp.mcmc.get_extra_fields()
    assert st["warmup_steps_run"].tolist() == [10]
    noise = gp.get_samples(chain_dim=True)["noise"]
    assert noise.shape == (1, 10) and bool(torch.isfinite(noise).all())
    assert [c["steps_done"] for c in calls] == [10, 20]
    assert calls[-1]["segments_done"] == 2 and calls[-1]["n_segments"] == 6
    assert calls[-1]["total_steps"] == 60
    assert len(calls[-1]["segment_leapfrogs"]) == len(calls[-1]["segment_wall_s"]) == 2
    assert calls[-1]["segment_leapfrogs"] == st["segment_leapfrogs"].tolist()
    assert sum(calls[-1]["segment_leapfrogs"]) == gp.mcmc.num_leapfrogs
    assert 0.0 <= float(st["accept_mean_all"]) <= 1.0
    mean, _ = gp.predict(1, np.linspace(-1, 1, 7), noiseless=True, device="cpu")
    assert bool(torch.isfinite(mean).all())


def test_far_deadline_full_plan():
    X, y = _toy()
    gp = gpax_torch.ExactGP(1, "RBF")
    gp.fit(0, X, y, num_warmup=20, num_samples=20, segment_size=10,
           deadline=time.perf_counter() + 3600.0, **FIT)
    st = gp.mcmc.get_extra_fields()
    assert st["warmup_steps_run"].tolist() == [20]
    assert gp.get_samples(chain_dim=True)["noise"].shape == (1, 20)
    assert st["segment_wall_s"].shape == (4,) and bool((st["segment_wall_s"] > 0).all())


@pytest.mark.parametrize("segment_size", [7, 40])
def test_segmented_draws_bit_identical(segment_size):
    """The segmented loop carries state, dual averaging and Welford sums
    across its boundaries: its draws equal the unsegmented fit's bit for bit."""
    X, y = _toy(12)
    runs = []
    for seg in (None, segment_size):
        gp = gpax_torch.ExactGP(1, "RBF")
        gp.fit(3, X, y, num_warmup=20, num_samples=20, segment_size=seg, **FIT)
        runs.append(gp)
    a, b = (r.get_samples() for r in runs)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    sa, sb = (r.mcmc.get_extra_fields() for r in runs)
    assert torch.equal(sa["num_steps"], sb["num_steps"])
    assert "segment_wall_s" not in sa and "segment_wall_s" in sb
    assert runs[0].mcmc.num_leapfrogs == runs[1].mcmc.num_leapfrogs == int(
        sb["segment_leapfrogs"].sum())


def test_warmup_depth_cap_bounds_the_head():
    """(cap, n_steps) = (2, 15): each of the first 15 warmup transitions
    builds at most 2 doublings, so at most 1 + 2 = 3 leapfrogs."""
    info = _potential()
    _, stats, _ = run_nuts_segmented(
        info.potential_fn, info.init_unconstrained, torch.Generator().manual_seed(0),
        num_warmup=30, num_samples=10, segment_size=10, max_tree_depth=6,
        warmup_depth_cap=(2, 15), collect_warmup=True)
    steps = stats["num_steps"]
    assert steps.shape == (40,)
    assert int(steps[:15].max()) <= 3
    assert int(stats["segment_leapfrogs"].sum()) == int(steps.sum())


@pytest.mark.parametrize("chain_method", ["vectorized", "parallel"])
def test_one_chain_runs_under_any_chain_method(chain_method):
    """One chain ignores chain_method, as in the JAX package
    (gpax_tpu/infer/mcmc.py:193-194): the same draws as 'sequential'."""
    X, y = _toy(12)
    runs = []
    for method in ("sequential", chain_method):
        gp = gpax_torch.ExactGP(1, "RBF")
        gp.fit(5, X, y, num_warmup=10, num_samples=10, chain_method=method, **FIT)
        runs.append(gp.get_samples())
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), k


def test_sequential_chains_warn_and_run_the_full_plan():
    """Sequential chains do not thread the window options: a past deadline
    warns (gpax_tpu/infer/mcmc.py:97-103) and each chain runs its whole
    plan, segmented, without the per-segment lists."""
    X, y = _toy(12)
    gp = gpax_torch.ExactGP(1, "RBF")
    with pytest.warns(UserWarning, match="not threaded"):
        gp.fit(0, X, y, num_warmup=10, num_samples=10, num_chains=2, segment_size=5,
               deadline=time.perf_counter() - 1.0, **FIT)
    st = gp.mcmc.get_extra_fields(group_by_chain=True)
    assert st["warmup_steps_run"].tolist() == [10, 10]
    assert not any(k.startswith("segment_") for k in st)
    assert gp.get_samples(chain_dim=True)["noise"].shape == (2, 10)
