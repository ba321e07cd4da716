"""The port's lockstep multi-chain NUTS (``run_nuts_segmented_chains``,
MCMC's "vectorized" and "parallel" chain methods): the batched hmc_util
pieces against per-chain calls, the batched potential and fused likelihood
against C single ones, a stopped chain's frozen state, segmented against
unsegmented draws, and the JAX package's multi-chain cases
(tests/test_nuts.py:78, :93, :195, :244 and tests/test_round5.py:28-90)."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpax_torch
import gpax_torch.distributions as tdist
import gpax_tpu
from _torch_parity import assert_close
from gpax_torch import ppl as tppl
from gpax_torch.infer import MCMC, NUTS, gelman_rubin
from gpax_torch.infer import hmc_util as th
from gpax_torch.infer.nuts import (NUTSState, _build_subtree, nuts_step, ravel,
                                   run_nuts_segmented_chains)
from gpax_torch.ops.fused_density import gp_mvn_log_prob
from gpax_torch.ppl import initialize_model

torch.set_num_threads(1)

FIT = dict(print_summary=False, progress_bar=False, device="cpu")
C, DIM = 3, 4


def _inv_mass(dense, seed=0):
    rng = np.random.default_rng(seed)
    if dense:
        A = rng.normal(size=(C, DIM, DIM))
        return torch.tensor(A @ A.transpose(0, 2, 1) / DIM + 0.5 * np.eye(DIM), dtype=torch.float32)
    return torch.tensor(rng.uniform(0.5, 2.0, (C, DIM)), dtype=torch.float32)


def _quartic_pg(z):
    """Potential 0.25Σz⁴ + ½Σz² + z₀z₁ of each row and its gradient."""
    u = 0.25 * (z**4).sum(-1) + 0.5 * (z * z).sum(-1) + z[..., 0] * z[..., 1]
    g = z**3 + z
    g = g + torch.stack([z[..., 1], z[..., 0]] + [torch.zeros_like(z[..., 0])] * (DIM - 2), -1)
    return u, g


@pytest.mark.parametrize("dense", [False, True])
def test_batched_hmc_util_equals_per_chain(dense):
    """mass_velocity, kinetic_energy, leapfrog, sample_momentum, Welford and
    dual averaging on (C, …) state equal C single-chain calls: exactly with
    a diagonal mass; with a dense one to 2 ulp of float32 (rtol 2.4e-7),
    since a batched product and a single-chain one accumulate their sums in
    different orders."""

    def same(a, b):
        if dense:
            assert_close(a, b, rtol=2.4e-7, atol=1e-7)
        else:
            assert torch.equal(a, b)

    rng = np.random.default_rng(1)
    m = _inv_mass(dense)
    z = torch.tensor(rng.normal(size=(C, DIM)), dtype=torch.float32)
    r = torch.tensor(rng.normal(size=(C, DIM)), dtype=torch.float32)
    rows = torch.tensor(rng.normal(size=(C, 5, DIM)), dtype=torch.float32)
    eps = torch.tensor([0.05, 0.1, 0.2])
    v = th.mass_velocity(m, r, dense)
    vr = th.mass_velocity(m, rows, dense)
    ke = th.kinetic_energy(r, m, dense)
    _, g = _quartic_pg(z)
    zb, rb, ub, gb = th.leapfrog(_quartic_pg, z, r, eps[:, None], m, g, dense)
    for c in range(C):
        same(v[c], th.mass_velocity(m[c], r[c]))
        same(vr[c], th.mass_velocity(m[c], rows[c]))
        same(ke[c], th.kinetic_energy(r[c], m[c]))
        zc, rc, uc, gc = th.leapfrog(_quartic_pg, z[c], r[c], eps[c], m[c], g[c])
        for a, b in ((zb[c], zc), (rb[c], rc), (ub[c], uc), (gb[c], gc)):
            same(a, b)
    # momentum: the batch's C rows of standard normal draws, each mapped by
    # its chain's mass matrix as a single-chain draw is
    xi = torch.randn((C, DIM), generator=torch.Generator().manual_seed(3))
    rb = th.sample_momentum(torch.Generator().manual_seed(3), m, dense)
    for c in range(C):
        if dense:
            L = torch.linalg.cholesky(m[c])
            want = torch.linalg.solve_triangular(L.mT, xi[c][:, None], upper=True)[:, 0]
        else:
            want = xi[c] / torch.sqrt(m[c])
        same(rb[c], want)
    xs = torch.tensor(rng.normal(size=(30, C, DIM)), dtype=torch.float32)
    wb = th.welford_init(DIM, dense=dense, batch_shape=(C,))
    ws = [th.welford_init(DIM, dense=dense) for _ in range(C)]
    for x in xs:
        wb = th.welford_update(wb, x)
        ws = [th.welford_update(w, x[c]) for c, w in enumerate(ws)]
    for reg in (False, True):
        vb = th.welford_variance(wb, reg)
        for c in range(C):
            same(vb[c], th.welford_variance(ws[c], reg))
    accepts = torch.tensor(rng.uniform(0.3, 1.0, (20, C)), dtype=torch.float32)
    db = th.da_init(eps)
    ds = [th.da_init(e) for e in eps]
    for a in accepts:
        db = th.da_update(db, a)
        ds = [th.da_update(d, a[c]) for c, d in enumerate(ds)]
    for c in range(C):
        for x, y in zip(db, ds[c]):
            assert torch.equal(x[c], y)


def test_find_reasonable_step_size_per_chain():
    """Each chain doubles or halves on its own: with the momentum draws of
    the batch, chain c ends where a single-chain search from the same draw
    ends; the chains' steps differ by their scales."""
    scales = torch.tensor([0.3, 1.0, 30.0])

    def pg(z):
        return 0.5 * (scales[:, None] * z * z).sum(-1), scales[:, None] * z

    z0 = torch.ones((C, 2))
    m = torch.ones((C, 2))
    eps = th.find_reasonable_step_size(pg, z0, m, torch.Generator().manual_seed(0),
                                       dense=False)
    for c in range(C):
        def pg1(z, c=c):
            return 0.5 * (scales[c] * z * z).sum(), scales[c] * z

        # a generator whose next momentum draw is the batch's row c: skip
        # the c rows before it
        g = torch.Generator().manual_seed(0)
        torch.randn((c, 2), generator=g)
        e1 = th.find_reasonable_step_size(pg1, z0[c], m[c], g)
        assert float(e1) == float(eps[c])
    assert float(eps[2]) < float(eps[0])
    k = torch.log2(eps)
    assert bool((k == torch.round(k)).all())


def _gp_data(n=20, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n, 1)).astype(np.float32)
    y = (np.sin(2 * X[:, 0]) + 0.1 * rng.normal(size=n)).astype(np.float32)
    return torch.as_tensor(X), torch.as_tensor(y)


@pytest.mark.parametrize("route", ["never", "always"])
def test_batched_potential_equals_single_potentials(route):
    """ExactGP's potential batched over C chains, and the gradient of its
    sum, against C single potentials on each likelihood route (float32
    tolerance: the batch reorders no sum, but the transforms' log-det is
    summed over a batch)."""
    X, y = _gp_data()
    gp = gpax_torch.ExactGP(1, "RBF")
    rng = np.random.default_rng(2)
    z = {"k_length": torch.tensor(rng.normal(0, 0.3, (C, 1)), dtype=torch.float32),
         "k_scale": torch.tensor(rng.normal(0, 0.3, C), dtype=torch.float32),
         "noise": torch.tensor(rng.normal(-2, 0.3, C), dtype=torch.float32)}
    gpax_torch.set_config(use_fused_likelihood=route)
    try:
        gen = torch.Generator().manual_seed(0)
        batched = initialize_model(gp.model, gen, (X, y), batch_shape=(C,)).potential_fn
        single = initialize_model(gp.model, gen, (X, y)).potential_fn
        zb = {k: v.clone().requires_grad_(True) for k, v in z.items()}
        ub = batched(zb)
        assert ub.shape == (C,)
        gb = torch.autograd.grad(ub.sum(), list(zb.values()))
        for c in range(C):
            zc = {k: v[c].clone().requires_grad_(True) for k, v in z.items()}
            uc = single(zc)
            gc = torch.autograd.grad(uc, list(zc.values()))
            assert_close(ub[c], uc, rtol=1e-6)
            for a, b in zip(gb, gc):
                assert_close(a[c], b, rtol=1e-5, atol=1e-6)
    finally:
        gpax_torch.set_config(use_fused_likelihood="auto")


@pytest.mark.parametrize("kind", ["rbf", "matern52"])
@pytest.mark.parametrize("per_point", [False, True])
def test_batched_fused_op_equals_unbatched(kind, per_point):
    """gp_mvn_log_prob over a leading batch of k_length/k_scale/noise_eff:
    each value and gradient is the unbatched call's (float32 tolerance)."""
    X, y = _gp_data(24)
    rng = np.random.default_rng(3)
    kl = torch.tensor(rng.uniform(0.5, 1.5, (C, 1)), dtype=torch.float32, requires_grad=True)
    ks = torch.tensor(rng.uniform(0.5, 1.5, C), dtype=torch.float32, requires_grad=True)
    shape = (C, 24) if per_point else (C,)
    ne = torch.tensor(rng.uniform(0.05, 0.2, shape), dtype=torch.float32, requires_grad=True)
    lp = gp_mvn_log_prob(X, kl, ks, ne, y, kind)
    assert lp.shape == (C,)
    grads = torch.autograd.grad(lp.sum(), [kl, ks, ne])
    for c in range(C):
        args = [t[c].detach().requires_grad_(True) for t in (kl, ks, ne)]
        l1 = gp_mvn_log_prob(X, *args, y, kind)
        g1 = torch.autograd.grad(l1, args)
        assert_close(lp[c], l1, rtol=1e-6)
        for a, b in zip(grads, g1):
            assert_close(a[c], b, rtol=1e-5, atol=1e-6)


def test_stopped_chain_state_is_frozen():
    """A chain that diverges at its first leaf stops: its edge, weight,
    accept sum and leaf count freeze while the other chain builds its whole
    subtree, and an inactive chain takes no part at all. In a transition,
    the stopped chain's invalid subtree is not merged: it keeps its start."""
    curv = torch.tensor([1.0, 1e6, 1.0])

    def pg(z):
        return 0.5 * (curv[:, None] * z * z).sum(-1), curv[:, None] * z

    z0 = torch.full((3, 2), 0.5)
    r0 = torch.tensor([[0.3, -0.2], [1.0, 1.0], [0.1, 0.1]])
    u0, g0 = pg(z0)
    m = torch.ones((3, 2))
    h0 = u0 + th.kinetic_energy(r0, m, False)
    active = torch.tensor([True, True, False])
    sub = _build_subtree(pg, 3, z0, r0, g0, torch.full((3,), 0.1), m, h0,
                         torch.Generator().manual_seed(0), 10, active, False)
    assert sub["n"].tolist() == [8, 1, 0] and sub["lockstep"] == 8
    assert sub["diverging"].tolist() == [False, True, False]
    assert sub["turning"].tolist() == [False, False, False]
    for c in (1, 2):  # frozen edges
        assert torch.equal(sub["z"][c], z0[c]) and torch.equal(sub["r"][c], r0[c])
    assert torch.equal(sub["z_prop"][2], z0[2]) and torch.equal(sub["r_sum"][2], 0 * r0[2])
    assert float(sub["log_weight"][2]) == -np.inf and float(sub["sum_accept"][2]) == 0.0
    assert float(sub["sum_accept"][1]) == 0.0  # exp(min(0, -Δ)) of a divergence
    assert not torch.equal(sub["z"][0], z0[0])

    state = NUTSState(z=z0, potential=u0, grad=g0, step_size=torch.full((3,), 0.1),
                      inv_mass=m, rng_key=torch.Generator().manual_seed(1),
                      accept_prob=torch.zeros(3), num_steps=torch.zeros(3, dtype=torch.int64),
                      diverging=torch.zeros(3, dtype=torch.bool), energy=u0)
    out = nuts_step(pg, state, max_depth=4)
    assert out.diverging.tolist() == [False, True, False]
    assert int(out.num_steps[1]) == 1 and torch.equal(out.z[1], z0[1])
    assert out.lockstep_steps == int(out.num_steps.max()) >= 2


def _normal_model():
    tppl.sample("x", tdist.Normal(0.0, 1.0))


@pytest.mark.parametrize("dense", [False, True])
def test_segmented_lockstep_draws_identical(dense):
    """The lockstep loop carries every chain's state, dual averaging and
    Welford sums across its segment boundaries: the draws of a segmented
    run equal the unsegmented run's bit for bit."""
    X, y = _gp_data(12)
    runs = []
    for seg in (None, 7):
        gp = gpax_torch.ExactGP(1, "RBF")
        gp.fit(3, X.numpy(), y.numpy(), num_warmup=20, num_samples=15, num_chains=2,
               chain_method="vectorized", segment_size=seg, dense_mass=dense, **FIT)
        runs.append(gp)
    a, b = (r.get_samples(chain_dim=True) for r in runs)
    for k in a:
        assert a[k].shape[:2] == (2, 15)
        assert torch.equal(a[k], b[k]), k
    sa, sb = (r.mcmc.get_extra_fields(group_by_chain=True) for r in runs)
    assert torch.equal(sa["num_steps"], sb["num_steps"])
    assert runs[0].mcmc.num_leapfrogs == runs[1].mcmc.num_leapfrogs == int(
        sb["segment_leapfrogs"].sum())
    assert runs[0].mcmc.num_lockstep_leapfrogs == runs[1].mcmc.num_lockstep_leapfrogs
    # chain leapfrogs are each chain's own trees; lockstep leapfrogs count
    # the batched potential's calls, at least the longer chain's tree
    assert runs[0].mcmc.num_lockstep_leapfrogs <= runs[0].mcmc.num_leapfrogs
    assert runs[0].mcmc.num_lockstep_leapfrogs >= int(sb["num_steps"].max(0).values.sum())


def test_multichain_vectorized_rhat():
    """tests/test_nuts.py:78."""
    mcmc = MCMC(NUTS(_normal_model), num_warmup=300, num_samples=600, num_chains=2,
                chain_method="vectorized", device="cpu")
    mcmc.run(4)
    grouped = mcmc.get_samples(group_by_chain=True)
    assert grouped["x"].shape == (2, 600)
    assert gelman_rubin(grouped["x"].numpy()) < 1.05
    assert mcmc.get_samples()["x"].shape == (1200,)
    assert not torch.equal(grouped["x"][0], grouped["x"][1])


def test_parallel_chains():
    """tests/test_nuts.py:93: "parallel" runs the lockstep program on the
    data's one device."""
    mcmc = MCMC(NUTS(_normal_model), num_warmup=200, num_samples=300, num_chains=4,
                chain_method="parallel", device="cpu")
    mcmc.run(5)
    x = mcmc.get_samples(group_by_chain=True)["x"]
    assert x.shape == (4, 300) and bool(torch.isfinite(x).all())
    assert mcmc.get_extra_fields(group_by_chain=True)["accept_prob"].shape == (4, 300)


@pytest.fixture(scope="module")
def jax_vectorized_fit():
    """The JAX package's 2-chain vectorized segmented fit of
    tests/test_nuts.py:195's data."""
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, (40, 1)).astype(np.float32)
    y = (np.sin(2 * X[:, 0]) + 0.1 * rng.normal(size=40).astype(np.float32)).astype(np.float32)
    gp = gpax_tpu.ExactGP(1, "RBF")
    gp.fit(jax.random.PRNGKey(0), jnp.asarray(X), jnp.asarray(y), num_warmup=80,
           num_samples=80, num_chains=2, chain_method="vectorized", segment_size=40,
           print_summary=False, progress_bar=False)
    return X, y, {k: np.asarray(v) for k, v in gp.get_samples(chain_dim=True).items()}


def test_vectorized_chains_segmented_exactgp(jax_vectorized_fit):
    """tests/test_nuts.py:195 on the port: both chains' noise means within
    0.2 of each other, and the pooled posterior means within Monte-Carlo
    error (4 sd over the effective draws) of the JAX package's vectorized
    fit on the same data."""
    X, y, jax_samples = jax_vectorized_fit
    gp = gpax_torch.ExactGP(1, "RBF")
    gp.fit(0, X, y, num_warmup=80, num_samples=80, num_chains=2, chain_method="vectorized",
           segment_size=40, **FIT)
    by_chain = gp.mcmc.get_samples(group_by_chain=True)
    assert by_chain["k_length"].shape[:2] == (2, 80)
    assert all(bool(torch.isfinite(v).all()) for v in by_chain.values())
    m0, m1 = (float(by_chain["noise"][c].mean()) for c in range(2))
    assert abs(m0 - m1) < 0.2, (m0, m1)
    for site in ("k_length", "k_scale", "noise"):
        t = by_chain[site].numpy().reshape(-1)
        j = jax_samples[site].reshape(-1)
        se = np.sqrt(t.var() / 40 + j.var() / 40)  # ~40 effective draws a side
        assert abs(t.mean() - j.mean()) < 4 * se + 1e-3, (site, t.mean(), j.mean(), se)


def test_dense_mass_segmented_chains():
    """tests/test_nuts.py:244: (chains, dim, dim) inverse masses through the
    lockstep runner recover a correlated Gaussian's covariance, the call
    translated as it stands there: one chain's potential, ``num_chains=2``
    (chain by chain, since no batched potential is given)."""
    cov = torch.tensor([[1.0, 0.9], [0.9, 1.0]])

    def model():
        tppl.sample("x", tdist.MultivariateNormal(torch.zeros(2), covariance_matrix=cov))

    info = initialize_model(model, torch.Generator().manual_seed(0))
    z0s = {k: v.expand((2,) + v.shape).clone() for k, v in info.init_unconstrained.items()}
    zs, stats, unravel = run_nuts_segmented_chains(
        info.potential_fn, z0s, torch.Generator().manual_seed(4), num_chains=2,
        num_warmup=200, num_samples=400, segment_size=100, dense_mass=True)
    assert zs.shape == (2, 400, 2) and stats["num_steps"].shape == (2, 400)
    assert bool(stats["chain_by_chain"])
    x = info.constrain_fn(unravel(zs))["x"].reshape(-1, 2).numpy()
    np.testing.assert_allclose(np.cov(x.T), cov.numpy(), atol=0.2)
    assert np.isfinite(x).all()


def _toy(n=24):
    rng = np.random.default_rng(0)
    X = np.linspace(-1, 1, n).astype(np.float32)
    y = (np.sin(3 * X) + 0.05 * rng.normal(size=n)).astype(np.float32)
    return X, y


def test_multichain_deadline_freezes_and_streams():
    """tests/test_round5.py:28-55: a past deadline freezes both chains'
    warmup at the first boundary, keeps one post-freeze segment of draws and
    streams each segment's telemetry with the chain count."""
    X, y = _toy()
    calls = []
    gp = gpax_torch.ExactGP(1, "RBF")
    gp.fit(0, X, y, num_warmup=20, num_samples=40, num_chains=2, chain_method="vectorized",
           segment_size=10, segment_callback=calls.append,
           deadline=time.perf_counter() - 1.0, **FIT)
    st = gp.mcmc.get_extra_fields()
    assert st["warmup_steps_run"].tolist() == [10]
    noise = gp.get_samples(chain_dim=True)["noise"]
    assert noise.shape == (2, 10) and bool(torch.isfinite(noise).all())
    assert len(calls) == 2 and calls[-1]["num_chains"] == 2
    assert calls[-1]["steps_done"] == 20 and len(calls[-1]["segment_leapfrogs"]) == 2
    assert sum(calls[-1]["segment_leapfrogs"]) == gp.mcmc.num_leapfrogs
    assert 0.0 <= float(st["accept_mean_all"][0]) <= 1.0
    mean, _ = gp.predict(1, np.linspace(-1, 1, 7), noiseless=True, device="cpu")
    assert bool(torch.isfinite(mean).all())


def test_multichain_far_deadline_full_plan():
    """tests/test_round5.py:58-67."""
    X, y = _toy()
    gp = gpax_torch.ExactGP(1, "RBF")
    gp.fit(0, X, y, num_warmup=20, num_samples=20, num_chains=2, chain_method="vectorized",
           segment_size=10, deadline=time.perf_counter() + 3600.0, **FIT)
    assert gp.mcmc.get_extra_fields()["warmup_steps_run"].tolist() == [20]
    assert gp.get_samples(chain_dim=True)["noise"].shape == (2, 20)


def test_multichain_freeze_restores_full_tree_depth():
    """tests/test_round5.py:70-90 with two lockstep chains: with
    warmup_depth_cap=(1, 20) every capped transition runs ≤ 1 leapfrog, so
    a post-freeze tree of more proves the freeze restored the full depth."""
    X, y = _toy()
    gp = gpax_torch.ExactGP(1, "RBF")
    Xt, yt = gp._set_data(X, y, device="cpu")
    gen = torch.Generator().manual_seed(0)
    info = initialize_model(gp.model, gen, (Xt, yt), batch_shape=(2,))
    single = initialize_model(gp.model, gen, (Xt, yt)).potential_fn
    z0s = {k: v.expand((2,) + v.shape).clone() for k, v in info.init_unconstrained.items()}
    zs, stats, _ = run_nuts_segmented_chains(
        single, z0s, torch.Generator().manual_seed(0), 2, 20, 40, segment_size=10,
        max_tree_depth=6, warmup_depth_cap=(1, 20), deadline=time.perf_counter() - 1.0,
        batched_potential_fn=info.potential_fn)
    assert not bool(stats["chain_by_chain"])
    assert int(stats["warmup_steps_run"]) == 10
    assert int(stats["num_steps"].max()) > 1, "the depth cap leaked into post-freeze draws"
    assert zs.shape == (2, 10, 3) and bool(torch.isfinite(zs).all())


def test_model_without_a_chain_dim_fails_by_name():
    """A model whose sites cannot carry the chain dim: its batched potential
    fails, one warning names the model, and its chains run chain by chain
    inside the lockstep tree."""
    def flat_model():
        x = tppl.sample("x", tdist.Normal(0.0, 1.0))
        # three terms whatever the latents' shape: no room for a chain dim
        tppl.factor("f", torch.zeros(3) - 0.5 * x.sum() ** 2)

    with pytest.warns(UserWarning, match="flat_model.*chain by chain"):
        mcmc = MCMC(NUTS(flat_model), 5, 5, num_chains=2, chain_method="vectorized",
                    device="cpu").run(0)
    assert mcmc.chain_by_chain
    x = mcmc.get_samples(group_by_chain=True)["x"]
    assert x.shape == (2, 5) and bool(torch.isfinite(x).all())


def test_window_options_warn_without_segments():
    """The window options keep their warning on an unsegmented lockstep run."""
    mcmc = MCMC(NUTS(_normal_model), 5, 5, num_chains=2, chain_method="vectorized",
                device="cpu")
    mcmc.deadline = time.perf_counter() + 3600.0
    with pytest.warns(UserWarning, match="segment_size"):
        mcmc.run(0)
    assert mcmc.get_samples(group_by_chain=True)["x"].shape == (2, 5)
    assert ravel({"a": torch.zeros(2)})[0].shape == (2,)


def test_segmented_chains_telemetry():
    """tests/test_round3.py:212-233, the call translated as it stands there:
    one chain's ExactGP potential, 2 chains from x and x + 0.1,
    ``num_chains=2``; per-segment wall and leapfrog telemetry, the totals
    with warmup's trees."""
    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.uniform(-1, 1, (10, 1)), dtype=torch.float32)
    y = torch.sin(3 * X[:, 0]) + 0.05 * torch.as_tensor(rng.normal(size=10), dtype=torch.float32)
    gp = gpax_torch.ExactGP(1, "RBF")
    gp.X_train, gp.y_train = X, y
    info = initialize_model(gp.model, torch.Generator().manual_seed(0), (X, y))
    z0 = {k: torch.stack([v, v + 0.1]) for k, v in info.init_unconstrained.items()}
    zs, stats, _ = run_nuts_segmented_chains(
        info.potential_fn, z0, torch.Generator().manual_seed(1), num_chains=2,
        num_warmup=20, num_samples=20, segment_size=10, max_tree_depth=5)
    assert zs.shape[0] == 2 and zs.shape[1] == 20
    assert stats["segment_wall_s"].shape == (4,)
    assert stats["segment_leapfrogs"].shape == (4,)
    assert int(stats["segment_leapfrogs"].sum()) >= int(stats["num_steps"].sum())


def test_chains_runner_signature_checks():
    """The reference's positional order (potential, batch, key, num_chains,
    num_warmup, num_samples, ...): num_chains is checked against the
    batch, ``shard_put`` is refused on one device, and a callable
    ``init_batch(key)`` gives the draws of the batch it returns."""
    info = initialize_model(_normal_model, torch.Generator().manual_seed(0))
    z0 = {k: torch.stack([v, v + 0.5]) for k, v in info.init_unconstrained.items()}
    with pytest.raises(ValueError, match="num_chains=3"):
        run_nuts_segmented_chains(info.potential_fn, z0, torch.Generator(), 3, 5, 5)
    with pytest.raises(ValueError, match="shard_put"):
        run_nuts_segmented_chains(info.potential_fn, z0, torch.Generator(), 2, 5, 5,
                                  shard_put=lambda carry: carry)
    zs, _, _ = run_nuts_segmented_chains(info.potential_fn, z0,
                                         torch.Generator().manual_seed(3), 2, 10, 10, 5)
    keys = []
    zc, _, _ = run_nuts_segmented_chains(info.potential_fn, lambda k: keys.append(k) or z0,
                                         torch.Generator().manual_seed(3), 2, 10, 10, 5)
    assert len(keys) == 1 and torch.equal(zs, zc)
