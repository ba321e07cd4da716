"""gpax_torch.parallel against gpax_tpu.parallel: grid-split prediction and
acquisition (tests/test_parallel_ckpt.py:28-80,136-150) and the mesh-split
factorization and likelihood (tests/test_distributed_chol.py:27-110).

The port runs on a CPU mesh of 8 slots, ``Mesh([cpu] * 8)``: the split into
chunks and the gathers are real, the devices are one. The JAX functions run
on ``get_mesh(8)`` of tests/conftest.py's 8 virtual CPU devices, under
``jax.jit`` as the JAX tests run them (their sharding constraints are made
for traced code). The tolerances are the JAX tests' own.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpax_torch
import gpax_tpu
from _torch_parity import assert_close, spd
from gpax_torch.parallel import (Mesh, get_mesh, make_sharded_mvn_log_prob,
                                 shard_leading_axis, sharded_acquisition, sharded_chol_inv,
                                 sharded_linalg, sharded_predict)
from gpax_torch.parallel.distributed_chol import active_sharded_linalg
from gpax_torch.utils import samples_from_numpy
from gpax_tpu import parallel as jpar

torch.set_num_threads(1)

CPU8 = Mesh([torch.device("cpu")] * 8, ("grid",))


@pytest.fixture(scope="module")
def fitted():
    """A JAX ExactGP fit (tests/test_parallel_ckpt.py:18-25) and a port
    ExactGP fitted on the same data; the comparisons pass the JAX fit's
    draws to both."""
    rng = np.random.default_rng(0)
    X = rng.uniform(-1, 1, 10).astype(np.float32)
    y = np.sin(3 * X).astype(np.float32)
    jm = gpax_tpu.ExactGP(1, "RBF")
    jm.fit(gpax_tpu.utils.get_keys()[0], jnp.asarray(X), jnp.asarray(y), num_warmup=60,
           num_samples=60, print_summary=False, progress_bar=False)
    s = {k: np.asarray(v) for k, v in jm.get_samples().items()}
    tm = gpax_torch.ExactGP(1, "RBF")
    tm.fit(0, X, y, num_warmup=60, num_samples=60, print_summary=False, progress_bar=False,
           device="cpu")
    return jm, tm, s


def test_sharded_predict_matches_local(fitted):
    jm, tm, s = fitted
    X_new = np.linspace(-1, 1, 19, dtype=np.float32)  # not a multiple of 8: padding
    mean_sharded, draws = sharded_predict(tm, 1, X_new, mesh=CPU8, samples=samples_from_numpy(s))
    mean_local, _ = tm.predict(1, X_new, samples_from_numpy(s), device="cpu")
    assert mean_sharded.shape == (19,) and draws.shape == (60, 1, 19)
    assert_close(mean_sharded, mean_local, rtol=1e-4, atol=1e-5)
    jmean, _ = jpar.sharded_predict(jm, jax.random.PRNGKey(1), jnp.asarray(X_new),
                                    mesh=jpar.get_mesh(8), samples=s)
    assert_close(mean_sharded, jmean, rtol=1e-4, atol=1e-5)


def test_sharded_predict_on_one_device_is_the_local_call(fitted):
    """On a mesh of one slot the split is one call: predict's own draws."""
    _, tm, s = fitted
    X_new = np.linspace(-1, 1, 19, dtype=np.float32)
    one = Mesh([torch.device("cpu")])
    out = sharded_predict(tm, 3, X_new, mesh=one, samples=samples_from_numpy(s), n=2)
    ref = tm.predict(3, X_new, samples_from_numpy(s), n=2, device="cpu")
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def test_sharded_acquisition_matches_local(fitted):
    jm, tm, s = fitted
    X_cand = np.linspace(-1.2, 1.2, 21, dtype=np.float32)
    ts = samples_from_numpy(s)
    acq_sharded = sharded_acquisition(gpax_torch.acquisition.UCB, 1, tm, X_cand, mesh=CPU8,
                                      beta=2.0, noiseless=True, samples=ts)
    acq_local = gpax_torch.acquisition.UCB(1, tm, X_cand, beta=2.0, noiseless=True, samples=ts,
                                           device="cpu")
    assert acq_sharded.shape == (21,)
    assert_close(acq_sharded, acq_local, rtol=1e-4, atol=1e-5)
    assert int(acq_sharded.argmax()) == int(acq_local.argmax())
    jacq = jpar.sharded_acquisition(gpax_tpu.acquisition.UCB, jax.random.PRNGKey(1), jm,
                                    jnp.asarray(X_cand), mesh=jpar.get_mesh(8), beta=2.0,
                                    noiseless=True, samples=s)
    assert_close(acq_sharded, jacq, rtol=1e-4, atol=1e-5)
    assert int(acq_sharded.argmax()) == int(np.argmax(np.asarray(jacq)))


def test_sharded_predict_collision_dim_not_missliced(fitted):
    """A sample count equal to the padded grid size (19 -> 24) must not be
    mis-sliced: only the declared grid axis is."""
    jm, tm, s = fitted
    s24 = {k: v[:24] for k, v in s.items()}
    X_new = np.linspace(-1, 1, 19, dtype=np.float32)
    mean, draws = sharded_predict(tm, 1, X_new, mesh=CPU8, samples=samples_from_numpy(s24))
    assert mean.shape == (19,)
    assert draws.shape[0] == 24 and draws.shape[-1] == 19
    jmean, jdraws = jpar.sharded_predict(jm, jax.random.PRNGKey(1), jnp.asarray(X_new),
                                         mesh=jpar.get_mesh(8), samples=s24)
    assert tuple(draws.shape) == jdraws.shape


def test_sharded_chol_inv_parity():
    n = 320  # not a multiple of the leaf: identity padding
    K = spd(n)  # well-conditioned A·Aᵀ/n + ½I
    L, W = sharded_chol_inv(torch.tensor(K), CPU8, leaf=64)
    mesh = jpar.get_mesh(8)
    Lj, Wj = jax.jit(lambda K: jpar.sharded_chol_inv(K, mesh, leaf=64))(jnp.asarray(K))
    L_ref = np.linalg.cholesky(K.astype(np.float64))
    assert L.dtype == torch.float32
    assert_close(L, L_ref, rtol=2e-4, atol=2e-4)
    assert_close(L, Lj, rtol=2e-4, atol=2e-4)
    res = (L @ W - torch.eye(n)).abs().max().item()
    assert res < 5e-4, res
    # the float64 factor itself: to float64 rounding
    L64, W64 = sharded_chol_inv(torch.tensor(K, dtype=torch.float64), CPU8, leaf=64)
    assert_close(L64, L_ref, rtol=0, atol=1e-12)
    assert (L64 @ W64 - torch.eye(n, dtype=torch.float64)).abs().max().item() < 1e-12


def test_sharded_chol_inv_propagates_nan_on_indefinite_input():
    K = spd(192, seed=3)
    K[150, 150] = -5.0
    L, W = sharded_chol_inv(torch.tensor(K), CPU8, leaf=64)
    assert not bool(torch.isfinite(L).all()) and not bool(torch.isfinite(W).all())


def test_sharded_mvn_log_prob_value_and_grad():
    n = 256
    K = spd(n, seed=1)
    diff = np.random.default_rng(2).normal(size=n).astype(np.float32)
    lp_j = jpar.make_sharded_mvn_log_prob(jpar.get_mesh(8), leaf=64)
    vj = jax.jit(lp_j)(jnp.asarray(K), jnp.asarray(diff))
    gj = jax.jit(jax.grad(lp_j, argnums=(0, 1)))(jnp.asarray(K), jnp.asarray(diff))
    Kt = torch.tensor(K, requires_grad=True)
    dt = torch.tensor(diff, requires_grad=True)
    vt = make_sharded_mvn_log_prob(CPU8, leaf=64)(Kt, dt)
    vt.backward()
    assert vt.dtype == torch.float32
    assert_close(vt, vj, rtol=1e-4)
    for t, j in zip((Kt.grad, dt.grad), gj):
        j = np.asarray(j)
        scale = np.abs(j).max() + 1e-12
        err = np.abs(t.numpy() - j).max() / scale
        assert err < 5e-3, err
    # the unsplit route of the port: the same numerics
    Ku = torch.tensor(K, requires_grad=True)
    du = torch.tensor(diff, requires_grad=True)
    vu = gpax_torch.ops.mvn_log_prob_centered(Ku, du)
    vu.backward()
    assert_close(vt, vu, rtol=1e-6)
    assert_close(Kt.grad, Ku.grad, rtol=0, atol=1e-6 * Ku.grad.abs().max().item())
    assert_close(dt.grad, du.grad, rtol=0, atol=1e-6 * du.grad.abs().max().item())


def _potential(gp, X, y, z, mesh=None):
    info = gpax_torch.ppl.initialize_model(gp.model, torch.Generator().manual_seed(0), (X, y))
    zz = {k: v.clone().requires_grad_(True) for k, v in z.items()}
    if mesh is None:
        u = info.potential_fn(zz)
    else:
        with sharded_linalg(mesh, leaf=64):
            assert not gp._fused_likelihood_ok(X, {"k_length": None, "k_scale": None,
                                                  "period": None})
            u = info.potential_fn(zz)
    grads = torch.autograd.grad(u, list(zz.values()))
    return u, torch.cat([g.reshape(-1) for g in grads])


@pytest.mark.parametrize("route", ["never", "always"])
def test_sharded_linalg_potential_matches_unsharded(route):
    """ExactGP's potential and gradient under the sharded_linalg context
    against the unsplit route (composed, or fused when forced, which the
    context sets aside) and against JAX's sharded potential at the same
    point."""
    rng = np.random.default_rng(0)
    n = 192
    X = rng.uniform(-2, 2, (n, 1)).astype(np.float32)
    y = np.sin(2 * X[:, 0]).astype(np.float32)
    gp = gpax_torch.ExactGP(1, "RBF")
    Xt, yt = gp._set_data(X, y, device="cpu")
    z = {"k_length": torch.tensor([-0.2]), "k_scale": torch.tensor(0.3),
         "noise": torch.tensor(-2.0)}
    gpax_torch.set_config(use_fused_likelihood=route)
    try:
        u0, g0 = _potential(gp, Xt, yt, z)
        u1, g1 = _potential(gp, Xt, yt, z, CPU8)
    finally:
        gpax_torch.set_config(use_fused_likelihood="auto")
    assert_close(u1, u0, rtol=1e-4)
    assert_close(g1, g0, rtol=1e-3, atol=1e-3)
    jm = gpax_tpu.ExactGP(1, "RBF")
    info = gpax_tpu.ppl.initialize_model(jm.model, jax.random.PRNGKey(0),
                                         (jnp.asarray(X), jnp.asarray(y)))
    zj = {k: jnp.asarray(v.numpy()) for k, v in z.items()}
    with jpar.sharded_linalg(jpar.get_mesh(8), leaf=64):
        uj, gj = jax.jit(jax.value_and_grad(info.potential_fn))(zj)
    assert_close(u1, uj, rtol=1e-4)
    assert_close(g1, np.concatenate([np.ravel(gj[k]) for k in z]), rtol=1e-3, atol=1e-3)


def test_sharded_linalg_nuts_smoke():
    """One short NUTS fit under the mesh context (tests/test_distributed_chol.py:93)."""
    rng = np.random.default_rng(0)
    n = 128
    X = rng.uniform(-2, 2, (n, 1)).astype(np.float32)
    y = (np.sin(2 * X[:, 0]) + 0.1 * rng.normal(size=n)).astype(np.float32)
    gp = gpax_torch.ExactGP(1, "RBF")
    with sharded_linalg(CPU8, leaf=64):
        assert active_sharded_linalg() == (CPU8, "grid", 64)
        gp.fit(0, X, y, num_warmup=30, num_samples=30, max_tree_depth=5,
               print_summary=False, progress_bar=False, device="cpu")
    assert active_sharded_linalg() is None
    s = gp.get_samples()
    assert bool(torch.isfinite(s["k_length"]).all())
    assert float(s["noise"].mean()) < 1.0


def test_mesh_helpers_on_the_cpu():
    """get_mesh spans the cards and raises without one; a CPU mesh is built
    explicitly; shard_leading_axis places a tree on a mesh of one device and
    refuses a mesh of several."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="Mesh"):
            get_mesh()
    assert CPU8.devices.size == 8 and CPU8.axis_names == ("grid",)
    tree = {"a": np.ones(3), "b": (torch.zeros(2, 2), [np.float32(2.0)])}
    out = shard_leading_axis(tree, CPU8)
    assert out["a"].device.type == "cpu" and isinstance(out["b"], tuple)
    assert torch.equal(out["b"][0], torch.zeros(2, 2)) and out["b"][1][0].item() == 2.0
    with pytest.raises(NotImplementedError):
        shard_leading_axis(tree, Mesh([torch.device("cpu"), torch.device("cuda", 0)]))


def test_init_distributed_localhost_smoke():
    """``init_distributed`` really joins a process group (gloo without a
    card) on localhost and reports world size times local devices; in a
    subprocess, so the group does not leak into the suite."""
    code = (
        "import torch, torch.distributed as dist\n"
        "from gpax_torch.parallel import init_distributed\n"
        "n = init_distributed(coordinator_address='localhost:43229',\n"
        "                     num_processes=1, process_id=0)\n"
        "assert dist.is_initialized() and dist.get_world_size() == 1\n"
        "assert dist.get_backend() == ('nccl' if torch.cuda.is_available() else 'gloo')\n"
        "t = torch.ones(3)\n"
        "dist.all_reduce(t)\n"
        "assert t.tolist() == [1.0, 1.0, 1.0]\n"
        "dist.destroy_process_group()\n"
        "print('OK', n)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=dict(os.environ), timeout=300,
                       cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert "OK 1" in r.stdout
