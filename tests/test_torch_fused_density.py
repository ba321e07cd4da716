"""gpax_torch.ops.fused_density.gp_mvn_log_prob against gpax_tpu's fused
likelihood op on the CPU (K1's twin and the library Cholesky with K2's twin
in the port; the Pallas gram in interpret mode in JAX), against a float64
finite-difference reference, against the port's composed route, and the
dispatch rule ``ExactGP._fused_likelihood_ok``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpax_torch
import gpax_tpu
from _torch_parity import assert_close, value_and_grads
from gpax_torch.ops import fused_density as tfd
from gpax_torch.ops import gram
from gpax_torch.ppl import initialize_model
from gpax_tpu.ops.fused_density import gp_mvn_log_prob as jax_gp_mvn_log_prob

torch.set_num_threads(1)

JBASE = 4.0 * float(np.finfo(np.float32).eps)  # per point: the base regularization


def _problem(n=96, d=2, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n, d)).astype(np.float32)
    y = (np.sin(2 * X[:, 0]) + 0.1 * rng.normal(size=n)).astype(np.float32)
    return X, y


@pytest.fixture
def fused_mode():
    """Set the port's use_fused_likelihood for one test, restoring "auto"."""
    yield lambda mode: gpax_torch.set_config(use_fused_likelihood=mode)
    gpax_torch.set_config(use_fused_likelihood="auto")


@pytest.mark.parametrize("kind", ["rbf", "matern52"])
def test_value_and_grads_match_jax(kind):
    """Same numpy inputs through both ops. Tolerances of the JAX package's
    own fused-vs-composed test (``test_fused_density.py:41,46-47``): its
    float32 factor at κ(K) ~ 3e3 carries ~1e-4 relative, the port's float64
    one less."""
    X, y = _problem()
    n = X.shape[0]
    noise_eff = 0.05 + 1e-6 + JBASE * n
    args = (X, np.array([0.7, 1.4]), np.array(1.3), np.array(noise_eff), y)
    (jv, tv), grads = value_and_grads(
        lambda *a: jax_gp_mvn_log_prob(*a, kind),
        lambda *a: tfd.gp_mvn_log_prob(*a, kind), args, argnums=(1, 2, 3, 4))
    assert_close(tv, jv, rtol=2e-4)
    for jg, tg in grads:
        assert_close(tg, jg, rtol=2e-3, atol=2e-4)


def test_grads_match_float64_finite_differences():
    """The port's closed-form θ-gradients against central differences of a
    float64 dense density (``test_fused_density.py:50-80``)."""
    X, y = _problem(n=48, d=1, seed=1)
    n = X.shape[0]
    base = (np.array([0.9]), np.array(1.1), np.array(0.08))

    def dense64(kl, ks, nz):
        Xd = X.astype(np.float64) / kl
        r2 = ((Xd[:, None, :] - Xd[None, :, :]) ** 2).sum(-1)
        K = ks * np.exp(-0.5 * r2) + (nz + 1e-6 + JBASE * n) * np.eye(n)
        L = np.linalg.cholesky(K)
        a = np.linalg.solve(L, y.astype(np.float64))
        return -0.5 * (a @ a + n * np.log(2 * np.pi)) - np.log(np.diag(L)).sum()

    params = [torch.tensor(b, dtype=torch.float32, requires_grad=True) for b in base]
    lp = tfd.gp_mvn_log_prob(torch.tensor(X), params[0], params[1],
                             params[2] + 1e-6 + JBASE * n, torch.tensor(y), "rbf")
    grads = torch.autograd.grad(lp, params)
    eps = 1e-5
    for i, g in enumerate(grads):
        hi = [b.astype(np.float64).copy() for b in base]
        lo = [b.astype(np.float64).copy() for b in base]
        hi[i] = hi[i] + eps
        lo[i] = lo[i] - eps
        fd = (dense64(*hi) - dense64(*lo)) / (2 * eps)
        np.testing.assert_allclose(g.sum().item(), fd, rtol=5e-3, atol=1e-3)


def test_vector_noise_and_failed_factorization():
    """A per-point noise_eff (the padded fit's noise mask) gets a per-point
    cotangent equal to JAX's; a K that even the escalated jitter cannot
    factor gives zero gradients, not NaN, as in JAX."""
    X, y = _problem(n=40, d=1, seed=5)
    nz = (0.1 + np.linspace(0, 0.2, 40)).astype(np.float32)
    (jv, tv), grads = value_and_grads(
        lambda *a: jax_gp_mvn_log_prob(*a, "rbf"),
        lambda *a: tfd.gp_mvn_log_prob(*a, "rbf"),
        (X, np.array([0.8]), np.array(1.2), nz, y), argnums=(3,))
    assert_close(tv, jv, rtol=2e-4)
    assert_close(grads[0][1], grads[0][0], rtol=2e-3, atol=2e-4)

    params = [torch.tensor(v, requires_grad=True)
              for v in ([0.8], 1.2, -50.0)]  # noise far below zero: indefinite
    Xt, yt = torch.tensor(X), torch.tensor(y)
    lp = tfd.gp_mvn_log_prob(Xt, *params, yt, "rbf")
    grads = torch.autograd.grad(lp, params)
    assert all(torch.equal(g, torch.zeros_like(g)) for g in grads)
    jgrads = jax.grad(lambda *a: jax_gp_mvn_log_prob(jnp.asarray(X), *a, jnp.asarray(y), "rbf"),
                      argnums=(0, 1, 2))(jnp.asarray([0.8]), jnp.asarray(1.2), jnp.asarray(-50.0))
    assert all(float(jnp.abs(g).max()) == 0.0 for g in jgrads)


@pytest.mark.parametrize("kind", ["rbf", "matern52"])
def test_maps_match_jax(kind):
    """map and map' (the port keeps them in ``ops/gram.py``, shared by both
    backwards) against the JAX helper, r² = 0 and the 1e-10 cut included."""
    from gpax_tpu.ops.fused_density import _maps as jax_maps

    r2 = np.concatenate([[0.0, 1e-12, 2e-10], np.linspace(0.01, 9.0, 50)]).astype(np.float32)
    m_j, dm_j = jax_maps(jnp.asarray(r2), kind)
    m_t, dm_t = gram._maps(torch.tensor(r2), kind)
    assert_close(m_t, m_j, rtol=1e-6, atol=1e-7)
    assert_close(dm_t, dm_j, rtol=1e-6, atol=1e-7)


def test_x_gets_a_zero_cotangent():
    X, y = _problem(n=32, d=2, seed=6)
    Xt = torch.tensor(X, requires_grad=True)
    lp = tfd.gp_mvn_log_prob(Xt, torch.tensor([0.7, 1.1]), torch.tensor(1.0),
                             torch.tensor(0.1), torch.tensor(y), "matern52")
    (gX,) = torch.autograd.grad(lp, [Xt])
    assert torch.equal(gX, torch.zeros_like(Xt))


def _potential_and_grad(gp, X, y, z):
    info = initialize_model(gp.model, torch.Generator().manual_seed(0), (X, y))
    zz = {k: torch.tensor(v, requires_grad=True) for k, v in z.items()}
    u = info.potential_fn(zz)
    return u.item(), torch.cat([g.reshape(-1) for g in torch.autograd.grad(u, list(zz.values()))])


@pytest.mark.parametrize("kernel", ["RBF", "Matern"])
def test_fused_potential_matches_composed(kernel, fused_mode):
    """The model's potential and gradient agree between the two routes
    (``test_fused_density.py:111-137``): the factor site replaces the
    observed sample site exactly, with the same diagonal."""
    X, y = _problem(n=80, d=1, seed=3)
    gp = gpax_torch.ExactGP(1, kernel)
    Xt, yt = gp._set_data(X, y, device="cpu")
    z = {"k_length": np.array([-0.2], np.float32), "k_scale": np.float32(0.4),
         "noise": np.float32(-2.0)}
    fused_mode("always")
    u_f, g_f = _potential_and_grad(gp, Xt, yt, z)
    fused_mode("never")
    u_c, g_c = _potential_and_grad(gp, Xt, yt, z)
    np.testing.assert_allclose(u_f, u_c, rtol=2e-5)
    assert_close(g_f, g_c, rtol=1e-3, atol=1e-3)


def test_fused_potential_matches_jax_fused(fused_mode):
    """The port's fused model potential against the JAX package's, both
    forced to the fused route."""
    X, y = _problem(n=64, d=2, seed=7)
    jm, tm = gpax_tpu.ExactGP(2, "RBF"), gpax_torch.ExactGP(2, "RBF")
    Xj, yj = jm._set_data(X, y)
    Xt, yt = tm._set_data(X, y, device="cpu")
    z = {"k_length": np.array([0.1, -0.3], np.float32), "k_scale": np.float32(0.2),
         "noise": np.float32(-2.5)}
    gpax_tpu.set_config(use_fused_likelihood="always")
    try:
        jinfo = gpax_tpu.ppl.initialize_model(jm.model, jax.random.PRNGKey(0), (Xj, yj))
        ju, jg = jax.value_and_grad(jinfo.potential_fn)({k: jnp.asarray(v) for k, v in z.items()})
    finally:
        gpax_tpu.set_config(use_fused_likelihood="auto")
    fused_mode("always")
    tu, tg = _potential_and_grad(tm, Xt, yt, z)
    np.testing.assert_allclose(tu, float(ju), rtol=2e-4)
    assert_close(tg, np.concatenate([np.ravel(jg[k]) for k in z]), rtol=2e-3, atol=2e-3)


def test_fused_nuts_posterior_matches_composed(fused_mode):
    """A NUTS fit on the fused route matches one on the composed route
    within Monte-Carlo error (``test_fused_density.py:83-108``)."""
    X, y = _problem(n=64, d=1, seed=2)
    samples = {}
    for mode in ("always", "never"):
        fused_mode(mode)
        gp = gpax_torch.ExactGP(1, "RBF")
        gp.fit(0, X, y, num_warmup=100, num_samples=100, print_summary=False,
               progress_bar=False, device="cpu")
        samples[mode] = {k: v.numpy() for k, v in gp.get_samples().items()}
    for site in ("k_length", "k_scale", "noise"):
        mf, mc = samples["always"][site].mean(), samples["never"][site].mean()
        sc = samples["never"][site].std() + 1e-6
        assert abs(mf - mc) < 4 * sc, (site, mf, mc, sc)


class _LatentInputGP(gpax_torch.ExactGP):
    _input_is_constant = False


@pytest.mark.parametrize("case,expected", [
    ("always", True), ("never", False), ("auto_cpu", False), ("periodic", False),
    ("custom_kernel", False), ("latent_inputs", False), ("x_1d", False),
    ("x_float64", False), ("extra_param", False), ("matern", True)])
def test_dispatch_rule(case, expected, fused_mode):
    """``_fused_likelihood_ok`` (``gp.py:186-212``): "auto" takes the fused
    route on a CUDA tensor only, so on the CPU it is the composed route."""
    X = torch.zeros((8, 1))
    params = {"k_length": torch.ones(1), "k_scale": torch.tensor(1.0), "period": None}
    kernel, cls = "RBF", gpax_torch.ExactGP
    fused_mode("auto" if case == "auto_cpu" else "never" if case == "never" else "always")
    if case == "periodic":
        kernel, params = "Periodic", dict(params, period=torch.tensor(1.0))
    elif case == "custom_kernel":
        kernel = gpax_torch.kernels.RBFKernel
    elif case == "latent_inputs":
        cls = _LatentInputGP
    elif case == "x_1d":
        X = torch.zeros(8)
    elif case == "x_float64":
        X = X.double()
    elif case == "extra_param":
        params = dict(params, c=torch.tensor(1.0))
    elif case == "matern":
        kernel = "Matern"
    assert cls(1, kernel)._fused_likelihood_ok(X, params) is expected


def test_auto_takes_the_composed_route_on_the_cpu(fused_mode):
    """With "auto" (the default) a CPU fit's model has the observed sample
    site, with "always" the factor site."""
    X, y = _problem(n=16, d=1)
    gp = gpax_torch.ExactGP(1, "RBF")
    Xt, yt = gp._set_data(X, y, device="cpu")
    sites = {}
    for mode in ("auto", "always"):
        fused_mode(mode)
        tr = gpax_torch.ppl.trace(gpax_torch.ppl.seed(gp.model, 0)).get_trace(Xt, yt)
        sites[mode] = {name: s["type"] for name, s in tr.items()}
    assert sites["auto"].get("y") == "sample" and "y_log_lik" not in sites["auto"]
    assert sites["always"].get("y_log_lik") == "factor" and "y" not in sites["always"]


def test_config_refuses_an_unknown_route():
    with pytest.raises(ValueError):
        gpax_torch.set_config(use_fused_likelihood="sometimes")
