"""gpax_torch.infer: exact parity of the adaptation pieces, deterministic
parity of one leapfrog, and statistical checks of NUTS (the RNG streams of
the two packages differ, so sampled outputs are held to Monte-Carlo error)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpax_torch.distributions as tdist
from _torch_parity import assert_close
from gpax_torch import ppl as tppl
from gpax_torch.infer import MCMC, NUTS, effective_sample_size, gelman_rubin
from gpax_torch.infer import hmc_util as th
from gpax_torch.infer.nuts import _is_turning, ravel, run_nuts
from gpax_tpu.infer import hmc_util as jh
from gpax_tpu.infer.nuts import _is_turning as j_is_turning

torch.set_num_threads(1)


@pytest.mark.parametrize("num_warmup", [0, 10, 19, 20, 60, 100, 150, 500, 1000])
def test_warmup_schedule_matches_jax(num_warmup):
    for t, j in zip(th.warmup_schedule(num_warmup), jh.warmup_schedule(num_warmup)):
        assert t.tolist() == np.asarray(j).tolist()


def test_dual_averaging_sequence_matches_jax():
    accepts = np.random.default_rng(0).uniform(0.3, 1.0, 50).astype(np.float32)
    t, j = th.da_init(torch.tensor(0.7)), jh.da_init(jnp.asarray(0.7, jnp.float32))
    for a in accepts:
        t = th.da_update(t, torch.tensor(a), 0.8)
        j = jh.da_update(j, jnp.asarray(a), 0.8)
    for tv, jv in zip(t, j):
        assert_close(tv, jv, rtol=2e-6, atol=1e-6)  # fp32 recurrences


@pytest.mark.parametrize("dense", [False, True])
def test_welford_matches_jax(dense):
    xs = np.random.default_rng(1).normal(2.0, 3.0, size=(200, 3)).astype(np.float32)
    t, j = th.welford_init(3, dense=dense), jh.welford_init(3, dense=dense)
    for x in xs:
        t = th.welford_update(t, torch.tensor(x))
        j = jh.welford_update(j, jnp.asarray(x))
    for reg in (False, True):
        assert_close(th.welford_variance(t, reg), jh.welford_variance(j, reg), rtol=1e-5)
    if not dense:
        assert_close(th.welford_variance(t, False), xs.var(0, ddof=1), rtol=1e-3)


def _quartic(xp):
    def pot(z):
        return 0.25 * xp.sum(z**4) + 0.5 * xp.sum(z * z) + z[0] * z[1]
    return pot


@pytest.mark.parametrize("dense", [False, True])
def test_leapfrog_matches_jax(dense):
    z = np.array([0.4, -1.1, 0.7], np.float32)
    r = np.array([0.3, 0.2, -0.5], np.float32)
    inv_mass = (np.array([[1.0, 0.2, 0.0], [0.2, 0.8, 0.1], [0.0, 0.1, 1.3]], np.float32)
                if dense else np.array([1.0, 0.5, 2.0], np.float32))
    jpg = jax.value_and_grad(_quartic(jnp))

    def tpg(zz):
        zz = zz.detach().requires_grad_(True)
        u = _quartic(torch)(zz)
        (g,) = torch.autograd.grad(u, zz)
        return u.detach(), g

    jz, jr, jg = jnp.asarray(z), jnp.asarray(r), jpg(jnp.asarray(z))[1]
    tz, tr, tg = torch.tensor(z), torch.tensor(r), tpg(torch.tensor(z))[1]
    for _ in range(5):
        jz, jr, ju, jg = jh.leapfrog(jpg, jz, jr, jnp.asarray(0.1), jnp.asarray(inv_mass), jg)
        tz, tr, tu, tg = th.leapfrog(tpg, tz, tr, torch.tensor(0.1), torch.tensor(inv_mass), tg)
    for a, b in ((tz, jz), (tr, jr), (tu, ju), (tg, jg)):
        assert_close(a, b, rtol=1e-5, atol=1e-6)  # five fp32 steps
    assert_close(th.kinetic_energy(tr, torch.tensor(inv_mass)),
                 jh.kinetic_energy(jr, jnp.asarray(inv_mass)), rtol=1e-6)


def test_is_turning_matches_jax():
    rng = np.random.default_rng(3)
    for _ in range(20):
        a, b, s = (rng.normal(size=3).astype(np.float32) for _ in range(3))
        m = rng.uniform(0.5, 2.0, 3).astype(np.float32)
        assert bool(_is_turning(*(torch.tensor(v) for v in (m, a, b, s)))) == \
            bool(j_is_turning(*(jnp.asarray(v) for v in (m, a, b, s))))


def test_sample_momentum_covariance():
    g = torch.Generator().manual_seed(0)
    inv_mass = torch.tensor([[1.0, 0.5], [0.5, 2.0]])
    r = torch.stack([th.sample_momentum(g, inv_mass) for _ in range(20000)])
    # r ~ N(0, Σ⁻¹): 20000 draws, Monte-Carlo error of a few 1e-2
    assert_close(torch.cov(r.T), torch.linalg.inv(inv_mass), rtol=0, atol=0.05)
    diag = torch.stack([th.sample_momentum(g, torch.tensor([4.0])) for _ in range(20000)])
    assert abs(diag.var().item() - 0.25) < 0.02


def test_find_reasonable_step_size_is_a_power_of_two():
    def pg(z):
        return 0.5 * (z * z).sum() * 100.0, 100.0 * z

    eps = th.find_reasonable_step_size(pg, torch.ones(2), torch.ones(2),
                                       torch.Generator().manual_seed(0))
    k = np.log2(eps.item())
    assert abs(k - round(k)) < 1e-6 and eps.item() < 1.0


def test_run_nuts_gaussian_moments():
    """N(μ, diag σ²) target: posterior moments within Monte-Carlo error."""
    mu = torch.tensor([1.0, -2.0, 0.5])
    sd = torch.tensor([0.5, 2.0, 1.0])

    def potential(z):
        return 0.5 * (((z["x"] - mu) / sd) ** 2).sum()

    zs, stats, _ = run_nuts(potential, {"x": torch.zeros(3)}, torch.Generator().manual_seed(0),
                            num_warmup=300, num_samples=1000)
    assert zs.shape == (1000, 3)
    x = zs.numpy()[None]
    ess = effective_sample_size(x)
    se = sd.numpy() / np.sqrt(ess)
    assert np.all(np.abs(x[0].mean(0) - mu.numpy()) < 4 * se)
    np.testing.assert_allclose(x[0].std(0), sd.numpy(), rtol=0.15)
    assert 0.6 < stats["accept_prob"].mean().item() <= 1.0
    assert stats["num_steps"].dtype == torch.int64 and stats["num_steps"].min() >= 1


def test_mcmc_correlated_gaussian_dense_mass():
    cov = torch.tensor([[1.0, 0.9], [0.9, 1.0]])

    def model():
        tppl.sample("x", tdist.MultivariateNormal(torch.zeros(2), covariance_matrix=cov))

    mcmc = MCMC(NUTS(model, dense_mass=True), num_warmup=400, num_samples=1000)
    mcmc.run(torch.Generator().manual_seed(1))
    x = mcmc.get_samples()["x"].numpy()
    assert x.shape == (1000, 2)
    np.testing.assert_allclose(np.cov(x.T), cov.numpy(), atol=0.15)
    assert set(mcmc.timing) == {"initialize_s", "sample_s", "postprocess_s"}
    assert mcmc.num_leapfrogs >= 1400


def test_mcmc_conjugate_normal_and_chains():
    """y ~ N(μ, 1), μ ~ N(0, 10): analytic posterior; two sequential chains."""
    y = torch.tensor(np.random.default_rng(0).normal(2.0, 1.0, size=50), dtype=torch.float32)

    def model(y):
        mu = tppl.sample("mu", tdist.Normal(0.0, 10.0**0.5))
        tppl.sample("y", tdist.Normal(mu, 1.0), obs=y)

    post_var = 1.0 / (1.0 / 10.0 + 50)
    post_mean = post_var * float(y.sum())
    mcmc = MCMC(NUTS(model), num_warmup=300, num_samples=1000, num_chains=2)
    mcmc.run(torch.Generator().manual_seed(2), y)
    mu = mcmc.get_samples(group_by_chain=True)["mu"]
    assert mu.shape == (2, 1000)
    assert abs(mu.mean().item() - post_mean) < 4 * np.sqrt(post_var / 500)
    np.testing.assert_allclose(mu.std().item(), np.sqrt(post_var), rtol=0.2)
    assert gelman_rubin(mu.numpy()) < 1.05
    assert mcmc.get_extra_fields()["diverging"].shape == (2000,)


def test_positive_latent_transform():
    def model():
        tppl.sample("s", tdist.LogNormal(0.0, 1.0))

    mcmc = MCMC(NUTS(model), num_warmup=300, num_samples=1500)
    mcmc.run(3)
    s = mcmc.get_samples()["s"].numpy()
    assert (s > 0).all()
    assert abs(np.log(s).mean()) < 0.2 and abs(np.log(s).std() - 1.0) < 0.15


@pytest.mark.parametrize("kwargs", [
    {"num_chains": 2, "chain_method": "vectorized", "segment_size": 10},
    {"num_chains": 2, "chain_method": "vectorized"},
    {"num_chains": 2, "chain_method": "parallel"}])
def test_unported_options_raise(kwargs):
    """Several lockstep chains need the JAX package's batched runner, which
    is not ported; one chain runs under any chain_method
    (tests/test_torch_nuts_segmented.py)."""
    with pytest.raises(NotImplementedError):
        MCMC(NUTS(lambda: None), **kwargs)


@pytest.mark.parametrize("attr", ["segment_callback", "deadline", "warmup_depth_cap"])
def test_unported_run_options_raise(attr):
    """The segmented runner's options are not errors on a non-segmented run:
    as in gpax_tpu, they are ignored with a warning naming segment_size."""
    mcmc = MCMC(NUTS(lambda: tppl.sample("a", tdist.Normal(0.0, 1.0))), 5, 5)
    setattr(mcmc, attr, 1.0)
    with pytest.warns(UserWarning, match="segment_size"):
        mcmc.run(0)
    assert torch.isfinite(mcmc.get_samples()["a"]).all()


def test_ravel_roundtrip_with_leading_dims():
    tree = {"a": torch.arange(3.0), "b": torch.tensor(7.0), "c": torch.ones(2, 2)}
    flat, unravel = ravel(tree)
    assert flat.shape == (8,)
    back = unravel(torch.stack([flat, 2 * flat]))
    assert back["a"].shape == (2, 3) and back["b"].shape == (2,) and back["c"].shape == (2, 2, 2)
    assert_close(back["c"][1], 2 * tree["c"], 0)
