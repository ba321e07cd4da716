"""gpax_torch.ppl: effect handlers, log density and initialization, against
gpax_tpu.ppl on the same models and values."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpax_torch.distributions as tdist
import gpax_tpu.distributions as jdist
from _torch_parity import assert_close
from gpax_torch import ppl as tppl
from gpax_tpu import ppl as jppl

torch.set_num_threads(1)


def _model(ppl, dist, xp):
    def model(y=None):
        with ppl.plate("ard", 2):
            ls = ppl.sample("ls", dist.LogNormal(0.0, 1.0))
        mu = ppl.sample("mu", dist.Normal(0.0, 2.0))
        ppl.deterministic("double_mu", 2.0 * mu)
        ppl.factor("pen", -0.5 * xp.sum(ls * ls))
        ppl.sample("y", dist.Normal(mu, 1.0), obs=y)
    return model


def test_log_density_matches_jax():
    y = np.array([0.3, -0.2, 1.1], np.float32)
    params = {"ls": np.array([0.7, 1.9], np.float32), "mu": np.float32(0.4)}
    jld, _ = jppl.log_density(_model(jppl, jdist, jnp), (jnp.asarray(y),), {},
                              {k: jnp.asarray(v) for k, v in params.items()})
    tld, tr = tppl.log_density(_model(tppl, tdist, torch), (torch.tensor(y),), {},
                               {k: torch.tensor(v) for k, v in params.items()})
    assert_close(tld, jld, rtol=1e-6)
    assert list(tr) == ["ls", "mu", "double_mu", "pen", "y"]
    assert_close(tr["double_mu"]["value"], 0.8, rtol=1e-6)


def test_potential_and_gradient_match_jax():
    y = np.array([0.3, -0.2, 1.1], np.float32)
    z = {"ls": np.array([-0.3, 0.5], np.float32), "mu": np.float32(0.4)}
    jinfo = jppl.initialize_model(_model(jppl, jdist, jnp), jax.random.PRNGKey(0),
                                  (jnp.asarray(y),))
    tinfo = tppl.initialize_model(_model(tppl, tdist, torch), torch.Generator().manual_seed(0),
                                  (torch.tensor(y),))
    jz = {k: jnp.asarray(v) for k, v in z.items()}
    ju, jg = jax.value_and_grad(jinfo.potential_fn)(jz)
    tz = {k: torch.tensor(v, requires_grad=True) for k, v in z.items()}
    tu = tinfo.potential_fn(tz)
    tu.backward()
    assert_close(tu, ju, rtol=1e-6)
    for k in z:
        assert_close(tz[k].grad, jg[k], rtol=1e-5, atol=1e-6)
    assert tinfo.deterministic_sites == ("double_mu",)
    assert set(tinfo.init_unconstrained) == {"ls", "mu"}
    assert tinfo.init_unconstrained["ls"].shape == (2,)


def test_init_to_median_averages_the_two_middle_draws():
    """jnp.median of an even count averages the middle pair; the port uses
    torch.quantile(…, 0.5), not torch.median (the lower one)."""
    def model():
        tppl.sample("a", tdist.Normal(0.0, 1.0))

    init = tppl.init_to_median(model, torch.Generator().manual_seed(3), num_samples=10)
    g = torch.Generator().manual_seed(3)
    tppl.trace(tppl.seed(model, g)).get_trace()  # the site discovery draw
    draws = tdist.Normal(0.0, 1.0).sample(g, (10,))
    assert_close(init["a"], np.median(draws.numpy()), rtol=1e-6)
    assert init["a"].item() != torch.median(draws).item()


def test_seed_substitute_condition_trace():
    def model():
        a = tppl.sample("a", tdist.Normal(0.0, 1.0))
        b = tppl.sample("b", tdist.Normal(a, 1.0))
        return a, b

    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    assert tppl.seed(model, g1)() == tppl.seed(model, g2)()
    tr = tppl.trace(tppl.substitute(tppl.seed(model, 0), data={"a": torch.tensor(2.0)})).get_trace()
    assert tr["a"]["value"].item() == 2.0 and not tr["a"]["is_observed"]
    tr = tppl.trace(tppl.condition(tppl.seed(model, 0), data={"b": torch.tensor(1.0)})).get_trace()
    assert tr["b"]["is_observed"] and tr["b"]["value"].item() == 1.0
    with pytest.raises(RuntimeError):
        model()  # latent site with no generator
    with pytest.raises(RuntimeError):
        tppl.trace(model).get_trace()


def test_duplicate_site_names_and_block():
    def model():
        tppl.sample("a", tdist.Normal(0.0, 1.0))
        tppl.sample("a", tdist.Normal(0.0, 1.0))

    with pytest.raises(ValueError):
        tppl.trace(tppl.seed(model, 0)).get_trace()

    def one():
        tppl.sample("a", tdist.Normal(0.0, 1.0))

    tr = tppl.trace(tppl.block(tppl.seed(one, 0), hide=["a"])).get_trace()
    assert tr["a"]["_blocked"]


def test_param_and_plate_shapes():
    def model():
        with tppl.plate("outer", 3):
            with tppl.plate("inner", 2):
                x = tppl.sample("x", tdist.Normal(0.0, 1.0))
        p = tppl.param("p", torch.ones(4))
        return x, p

    x, p = tppl.seed(model, 0)()
    assert x.shape == (3, 2) and p.shape == (4,)
    tr = tppl.trace(tppl.substitute(tppl.seed(model, 0), data={"p": torch.zeros(4)})).get_trace()
    assert tr["p"]["value"].sum() == 0


def test_predictive_prior_and_posterior():
    model = _model(tppl, tdist, torch)
    g = torch.Generator().manual_seed(0)
    prior = tppl.Predictive(model, num_samples=7)(g)
    assert prior["mu"].shape == (7,) and prior["ls"].shape == (7, 2)
    assert prior["y"].shape == (7,)
    post = {"mu": torch.arange(4.0), "ls": torch.ones(4, 2)}
    out = tppl.Predictive(model, posterior_samples=post, return_sites=["double_mu", "y"])(g)
    assert set(out) == {"double_mu", "y"}
    assert_close(out["double_mu"], 2.0 * torch.arange(4.0), 0)
    with pytest.raises(ValueError):
        tppl.Predictive(model)
