"""gpax_torch.priors and the utils that came with them (split_dict,
random_sample_dict, dviz, the compat re-export of the prior factories)
against gpax_tpu: tests/test_utils.py:42 and :127-149, and the factories'
distributions held to JAX's."""

import matplotlib

matplotlib.use("Agg")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import gpax_torch  # noqa: E402
import gpax_tpu  # noqa: E402
from _torch_parity import assert_close  # noqa: E402
from gpax_torch import ppl, priors  # noqa: E402
from gpax_torch import utils as tutils  # noqa: E402

torch.set_num_threads(1)


def test_split_and_sample_dict():
    """tests/test_utils.py:42-49."""
    d = {"a": torch.arange(10), "b": torch.arange(20).reshape(10, 2)}
    parts = tutils.split_dict(d, 4)
    assert [p["a"].shape[0] for p in parts] == [4, 4, 2]
    sub = tutils.random_sample_dict(d, 3, torch.Generator().manual_seed(0))
    assert sub["a"].shape == (3,)
    # the same rows of both tensors
    assert torch.equal(sub["b"][:, 0], sub["a"] * 2)
    assert len(set(sub["a"].tolist())) == 3
    # numpy arrays and an integer seed
    subn = tutils.random_sample_dict({"a": np.arange(10)}, 4, 1)
    assert subn["a"].shape == (4,)


def test_priors_factories():
    """tests/test_utils.py:127-136."""
    tr = ppl.trace(ppl.seed(lambda: priors.place_normal_prior("w", 1.0, 2.0), 0))
    sites = tr.get_trace()
    assert "w" in sites
    g = priors.gamma_dist(None, None, torch.tensor([0.0, 4.0]))
    assert_close(g.concentration, 2.0, 0)
    u = priors.uniform_dist(None, None, torch.tensor([1.0, 5.0]))
    assert_close(u.low, 1.0, 0)
    with pytest.raises(ValueError):
        priors.uniform_dist()
    with pytest.raises(ValueError):
        priors.gamma_dist()


def test_auto_priors():
    """tests/test_utils.py:139-149."""
    def fn(x, a, b):
        return a * x + b

    sampler = priors.auto_normal_priors(fn, loc=0.0, scale=2.0)
    tr = ppl.trace(ppl.seed(sampler, 0)).get_trace()
    assert set(tr) == {"a", "b"}
    kern_sampler = priors.auto_lognormal_kernel_priors(lambda X, Z, ell: None)
    tr2 = ppl.trace(ppl.seed(kern_sampler, 0)).get_trace()
    assert set(tr2) == {"ell"}
    assert float(tr2["ell"]["value"]) > 0
    tr3 = ppl.trace(ppl.seed(priors.auto_lognormal_priors(fn), 0)).get_trace()
    assert all(float(s["value"]) > 0 for s in tr3.values())
    assert set(ppl.trace(ppl.seed(priors.auto_normal_kernel_priors(
        lambda X, Z, s, t: None), 0)).get_trace()) == {"s", "t"}


FACTORIES = [
    ("normal_dist", (0.5, 2.0), np.array([-1.0, 0.5, 3.0])),
    ("lognormal_dist", (0.1, 0.7), np.array([0.2, 1.0, 3.0])),
    ("halfnormal_dist", (0.3,), np.array([0.01, 0.2, 1.0])),
    ("gamma_dist", (2.0, 5.0), np.array([0.05, 0.4, 1.5])),
    ("uniform_dist", (3.0, 7.0), np.array([3.0, 4.5, 7.0])),
]


@pytest.mark.parametrize("name,args,value", FACTORIES)
def test_factories_match_jax(name, args, value):
    """Each factory's distribution: the same family and log_prob as JAX's
    (float32, a few ulps), also through the utils re-export."""
    value = value.astype(np.float32)
    t = getattr(priors, name)(*args)
    j = getattr(gpax_tpu.priors, name)(*args)
    assert type(t).__name__ == type(j).__name__
    assert_close(t.log_prob(torch.tensor(value)), j.log_prob(jnp.asarray(value)),
                 rtol=1e-6, atol=1e-6)
    assert getattr(tutils, name) is getattr(priors, name)


def test_data_driven_defaults_match_jax():
    """gamma_dist's shape from half the input's range and uniform_dist's
    missing bounds from its min and max, from numpy and from tensors."""
    x = np.array([0.5, 2.0, -1.0, 3.5], np.float32)
    for arg in (x, torch.tensor(x)):
        g = priors.gamma_dist(None, 2.0, arg)
        jg = gpax_tpu.priors.gamma_dist(None, 2.0, jnp.asarray(x))
        assert_close(g.concentration, jg.concentration, 0)
        u = priors.uniform_dist(None, 4.0, arg)
        ju = gpax_tpu.priors.uniform_dist(None, 4.0, jnp.asarray(x))
        assert_close(u.low, ju.low, 0)
        assert_close(u.high, ju.high, 0)


def test_place_priors_sample_and_score():
    """place_*_prior sample named latents in a model; the uniform and gamma
    ones with their bounds or shape from data, inside the support."""
    X = torch.tensor([1.0, 2.0, 4.0])

    def model():
        priors.place_lognormal_prior("a", 0.0, 1.0)
        priors.place_halfnormal_prior("b", 0.5)
        priors.place_uniform_prior("c", X=X)
        priors.place_gamma_prior("d", X=X)

    tr = ppl.trace(ppl.seed(model, 3)).get_trace()
    assert set(tr) == {"a", "b", "c", "d"}
    assert 1.0 <= float(tr["c"]["value"]) <= 4.0
    assert float(tr["d"]["value"]) > 0 and float(tr["d"]["fn"].concentration) == 1.5
    ld, _ = ppl.log_density(model, params={k: s["value"] for k, s in tr.items()})
    assert bool(torch.isfinite(ld))


def test_structured_gp_with_factory_priors_fits():
    """The factories as ExactGP's lengthscale and noise priors, and a
    Uniform latent in the mean's prior, through a short fit."""
    rng = np.random.default_rng(0)
    X = np.linspace(0, 1.2, 10).astype(np.float32)
    y = (np.sin(5 * X) + 0.05 * rng.normal(size=10)).astype(np.float32)
    gp = gpax_torch.ExactGP(
        1, "Matern", mean_fn=lambda x, p: p["A"] * torch.sin(p["w"] * x).squeeze(),
        mean_fn_prior=lambda: {"A": priors.place_lognormal_prior("A", 0.0, 0.5),
                               "w": priors.place_uniform_prior("w", 3.0, 7.0)},
        lengthscale_prior_dist=priors.gamma_dist(2.0, 5.0),
        noise_prior_dist=priors.halfnormal_dist(0.1))
    gp.fit(0, X, y, num_warmup=20, num_samples=20, print_summary=False, progress_bar=False,
           device="cpu")
    w = gp.get_samples()["w"]
    assert w.shape == (20,) and bool(((w > 3.0) & (w < 7.0)).all())


def test_dviz_draws_a_histogram():
    """dviz on the Agg backend: one figure of the distribution's draws."""
    import matplotlib.pyplot as plt

    plt.close("all")
    tutils.dviz(priors.gamma_dist(2.0, 5.0), samples=200)
    assert len(plt.get_fignums()) == 1
    plt.close("all")
