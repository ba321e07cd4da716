"""gpax_torch.hypo against gpax_tpu.hypo: tests/test_hypo.py:21-60 (step on an
sPM and on a GP-wrapped hypothesis, the bandit policies, the reward record),
and step's reward held to JAX's on the same data."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpax_torch
import gpax_torch.distributions as dist
import gpax_tpu
from _torch_parity import to_np
from gpax_torch import ppl
from gpax_torch.hypo import sample_next, step, update_record

torch.set_num_threads(1)


def quadratic(x, params):
    return params["a"] * x**2


def quadratic_prior():
    return {"a": ppl.sample("a", dist.Normal(2.0, 1.0))}


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, n).astype(np.float32)
    y = (2.0 * X**2 + 0.05 * rng.normal(size=n)).astype(np.float32)
    return X, y


def test_step_spm():
    """tests/test_hypo.py:21-32."""
    X, y = _data(15)
    X_un = np.linspace(-1.5, 1.5, 9)
    obj, model = step(quadratic, quadratic_prior, X, y, X_un, num_warmup=100,
                      num_samples=100, num_restarts=2, print_summary=False, device="cpu")
    assert obj.shape == (9,)
    assert bool((obj >= 0).all())
    assert abs(model.get_param_means()["a"] - 2.0) < 0.5
    assert isinstance(model, gpax_torch.sPM)


def test_step_gp_wrap():
    """tests/test_hypo.py:35-43: the hypothesis as an ExactGP's mean,
    written for one draw."""
    X, y = _data(12)
    X_un = np.linspace(-1, 1, 7)
    obj, model = step(lambda x, p: p["a"] * x.squeeze() ** 2, quadratic_prior, X, y, X_un,
                      gp_wrap=True, gp_kernel="RBF", num_warmup=80, num_samples=80,
                      print_summary=False, device="cpu")
    assert obj.shape == (7,)
    assert bool((obj >= 0).all()) and bool(torch.isfinite(obj).all())
    assert isinstance(model, gpax_torch.ExactGP) and "a" in model.get_samples()


def test_step_reward_is_the_population_variance():
    """The reward is the predictive draws' variance with ddof 0, as JAX's
    ``var(0)``: the same predict key gives it back."""
    X, y = _data(15)
    X_un = np.linspace(-1.5, 1.5, 9)
    obj, model = step(quadratic, quadratic_prior, X, y, X_un, num_warmup=50,
                      num_samples=50, print_summary=False, device="cpu")
    _, samples = model.predict(gpax_torch.utils.get_keys(0)[1], X_un, device="cpu")
    assert torch.equal(obj, samples.squeeze().var(0, correction=0))


def test_step_spm_reward_matches_jax():
    """The sPM step's reward against JAX's on the same data and budget: the
    noisy predictive variance is dominated by the fitted noise, so the two
    mean rewards agree within 30 % (independent chains)."""
    X, y = _data(15)
    X_un = np.linspace(-1.5, 1.5, 9)
    tobj, _ = step(quadratic, quadratic_prior, X, y, X_un, num_warmup=100, num_samples=100,
                   print_summary=False, device="cpu")

    def jprior():
        return {"a": gpax_tpu.ppl.sample("a", gpax_tpu.distributions.Normal(2.0, 1.0))}

    jobj, _ = gpax_tpu.hypo.step(quadratic, jprior, jnp.asarray(X), jnp.asarray(y),
                                 jnp.asarray(X_un, jnp.float32), num_warmup=100,
                                 num_samples=100, print_summary=False)
    t, j = float(to_np(tobj).mean()), float(np.asarray(jobj).mean())
    assert abs(t - j) < 0.3 * j, (t, j)


def test_sample_next_policies():
    """tests/test_hypo.py:46-54."""
    rewards = np.array([0.1, 0.9, 0.3])
    np.random.seed(0)
    picks = [sample_next(rewards, "softmax", temperature=0.1) for _ in range(20)]
    assert np.bincount(picks, minlength=3).argmax() == 1
    picks = [sample_next(rewards, "eps-greedy", eps=0.0) for _ in range(5)]
    assert all(p == 1 for p in picks)
    with pytest.raises(NotImplementedError):
        sample_next(rewards, "banana")
    with pytest.raises(AttributeError):
        sample_next(np.zeros((2, 2)))
    assert gpax_torch.sample_next is sample_next


def test_update_record():
    """tests/test_hypo.py:57-62."""
    record = np.zeros((3, 2))
    record = update_record(record, 1, 4.0)
    assert record[1, 0] == 1 and record[1, 1] == 4.0
    record = update_record(record, 1, 2.0)
    assert record[1, 0] == 2 and record[1, 1] == 3.0
