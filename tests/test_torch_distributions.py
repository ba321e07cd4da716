"""gpax_torch.distributions against gpax_tpu.distributions on the same inputs."""

import numpy as np
import pytest
import torch

import gpax_torch.distributions as tdist
import gpax_tpu.distributions as jdist
from _torch_parity import assert_close, spd, value_and_grads

torch.set_num_threads(1)

SCALAR = [
    ("Normal", (0.3, 1.7), np.array([-2.0, 0.0, 0.5, 3.0])),
    ("LogNormal", (0.2, 0.8), np.array([0.1, 1.0, 2.5, 7.0])),
    ("HalfNormal", (1.3,), np.array([0.01, 0.5, 1.0, 4.0])),
]


@pytest.mark.parametrize("name,params,value", SCALAR)
def test_log_prob_value_and_grads_match_jax(name, params, value):
    def jf(v, *p):
        return getattr(jdist, name)(*p).log_prob(v)

    def tf(v, *p):
        return getattr(tdist, name)(*p).log_prob(v)

    argnums = tuple(range(1 + len(params)))
    (jv, tv), grads = value_and_grads(jf, tf, [value, *params], argnums)
    # closed forms in fp32: a few ulps
    assert_close(tv, jv, rtol=1e-6, atol=1e-6)
    for jg, tg in grads:
        assert_close(tg, jg, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,params,_", SCALAR)
def test_moments_and_sample_statistics(name, params, _):
    d = getattr(tdist, name)(*params)
    ref = getattr(jdist, name)(*params)
    assert_close(d.mean, ref.mean, rtol=1e-6)
    assert_close(d.variance, ref.variance, rtol=1e-6)
    g = torch.Generator().manual_seed(0)
    draws = d.sample(g, (40000,))
    assert draws.shape == (40000,)
    # Monte-Carlo error of the mean: 4 standard errors
    assert abs(draws.mean().item() - float(ref.mean)) < 4 * float(np.sqrt(ref.variance) / 200)
    assert bool(d.support(draws).all())


def test_batch_shapes_broadcast():
    d = tdist.Normal(torch.zeros(3), torch.ones(2, 1))
    assert d.batch_shape == (2, 3)
    g = torch.Generator().manual_seed(1)
    assert d.sample(g, (5,)).shape == (5, 2, 3)
    assert tdist.LogNormal(0.0, 1.0).sample(g, (4, 2)).shape == (4, 2)
    assert tdist.HalfNormal(torch.ones(3)).batch_shape == (3,)


def test_mvn_covariance_log_prob_matches_jax():
    rng = np.random.default_rng(0)
    cov = spd(6, seed=3)
    loc = rng.normal(size=6).astype(np.float32)
    value = rng.normal(size=6).astype(np.float32)

    def jf(v, c):
        return jdist.MultivariateNormal(loc, covariance_matrix=c).log_prob(v)

    def tf(v, c):
        return tdist.MultivariateNormal(torch.tensor(loc), covariance_matrix=c).log_prob(v)

    (jv, tv), [(jgv, tgv), (jgc, tgc)] = value_and_grads(jf, tf, [value, cov], (0, 1))
    assert_close(tv, jv, rtol=1e-5)
    assert_close(tgv, jgv, rtol=1e-4, atol=1e-5)
    # the JAX default backward returns dK up to an antisymmetric part (its
    # 'symmetric_equivalent' gauge) from a compensated bf16 WᵀW (~1e-5 rel):
    # compare the symmetric parts
    assert_close(0.5 * (tgc + tgc.T), 0.5 * (jgc + jgc.T), rtol=1e-3, atol=1e-4)


def test_mvn_scale_tril_log_prob_sample_and_moments():
    cov = spd(4, seed=5)
    L = np.linalg.cholesky(cov).astype(np.float32)
    values = np.random.default_rng(2).normal(size=(3, 4)).astype(np.float32)
    t = tdist.MultivariateNormal(torch.zeros(4), scale_tril=torch.tensor(L))
    j = jdist.MultivariateNormal(np.zeros(4, np.float32), scale_tril=L)
    assert t.batch_shape == () and t.event_shape == (4,)
    assert_close(t.log_prob(torch.tensor(values)), j.log_prob(values), rtol=1e-5)
    assert_close(t.covariance_matrix, cov, rtol=1e-5, atol=1e-6)
    assert_close(t.variance, np.diag(cov), rtol=1e-5)
    draws = t.sample(torch.Generator().manual_seed(3), (30000,))
    assert draws.shape == (30000, 4)
    assert_close(torch.cov(draws.T), cov, rtol=0, atol=0.06)


def test_mvn_batched_covariance_uses_factor_path():
    covs = np.stack([spd(5, seed=s) for s in range(3)])
    value = np.ones(5, np.float32)
    t = tdist.MultivariateNormal(torch.zeros(5), covariance_matrix=torch.tensor(covs))
    j = jdist.MultivariateNormal(np.zeros(5, np.float32), covariance_matrix=covs)
    assert t.batch_shape == (3,)
    assert_close(t.log_prob(torch.tensor(value)), j.log_prob(value), rtol=1e-5)


def test_mvn_needs_exactly_one_matrix():
    with pytest.raises(ValueError):
        tdist.MultivariateNormal(torch.zeros(2))


def test_transforms_and_constraints():
    x = torch.tensor([-1.5, 0.0, 2.0])
    exp = tdist.biject_to(tdist.constraints.positive)
    assert isinstance(exp, tdist.ExpTransform)
    assert_close(exp.inv(exp(x)), x, rtol=1e-6)
    assert_close(exp.log_abs_det_jacobian(x, exp(x)), x, 0)
    for c in (tdist.constraints.real, tdist.constraints.real_vector):
        ident = tdist.biject_to(c)
        assert isinstance(ident, tdist.IdentityTransform)
        assert_close(ident.log_abs_det_jacobian(x, x), torch.zeros(3), 0)
    assert tdist.constraints.positive(torch.tensor([1.0, -1.0])).tolist() == [True, False]
    assert tdist.constraints.real_vector(torch.tensor([[1.0, float("inf")]])).tolist() == [False]
    with pytest.raises(NotImplementedError):
        tdist.biject_to(object())
