"""gpax_torch.distributions against gpax_tpu.distributions on the same inputs."""

import numpy as np
import pytest
import scipy.stats as sps
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


# ------------------------------------- Gamma, Exponential, Uniform, Delta

NEW = [
    ("Gamma", (2.0, 3.0), np.array([0.05, 0.3, 1.0, 2.5]), sps.gamma(2.0, scale=1.0 / 3.0)),
    ("Exponential", (1.7,), np.array([0.01, 0.4, 1.0, 3.0]), sps.expon(scale=1.0 / 1.7)),
    ("Uniform", (-1.0, 3.0), np.array([-0.9, 0.0, 1.5, 2.9]), sps.uniform(-1.0, 4.0)),
]


@pytest.mark.parametrize("name,params,value,ref", NEW)
def test_new_log_prob_matches_jax_and_scipy(name, params, value, ref):
    """tests/test_distributions.py:26-37 for the new families: log_prob and
    its gradients against JAX (float32: a few ulps; Gamma's lgamma against
    gammaln), and the values against SciPy in float64 (rtol 2e-4 as there)."""
    def jf(v, *p):
        return getattr(jdist, name)(*p).log_prob(v)

    def tf(v, *p):
        return getattr(tdist, name)(*p).log_prob(v)

    argnums = tuple(range(1 + len(params)))
    (jv, tv), grads = value_and_grads(jf, tf, [value, *params], argnums)
    assert_close(tv, jv, rtol=1e-6, atol=1e-6)
    for jg, tg in grads:
        assert_close(tg, jg, rtol=1e-5, atol=1e-6)
    assert_close(tv, ref.logpdf(value), rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("name,params,_v,ref", NEW)
def test_new_moments_and_samples(name, params, _v, ref):
    """Moments against JAX's; 40000 draws with the mean within 4 standard
    errors and every draw in the support (the RNG streams differ)."""
    d = getattr(tdist, name)(*params)
    j = getattr(jdist, name)(*params)
    assert_close(d.mean, j.mean, rtol=1e-6)
    if name == "Gamma":
        assert_close(d.variance, j.variance, rtol=1e-6)
    draws = d.sample(torch.Generator().manual_seed(0), (40000,))
    assert draws.shape == (40000,)
    assert abs(draws.mean().item() - ref.mean()) < 4 * ref.std() / 200
    assert bool(d.support(draws).all()) if name != "Uniform" else \
        bool(((draws >= -1.0) & (draws <= 3.0)).all())


def test_new_families_expand_and_batch():
    g = torch.Generator().manual_seed(1)
    assert tdist.Gamma(torch.ones(3), 2.0).sample(g, (5,)).shape == (5, 3)
    assert tdist.Gamma(2.0, 1.0).expand((4, 3)).sample(g).shape == (4, 3)
    assert tdist.Exponential(1.0).expand((2,)).sample(g, (3,)).shape == (3, 2)
    u = tdist.Uniform(torch.zeros(2), torch.tensor([1.0, 2.0]))
    assert u.batch_shape == (2,) and u.sample(g, (6,)).shape == (6, 2)
    assert u.expand((3, 2)).log_prob(torch.full((3, 2), 0.5)).shape == (3, 2)


def test_uniform_log_prob_bounds_and_support():
    """log_prob keeps both bounds inside (the reference's <=), −inf outside;
    its support is the open interval of its own bounds."""
    u = tdist.Uniform(2.0, 5.0)
    j = jdist.Uniform(2.0, 5.0)
    v = np.array([1.999, 2.0, 3.0, 5.0, 5.001], np.float32)
    assert_close(u.log_prob(torch.tensor(v)), j.log_prob(v), rtol=1e-6)
    assert isinstance(u.support, tdist.constraints.Interval)
    assert u.support(torch.tensor([2.0, 3.0, 5.0])).tolist() == [False, True, False]


def test_delta():
    """tests/test_distributions.py:113-117, and log_prob with an event dim."""
    g = torch.Generator().manual_seed(0)
    d = tdist.Delta(torch.tensor([1.0, 2.0]))
    assert d.sample(g).shape == (2,)
    assert d.sample(g).tolist() == [1.0, 2.0]
    assert d.sample(g, (3,)).shape == (3, 2)
    j = jdist.Delta(np.array([1.0, 2.0], np.float32), log_density=-0.5)
    t = tdist.Delta(torch.tensor([1.0, 2.0]), log_density=-0.5)
    assert_close(t.log_prob(torch.zeros(4, 2)), j.log_prob(np.zeros((4, 2), np.float32)), 0)
    e = tdist.Delta(torch.ones(3, 2), log_density=1.5, event_dim=1)
    assert e.batch_shape == (3,) and e.event_shape == (2,)
    assert e.log_prob(torch.ones(3, 2)).tolist() == [1.5] * 3


def test_transforms_roundtrip_and_jacobian():
    """tests/test_distributions.py:92-110 with the port's autograd: the
    bijection of each support round-trips draws, and log|det J| is the log
    of the autograd derivative; SigmoidTransform against JAX's."""
    g = torch.Generator().manual_seed(0)
    for d in (tdist.LogNormal(0.0, 1.0), tdist.Uniform(2.0, 5.0), tdist.Normal(0.0, 1.0),
              tdist.Gamma(2.0, 1.0), tdist.Exponential(1.0)):
        t = tdist.biject_to(d.support)
        y = d.sample(g, (5,))
        x = t.inv(y)
        assert_close(t(x), y, rtol=1e-4, atol=1e-5)
        lad = t.log_abs_det_jacobian(x, t(x))
        for i in range(5):
            xi = x[i].clone().requires_grad_(True)
            (gi,) = torch.autograd.grad(t(xi), xi)
            assert_close(lad[i], torch.log(gi.abs()), rtol=1e-3, atol=1e-5)
    x = np.linspace(-6, 6, 13).astype(np.float32)
    jt = jdist.SigmoidTransform(2.0, 5.0)
    tt = tdist.SigmoidTransform(2.0, 5.0)
    assert_close(tt(torch.tensor(x)), jt(x), rtol=1e-6)
    assert_close(tt.log_abs_det_jacobian(torch.tensor(x), None),
                 jt.log_abs_det_jacobian(x, None), rtol=1e-6, atol=1e-6)


def test_sigmoid_inverse_clip_matches_jax_at_the_bounds():
    """The inverse clips (y − low)/(high − low) to [1e-12, 1 − 1e-12] as JAX
    does; 1 − 1e-12 rounds to 1 in float32 on both sides, so y = high maps
    to +inf in both."""
    y = np.array([2.0, 2.0 + 1e-7, 3.5, 5.0 - 1e-6, 5.0], np.float32)
    ti = tdist.SigmoidTransform(2.0, 5.0).inv(torch.tensor(y)).numpy()
    ji = np.asarray(jdist.SigmoidTransform(2.0, 5.0).inv(y))
    np.testing.assert_array_equal(np.isinf(ti), np.isinf(ji))
    fin = np.isfinite(ji)
    assert_close(ti[fin], ji[fin], rtol=1e-5)


def test_interval_constraints_and_biject_to():
    """nonnegative, Interval/interval/unit_interval; biject_to dispatches any
    Interval by isinstance, its bounds taken to the latent's dtype (float64
    here) and device."""
    c = tdist.constraints
    assert c.nonnegative(torch.tensor([0.0, -1.0])).tolist() == [True, False]
    assert c.unit_interval(torch.tensor([0.5, 1.0])).tolist() == [True, False]
    assert c.interval(0.0, 2.0)(torch.tensor([1.0, 3.0])).tolist() == [True, False]
    assert isinstance(tdist.biject_to(c.nonnegative), tdist.ExpTransform)
    t = tdist.biject_to(c.interval(torch.tensor(1.0), torch.tensor(3.0)))
    assert isinstance(t, tdist.SigmoidTransform)
    x = torch.tensor([-2.0, 0.0, 2.0], dtype=torch.float64)
    y = t(x)
    assert y.dtype == torch.float64 and bool(((y > 1.0) & (y < 3.0)).all())
    assert t.log_abs_det_jacobian(x, y).dtype == torch.float64
    assert_close(t.inv(y), x, rtol=1e-12)
