"""gpax_torch.acquisition against gpax_tpu.acquisition on the same inputs:
the moment-level functions, the fully Bayesian EI/UCB/POI/UE and the
q-functions on a model with injected posterior draws, the penalties, the
knowledge gradient's fantasy posteriors on the same fantasy draws, Thompson
sampling, and optimize_acq against a dense grid."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpax_torch
import gpax_tpu
from _torch_parity import assert_close
from gpax_torch import acquisition as tacq
from gpax_torch.acquisition.base_acq import fantasy_kg
from gpax_torch.utils import samples_from_numpy
from gpax_tpu import acquisition as jacq

torch.set_num_threads(1)

# float32 moments on both sides (the port's factor in float64): acquisition
# values agree to float32 rounding of the predictive mean and variance
RTOL, ATOL = 1e-3, 1e-5
# optimize_acq's distance to the argmax of UCB on a grid of spacing 1e-3;
# the JAX package's optimize_acq lands within 3.6e-4 of it on this model,
# with either backend and any of three seeds
OPT_TOL = 1e-3

_rng = np.random.default_rng(0)
X_TRAIN = _rng.uniform(-1, 1, 8).astype(np.float32)
Y_TRAIN = np.sin(3 * X_TRAIN).astype(np.float32)
X_CAND = np.linspace(-1.5, 1.5, 20).astype(np.float32)


def _samples(S=5, seed=1):
    rng = np.random.default_rng(seed)
    return {"k_length": rng.uniform(0.3, 1.0, (S, 1)).astype(np.float32),
            "k_scale": rng.uniform(0.5, 2.0, S).astype(np.float32),
            "noise": rng.uniform(0.01, 0.1, S).astype(np.float32)}


class JaxGP(gpax_tpu.ExactGP):
    """A fitted gpax_tpu.ExactGP stand-in: injected draws, real predictive
    path (tests/test_acq.py's mock)."""

    def __init__(self, samples, bayesian=True):
        super().__init__(1, "RBF")
        self._set_training_data(jnp.asarray(X_TRAIN)[:, None], jnp.asarray(Y_TRAIN))
        self.mcmc = 1 if bayesian else None
        self._s = {k: jnp.asarray(v if bayesian else v[0]) for k, v in samples.items()}

    def get_samples(self, chain_dim=False):
        return self._s


class TorchGP(gpax_torch.ExactGP):
    """The same stand-in for a gpax_torch.ExactGP, on the CPU; without
    ``bayesian``, a point estimate (the first draw)."""

    def __init__(self, samples, bayesian=True):
        super().__init__(1, "RBF")
        self._set_training_data(X_TRAIN[:, None], Y_TRAIN, device="cpu")
        self.mcmc = object() if bayesian else None
        self._s = samples_from_numpy(
            samples if bayesian else {k: v[0] for k, v in samples.items()}, device="cpu")

    def get_samples(self, chain_dim=False):
        return self._s


def _pair():
    s = _samples()
    return JaxGP(s), TorchGP(s)


@pytest.mark.parametrize("maximize", [False, True])
@pytest.mark.parametrize("best_f", [None, 0.3])
def test_base_functions_match_jax(maximize, best_f):
    """On the same numpy moments, one vector and a (q, m) batch whose rows
    the JAX package scores one by one."""
    rng = np.random.default_rng(3)
    mean = rng.normal(size=(3, 11)).astype(np.float32)
    var = rng.uniform(0.01, 1.0, (3, 11)).astype(np.float32)
    jfns = {"ei": lambda mo: jacq.ei(mo, best_f, maximize),
            "ucb": lambda mo: jacq.ucb(mo, 2.0, maximize),
            "poi": lambda mo: jacq.poi(mo, best_f, 0.05, maximize),
            "ue": jacq.ue}
    tfns = {"ei": lambda mo: tacq.ei(mo, best_f, maximize),
            "ucb": lambda mo: tacq.ucb(mo, 2.0, maximize),
            "poi": lambda mo: tacq.poi(mo, best_f, 0.05, maximize),
            "ue": tacq.ue}
    for name in jfns:
        jrows = jax.vmap(lambda m, v: jfns[name]((m, v)))(jnp.asarray(mean), jnp.asarray(var))
        assert_close(tfns[name]((torch.as_tensor(mean), torch.as_tensor(var))), jrows,
                     rtol=1e-5, atol=1e-6)
        assert_close(tfns[name]((torch.as_tensor(mean[0]), torch.as_tensor(var[0]))),
                     jfns[name]((jnp.asarray(mean[0]), jnp.asarray(var[0]))),
                     rtol=1e-5, atol=1e-6)


def test_normal_cdf_icdf_match_jax():
    """Normal.cdf into the lower tail, where ei and poi read it, and icdf."""
    x = np.array([-12.0, -8.0, -5.3, -5.0, -3.0, -0.4, 0.0, 1.2, 6.0], np.float32)
    loc, scale = np.float32(0.3), np.float32(1.7)
    jn = gpax_tpu.distributions.Normal(jnp.asarray(loc), jnp.asarray(scale))
    tn = gpax_torch.distributions.Normal(torch.tensor(loc), torch.tensor(scale))
    assert_close(tn.cdf(torch.as_tensor(x * scale + loc)), jn.cdf(jnp.asarray(x * scale + loc)),
                 rtol=1e-5)
    q = np.array([1e-6, 0.025, 0.5, 0.9, 0.999], np.float32)
    assert_close(tn.icdf(torch.as_tensor(q)), jn.icdf(jnp.asarray(q)), rtol=1e-5)
    e = tacq.ei((torch.linspace(0.0, 40.0, 4001), torch.ones(4001)), best_f=0.0)  # u in [-40, 0]
    assert bool((e >= -1e-30).all())  # float32 subnormals below u ~ -13
    u = -torch.linspace(0.0, 40.0, 4001, dtype=torch.float64)
    ref = torch.exp(-u * u / 2) / math.sqrt(2 * math.pi) + u * 0.5 * torch.special.erfc(
        -u / math.sqrt(2))
    big = ref > 1e-20  # u > -9.1; float32's exp(-u²/2) loses ~u²·eps relative below
    assert_close(e.double()[big], ref[big], rtol=1e-3, atol=0)


@pytest.mark.parametrize("name", ["EI", "UCB", "POI", "UE"])
def test_bayesian_acquisitions_match_jax(name):
    """The exact mixture moments of the injected draws (predict_moments on
    both sides), then the acquisition; once more with a delta penalty."""
    jm, tm = _pair()
    j = getattr(jacq, name)(jax.random.PRNGKey(0), jm, jnp.asarray(X_CAND))
    t = getattr(tacq, name)(0, tm, X_CAND)
    assert t.shape == (20,)
    assert_close(t, j, rtol=RTOL, atol=ATOL)
    recent = X_CAND[[3, 7]][:, None]
    jp = getattr(jacq, name)(jax.random.PRNGKey(0), jm, jnp.asarray(X_CAND), penalty="delta",
                             recent_points=recent)
    tp = getattr(tacq, name)(0, tm, X_CAND, penalty="delta", recent_points=recent)
    assert bool(torch.isneginf(tp[[3, 7]]).all())
    assert_close(tp, jp, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("penalty", ["delta", "inverse_distance", "inverse distance"])
def test_penalties_match_jax(penalty):
    X = np.linspace(0, 1, 7, dtype=np.float32)[:, None]
    for recent in (np.array([[0.0]], np.float32), X[[1, 4, 6]]):
        j = jacq.compute_penalty(jnp.asarray(X), jnp.asarray(recent), penalty, 2.0)
        t = tacq.compute_penalty(torch.as_tensor(X), recent, penalty, 2.0)
        assert_close(t, j, rtol=1e-6)
    with pytest.raises(NotImplementedError):
        tacq.compute_penalty(torch.as_tensor(X), X[:1], "gaussian")


def _sorted_rows(a):
    a = np.asarray(a)
    return a[np.argsort(a.sum(-1))]


@pytest.mark.parametrize("name", ["qEI", "qUCB", "qPOI"])
def test_batch_acquisitions_match_jax(name):
    """With subsample_size equal to the number of draws, the rows are each
    draw's acquisition, in the order of a permutation: the same set as the
    JAX package's."""
    jm, tm = _pair()
    j = getattr(jacq, name)(jax.random.PRNGKey(0), jm, jnp.asarray(X_CAND), subsample_size=5)
    t = getattr(tacq, name)(0, tm, X_CAND, subsample_size=5)
    assert t.shape == (5, 20)
    assert_close(_sorted_rows(t.numpy()), _sorted_rows(j), rtol=RTOL, atol=ATOL)
    t_md = getattr(tacq, name)(1, tm, X_CAND, subsample_size=2, maximize_distance=True, n_evals=3)
    assert t_md.shape == (2, 20) and bool(torch.isfinite(t_md).all())
    with pytest.raises(ValueError):
        getattr(tacq, name)(0, TorchGP(_samples(), bayesian=False), X_CAND)


def _mtgp_pair():
    rng = np.random.default_rng(4)
    X = np.column_stack([rng.uniform(0, 2, 12), np.repeat([0.0, 1.0], 6)]).astype(np.float32)
    y = (np.sin(3 * X[:, 0]) + 0.1 * X[:, 1]).astype(np.float32)
    jm = gpax_tpu.MultiTaskGP(1, "Matern", num_latents=1, num_tasks=2)
    tm = gpax_torch.MultiTaskGP(1, "Matern", num_latents=1, num_tasks=2)
    jm._set_training_data(jnp.asarray(X), jnp.asarray(y))
    tm._set_training_data(X, y, device="cpu")
    sample = {"k_length": np.array([[0.5]], np.float32), "k_scale": np.ones(1, np.float32),
              "W": np.array([[[0.9], [0.7]]], np.float32), "v": np.array([[0.3, 0.2]], np.float32),
              "noise": np.array([0.01, 0.02], np.float32)}
    Xn = np.column_stack([np.linspace(0, 2, 6), np.ones(6)]).astype(np.float32)
    return jm, tm, sample, Xn


@pytest.mark.parametrize("kind", ["ExactGP", "MultiTaskGP"])
@pytest.mark.parametrize("maximize", [True, False])
def test_kg_fantasy_posterior_matches_jax(kind, maximize):
    """The JAX package's kg and the port's fantasy_kg on the SAME fantasy
    draws: drawn in JAX with JAX's key, as gpax_tpu/acquisition/base_acq.py
    draws them, and handed to the port."""
    if kind == "ExactGP":
        jm, tm = _pair()
        sample = {k: v[0] for k, v in _samples().items()}
        Xn = X_CAND[:6, None]
    else:
        jm, tm, sample, Xn = _mtgp_pair()
    key = jax.random.PRNGKey(7)
    js = {k: jnp.asarray(v) for k, v in sample.items()}
    j = jax.jit(lambda p: gpax_tpu.acquisition.kg(jm, jnp.asarray(Xn), p, key, n=3,
                                                  maximize=maximize))(js)

    @jax.jit
    def fantasies(p):
        mean, cov = jm.get_mvn_posterior(jnp.asarray(Xn), p, noiseless=True)
        return gpax_tpu.distributions.MultivariateNormal(mean, covariance_matrix=cov).sample(
            key, sample_shape=(3,))

    y_sim = fantasies(js)
    ts = {k: torch.as_tensor(v) for k, v in sample.items()}
    Xt = torch.as_tensor(Xn)
    t_mean, _ = tm.get_mvn_posterior(Xt, ts, noiseless=True)
    t = fantasy_kg(tm, Xt, (ts,), torch.tensor(np.asarray(y_sim)), t_mean, maximize)
    assert t.shape == (6,)
    assert_close(t, j, rtol=RTOL, atol=1e-4)
    assert tm.X_train.shape == jm.X_train.shape  # the caller's model is untouched


def test_kg_and_thompson_shapes():
    _, tm = _pair()
    assert tacq.KG(0, tm, X_CAND[:6], n=2).shape == (5, 6)
    assert tacq.KG(0, TorchGP(_samples(), bayesian=False), X_CAND[:6], n=2).shape == (6,)
    k = tacq.KG(0, tm, X_CAND[:6], n=2, penalty="delta", recent_points=X_CAND[[1]][:, None])
    assert bool(torch.isneginf(k[:, 1]).all()) and bool(torch.isfinite(k[:, [0, 2]]).all())
    assert tacq.qKG(0, tm, X_CAND[:6], subsample_size=2).shape == (2, 6)
    t = tacq.Thompson(0, tm, X_CAND)
    assert t.squeeze().shape == (20,) and bool(torch.isfinite(t).all())


@pytest.mark.parametrize("backend", ["optax", "scipy"])
@pytest.mark.parametrize("maximize", [False, True])
def test_optimize_acq_finds_the_grid_argmax(backend, maximize):
    _, tm = _pair()
    grid = np.linspace(-1.5, 1.5, 3001).astype(np.float32)
    x_grid = grid[int(tacq.UCB(0, tm, grid, maximize=maximize).argmax())]
    x = tacq.optimize_acq(0, tm, tacq.UCB, 8, -1.5, 1.5, num_steps=50, backend=backend,
                          maximize=maximize)
    assert x.shape == (1,) and -1.5 <= float(x[0]) <= 1.5
    assert abs(float(x[0]) - x_grid) <= OPT_TOL
