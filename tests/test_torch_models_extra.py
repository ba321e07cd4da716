"""gpax_torch's remaining GP models against gpax_tpu's: vExactGP,
VarNoiseGP, UIGP, MeasuredNoiseGP (with LinReg), iBNN and vi_iBNN, the NNGP
kernel, HalfCauchy, cho_solve and the function adapters of utils.fn.

The potentials (or the model's log density, for the SVI models) and their
gradients are held to JAX at the same unconstrained point, and the
predictive math to JAX on the same injected posterior draws; the small fits
check the shapes of tests/test_models_extra.py (the RNG streams of the two
packages differ, so fitted values are not compared draw for draw)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpax_torch
import gpax_tpu
from _torch_parity import assert_close, to_np
from gpax_torch.utils import samples_from_numpy

torch.set_num_threads(1)

# potentials and their gradients at cond(K) ≤ ~1e4: float32 grams on both
# sides, the port's factor in float64 (as tests/test_torch_mtgp.py)
POT_RTOL = 1e-4
# predictive means and covariances on injected draws: float32 grams
RTOL, ATOL = 2e-4, 2e-5
FIT = dict(print_summary=False, progress_bar=False, device="cpu")


@pytest.fixture
def jax_fp32_wtw():
    old = gpax_tpu.get_config().wtw_precision
    gpax_tpu.set_config(wtw_precision="highest")
    yield
    gpax_tpu.set_config(wtw_precision=old)


def _potentials(jm, tm, args_np, z):
    """(JAX value, grads), (port value, grads) of the two models' potentials
    at the unconstrained point z (numpy), on the same data."""
    jargs = tuple(jnp.asarray(a) for a in args_np)
    targs = tuple(torch.as_tensor(a) for a in args_np)
    jinfo = gpax_tpu.ppl.initialize_model(jm.model, jax.random.PRNGKey(0), jargs)
    tinfo = gpax_torch.ppl.initialize_model(tm.model, torch.Generator().manual_seed(0), targs)
    assert set(jinfo.init_unconstrained) == set(tinfo.init_unconstrained) == set(z)
    for k, v in z.items():
        assert tuple(tinfo.init_unconstrained[k].shape) == np.shape(v), k
    ju, jg = jax.jit(jax.value_and_grad(jinfo.potential_fn))(
        {k: jnp.asarray(v) for k, v in z.items()})
    tz = {k: torch.tensor(np.asarray(v), requires_grad=True) for k, v in z.items()}
    tu = tinfo.potential_fn(tz)
    tu.backward()
    return (ju, jg), (tu, {k: v.grad for k, v in tz.items()})


def _assert_potentials(jm, tm, args_np, z, rtol=POT_RTOL):
    (ju, jg), (tu, tg) = _potentials(jm, tm, args_np, z)
    assert_close(tu, ju, rtol=rtol)
    for k in z:
        assert_close(tg[k], jg[k], rtol=rtol, atol=rtol)


def _posterior_vs_jax(jm, tm, X_new, draws, rtol=RTOL, atol=ATOL, **kw):
    """get_mvn_posterior of a chunk of injected draws in the port against
    JAX's per draw (vmapped)."""
    jd = {k: jnp.asarray(v) for k, v in draws.items()}
    jmean, jcov = jax.vmap(lambda p: jm.get_mvn_posterior(jnp.asarray(X_new), p, **kw))(jd)
    tmean, tcov = tm.get_mvn_posterior(torch.as_tensor(X_new),
                                       samples_from_numpy(draws, device="cpu"), **kw)
    assert tuple(tmean.shape) == jmean.shape and tuple(tcov.shape) == jcov.shape
    assert_close(tmean, jmean, rtol=rtol, atol=atol)
    assert_close(tcov, jcov, rtol=rtol, atol=atol)
    return tmean, tcov


# ---------------------------------------------------------------- vExactGP

def _vdata(T=2, n=12, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (T, n, 1)).astype(np.float32)
    y = (np.sin(3 * X[..., 0]) + 0.05 * rng.normal(size=(T, n))).astype(np.float32)
    return X, y


def test_vexactgp_potential_matches_jax(jax_fp32_wtw):
    X, y = _vdata()
    z = {"k_length": np.log([[0.6], [0.9]]).astype(np.float32),
         "k_scale": np.log([1.2, 0.8]).astype(np.float32),
         "noise": np.log([0.05, 0.1]).astype(np.float32)}
    _assert_potentials(gpax_tpu.vExactGP(1, "RBF"), gpax_torch.vExactGP(1, "RBF"), (X, y), z)


@pytest.mark.parametrize("noiseless", [False, True])
def test_vexactgp_predictive_on_injected_draws_matches_jax(noiseless):
    X, y = _vdata()
    rng = np.random.default_rng(3)
    S = 4
    draws = {"k_length": rng.uniform(0.4, 1.2, (S, 2, 1)).astype(np.float32),
             "k_scale": rng.uniform(0.5, 2.0, (S, 2)).astype(np.float32),
             "noise": rng.uniform(0.02, 0.2, (S, 2)).astype(np.float32)}
    jm, tm = gpax_tpu.vExactGP(1, "RBF"), gpax_torch.vExactGP(1, "RBF")
    jm.X_train, jm.y_train = jnp.asarray(X), jnp.asarray(y)
    tm.X_train, tm.y_train = torch.as_tensor(X), torch.as_tensor(y)
    X_new = rng.uniform(-1, 1, (2, 7, 1)).astype(np.float32)
    _posterior_vs_jax(jm, tm, X_new, draws, noiseless=noiseless)


def test_vexactgp_fit_shapes():
    """tests/test_models_extra.py:23-37 on the port."""
    rng = np.random.default_rng(0)
    X = rng.uniform(-1, 1, (2, 12)).astype(np.float32)
    y = np.sin(3 * X).astype(np.float32)
    m = gpax_torch.vExactGP(1, "RBF")
    m.fit(0, X, y, num_warmup=30, num_samples=30, **FIT)
    s = m.get_samples()
    assert s["k_length"].shape == (30, 2, 1) and s["noise"].shape == (30, 2)
    mean, sampled = m.predict(1, rng.uniform(-1, 1, (2, 7)).astype(np.float32), device="cpu")
    assert mean.shape == (2, 7) and sampled.shape == (30, 1, 2, 7)
    assert bool(torch.isfinite(mean).all()) and bool(torch.isfinite(sampled).all())
    mean_b, sampled_b = m.predict_in_batches(1, rng.uniform(-1, 1, (2, 9)).astype(np.float32),
                                             batch_size=4, device="cpu")
    assert mean_b.shape == (2, 9) and sampled_b.shape == (30, 1, 2, 9)


# -------------------------------------------------------------- VarNoiseGP

def _hsk_data(n=16, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, n).astype(np.float32)
    y = (np.sin(3 * X) + np.abs(X) * rng.normal(0, 0.5, n)).astype(np.float32)
    return X, y


def _hsk_point(n=16, seed=4):
    """A point whose noise gram is well conditioned (short noise
    lengthscale): the noise GP's jitter is only 1e-6."""
    rng = np.random.default_rng(seed)
    return {"k_noise_scale": np.float32(np.log(0.7)), "k_noise_length": np.float32(np.log(0.1)),
            "log_var": (rng.normal(size=n) * 0.5 - 2.0).astype(np.float32),
            "k_length": np.log([0.5]).astype(np.float32), "k_scale": np.float32(np.log(1.1))}


def test_varnoise_potential_matches_jax(jax_fp32_wtw):
    """On evenly spaced inputs, where the noise gram's condition number
    stays near 1e2 (two of _hsk_data's random points lie close enough to
    put it at 1e6, beyond what float32 grams resolve)."""
    _, y = _hsk_data()
    X = np.linspace(-1, 1, 16, dtype=np.float32)
    _assert_potentials(gpax_tpu.VarNoiseGP(1, "RBF"), gpax_torch.VarNoiseGP(1, "RBF"),
                       (X[:, None], y), _hsk_point())


def test_varnoise_predictive_on_injected_draws_matches_jax():
    """The main posterior's training gram carries only the jitter (the
    noise is the latent field's), so the draws' lengthscales are short
    enough to keep it near cond 1e2 on evenly spaced inputs."""
    _, y = _hsk_data()
    X = np.linspace(-1, 1, 16, dtype=np.float32)
    rng = np.random.default_rng(5)
    S = 3
    draws = {"k_noise_scale": rng.uniform(0.5, 1.0, S).astype(np.float32),
             "k_noise_length": rng.uniform(0.08, 0.12, S).astype(np.float32),
             "log_var": (rng.normal(size=(S, 16)) * 0.5 - 2.0).astype(np.float32),
             "k_length": rng.uniform(0.08, 0.12, (S, 1)).astype(np.float32),
             "k_scale": rng.uniform(0.8, 1.5, S).astype(np.float32)}
    jm, tm = gpax_tpu.VarNoiseGP(1, "RBF"), gpax_torch.VarNoiseGP(1, "RBF")
    jm.X_train, jm.y_train = jnp.asarray(X[:, None]), jnp.asarray(y)
    tm.X_train, tm.y_train = torch.as_tensor(X[:, None]), torch.as_tensor(y)
    X_new = np.linspace(-1, 1, 9, dtype=np.float32)[:, None]
    _posterior_vs_jax(jm, tm, X_new, draws)


def test_varnoise_fit_shapes():
    """tests/test_models_extra.py:40-59 on the port, at tree depth 4 (the
    latent log-variance field makes every tree of the default depth run
    its 1023 leapfrogs at this size)."""
    X, y = _hsk_data()
    m = gpax_torch.VarNoiseGP(1, "RBF")
    m.fit(0, X, y, num_warmup=20, num_samples=20, max_tree_depth=4, **FIT)
    s = m.get_samples()
    assert "k_noise_length" in s and s["log_var"].shape == (20, 16)
    var_samples = m.get_data_var_samples()
    assert var_samples.shape == (20, 16) and bool((var_samples > 0).all())
    mean, sampled = m.predict(1, np.linspace(-1, 1, 9), device="cpu")
    assert mean.shape == (9,) and sampled.shape == (20, 1, 9)
    assert bool(torch.isfinite(mean).all())


# -------------------------------------------------------------------- UIGP

def _ui_data(n=12, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, n).astype(np.float32)
    return X, np.sin(5 * X).astype(np.float32)


def test_uigp_potential_matches_jax(jax_fp32_wtw):
    X, y = _ui_data()
    rng = np.random.default_rng(6)
    z = {"sigma_x": np.log([0.08]).astype(np.float32),
         "X_prime": (X[:, None] + 0.03 * rng.normal(size=(12, 1))).astype(np.float32),
         "k_length": np.log([0.4]).astype(np.float32), "k_scale": np.float32(np.log(1.3)),
         "noise": np.float32(np.log(0.05))}
    jm, tm = gpax_tpu.UIGP(1, "RBF"), gpax_torch.UIGP(1, "RBF")
    assert not tm._input_is_constant
    _assert_potentials(jm, tm, (X[:, None], y), z)


def test_uigp_predictive_on_injected_draws_matches_jax():
    X, y = _ui_data()
    rng = np.random.default_rng(7)
    S = 3
    draws = {"sigma_x": rng.uniform(0.05, 0.1, (S, 1)).astype(np.float32),
             "X_prime": (X[None, :, None] + 0.03 * rng.normal(size=(S, 12, 1))).astype(
                 np.float32),
             "k_length": rng.uniform(0.3, 0.6, (S, 1)).astype(np.float32),
             "k_scale": rng.uniform(0.8, 1.5, S).astype(np.float32),
             "noise": rng.uniform(0.02, 0.1, S).astype(np.float32)}
    jm, tm = gpax_tpu.UIGP(1, "RBF"), gpax_torch.UIGP(1, "RBF")
    jm.X_train, jm.y_train = jnp.asarray(X[:, None]), jnp.asarray(y)
    tm.X_train, tm.y_train = torch.as_tensor(X[:, None]), torch.as_tensor(y)
    _posterior_vs_jax(jm, tm, np.linspace(0, 1, 7, dtype=np.float32)[:, None], draws,
                      noiseless=True)


def test_uigp_fit_shapes_and_warning():
    """tests/test_models_extra.py:62-74 on the port: the default sigma_x
    prior's warning on inputs not spanning (0, 1)."""
    X, y = _ui_data()
    m = gpax_torch.UIGP(1, "RBF")
    with pytest.warns(UserWarning, match="sigma_x"):
        m.fit(0, X, y, num_warmup=30, num_samples=30, max_tree_depth=6, **FIT)
    s = m.get_samples()
    assert s["sigma_x"].shape == (30, 1) and s["X_prime"].shape == (30, 12, 1)
    mean, sampled = m.predict(1, np.linspace(0, 1, 7), n=2, device="cpu")
    assert mean.shape == (7,) and sampled.shape == (30, 2, 7)
    assert bool(torch.isfinite(mean).all())


# --------------------------------------------------- MeasuredNoiseGP, LinReg

def _mn_data(n=14, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, n).astype(np.float32)
    noise = rng.uniform(0.01, 0.05, n).astype(np.float32)
    return X, noise, np.sin(3 * X).astype(np.float32)


def test_measured_noise_potential_matches_jax(jax_fp32_wtw):
    X, noise, y = _mn_data()
    z = {"k_length": np.log([0.5]).astype(np.float32), "k_scale": np.float32(np.log(1.4))}
    _assert_potentials(gpax_tpu.MeasuredNoiseGP(1, "RBF"), gpax_torch.MeasuredNoiseGP(1, "RBF"),
                       (X[:, None], y, noise), z)


def test_measured_noise_predictive_on_injected_draws_matches_jax():
    """The predictive moments, and the variance the draws are made from
    (the covariance's diagonal plus the extrapolated noise), on injected
    draws and injected noise predictions. The posterior's training gram
    carries only the jitter (noise 0, as in the JAX package), so the inputs
    are evenly spaced and the lengthscales short, near cond 1e2."""
    _, noise, y = _mn_data()
    X = np.linspace(-1, 1, 14, dtype=np.float32)
    rng = np.random.default_rng(8)
    S = 3
    draws = {"k_length": rng.uniform(0.08, 0.12, (S, 1)).astype(np.float32),
             "k_scale": rng.uniform(0.8, 1.5, S).astype(np.float32),
             "noise": np.zeros(S, np.float32)}
    jm, tm = gpax_tpu.MeasuredNoiseGP(1, "RBF"), gpax_torch.MeasuredNoiseGP(1, "RBF")
    jm.X_train, jm.y_train = jnp.asarray(X[:, None]), jnp.asarray(y)
    tm.X_train, tm.y_train = torch.as_tensor(X[:, None]), torch.as_tensor(y)
    X_new = np.linspace(-1, 1, 8, dtype=np.float32)[:, None]
    _, tcov = _posterior_vs_jax(jm, tm, X_new, draws, noiseless=True)
    nz = rng.uniform(0.01, 0.05, 8).astype(np.float32)
    g = torch.Generator().manual_seed(0)
    tmean, tdraws = tm._predict(g, torch.as_tensor(X_new), samples_from_numpy(draws),
                                torch.as_tensor(nz), 20000, True)
    # draws (S, n, m) from N(mean, diag(cov) + noise): Monte-Carlo error
    # of 20000 draws, ~1 % of the standard deviation
    assert tdraws.shape == (S, 20000, 8)
    sd = torch.sqrt(tcov.diagonal(dim1=-2, dim2=-1) + torch.as_tensor(nz))
    assert_close(tdraws.std(1), sd, rtol=0.03)
    assert_close(tdraws.mean(1), tmean, rtol=0, atol=0.05 * float(sd.max()))


def test_linreg_log_density_matches_jax():
    X, noise, _ = _mn_data()
    params = {"beta": np.array([0.3], np.float32), "alpha": np.float32(0.1),
              "sigma": np.float32(0.2)}
    jld, _ = gpax_tpu.ppl.log_density(gpax_tpu.LinReg.model, (jnp.asarray(X[:, None]),
                                                               jnp.asarray(noise)), {},
                                      {k: jnp.asarray(v) for k, v in params.items()})
    tld, _ = gpax_torch.ppl.log_density(gpax_torch.LinReg.model,
                                        (torch.as_tensor(X[:, None]), torch.as_tensor(noise)),
                                        {}, {k: torch.as_tensor(v) for k, v in params.items()})
    assert_close(tld, jld, rtol=1e-5)


def test_halfcauchy_matches_jax():
    v = np.array([0.01, 0.3, 1.0, 4.0, 50.0], np.float32)
    for scale in (0.5, 1.0, 3.0):
        assert_close(gpax_torch.distributions.HalfCauchy(scale).log_prob(torch.as_tensor(v)),
                     gpax_tpu.distributions.HalfCauchy(scale).log_prob(jnp.asarray(v)),
                     rtol=1e-6)
    d = gpax_torch.distributions.HalfCauchy(2.0).sample(torch.Generator().manual_seed(0),
                                                        (20000,))
    assert bool((d > 0).all()) and abs(float(d.median()) - 2.0) < 0.1  # median = scale


@pytest.mark.parametrize("seed", [0, 3])
def test_linreg_fit_recovers_a_line(seed):
    """5000 Adam steps of the SVI fit from the prior medians recover an
    intercept and slope to the noise level (from one prior draw, as the JAX
    package starts, seeds 0 and 3 ended on a plateau of large sigma)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, 40).astype(np.float32)
    y = (0.5 + 2.0 * x + 0.05 * rng.normal(size=40)).astype(np.float32)
    lr = gpax_torch.LinReg()
    lr.train(x[:, None], y, device="cpu", rng_key=seed)
    p = lr.get_params()
    assert p["beta"].shape == (1,) and p["alpha"].shape == ()
    assert abs(float(p["alpha"]) - 0.5) < 0.05 and abs(float(p["beta"][0]) - 2.0) < 0.1
    pred = lr.predict(np.array([0.0, 1.0], np.float32))
    assert_close(pred, [float(p["alpha"]), float(p["alpha"] + p["beta"][0])], rtol=1e-6)


@pytest.mark.parametrize("method", ["linreg", "gpreg"])
def test_measured_noise_fit_shapes(method):
    """tests/test_models_extra.py:77-92 on the port, with both noise
    prediction methods."""
    X, noise, y = _mn_data()
    m = gpax_torch.MeasuredNoiseGP(1, "RBF")
    m.fit(0, X, y, noise, num_warmup=30, num_samples=30, **FIT)
    s = m.get_samples()
    assert s["noise"].shape == (30,) and float(s["noise"].abs().max()) == 0.0
    mean, sampled = m.predict(1, np.linspace(-1, 1, 8), n=2, noise_prediction_method=method,
                              device="cpu")
    assert mean.shape == (8,) and sampled.shape == (30, 2, 8)
    assert m.noise_predicted.shape == (8,) and bool(torch.isfinite(sampled).all())
    with pytest.raises(NotImplementedError):
        m.predict(1, np.linspace(-1, 1, 8), noise_prediction_method="spline", device="cpu")


# ------------------------------------------------------ NNGP, iBNN, vi_iBNN

@pytest.mark.parametrize("activation", ["erf", "relu"])
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_nngp_kernel_matches_jax(activation, depth):
    rng = np.random.default_rng(depth)
    X = rng.normal(size=(9, 3)).astype(np.float32)
    Z = rng.normal(size=(5, 3)).astype(np.float32)
    p = {"var_b": np.float32(0.4), "var_w": np.float32(1.7)}
    jk = gpax_tpu.kernels.get_kernel("NNGP", activation=activation, depth=depth)
    tk = gpax_torch.kernels.get_kernel("NNGP", activation=activation, depth=depth)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    for A, B in ((X, X), (X, Z)):
        assert_close(tk(torch.as_tensor(A), torch.as_tensor(B), tp, 0.1),
                     jk(jnp.asarray(A), jnp.asarray(B), jp, 0.1), rtol=1e-5, atol=1e-6)
    pair = gpax_torch.kernels.nngp_erf if activation == "erf" else gpax_torch.kernels.nngp_relu
    jpair = gpax_tpu.kernels.nngp_erf if activation == "erf" else gpax_tpu.kernels.nngp_relu
    assert_close(pair(torch.as_tensor(X[0]), torch.as_tensor(Z[1]), 0.4, 1.7, depth),
                 jpair(jnp.asarray(X[0]), jnp.asarray(Z[1]), 0.4, 1.7, depth), rtol=1e-5)
    # a batch of draws of (var_b, var_w) gives each draw's gram
    tb = {"var_b": torch.tensor([0.4, 0.9]), "var_w": torch.tensor([1.7, 0.6])}
    Kb = tk(torch.as_tensor(X), torch.as_tensor(X), tb, torch.tensor([0.1, 0.2]))
    for i in range(2):
        assert_close(Kb[i], tk(torch.as_tensor(X), torch.as_tensor(X),
                               {k: v[i] for k, v in tb.items()}, 0.1 + 0.1 * i), rtol=1e-6)


def test_ibnn_potential_and_predictive_match_jax(jax_fp32_wtw):
    rng = np.random.default_rng(0)
    X = rng.uniform(-1, 1, (10, 1)).astype(np.float32)
    y = np.sin(2 * X[:, 0]).astype(np.float32)
    z = {"var_b": np.float32(np.log(0.5)), "var_w": np.float32(np.log(1.5)),
         "noise": np.float32(np.log(0.05))}
    jm = gpax_tpu.iBNN(1, depth=2, activation="erf")
    tm = gpax_torch.iBNN(1, depth=2, activation="erf")
    _assert_potentials(jm, tm, (X, y), z)
    draws = {"var_b": np.array([0.5, 0.8], np.float32), "var_w": np.array([1.5, 0.9], np.float32),
             "noise": np.array([0.05, 0.1], np.float32)}
    jm.X_train, jm.y_train = jnp.asarray(X), jnp.asarray(y)
    tm.X_train, tm.y_train = torch.as_tensor(X), torch.as_tensor(y)
    _posterior_vs_jax(jm, tm, np.linspace(-1, 1, 6, dtype=np.float32)[:, None], draws)


def test_vi_ibnn_log_density_and_predictive_match_jax():
    """vi_iBNN's model log density at the same latents (the ELBO's model
    term) and its predictive moments at a point estimate."""
    rng = np.random.default_rng(0)
    X = rng.uniform(-1, 1, (10, 1)).astype(np.float32)
    y = np.sin(2 * X[:, 0]).astype(np.float32)
    jm = gpax_tpu.vi_iBNN(1, depth=2, activation="relu")
    tm = gpax_torch.vi_iBNN(1, depth=2, activation="relu")
    lat = {"var_b": np.float32(0.3), "var_w": np.float32(2.0), "noise": np.float32(0.05)}
    jld, _ = gpax_tpu.ppl.log_density(jm.model, (jnp.asarray(X), jnp.asarray(y)), {},
                                      {k: jnp.asarray(v) for k, v in lat.items()})
    tld, _ = gpax_torch.ppl.log_density(tm.model, (torch.as_tensor(X), torch.as_tensor(y)), {},
                                        {k: torch.as_tensor(v) for k, v in lat.items()})
    assert_close(tld, jld, rtol=POT_RTOL)
    jm.X_train, jm.y_train = jnp.asarray(X), jnp.asarray(y)
    tm.X_train, tm.y_train = torch.as_tensor(X), torch.as_tensor(y)
    _posterior_vs_jax(jm, tm, np.linspace(-1, 1, 6, dtype=np.float32)[:, None],
                      {k: np.asarray(v)[None] for k, v in lat.items()})


def test_ibnn_and_vi_ibnn_fit_shapes():
    """tests/test_models_extra.py:122-150 on the port."""
    rng = np.random.default_rng(0)
    X = rng.uniform(-1, 1, 10).astype(np.float32)
    y = np.sin(2 * X).astype(np.float32)
    m = gpax_torch.iBNN(1, depth=2, activation="erf")
    m.fit(0, X, y, num_warmup=30, num_samples=30, **FIT)
    s = m.get_samples()
    assert set(s) == {"var_b", "var_w", "noise"}
    mean, _ = m.predict(1, X, device="cpu")
    assert mean.shape == (10,) and bool(torch.isfinite(mean).all())
    v = gpax_torch.vi_iBNN(1, depth=2, activation="relu")
    v.fit(0, X, y, num_steps=100, **FIT)
    mean, var = v.predict(1, X, device="cpu")
    assert bool(torch.isfinite(mean).all()) and bool((var > 0).all())


# --------------------------------------------------- cho_solve and utils.fn

def test_cho_solve_matches_jax():
    from _torch_parity import spd

    K = spd(6, 3).astype(np.float64)
    L = np.linalg.cholesky(K)
    rng = np.random.default_rng(1)
    for B in (rng.normal(size=6), rng.normal(size=(6, 3))):
        j = gpax_tpu.ops.cho_solve(jnp.asarray(L, jnp.float32), jnp.asarray(B, jnp.float32))
        t = gpax_torch.ops.cho_solve(torch.as_tensor(L, dtype=torch.float32),
                                     torch.as_tensor(B, dtype=torch.float32))
        assert_close(t, j, rtol=1e-4, atol=1e-5)
        assert_close(t.double(), np.linalg.solve(K, B), rtol=1e-4, atol=1e-5)
    # a batch of factors, one vector each
    Lb = torch.as_tensor(np.stack([L, 2 * L]))
    Bb = torch.as_tensor(rng.normal(size=(2, 6)))
    xb = gpax_torch.ops.cho_solve(Lb, Bb)
    for i in range(2):
        assert_close(xb[i], gpax_torch.ops.cho_solve(Lb[i], Bb[i]), rtol=1e-12)


def test_set_fn_and_set_kernel_fn_match_jax():
    def line(x, a, b):
        return a * x + b

    x = np.linspace(-1, 1, 5).astype(np.float32)
    p = {"a": np.float32(2.0), "b": np.float32(-0.5)}
    assert_close(gpax_torch.utils.set_fn(line)(torch.as_tensor(x),
                                               {k: torch.as_tensor(v) for k, v in p.items()}),
                 gpax_tpu.utils.set_fn(line)(jnp.asarray(x), p), rtol=1e-6)

    def j_kern(X, Z, k_scale, ell):
        return k_scale * jnp.exp(-((X[:, None, 0] - Z[None, :, 0]) / ell) ** 2)

    def t_kern(X, Z, k_scale, ell):
        return k_scale * torch.exp(-((X[:, None, 0] - Z[None, :, 0]) / ell) ** 2)

    X = x[:, None]
    Z = X[:3] + np.float32(0.1)
    kp = {"k_scale": np.float32(1.3), "ell": np.float32(0.7)}
    jk, tk = gpax_tpu.utils.set_kernel_fn(j_kern), gpax_torch.utils.set_kernel_fn(t_kern)
    for A, B in ((X, X), (X, Z)):
        assert_close(tk(torch.as_tensor(A), torch.as_tensor(B),
                        {k: torch.as_tensor(v) for k, v in kp.items()}, 0.1),
                     jk(jnp.asarray(A), jnp.asarray(B), kp, 0.1), rtol=1e-6)


def test_set_noise_kernel_fn_matches_jax():
    X = np.linspace(-1, 1, 6).astype(np.float32)[:, None]
    p = {"k_length": np.array([0.5], np.float32), "k_scale": np.float32(2.0),
         "k_noise_length": np.array([0.2], np.float32), "k_noise_scale": np.float32(0.3)}
    jk = gpax_tpu.utils._set_noise_kernel_fn(gpax_tpu.kernels.RBFKernel)
    tk = gpax_torch.utils._set_noise_kernel_fn(gpax_torch.kernels.RBFKernel)
    t = tk(torch.as_tensor(X), torch.as_tensor(X), {k: torch.as_tensor(v) for k, v in p.items()})
    assert_close(t, jk(jnp.asarray(X), jnp.asarray(X), {k: jnp.asarray(v) for k, v in p.items()}),
                 rtol=1e-5, atol=1e-6)
    # the noise hyperparameters were read, not the main ones
    assert abs(float(t[0, 0]) - (0.3 + 1e-6)) < 1e-6


def test_samples_grouped_by_chain_and_new_sites_convert():
    """samples_from_numpy on draws grouped by chain (C, S, …) flattens them
    to (C·S, …) as predict takes them, with the new models' sites."""
    rng = np.random.default_rng(0)
    grouped = {"log_var": rng.normal(size=(2, 3, 16)), "k_noise_length": rng.uniform(size=(2, 3)),
               "X_prime": rng.normal(size=(2, 3, 12, 1)), "sigma_x": rng.uniform(size=(2, 3, 1)),
               "k_length": rng.uniform(size=(2, 3, 4, 1))}
    flat = samples_from_numpy(grouped, device="cpu", chain_dim=True)
    for k, v in grouped.items():
        assert tuple(flat[k].shape) == (6,) + v.shape[2:]
        assert_close(flat[k], v.reshape((6,) + v.shape[2:]), rtol=1e-6)
    assert to_np(flat["log_var"]).dtype == np.float32
