"""The JAX package's precision modes on gpax_torch, against gpax_tpu on the
CPU with the same seeded numpy inputs: the compensated gram (K1's twin
against the Pallas gram in interpret mode), the WᵀW modes and gauges of
``ops.linalg.wtw_compensated``, the composed and fused log-density
θ-gradients under each mode, the HMC-scoped override of ``MCMC.run``,
``set_config``'s validation, and a small NUTS fit under the JAX package's
defaults."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpax_torch
from _torch_parity import assert_close, spd, value_and_grads
from gpax_torch import config as tconfig
from gpax_torch.ops import fused_density as tfd
from gpax_torch.ops import gram as tgram
from gpax_torch.ops import linalg as tlinalg
from gpax_tpu import config as jconfig
from gpax_tpu.kernels import RBFKernel as jax_rbf
from gpax_tpu.ops import linalg as jlinalg
from gpax_tpu.ops.fused_density import gp_mvn_log_prob as jax_fused
from gpax_tpu.ops.pallas_gram import gram as jax_gram
from gpax_tpu.ops.pallas_gram import pallas_gram

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)
JBASE = 4.0 * EPS32  # per point: the θ-independent base regularization
JAX_MODES = ("highest", "compensated", "default")


@pytest.fixture
def modes():
    """``set(jax=..., torch=...)`` sets fields of each package's config for
    one test; both configs are restored after it."""
    jold, told = jconfig.get_config(), tconfig.get_config()

    def set_(jax_kw=None, torch_kw=None):
        if jax_kw:
            jconfig.set_config(**jax_kw)
        if torch_kw:
            tconfig.set_config(**torch_kw)

    yield set_
    jconfig.set_config(**dataclasses.asdict(jold))
    tconfig.set_config(**dataclasses.asdict(told))


def _gram_inputs(n, d, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    kl = rng.uniform(0.5, 2.0, d).astype(np.float32)
    return (X / kl).astype(np.float32), np.full(n, 1e-3, np.float32)


# ---------------------------------------------------------------------------
# K1's compensated twin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rbf", "matern52"])
@pytest.mark.parametrize("n,d", [(96, 64), (40, 1), (33, 3)])
def test_compensated_gram_twin_matches_jax_interpret(kind, n, d):
    """The same hi/lo split and exact bf16 products on both sides, summed
    in fp32 in other orders. Off the diagonal within 1e-6 absolute; on it,
    where r² is the difference of squared norms up to ~100 at d = 64, within
    4·eps·(‖x‖² + ‖z‖²) + 1e-6 (the "highest" grams of the two packages
    differ by as much there). Against the port's "highest" gram, within the
    JAX package's limits (5e-4 RBF, 1e-3 Matérn; test_pallas.py:81-100)."""
    Xs, nz = _gram_inputs(n, d, n + d)
    j = np.asarray(pallas_gram(jnp.asarray(Xs), jnp.asarray(Xs), jnp.asarray(nz), kind=kind,
                               add_noise=True, interpret=True, precision="compensated"))
    Xt, nzt = torch.tensor(Xs)[None], torch.tensor(nz)[None]
    t = tgram.gram_unscaled(Xt, Xt, nzt, kind, True, "compensated")[0].numpy()
    diff = np.abs(t - j)
    off = diff - np.diag(np.diag(diff))
    assert off.max() <= 1e-6, off.max()
    norms = 2.0 * float((Xs * Xs).sum(-1).max())
    assert np.diag(diff).max() <= 1e-6 + 4 * EPS32 * norms, np.diag(diff).max()
    hi = tgram.gram_unscaled(Xt, Xt, nzt, kind, True, "highest")[0].numpy()
    assert np.abs(t - hi).max() < (5e-4 if kind == "rbf" else 1e-3)
    assert np.isfinite(np.linalg.cholesky(t.astype(np.float64))).all()


@pytest.mark.parametrize("kind", ["rbf", "matern52"])
@pytest.mark.parametrize("n,m,d", [(24, 24, 8), (30, 17, 3)])
def test_compensated_gram_gradients_match_jax(kind, n, m, d, modes):
    """θ-gradients of sum(gram) under gram_precision="compensated" against
    JAX's (interpret-mode Pallas gram, its Precision.HIGH backward, fp32 on
    the CPU): rtol 1e-3, atol 1e-4, as ``test_pallas.py:103-114``; the
    port's ``gram`` reads the mode from the config."""
    rng = np.random.default_rng(4 + d)
    X = rng.normal(size=(n, d)).astype(np.float32)
    Z = X if n == m else rng.normal(size=(m, d)).astype(np.float32)
    kl = rng.uniform(0.6, 1.6, d).astype(np.float32)
    modes(torch_kw={"gram_precision": "compensated"})

    def jfn(kl, ks, nz):
        Zj = jnp.asarray(X) if n == m else jnp.asarray(Z)
        Xj = jnp.asarray(X)
        return jax_gram(Xj, Xj if n == m else Zj, kl, ks, nz, kind=kind, interpret=True,
                        precision="compensated")

    def tfn(kl, ks, nz):
        Xt = torch.tensor(X)
        return tgram.gram(Xt, Xt if n == m else torch.tensor(Z), kl, ks, nz, kind=kind)

    (jv, tv), grads = value_and_grads(jfn, tfn, (kl, np.float32(1.3), np.float32(0.1)),
                                      argnums=(0, 1, 2))
    assert_close(tv, jv, rtol=1e-5, atol=1e-5)
    for jg, tg in grads:
        assert_close(tg, jg, rtol=1e-3, atol=1e-4)


def test_square_scaled_distance_reads_gram_precision(modes):
    """The plain path's cross term (kernels.py:71-76) follows the config:
    the split under "compensated", fp32 under "highest"; float64 inputs stay
    float64 in either mode."""
    Xs, _ = _gram_inputs(20, 5, 0)
    X = torch.tensor(Xs)
    from gpax_torch.kernels import square_scaled_distance

    full = square_scaled_distance(X, X)
    modes(torch_kw={"gram_precision": "compensated"})
    comp = square_scaled_distance(X, X)
    assert torch.equal(comp, tgram.scaled_sq_dist(X, X, "compensated"))
    assert 0 < (comp - full).abs().max().item() < 1e-3
    X64 = X.double()
    assert torch.equal(square_scaled_distance(X64, X64), tgram.scaled_sq_dist(X64, X64))


# ---------------------------------------------------------------------------
# WᵀW modes
# ---------------------------------------------------------------------------

def _w(n=96, seed=3):
    """W = L⁻¹ of a well-conditioned SPD matrix, float32 (the JAX factor's
    dtype; the port gets the same values in float64, its factor's dtype)."""
    L = np.linalg.cholesky(spd(n, seed).astype(np.float64))
    return np.linalg.inv(L).astype(np.float32)


@pytest.mark.parametrize("mode", JAX_MODES)
@pytest.mark.parametrize("gauge", ["exact", "symmetric_equivalent"])
@pytest.mark.parametrize("symmetric_consumer", [False, True])
def test_wtw_modes_match_jax(mode, gauge, symmetric_consumer, modes):
    """``wtw_compensated`` under the same mode and gauge in both packages.
    "highest" and "compensated" split and multiply alike (bf16 products are
    exact): within 1e-5 of max|WᵀW|. JAX's "default" on the CPU is the plain
    fp32 product, the port's one bf16 pass: within bf16's 2·2⁻⁸ relative
    error of each product, 8e-3 of max|WᵀW| (``tests/test_round4.py:52-58``
    relies on the same fact); held exactly instead below."""
    W = _w()
    modes(jax_kw={"wtw_precision": mode, "mvn_dk_gauge": gauge},
          torch_kw={"wtw_precision": mode, "mvn_dk_gauge": gauge})
    j = np.asarray(jlinalg.wtw_compensated(jnp.asarray(W), symmetric_consumer))
    t = tlinalg.wtw_compensated(torch.tensor(W, dtype=torch.float64), symmetric_consumer)
    assert t.dtype == torch.float64
    scale = np.abs(j).max()
    tol = 8e-3 if mode == "default" else 1e-5
    assert np.abs(t.numpy() - j).max() <= tol * scale
    if mode == "compensated" and symmetric_consumer and gauge == "symmetric_equivalent":
        # the cheaper gauge: the same symmetric part, not a symmetric matrix
        assert np.abs(t.numpy() - t.numpy().T).max() > 1e-7 * scale
        full = tlinalg.wtw_compensated(torch.tensor(W, dtype=torch.float64))
        assert_close(0.5 * (t + t.mT), full, rtol=0, atol=1e-6 * scale)


def test_wtw_default_is_one_bf16_pass_and_float64_is_exact(modes):
    """The port's "default" against numpy on the bf16-rounded values (ml_dtypes'
    round to nearest even, as torch's): fp32 sums of exact products, within
    n·eps32 of max|WᵀW|. "float64" is today's product, bit for bit."""
    W = _w()
    W64 = torch.tensor(W, dtype=torch.float64)
    hi = np.asarray(jnp.asarray(W).astype(jnp.bfloat16)).astype(np.float64)
    modes(torch_kw={"wtw_precision": "default"})
    t = tlinalg.wtw_compensated(W64).numpy()
    ref = hi.T @ hi
    assert np.abs(t - ref).max() <= W.shape[0] * EPS32 * np.abs(ref).max()
    modes(torch_kw={"wtw_precision": "float64"})
    assert torch.equal(tlinalg.wtw_compensated(W64), W64.mT @ W64)


# ---------------------------------------------------------------------------
# θ-gradients of the composed and the fused log-density under each mode
# ---------------------------------------------------------------------------

def _density_problem(n=64, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n, 1)).astype(np.float32)
    y = (np.sin(2 * X[:, 0]) + 0.1 * rng.normal(size=n)).astype(np.float32)
    return X, y


# (the port's mode, the JAX mode it is held to, gauge, gradient tolerance
# relative to the largest of a gradient): where both sides multiply alike
# the gradients agree to ~1e-4 (the float32 factor of JAX at κ ~ 1e3 against
# the port's float64 one), so 5e-4; "default" is one bf16 pass in the port
# and the fp32 product in JAX on the CPU, whose ~4e-3 matrix error
# contracts in ⟨dK, ∂K/∂θ⟩ to at most 3.9e-3 of the gradient here, so 1e-2
MODE_CASES = [("float64", "highest", "symmetric_equivalent", 5e-4),
              ("highest", "highest", "symmetric_equivalent", 5e-4),
              ("compensated", "compensated", "exact", 5e-4),
              ("compensated", "compensated", "symmetric_equivalent", 5e-4),
              ("default", "default", "symmetric_equivalent", 1e-2)]


@pytest.mark.parametrize("tmode,jmode,gauge,grad_rtol", MODE_CASES)
def test_composed_density_grads_match_jax(tmode, jmode, gauge, grad_rtol, modes):
    """The composed route: RBF gram, then ``mvn_log_prob_centered``; the
    θ-gradients (k_length, k_scale, noise) under each WᵀW mode and gauge
    against JAX's. Value within 2e-4 relative (float32 factor in JAX at κ ~
    1e3, float64 in the port)."""
    X, y = _density_problem()
    modes(jax_kw={"wtw_precision": jmode, "mvn_dk_gauge": gauge},
          torch_kw={"wtw_precision": tmode, "mvn_dk_gauge": gauge})

    def jfn(kl, ks, nz, yy):
        K = jax_rbf(jnp.asarray(X), jnp.asarray(X), {"k_length": kl, "k_scale": ks}, nz)
        return jlinalg.mvn_log_prob_centered(K, yy)

    def tfn(kl, ks, nz, yy):
        K = gpax_torch.kernels.RBFKernel(torch.tensor(X), torch.tensor(X),
                                         {"k_length": kl, "k_scale": ks}, nz)
        return tlinalg.mvn_log_prob_centered(K, yy)

    args = (np.array([0.7]), np.array(1.3), np.array(0.05), y)
    (jv, tv), grads = value_and_grads(jfn, tfn, args, argnums=(0, 1, 2, 3))
    assert_close(tv, jv, rtol=2e-4)
    for jg, tg in grads:
        assert_close(tg, jg, rtol=grad_rtol, atol=grad_rtol * np.abs(jg).max())


@pytest.mark.parametrize("tmode,jmode,gauge,grad_rtol", MODE_CASES)
def test_fused_density_grads_match_jax(tmode, jmode, gauge, grad_rtol, modes):
    """The fused op (``gp_mvn_log_prob``) under each WᵀW mode against
    JAX's; it is never a symmetric consumer, so the gauge changes nothing
    in either package."""
    X, y = _density_problem(seed=1)
    n = X.shape[0]
    modes(jax_kw={"wtw_precision": jmode, "mvn_dk_gauge": gauge},
          torch_kw={"wtw_precision": tmode, "mvn_dk_gauge": gauge})
    args = (X, np.array([0.8]), np.array(1.1), np.array(0.05 + 1e-6 + JBASE * n), y)
    (jv, tv), grads = value_and_grads(lambda *a: jax_fused(*a, "rbf"),
                                      lambda *a: tfd.gp_mvn_log_prob(*a, "rbf"), args,
                                      argnums=(1, 2, 3, 4))
    assert_close(tv, jv, rtol=2e-4)
    for jg, tg in grads:
        assert_close(tg, jg, rtol=grad_rtol, atol=grad_rtol * np.abs(jg).max())


SHARDED_CASES = [("highest", "symmetric_equivalent", 5e-3),
                 ("compensated", "exact", 5e-3),
                 ("compensated", "symmetric_equivalent", 5e-3),
                 ("default", "symmetric_equivalent", 2e-2)]


@pytest.mark.parametrize("mode,gauge,tol", SHARDED_CASES)
def test_sharded_density_grads_match_jax(mode, gauge, tol, modes):
    """``make_sharded_mvn_log_prob`` on a CPU mesh of 8 slots under each
    WᵀW mode and gauge, against the JAX package's on its 8 virtual devices
    under the same mode (the tolerance of tests/test_torch_parallel.py, the
    JAX float32 factor against the port's float64 one; "default" is bf16 in
    the port and fp32 in JAX on the CPU), and against the port's unsplit
    ``mvn_log_prob_centered`` in the same mode, to 1e-6 of max|dK|: the
    row split of each product changes no sum."""
    from gpax_torch.parallel import Mesh, make_sharded_mvn_log_prob
    from gpax_tpu import parallel as jpar

    n = 256
    K = spd(n, seed=1)
    diff = np.random.default_rng(2).normal(size=n).astype(np.float32)
    modes(jax_kw={"wtw_precision": mode, "mvn_dk_gauge": gauge},
          torch_kw={"wtw_precision": mode, "mvn_dk_gauge": gauge})
    lp_j = jpar.make_sharded_mvn_log_prob(jpar.get_mesh(8), leaf=64)
    gj = jax.jit(jax.grad(lp_j, argnums=(0, 1)))(jnp.asarray(K), jnp.asarray(diff))
    Kt, dt = torch.tensor(K, requires_grad=True), torch.tensor(diff, requires_grad=True)
    make_sharded_mvn_log_prob(Mesh([torch.device("cpu")] * 8, ("grid",)), leaf=64)(
        Kt, dt).backward()
    for t, j in zip((Kt.grad, dt.grad), gj):
        j = np.asarray(j)
        assert np.abs(t.numpy() - j).max() <= tol * np.abs(j).max()
    Ku, du = torch.tensor(K, requires_grad=True), torch.tensor(diff, requires_grad=True)
    tlinalg.mvn_log_prob_centered(Ku, du).backward()
    assert_close(Kt.grad, Ku.grad, rtol=0, atol=1e-6 * Ku.grad.abs().max().item())
    assert_close(dt.grad, du.grad, rtol=0, atol=1e-6 * du.grad.abs().max().item())


@pytest.mark.parametrize("kernel", ["RBF", "Matern"])
@pytest.mark.parametrize("model", ["ExactGP", "MultiTaskGP", "CoregGP"])
def test_symmetric_equivalent_gauge_keeps_theta_gradients(model, kernel, modes):
    """Under "compensated" WᵀW the symmetric-equivalent dK is not symmetric:
    every consumer of dK on the composed route (the gram's symmetric
    backward, the noise diagonal, the LCM/ICM task grams of mtkernels, the
    jitter's diagonal clones, ``_unbroadcast``) must contract only its
    symmetric part. The potential's θ-gradient under both gauges agrees to
    fp32 rounding of the factor (1e-4 relative)."""
    rng = np.random.default_rng(7)
    if model == "ExactGP":
        X = rng.uniform(-1, 1, (40, 1)).astype(np.float32)
        m = gpax_torch.ExactGP(1, kernel)
    else:
        x = rng.uniform(-1, 1, (20, 1)).astype(np.float32)
        X = np.concatenate([np.concatenate([x, np.full_like(x, t)], 1) for t in (0, 1)])
        m = (gpax_torch.MultiTaskGP(1, kernel, num_latents=2, num_tasks=2) if model == "MultiTaskGP"
             else gpax_torch.CoregGP(1, kernel))
    y = (np.sin(3 * X[:, 0]) + 0.05 * rng.normal(size=len(X))).astype(np.float32)
    m._set_training_data(X, y, device="cpu")
    info = gpax_torch.ppl.initialize_model(m.model, torch.Generator().manual_seed(0),
                                           (m.X_train, m.y_train))
    z0 = {k: v.detach().clone() for k, v in info.init_unconstrained.items()}
    out = {}
    for gauge in ("exact", "symmetric_equivalent"):
        modes(torch_kw={"wtw_precision": "compensated", "mvn_dk_gauge": gauge,
                        "use_fused_likelihood": "never"})
        z = {k: v.clone().requires_grad_(True) for k, v in z0.items()}
        u = info.potential_fn(z)
        out[gauge] = torch.cat([g.reshape(-1) for g in torch.autograd.grad(u, list(z.values()))])
    a, b = out["exact"], out["symmetric_equivalent"]
    assert (a - b).abs().max().item() <= 1e-4 * a.abs().max().item() + 1e-6


# ---------------------------------------------------------------------------
# The HMC-scoped override
# ---------------------------------------------------------------------------

def _toy(n=12, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n, 1)).astype(np.float32)
    y = (np.sin(3 * X[:, 0]) + 0.05 * rng.normal(size=n)).astype(np.float32)
    return torch.tensor(X), torch.tensor(y)


def _recording_model(seen):
    def model(X, y=None):
        seen.append(tconfig.get_config().wtw_precision)
        s = gpax_torch.ppl.sample("scale", gpax_torch.distributions.LogNormal(0.0, 1.0))
        gpax_torch.ppl.sample("y", gpax_torch.distributions.Normal(torch.zeros(X.shape[0]),
                                                                   s.unsqueeze(-1)), obs=y)
    return model


@pytest.mark.parametrize("runner", ["single", "segmented", "vectorized", "sequential"])
def test_hmc_wtw_precision_scoped_to_the_run(runner, modes):
    """``tests/test_round4.py:26-49``: hmc_wtw_precision binds every trace of
    the model inside ``MCMC.run``, whichever runner it takes, and
    wtw_precision is restored after it."""
    from gpax_torch.infer import MCMC, NUTS

    seen = []
    modes(torch_kw={"hmc_wtw_precision": "highest"})
    assert tconfig.get_config().wtw_precision == "float64"
    kw = {"single": {}, "segmented": {"segment_size": 5},
          "vectorized": {"num_chains": 2, "chain_method": "vectorized"},
          "sequential": {"num_chains": 2, "chain_method": "sequential"}}[runner]
    mcmc = MCMC(NUTS(_recording_model(seen)), num_warmup=10, num_samples=10, **kw)
    mcmc.run(0, *_toy())
    assert seen and all(v == "highest" for v in seen)
    assert tconfig.get_config().wtw_precision == "float64"
    assert mcmc.get_samples()["scale"].shape[0] == 10 * mcmc.num_chains


def test_hmc_wtw_precision_restored_when_the_run_raises(modes):
    """A run that raises inside the sampler leaves wtw_precision as it was."""
    from gpax_torch.infer import MCMC, NUTS

    seen = []

    def model(X, y=None):
        _recording_model(seen)(X, y)
        if len(seen) > 3:
            raise RuntimeError("model failure inside the run")

    modes(torch_kw={"hmc_wtw_precision": "compensated"})
    with pytest.raises(RuntimeError, match="inside the run"):
        MCMC(NUTS(model), num_warmup=10, num_samples=10).run(0, *_toy())
    assert "compensated" in seen
    assert tconfig.get_config().wtw_precision == "float64"
    assert tconfig.get_config().hmc_wtw_precision == "compensated"


def test_hmc_override_does_not_bind_svi(modes):
    """SVI (and so predict and user gradients) trace under wtw_precision."""
    from gpax_torch.infer import SVI, AutoNormal

    seen = []
    modes(torch_kw={"hmc_wtw_precision": "default"})
    model = _recording_model(seen)
    X, y = _toy()
    svi = SVI(model, AutoNormal(model), 1e-2)
    svi.run(0, 3, X, y)
    assert seen and all(v == "float64" for v in seen)


def test_override_is_a_no_op_when_equal_or_none(modes):
    """None, or a mode equal to wtw_precision, leaves the run's mode alone."""
    from gpax_torch.infer import MCMC, NUTS

    for hmc, base in ((None, "highest"), ("highest", "highest")):
        seen = []
        modes(torch_kw={"hmc_wtw_precision": hmc, "wtw_precision": base})
        MCMC(NUTS(_recording_model(seen)), num_warmup=5, num_samples=5).run(0, *_toy())
        assert seen and set(seen) == {base}


# ---------------------------------------------------------------------------
# set_config
# ---------------------------------------------------------------------------

VALID = {"gram_precision": ["highest", "compensated"],
         "wtw_precision": ["float64", "highest", "compensated", "default"],
         "mvn_dk_gauge": ["exact", "symmetric_equivalent"],
         "hmc_wtw_precision": [None, "float64", "highest", "compensated", "default"]}


def test_the_ports_defaults_are_unchanged():
    """The port keeps its own defaults where they differ from the JAX
    package's (ROADMAP Queue 3): float64 WᵀW and no HMC override."""
    cfg = tconfig.Config()
    assert (cfg.gram_precision, cfg.wtw_precision, cfg.mvn_dk_gauge,
            cfg.hmc_wtw_precision) == ("highest", "float64", "symmetric_equivalent", None)
    assert tconfig.get_config() == cfg


@pytest.mark.parametrize("field,value", [(f, v) for f, vs in VALID.items() for v in vs])
def test_set_config_accepts_every_mode(field, value, modes):
    modes(torch_kw={field: value})
    assert getattr(tconfig.get_config(), field) == value


@pytest.mark.parametrize("field,value", [("gram_precision", "default"),
                                         ("gram_precision", "float64"),
                                         ("wtw_precision", "bf16"),
                                         ("wtw_precision", None),
                                         ("mvn_dk_gauge", "symmetric"),
                                         ("hmc_wtw_precision", "fast"),
                                         ("use_fused_likelihood", "sometimes")])
def test_set_config_refuses_other_values(field, value):
    before = tconfig.get_config()
    with pytest.raises(ValueError):
        tconfig.set_config(**{field: value})
    assert tconfig.get_config() == before


@pytest.mark.parametrize("field", ["matmul_precision", "use_pallas", "pallas_min_elems",
                                   "use_pallas_chol", "pallas_chol_min_n"])
def test_set_config_refuses_the_dispatch_fields(field):
    """The JAX package's dispatch fields are not ported, with the reason."""
    value = getattr(jconfig.Config(), field)
    with pytest.raises(NotImplementedError, match="by device"):
        tconfig.set_config(**{field: value})
    with pytest.raises(TypeError):
        tconfig.set_config(no_such_field=1)


# ---------------------------------------------------------------------------
# A small fit under the JAX package's defaults
# ---------------------------------------------------------------------------

def test_fit_under_jax_defaults_matches_the_ports_defaults(modes):
    """``tests/test_round4.py:51-74`` on the port: the JAX package's
    defaults (compensated WᵀW, a bf16 "default" HMC gradient, the
    symmetric-equivalent gauge) change only the proposals' gradient, so the
    fit is statistically the default fit's (noise means within 0.05; the
    true noise is 0.05). The override leaves wtw_precision as it was."""
    X, y = _toy(n=16, seed=3)
    jax_defaults = {f: getattr(jconfig.Config(), f)
                    for f in ("wtw_precision", "mvn_dk_gauge", "hmc_wtw_precision")}
    stats = {}
    for label, kw in (("port", None), ("jax", jax_defaults)):
        modes(torch_kw=kw)
        gp = gpax_torch.ExactGP(1, "RBF")
        gp.fit(0, X, y, num_warmup=100, num_samples=100, print_summary=False,
               progress_bar=False, device="cpu")
        stats[label] = float(gp.get_samples()["noise"].mean())
    assert tconfig.get_config().wtw_precision == "compensated"
    assert all(np.isfinite(v) for v in stats.values())
    np.testing.assert_allclose(stats["jax"], stats["port"], atol=0.05)
