"""gpax_torch's NN modules, Cauchy, get_haiku_dict, viDKL and viMTDKL
against gpax_tpu's on the same numpy inputs: values, site structure, the
negative ELBO and its gradients, a MAP trajectory from JAX's own initial
values, the predictive math on carried-over state, and the batched
ensemble and channels against single fits of the port."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gpax_torch
import gpax_tpu
from _torch_parity import assert_close, to_np
from gpax_torch.infer import SVI, AutoDelta
from gpax_torch.ops import gram as tgram
from gpax_torch.utils import get_haiku_dict, load_vidkl_state, vidkl_state_from_jax

torch.set_num_threads(1)

N, D = 24, 12
# the float32 predictive math of both packages on the same state; κ(K) of
# the fitted grams ~1e3
PRED_RTOL, PRED_ATOL = 1e-4, 1e-5


@pytest.fixture
def jax_fp32_wtw():
    """The JAX backward at float32 WᵀW, as in tests/test_torch_gp.py."""
    old = gpax_tpu.get_config().wtw_precision
    gpax_tpu.set_config(wtw_precision="highest")
    yield
    gpax_tpu.set_config(wtw_precision=old)


def _data(n=N, d=D, seed=0):
    """tests/test_dkl.py's dummy features at a small size."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (np.sin(X[:, 0]) + 0.05 * rng.normal(size=n)).astype(np.float32)
    return X, y


def _mtdata(seed=0):
    """tests/test_models_extra.py::test_vi_mtdkl's two tasks."""
    rng = np.random.default_rng(seed)
    n0, n1, d = 8, 6, 5
    X = np.concatenate([np.column_stack([rng.normal(size=(n0, d)), np.zeros(n0)]),
                        np.column_stack([rng.normal(size=(n1, d)), np.ones(n1)])])
    y = np.concatenate([np.sin(X[:n0, 0]), np.cos(X[n0:, 0])])
    return X.astype(np.float32), y.astype(np.float32)


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _ttree(tree):
    if isinstance(tree, dict):
        return {k: _ttree(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


# ---------------------------------------------------------------- Cauchy

def test_cauchy_log_prob_matches_jax_and_samples():
    rng = np.random.default_rng(0)
    loc = rng.normal(size=(3, 1)).astype(np.float32)
    scale = rng.uniform(0.2, 3.0, size=(1, 4)).astype(np.float32)
    v = rng.standard_cauchy(size=(5, 3, 4)).astype(np.float32)
    j = gpax_tpu.distributions.Cauchy(jnp.asarray(loc), jnp.asarray(scale))
    t = gpax_torch.distributions.Cauchy(torch.tensor(loc), torch.tensor(scale))
    assert t.batch_shape == j.batch_shape == (3, 4)
    assert_close(t.log_prob(torch.tensor(v)), j.log_prob(jnp.asarray(v)), rtol=1e-6)
    assert t.support is gpax_torch.distributions.constraints.real
    draws = t.sample(torch.Generator().manual_seed(0), (20000,))
    assert draws.shape == (20000, 3, 4)
    # the median and quartiles of a Cauchy are loc and loc ± scale
    q = torch.quantile(draws[:, 0, 0], torch.tensor([0.25, 0.5, 0.75]))
    assert_close(q, [loc[0, 0] - scale[0, 0], loc[0, 0], loc[0, 0] + scale[0, 0]],
                 rtol=0, atol=0.06 * scale[0, 0])
    e = gpax_torch.distributions.Cauchy(0.0, 1.0).expand((2, 3))
    assert e.batch_shape == (2, 3) and e.to_event(2).log_prob(torch.zeros(4, 2, 3)).shape == (4,)


# --------------------------------------------------------------- modules

def test_mlp_apply_matches_jax_on_carried_weights():
    jm = gpax_tpu.nn.MLP(embedim=3, hidden_dim=(16, 8))
    tm = gpax_torch.nn.MLP(embedim=3, hidden_dim=(16, 8))
    x = np.random.default_rng(1).normal(size=(5, 2, 5)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tparams = _ttree(params)
    assert {k: {n: tuple(v.shape) for n, v in p.items()} for k, p in tparams.items()} == \
        {k: {n: tuple(v.shape) for n, v in p.items()}
         for k, p in tm.init(torch.Generator().manual_seed(0), torch.tensor(x)).items()}
    out = tm.apply(tparams, torch.tensor(x))
    assert out.shape == (5, 3)
    assert_close(out, jm.apply(params, jnp.asarray(x)), rtol=1e-5, atol=1e-6)


def test_conv_net_apply_matches_jax_on_carried_weights():
    jm = gpax_tpu.nn.ConvNet(embedim=2, channels=(4, 8), dense_dim=16)
    tm = gpax_torch.nn.ConvNet(embedim=2, channels=(4, 8), dense_dim=16)
    x = np.random.default_rng(2).normal(size=(3, 10, 9, 2)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tparams = _ttree(params)
    assert tparams["conv_1"]["w"].shape == (3, 3, 4, 8)
    assert tparams["dense_0"]["w"].shape == \
        tm.init(torch.Generator().manual_seed(0), torch.tensor(x))["dense_0"]["w"].shape
    assert_close(tm.apply(tparams, torch.tensor(x)), jm.apply(params, jnp.asarray(x)),
                 rtol=1e-5, atol=1e-6)
    x3 = x[..., 0]  # channelless images get a channel dim
    p3 = jm.init(jax.random.PRNGKey(1), jnp.asarray(x3))
    assert_close(tm.apply(_ttree(p3), torch.tensor(x3)), jm.apply(p3, jnp.asarray(x3)),
                 rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("net", ["mlp", "conv"])
def test_batched_weights_give_each_model_its_output(net):
    """Weights with a leading model dim (an ensemble's or channels') run as
    one batched program and equal each model's own apply."""
    if net == "mlp":
        m = gpax_torch.nn.MLP(embedim=2, hidden_dim=(8, 4))
        x = torch.randn(6, 5, generator=torch.Generator().manual_seed(0))
    else:
        m = gpax_torch.nn.ConvNet(embedim=2, channels=(3, 4), dense_dim=8)
        x = torch.randn(6, 8, 8, 2, generator=torch.Generator().manual_seed(0))
    per = [m.init(torch.Generator().manual_seed(s), x) for s in range(3)]
    batched = {k: {n: torch.stack([p[k][n] for p in per]) for n in per[0][k]} for k in per[0]}
    out = m.apply(batched, x)
    assert out.shape == (3, 6, 2)
    for b in range(3):
        assert_close(out[b], m.apply(per[b], x), rtol=1e-5, atol=1e-6)


def _trace_sites(pkg, register, module, x):
    def model():
        return register("feature_extractor", module, (1, x.shape[-1]))(x)

    if pkg is gpax_tpu:
        return pkg.ppl.trace(pkg.ppl.seed(model, jax.random.PRNGKey(0))).get_trace()
    return pkg.ppl.trace(pkg.ppl.seed(model, 0)).get_trace()


def test_random_module_sites_match_jax():
    """Site names, order, shapes and prior distributions (Normal weights,
    Cauchy biases, to_event over the leaf) exactly as JAX's trace."""
    x = np.ones((3, 6), np.float32)
    jtr = _trace_sites(gpax_tpu, gpax_tpu.nn.random_module,
                       gpax_tpu.nn.MLP(embedim=2, hidden_dim=(4,)), jnp.asarray(x))
    ttr = _trace_sites(gpax_torch, gpax_torch.nn.random_module,
                       gpax_torch.nn.MLP(embedim=2, hidden_dim=(4,)), torch.tensor(x))
    assert list(ttr) == list(jtr)
    assert "feature_extractor/linear_1/b" in ttr
    for name, js in jtr.items():
        ts = ttr[name]
        assert ts["type"] == js["type"] == "sample"
        assert tuple(ts["value"].shape) == tuple(js["value"].shape)
        jd, td = js["fn"], ts["fn"]
        assert type(td).__name__ == type(jd).__name__ == "Independent"
        assert type(td.base).__name__ == type(jd.base).__name__
        assert tuple(td.event_shape) == tuple(jd.event_shape)
        assert tuple(td.batch_shape) == tuple(jd.batch_shape)
        v = np.linspace(-2, 2, int(np.prod(js["value"].shape)), dtype=np.float32).reshape(
            js["value"].shape)
        assert_close(td.log_prob(torch.tensor(v)), jd.log_prob(jnp.asarray(v)), rtol=1e-6)


def test_module_param_site_matches_jax_and_starts_every_member_alike():
    x = np.ones((3, 6), np.float32)
    jtr = _trace_sites(gpax_tpu, gpax_tpu.nn.module_param,
                       gpax_tpu.nn.MLP(embedim=2, hidden_dim=(4,)), jnp.asarray(x))
    tm = gpax_torch.nn.MLP(embedim=2, hidden_dim=(4,))
    ttr = _trace_sites(gpax_torch, gpax_torch.nn.module_param, tm, torch.tensor(x))
    assert list(ttr) == list(jtr) == ["feature_extractor$params"]
    assert ttr["feature_extractor$params"]["type"] == "param"
    jproto = jtr["feature_extractor$params"]["init_value"]
    tproto = ttr["feature_extractor$params"]["init_value"]
    assert jax.tree_util.tree_map(lambda v: v.shape, jproto) == \
        {k: {n: tuple(v.shape) for n, v in p.items()} for k, p in tproto.items()}
    # a fixed generator: another module instance gets the same prototype
    again = _trace_sites(gpax_torch, gpax_torch.nn.module_param,
                         gpax_torch.nn.MLP(embedim=2, hidden_dim=(4,)), torch.tensor(x))
    assert torch.equal(again["feature_extractor$params"]["init_value"]["linear_0"]["w"],
                       tproto["linear_0"]["w"])


def test_get_haiku_dict_matches_jax():
    flat = {"feature_extractor/linear_0/w": np.ones((3, 2), np.float32),
            "feature_extractor/linear_0/b": np.zeros(2, np.float32),
            "feature_extractor/block/inner/w1": np.full((2,), 3.0, np.float32),
            "feature_extractor/w9": np.ones(1, np.float32),
            "k_length": np.ones(2, np.float32), "noise": np.float32(0.1)}
    j = gpax_tpu.utils.get_haiku_dict({k: jnp.asarray(v) for k, v in flat.items()})
    t = get_haiku_dict({k: torch.tensor(v) for k, v in flat.items()})
    tn = gpax_torch.utils.tree_map(to_np, t)
    assert jax.tree_util.tree_structure(j) == jax.tree_util.tree_structure(tn)
    for a, b in zip(jax.tree_util.tree_leaves(tn), jax.tree_util.tree_leaves(j)):
        assert_close(a, b, rtol=0)


# -------------------------------------------------------- viDKL's objective

def _jax_delta_init(jm, X, y, key):
    """The initial AutoDelta values JAX's SVI.run(key) starts from."""
    k_init, _ = jax.random.split(key)
    guide = gpax_tpu.infer.AutoDelta(jm.model)
    guide._setup(k_init, (X, y), {})
    return guide, guide.init_params(k_init, (X, y))


@pytest.mark.parametrize("nn_prior", [True, False], ids=["map", "mle"])
def test_vidkl_neg_elbo_and_gradients_match_jax(nn_prior, jax_fp32_wtw):
    """At JAX's initial guide values (and, for MLE, JAX's network
    prototype), the negative ELBO and its gradient in every parameter:
    rtol 1e-4 (gradients 1e-4 of their site's largest entry, the network's
    under MLE)."""
    X, y = _data()
    Xj, yj = jnp.asarray(X), jnp.asarray(y)
    jm = gpax_tpu.viDKL(D, 2, nn_prior=nn_prior)
    tm = gpax_torch.viDKL(D, 2, nn_prior=nn_prior)
    jguide, init = _jax_delta_init(jm, Xj, yj, jax.random.PRNGKey(3))
    jsvi = gpax_tpu.infer.SVI(jm.model, jguide, optax.adam(1e-3))
    mparams = jsvi._collect_model_params(jax.random.PRNGKey(0), (Xj, yj), {})
    jv, (jg, jmg) = jax.jit(jax.value_and_grad(jsvi._neg_elbo, argnums=(0, 1)))(
        init, mparams, jax.random.PRNGKey(0), (Xj, yj), {})
    Xt, yt = tm._set_data(X, y, device="cpu")
    tsvi = SVI(tm.model, AutoDelta(tm.model), 1e-3)
    tsvi.guide.init_params(torch.Generator().manual_seed(0), (Xt, yt))
    tp = {k: torch.tensor(np.asarray(v), requires_grad=True) for k, v in init.items()}
    tmp = {k: jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a), requires_grad=True),
                                     v) for k, v in mparams.items()}
    tv = tsvi._neg_elbo(tp, tmp, None, (Xt, yt), {})
    tv.backward()
    assert_close(tv, jv, rtol=1e-4)
    for k in init:
        g = np.asarray(jg[k])
        assert_close(tp[k].grad, g, rtol=0, atol=1e-4 * max(np.abs(g).max(), 1e-6))
    # MLE: relative to the network's largest gradient, since the gram is
    # translation-invariant and the head bias's gradient is zero up to rounding
    jleaves = [np.asarray(g) for g in jax.tree_util.tree_leaves(jmg)]
    scale = max([np.abs(g).max() for g in jleaves], default=0.0)
    for leaf_t, g in zip(jax.tree_util.tree_leaves(tmp), jleaves):
        assert_close(leaf_t.grad, g, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("kind", ["rbf", "matern52"])
def test_gram_dxs_backward_matches_float64_finite_difference(kind):
    """_Gram's gradient into its inputs (the network's path): the symmetric
    backward (X passed twice) and the cross backward, against central
    differences of the float64 twin, 1e-4 relative."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2, 9, 3))
    Z = rng.normal(size=(2, 7, 3))
    G = rng.normal(size=(2, 9, 9))
    Gc = rng.normal(size=(2, 9, 7))
    nz = np.full((2, 9), 0.1)

    def f_sym(x):
        return (tgram.gram_twin(x, x, torch.tensor(nz), kind, True) * torch.tensor(G)).sum()

    def f_cross(x, z):
        return (tgram.gram_twin(x, z, torch.zeros(2, 9, dtype=torch.float64), kind, False)
                * torch.tensor(Gc)).sum()

    def fd(fn, a, eps=1e-6):
        out = np.zeros_like(a)
        for idx in np.ndindex(a.shape):
            ap, am = a.copy(), a.copy()
            ap[idx] += eps
            am[idx] -= eps
            out[idx] = (fn(torch.tensor(ap)).item() - fn(torch.tensor(am)).item()) / (2 * eps)
        return out

    Xt = torch.tensor(X, dtype=torch.float32, requires_grad=True)
    k = tgram._Gram.apply(Xt, Xt, torch.tensor(nz, dtype=torch.float32), kind, True, True)
    (k * torch.tensor(G, dtype=torch.float32)).sum().backward()
    ref = fd(f_sym, X)
    assert_close(Xt.grad, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    Xt = torch.tensor(X, dtype=torch.float32, requires_grad=True)
    Zt = torch.tensor(Z, dtype=torch.float32, requires_grad=True)
    k = tgram._Gram.apply(Xt, Zt, torch.zeros(2, 9), kind, False, False)
    (k * torch.tensor(Gc, dtype=torch.float32)).sum().backward()
    ref_x = fd(lambda x: f_cross(x, torch.tensor(Z)), X)
    ref_z = fd(lambda z: f_cross(torch.tensor(X), z), Z)
    assert_close(Xt.grad, ref_x, rtol=0, atol=1e-4 * np.abs(ref_x).max())
    assert_close(Zt.grad, ref_z, rtol=0, atol=1e-4 * np.abs(ref_z).max())


def test_vidkl_map_trajectory_from_jax_init_matches_jax(monkeypatch, jax_fp32_wtw):
    """20 Adam(5e-3, b1=0.5) steps of the AutoDelta fit from JAX's own
    initial values, injected into the port's guide: the deterministic MAP
    trajectory gives the same losses and parameters within rtol 1e-3."""
    X, y = _data()
    key = jax.random.PRNGKey(5)
    jm = gpax_tpu.viDKL(D, 2)
    _, init = _jax_delta_init(jm, jnp.asarray(X), jnp.asarray(y), key)
    jnn, jk, jloss = jm.single_fit(key, jnp.asarray(X), jnp.asarray(y), num_steps=20,
                                   print_summary=False, progress_bar=False)
    original = AutoDelta.init_params

    def from_jax(self, rng_key, model_args=(), model_kwargs=None):
        original(self, rng_key, model_args, model_kwargs)
        return {k: torch.tensor(np.asarray(v)) for k, v in init.items()}

    monkeypatch.setattr(AutoDelta, "init_params", from_jax)
    tm = gpax_torch.viDKL(D, 2)
    tnn, tk, tloss = tm.single_fit(0, X, y, num_steps=20, print_summary=False,
                                   progress_bar=False, device="cpu")
    assert tloss.shape == (20,)
    assert_close(tloss, jloss, rtol=1e-3)
    # the gradients agree to ~1e-4 of each site's largest entry, so an entry
    # whose own gradient is far smaller takes Adam steps (each at most the
    # step size) that differ in proportion: atol 0.2 % of the farthest
    # 20 steps can move an entry
    atol = 2e-3 * 20 * 5e-3
    for k in jk:
        assert_close(tk[k], jk[k], rtol=1e-3, atol=atol)
    for layer in jnn:
        for p in jnn[layer]:
            assert_close(tnn[layer][p], jnn[layer][p], rtol=1e-3, atol=atol)


# ------------------------------------------------------ predictive math

@pytest.fixture(scope="module")
def jax_fits():
    """Short JAX fits whose states the port takes over: one model and two
    channels."""
    X, y = _data()
    one = gpax_tpu.viDKL(D, 2)
    one.fit(jax.random.PRNGKey(1), jnp.asarray(X), jnp.asarray(y), num_steps=60,
            print_summary=False, progress_bar=False)
    two = gpax_tpu.viDKL(D, 2)
    two.fit(jax.random.PRNGKey(2), jnp.asarray(X), jnp.asarray(np.stack([y, 1.0 - y])),
            num_steps=30, print_summary=False, progress_bar=False)
    return {"one": one, "two": two}


@pytest.mark.parametrize("which", ["one", "two"])
def test_vidkl_predict_and_embed_on_carried_state_match_jax(jax_fits, which):
    X, _ = _data()
    X_new = _data(n=17, seed=4)[0]
    jm = jax_fits[which]
    state = vidkl_state_from_jax(jm)
    tm = gpax_torch.viDKL(D, 2)
    load_vidkl_state(tm, state, device="cpu")
    jmean, jvar = jm.predict(None, jnp.asarray(X_new))
    tmean, tvar = tm.predict(None, X_new, device="cpu")
    lead = (2,) if which == "two" else ()
    assert tmean.shape == tvar.shape == lead + (17,)
    # the fitted embeddings are large (the weights' prior is Normal(0, 1)),
    # so both packages' float32 r² = ‖x‖² − 2x·z + ‖z‖² carry a rounding
    # error of up to u·(‖x‖² + ‖z‖²), in lengthscales, that exp(−r²/2)
    # turns into a relative error of the kernel: the tolerance adds it
    z = np.concatenate([np.asarray(jm.embed(jnp.asarray(X))),
                        np.asarray(jm.embed(jnp.asarray(X_new)))], -2)
    ls = np.asarray(jm.kernel_params["k_length"])[..., None, :]
    rel = PRED_RTOL + 2.0**-24 * 2 * ((z / ls) ** 2).sum(-1).max()
    scale_m, scale_v = np.abs(np.asarray(jmean)).max(), np.abs(np.asarray(jvar)).max()
    assert_close(tmean, jmean, rtol=0, atol=rel * scale_m + PRED_ATOL)
    assert_close(tvar, jvar, rtol=0, atol=rel * scale_v + PRED_ATOL)
    # gpax_tpu pads the last batch and trims only dim 0, so its batched
    # means of several channels keep the padding's columns: the channels'
    # reference is its unbatched predict
    jb = (jm.predict_in_batches(None, jnp.asarray(X_new), batch_size=5) if which == "one"
          else (jmean, jvar))
    tb = tm.predict_in_batches(None, X_new, batch_size=5, device="cpu")
    assert_close(tb[0], jb[0], rtol=0, atol=rel * scale_m + PRED_ATOL)
    assert_close(tb[1], jb[1], rtol=0, atol=rel * scale_v + PRED_ATOL)
    jz = np.asarray(jm.embed(jnp.asarray(X_new)))
    assert_close(tm.embed(X_new, device="cpu"), jz, rtol=0,
                 atol=1e-5 * np.abs(jz).max())
    if which == "one":
        jmu, _ = jm.sample_from_posterior(jax.random.PRNGKey(0), jnp.asarray(X_new), n=4)
        tmu, tdraws = tm.sample_from_posterior(0, X_new, n=4, device="cpu")
        assert tdraws.shape == (4, 17) and bool(torch.isfinite(tdraws).all())
        assert_close(tmu, jmu, rtol=0, atol=rel * scale_m + PRED_ATOL)
    else:
        with pytest.raises(NotImplementedError):
            tm.sample_from_posterior(0, X_new, device="cpu")


def test_vidkl_ensemble_predict_matches_jax_model_by_model():
    """Three models' states at once (a leading ensemble dim on every leaf):
    the port's batched posterior (predict, predict_in_batches) and embedding
    equal JAX's get_mvn_posterior and network of each."""
    X, y = _data()
    X_new = _data(n=11, seed=5)[0]
    jm = gpax_tpu.viDKL(D, 2)
    jm.X_train, jm.y_train = jnp.asarray(X), jnp.asarray(y)
    nets = [jm.nn_module.init(jax.random.PRNGKey(s), jnp.asarray(X)) for s in range(3)]
    kps = [{"k_length": np.array([0.5 + s, 1.0], np.float32),
            "k_scale": np.float32(1.0 + 0.3 * s), "noise": np.float32(0.05 * (s + 1))}
           for s in range(3)]
    state = {"nn_params": jax.tree_util.tree_map(lambda *a: np.stack(a), *nets),
             "kernel_params": {k: np.stack([kp[k] for kp in kps]) for k in kps[0]},
             "X_train": X, "y_train": y}
    tm = gpax_torch.viDKL(D, 2)
    load_vidkl_state(tm, state, device="cpu")
    tmean, tvar = tm.predict(None, X_new, device="cpu")
    bmean, bvar = tm.predict_in_batches(None, X_new, batch_size=4, device="cpu")
    tz = tm.embed(X_new, device="cpu")
    assert tmean.shape == bmean.shape == (3, 11) and tz.shape == (3, 11, 2)
    for s in range(3):
        jmean, jcov = jm.get_mvn_posterior(jnp.asarray(X_new), nets[s], _jtree(kps[s]))
        jvar = np.diag(np.asarray(jcov))
        for mean, var in ((tmean, tvar), (bmean, bvar)):
            assert_close(mean[s], jmean, rtol=0,
                         atol=PRED_RTOL * np.abs(jmean).max() + PRED_ATOL)
            assert_close(var[s], jvar, rtol=0, atol=PRED_RTOL * np.abs(jvar).max() + PRED_ATOL)
        jz = np.asarray(jm.nn_module.apply(nets[s], jnp.asarray(X_new)))
        assert_close(tz[s], jz, rtol=1e-5, atol=1e-6)


# --------------------------------------------- batched ensembles and channels

def test_batched_ensemble_fit_equals_single_fits():
    """fit_predict(n_models=3) is one batched SVI run; each model's losses
    and parameters equal a single fit of the port from the same key, and
    the ensemble's predictions each model's own."""
    X, y = _data()
    X_new = X[:7]
    key = torch.Generator().manual_seed(11)
    keys = [torch.Generator().manual_seed(11) for _ in range(2)]
    model = gpax_torch.viDKL(D, 2)
    mean, var = model.fit_predict(key, X, y, X_new, num_steps=40, n_models=3,
                                  print_summary=False, progress_bar=False, device="cpu")
    assert mean.shape == var.shape == (3, 7) and model.loss.shape == (3, 40)
    assert not torch.allclose(model.kernel_params["k_length"][0],
                              model.kernel_params["k_length"][1])  # distinct inits
    from gpax_torch.utils import spawn
    singles = [spawn(keys[0]) for _ in range(3)]
    for b, k in enumerate(singles):
        single = gpax_torch.viDKL(D, 2)
        single.fit(k, X, y, num_steps=40, print_summary=False, progress_bar=False,
                   device="cpu")
        assert_close(model.loss[b], single.loss, rtol=1e-5)
        for name, v in single.kernel_params.items():
            assert_close(model.kernel_params[name][b], v, rtol=1e-5, atol=1e-7)
        for layer, p in single.nn_params.items():
            for n, v in p.items():
                assert_close(model.nn_params[layer][n][b], v, rtol=1e-5, atol=1e-6)
        smean, svar = single.predict(None, X_new, device="cpu")
        assert_close(mean[b], smean, rtol=1e-4, atol=1e-5)
        assert_close(var[b], svar, rtol=1e-4, atol=1e-5)
    parallel = gpax_torch.viDKL(D, 2).fit_predict(
        keys[1], X, y, X_new, num_steps=40, n_models=3, ensemble_method="parallel",
        print_summary=False, progress_bar=False, device="cpu")
    assert_close(parallel[0], mean, rtol=0)
    with pytest.raises(ValueError):
        model.fit_predict(0, X, y, X_new, n_models=2, ensemble_method="bogus", device="cpu")


def test_channels_share_one_init_as_in_jax():
    """A 2-D y fits one model per channel from the SAME key: with the two
    channels equal, the two fits are identical; with different channels
    their first losses differ only through y."""
    X, y = _data()
    m = gpax_torch.viDKL(D, 2)
    m.fit(3, X, np.stack([y, y]), num_steps=10, print_summary=False, progress_bar=False,
          device="cpu")
    assert m.loss.shape == (2, 10)
    assert torch.equal(m.loss[0], m.loss[1])
    for p in m.nn_params.values():
        for v in p.values():
            assert torch.equal(v[0], v[1])
    m0 = gpax_torch.viDKL(D, 2)
    m0.fit(3, X, np.stack([y, 1.0 - y]), num_steps=1, print_summary=False,
           progress_bar=False, device="cpu")
    single = gpax_torch.viDKL(D, 2)
    single.fit(3, X, y, num_steps=1, print_summary=False, progress_bar=False, device="cpu")
    assert_close(m0.loss[0], single.loss, rtol=1e-6)
    assert m0.embed(X, device="cpu").shape == (2, N, 2)


def test_vidkl_mle_normal_guide_and_devices():
    """MLE mode and the 'normal' guide run; the entry points follow the
    device rule."""
    X, y = _data()
    for kwargs in ({"nn_prior": False}, {"guide": "normal"}):
        m = gpax_torch.viDKL(D, 2, **kwargs)
        m.fit(0, X, y, num_steps=20, print_summary=False, progress_bar=False, device="cpu")
        assert bool(torch.isfinite(m.loss).all())
        mean, var = m.predict(None, X[:4], device="cpu")
        assert bool(torch.isfinite(mean).all()) and bool((var > 0).all())
    with pytest.raises(NotImplementedError):
        gpax_torch.viDKL(D, 2, guide="bogus")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            gpax_torch.viDKL(D, 2).fit(0, X, y, num_steps=1, print_summary=False)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            m.predict(None, X[:2])


# ---------------------------------------------------------------- viMTDKL

def test_vi_mtdkl_neg_elbo_and_predict_match_jax(jax_fp32_wtw):
    """viMTDKL's negative ELBO at JAX's initial values (rtol 1e-4), and
    predict on a state carried over from a short JAX fit."""
    X, y = _mtdata()
    Xj, yj = jnp.asarray(X), jnp.asarray(y)
    jm = gpax_tpu.viMTDKL(5, z_dim=2, data_kernel="RBF", num_latents=1, num_tasks=2, rank=1)
    jm.X_train = Xj
    jguide, init = _jax_delta_init(jm, Xj, yj, jax.random.PRNGKey(0))
    jsvi = gpax_tpu.infer.SVI(jm.model, jguide, optax.adam(1e-3))
    jv = jax.jit(jsvi._neg_elbo)(init, {}, jax.random.PRNGKey(0), (Xj, yj), {})
    tm = gpax_torch.viMTDKL(5, z_dim=2, data_kernel="RBF", num_latents=1, num_tasks=2, rank=1)
    Xt, yt = tm._set_data(X, y, device="cpu")
    tm.X_train = Xt
    tsvi = SVI(tm.model, AutoDelta(tm.model), 1e-3)
    tsvi.guide.init_params(torch.Generator().manual_seed(0), (Xt, yt))
    assert set(tsvi.guide._transforms) == set(jguide._transforms)
    tv = tsvi._neg_elbo({k: torch.tensor(np.asarray(v)) for k, v in init.items()}, {}, None,
                        (Xt, yt), {})
    assert_close(tv, jv, rtol=1e-4)

    jm.fit(jax.random.PRNGKey(1), Xj, yj, num_steps=40, print_summary=False,
           progress_bar=False)
    load_vidkl_state(tm, vidkl_state_from_jax(jm), device="cpu")
    X_new = np.column_stack([np.random.default_rng(3).normal(size=(6, 5)),
                             np.array([0, 1, 1, 0, 1, 0])]).astype(np.float32)
    jmean, jvar = jm.predict(None, jnp.asarray(X_new))
    tmean, tvar = tm.predict(None, X_new, device="cpu")
    assert tmean.shape == (6,)
    assert_close(tmean, jmean, rtol=0, atol=PRED_RTOL * np.abs(np.asarray(jmean)).max()
                 + PRED_ATOL)
    assert_close(tvar, jvar, rtol=0, atol=PRED_RTOL * np.abs(np.asarray(jvar)).max()
                 + PRED_ATOL)


def test_vi_mtdkl_fit_and_batched_ensemble():
    X, y = _mtdata()
    m = gpax_torch.viMTDKL(5, z_dim=2, data_kernel="RBF", num_latents=1, num_tasks=2, rank=1)
    m.fit(0, X, y, num_steps=40, print_summary=False, progress_bar=False, device="cpu")
    nn_params, k_params = m.get_samples()
    assert "W" in k_params and k_params["noise"].shape == (2,)
    mean, var = m.predict(None, X, device="cpu")
    assert mean.shape == (14,) and bool((var > 0).all())
    mean, var = gpax_torch.viMTDKL(
        5, z_dim=2, data_kernel="RBF", num_latents=1, num_tasks=2, rank=1).fit_predict(
        0, X, y, X[:5], num_steps=20, n_models=2, print_summary=False, progress_bar=False,
        device="cpu")
    assert mean.shape == (2, 5) and bool(torch.isfinite(var).all())
