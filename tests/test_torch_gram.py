"""K1 (fused gram): the port's twin against the JAX fused gram in Pallas
interpret mode, for values and gradients (cases of tests/test_pallas.py)."""

import numpy as np
import pytest
import torch

from _torch_parity import assert_close, value_and_grads
from gpax_torch.kernels import MaternKernel as TMatern
from gpax_torch.kernels import PeriodicKernel as TPeriodic
from gpax_torch.kernels import RBFKernel as TRBF
from gpax_torch.kernels import square_scaled_distance as t_ssd
from gpax_torch.ops import gram as tgram
from gpax_tpu.kernels import PeriodicKernel as JPeriodic
from gpax_tpu.kernels import square_scaled_distance as j_ssd
from gpax_tpu.ops.pallas_gram import gram as jgram

torch.set_num_threads(1)

KINDS = [("rbf", TRBF), ("matern52", TMatern)]


def _inputs(n, m, d, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    Z = X if (n, d) == (m, d) else rng.normal(size=(m, d)).astype(np.float32)
    ls = rng.uniform(0.5, 2.0, d).astype(np.float32)
    return X, Z, ls


@pytest.mark.parametrize("kind,_", KINDS)
@pytest.mark.parametrize("n,m,d", [(16, 16, 1), (40, 40, 3), (40, 24, 2),
                                   (13, 13, 1), (22, 22, 2), (27, 27, 2), (12, 9, 3),
                                   (5, 30, 1), (70, 131, 2)])
def test_gram_twin_matches_pallas_interpret(kind, _, n, m, d):
    """Among the cases: widths that are not a multiple of 4 (m % 4 in {1,
    2, 3}: rows that K1 stores element by element) and n below and above
    K1's 64-row tile."""
    X, Z, ls = _inputs(n, m, d)
    ref = jgram(X, X if Z is X else Z, ls, np.float32(1.7), np.float32(0.3),
                kind=kind, jitter=1e-6, interpret=True)
    Xt = torch.tensor(X)
    Zt = Xt if Z is X else torch.tensor(Z)
    out = tgram.gram(Xt, Zt, torch.tensor(ls), torch.tensor(1.7), torch.tensor(0.3),
                     kind=kind, jitter=1e-6)
    # fp32 r² from norms of size ~d: agreement to a few ulps of the map
    assert_close(out, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kind,kernel", KINDS)
def test_kernel_functions_route_to_gram(kind, kernel):
    X, Z, ls = _inputs(30, 12, 2, seed=3)
    params = {"k_length": torch.tensor(ls), "k_scale": torch.tensor(0.9)}
    out_xx = kernel(torch.tensor(X), torch.tensor(X), params, 0.2)
    out_xz = kernel(torch.tensor(X), torch.tensor(Z), params, 0.2)
    for Zj, out in ((X, out_xx), (Z, out_xz)):
        ref = jgram(X, Zj, ls, np.float32(0.9), np.float32(0.2), kind=kind, interpret=True)
        assert_close(out, ref, rtol=2e-5, atol=2e-5)


def test_gram_vector_noise():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(12, 2)).astype(np.float32)
    noise = rng.uniform(0.1, 0.5, 12).astype(np.float32)
    ref = jgram(X, X, np.ones(2, np.float32), np.float32(2.0), noise, kind="rbf",
                interpret=True)
    Xt = torch.tensor(X)
    out = tgram.gram(Xt, Xt, torch.ones(2), torch.tensor(2.0), torch.tensor(noise))
    assert_close(out, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kind,_", KINDS)
@pytest.mark.parametrize("same", [True, False])
def test_gram_gradients_match_pallas(kind, _, same):
    """Closed-form backward vs the JAX custom VJP, for k_length, k_scale and
    noise (the symmetric X≡Z fast path and the general one)."""
    X, Z, _ = _inputs(20, 20 if same else 14, 2, seed=5)

    def jf(kl, ks, nz):
        return jnp_sin(jgram(X, X if same else Z, kl, ks, nz, kind=kind, interpret=True))

    Xt = torch.tensor(X)
    Zt = Xt if same else torch.tensor(Z)

    def tf(kl, ks, nz):
        return torch.sin(tgram.gram(Xt, Zt, kl, ks, nz, kind=kind))

    (jv, tv), grads = value_and_grads(jf, tf, [[0.8, 1.3], 1.5, 0.2], argnums=(0, 1, 2))
    assert_close(tv, jv, rtol=2e-5, atol=2e-5)
    for jg, tg in grads:
        # sums over n² terms of fp32 products: relative agreement 1e-4
        assert_close(tg, jg, rtol=1e-4, atol=1e-5)


def jnp_sin(x):
    import jax.numpy as jnp

    return jnp.sin(x)


def test_gram_gradient_wrt_inputs():
    """dX through the kernel (used when a caller differentiates the data)."""
    X, Z, ls = _inputs(10, 7, 2, seed=7)

    def jf(x, z):
        return jnp_sin(jgram(x, z, ls, np.float32(1.1), np.float32(0.0), interpret=True))

    def tf(x, z):
        return torch.sin(tgram.gram(x, z, torch.tensor(ls), torch.tensor(1.1), 0.0))

    _, grads = value_and_grads(jf, tf, [X, Z], argnums=(0, 1))
    for jg, tg in grads:
        assert_close(tg, jg, rtol=1e-4, atol=1e-5)


def test_gram_batched_hyperparameters_match_per_draw():
    """A leading batch of hyperparameters (predict's chunk of draws) equals
    one gram per draw."""
    X, Z, _ = _inputs(15, 9, 2, seed=11)
    rng = np.random.default_rng(2)
    ls = torch.tensor(rng.uniform(0.5, 2, (4, 2)), dtype=torch.float32)
    ks = torch.tensor(rng.uniform(0.5, 2, 4), dtype=torch.float32)
    nz = torch.tensor(rng.uniform(0.1, 0.3, 4), dtype=torch.float32)
    Xt, Zt = torch.tensor(X), torch.tensor(Z)
    for kind in ("rbf", "matern52"):
        kxx = tgram.gram(Xt, Xt, ls, ks, nz, kind=kind)
        kxz = tgram.gram(Xt, Zt, ls, ks, nz, kind=kind)
        assert kxx.shape == (4, 15, 15) and kxz.shape == (4, 15, 9)
        for s in range(4):
            assert_close(kxx[s], tgram.gram(Xt, Xt, ls[s], ks[s], nz[s], kind=kind), 1e-6, 1e-7)
            assert_close(kxz[s], tgram.gram(Xt, Zt, ls[s], ks[s], nz[s], kind=kind), 1e-6, 1e-7)


def test_cpu_tensors_take_the_twin_and_never_count_a_launch():
    X, _, ls = _inputs(8, 8, 1)
    before = tgram.launches
    Xs = torch.tensor(X)[None]
    out = tgram.gram_unscaled(Xs, Xs, torch.zeros(1, 8), "rbf", True)
    assert tgram.launches == before
    assert_close(out, tgram.gram_twin(Xs, Xs, torch.zeros(1, 8)), 0, 0)


def test_square_scaled_distance_and_periodic_match_jax():
    X, Z, ls = _inputs(9, 6, 2, seed=13)
    assert_close(t_ssd(torch.tensor(X), torch.tensor(Z), torch.tensor(ls)),
                 j_ssd(X, Z, ls), rtol=1e-5, atol=1e-5)
    params = {"k_length": ls, "k_scale": np.float32(1.4), "period": np.float32(0.7)}
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    for Zi in (X, Z):
        assert_close(TPeriodic(torch.tensor(X), torch.tensor(Zi), tparams, 0.1),
                     JPeriodic(X, Zi, params, 0.1), rtol=2e-5, atol=2e-5)
