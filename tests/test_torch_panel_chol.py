"""gpax_torch.ops.panel_chol (K4/K5's twins on the CPU, with the port's
padding, slicing and batching) against the JAX package's panel kernels in
interpret mode (``scripts/panel_chol.py``, loaded as tests/test_chol.py
loads it) and against numpy in float64."""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import spd
from gpax_torch.ops import chol, panel_chol

torch.set_num_threads(1)


def _jax_panel():
    path = pathlib.Path(__file__).resolve().parents[1] / "scripts" / "panel_chol.py"
    spec = importlib.util.spec_from_file_location("panel_chol", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n", [128, 200, 256, 384])
def test_panel_factors_match_jax(n):
    """L and Wᵀ within the JAX package's own tolerance 5e-4
    (``test_chol.py:245-258``) of its interpret-mode kernels, both float32
    on κ ≤ ~9 matrices; both strictly triangular."""
    mod = _jax_panel()
    K = spd(n, seed=n)
    L_j = np.asarray(mod.panel_cholesky(jnp.asarray(K), True), np.float64)
    WT_j = np.asarray(mod.panel_tri_inv_t(jnp.asarray(L_j, jnp.float32), True), np.float64)
    L = panel_chol.panel_cholesky(torch.tensor(K))
    WT = panel_chol.panel_tri_inv_t(L)
    assert L.dtype == WT.dtype == torch.float32
    assert np.abs(L.double().numpy() - L_j).max() < 5e-4
    assert np.abs(WT.double().numpy() - WT_j).max() < 5e-4
    assert np.abs(WT.double().numpy().T @ L.double().numpy() - np.eye(n)).max() < 5e-4
    assert torch.count_nonzero(torch.triu(L, 1)) == 0
    assert torch.count_nonzero(torch.tril(WT, -1)) == 0


def test_panel_chol_factors_match_jax():
    mod = _jax_panel()
    K = spd(256, seed=3)
    L_j, W_j = mod.panel_chol_factors(jnp.asarray(K), True)
    L, W = panel_chol.panel_chol_factors(torch.tensor(K))
    np.testing.assert_allclose(L.numpy(), np.asarray(L_j), atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(W.numpy(), np.asarray(W_j), atol=5e-4, rtol=5e-4)


def test_panel_cholesky_nan_on_indefinite():
    """NaN, not the finite partial factor ``cholesky_ex`` returns, as the
    JAX kernel's rsqrt gives (``test_chol.py:261-266``)."""
    K = spd(160) - 5.0 * np.eye(160, dtype=np.float32)
    L_j = _jax_panel().panel_cholesky(jnp.asarray(K), True)
    L = panel_chol.panel_cholesky(torch.tensor(K))
    assert not bool(jnp.all(jnp.isfinite(L_j)))
    assert torch.isnan(L).all()


@pytest.mark.parametrize("n", [200, 256])
def test_float64_against_numpy(n):
    """float64 in, float64 out, equal to numpy's factor and inverse to
    ~n·eps·κ (κ ≤ ~9)."""
    K = spd(n, seed=n + 1).astype(np.float64)
    L, W = panel_chol.panel_chol_factors(torch.tensor(K))
    assert L.dtype == W.dtype == torch.float64
    L_np = np.linalg.cholesky(K)
    np.testing.assert_allclose(L.numpy(), L_np, atol=1e-12, rtol=0)
    np.testing.assert_allclose(W.numpy(), np.linalg.inv(L_np), atol=1e-11, rtol=0)


def test_batch_over_leading_dims():
    """A (2, 3, n, n) batch equals the matrices one by one, with a
    non-finite factor in one matrix left to that matrix alone."""
    Ks = np.stack([spd(200, seed=s) for s in range(6)]).reshape(2, 3, 200, 200)
    Ks[1, 2] -= 5.0 * np.eye(200, dtype=np.float32)
    L, W = panel_chol.panel_chol_factors(torch.tensor(Ks))
    assert L.shape == W.shape == (2, 3, 200, 200)
    for i in range(2):
        for j in range(3):
            Li, Wi = panel_chol.panel_chol_factors(torch.tensor(Ks[i, j]))
            torch.testing.assert_close(L[i, j], Li, rtol=0, atol=0, equal_nan=True)
            torch.testing.assert_close(W[i, j], Wi, rtol=0, atol=0, equal_nan=True)
    assert torch.isfinite(L[0]).all() and torch.isnan(L[1, 2]).all()


def test_padding_is_identity():
    """The padded twins see block_diag(K, I) and the slices are exact."""
    K = torch.tensor(spd(200, seed=9))
    Kp = chol._pad_spd(K[None], 256)
    assert Kp.shape == (1, 256, 256)
    torch.testing.assert_close(Kp[0, 200:, 200:], torch.eye(56), rtol=0, atol=0)
    assert torch.count_nonzero(Kp[0, :200, 200:]) == 0
    Lp = panel_chol.panel_cholesky_padded(Kp)
    torch.testing.assert_close(Lp[0, :200, :200], panel_chol.panel_cholesky(K),
                               rtol=0, atol=0)
    torch.testing.assert_close(Lp[0, 200:, 200:], torch.eye(56), rtol=0, atol=0)


def test_cholesky_phase_ms_raises_on_a_cpu_tensor():
    """Only the CUDA kernel has phases: no twin stands in for it."""
    with pytest.raises(RuntimeError, match="CUDA"):
        panel_chol.cholesky_phase_ms(torch.tensor(spd(128)))


def test_tri_inv_phase_ms_raises_on_a_cpu_tensor():
    """K5's phases are the CUDA kernel's too: no twin stands in for them."""
    L = torch.linalg.cholesky(torch.tensor(spd(128)))
    with pytest.raises(RuntimeError, match="CUDA"):
        panel_chol.tri_inv_phase_ms(L)
