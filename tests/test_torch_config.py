"""gpax_torch config: fp32 matmul pins and the import guard (no jax)."""

import subprocess
import sys

import pytest
import torch

import gpax_torch
from gpax_torch.config import get_config, pin_fp32_matmul, set_config

torch.set_num_threads(1)


def test_import_pins_fp32_matmul():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_set_config_repins_after_user_change():
    torch.set_float32_matmul_precision("high")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        set_config(default_jitter=1e-6)
        assert torch.get_float32_matmul_precision() == "highest"
        assert torch.backends.cuda.matmul.allow_tf32 is False
    finally:
        pin_fp32_matmul()


@pytest.mark.parametrize("field", ["gram_precision", "wtw_precision"])
def test_only_highest_precision_is_ported(field):
    """Each precision field has one ported mode: the fp32 gram ("highest")
    and the float64 factor path and WᵀW ("float64")."""
    mode = {"gram_precision": "highest", "wtw_precision": "float64"}[field]
    assert getattr(get_config(), field) == mode
    for other in ("compensated", "highest" if mode == "float64" else "float64"):
        with pytest.raises(NotImplementedError):
            set_config(**{field: other})
    assert getattr(get_config(), field) == mode


@pytest.mark.parametrize("kernel", ["RBF", "Matern", "Periodic"])
def test_kernels_read_default_jitter(kernel):
    X = torch.linspace(0, 1, 5)[:, None]
    params = {"k_length": torch.tensor([0.5]), "k_scale": torch.tensor(1.0),
              "period": torch.tensor(2.0)}
    k = gpax_torch.kernels.get_kernel(kernel)
    base = k(X, X, params, 0.1)
    try:
        set_config(default_jitter=1e-2)
        raised = k(X, X, params, 0.1)
    finally:
        set_config(default_jitter=1e-6)
    # only the diagonal moves, by the change of the jitter
    torch.testing.assert_close(raised - base, (1e-2 - 1e-6) * torch.eye(5),
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(k(X, X, params, 0.1, jitter=0.0) - base,
                               -1e-6 * torch.eye(5), rtol=0, atol=1e-7)


def test_import_leaves_jax_out():
    code = ("import sys, gpax_torch, gpax_torch.models, gpax_torch.infer; "
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)


def test_public_names():
    assert gpax_torch.ExactGP is gpax_torch.models.ExactGP
    assert callable(gpax_torch.utils.get_keys)
