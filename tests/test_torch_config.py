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
    """Each precision field keeps the port's default ("highest" gram,
    "float64" WᵀW), takes every mode of the JAX package (and the port's
    "float64" WᵀW), and refuses any other value with ValueError."""
    default, accepted, refused = {
        "gram_precision": ("highest", ("compensated", "highest"), ("float64", "default")),
        "wtw_precision": ("float64", ("highest", "compensated", "default", "float64"),
                          ("bf16", None)),
    }[field]
    assert getattr(get_config(), field) == default
    try:
        for mode in accepted:
            assert getattr(set_config(**{field: mode}), field) == mode
    finally:
        set_config(**{field: default})
    for other in refused:
        with pytest.raises(ValueError):
            set_config(**{field: other})
    assert getattr(get_config(), field) == default


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


@pytest.mark.parametrize("order", [(True, False), (False, True, False)])
def test_enable_x64_leaves_tf32_off_and_sets_the_default_dtype(order):
    """enable_x64 switches torch's default dtype (is_x64 reads it back) and
    leaves the fp32 matmul pins in place, both ways."""
    try:
        for on in order:
            gpax_torch.enable_x64(on)
            assert gpax_torch.config.is_x64() is on
            assert torch.get_default_dtype() == (torch.float64 if on else torch.float32)
            test_import_pins_fp32_matmul()
    finally:
        gpax_torch.enable_x64(False)
