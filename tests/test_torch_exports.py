"""Export parity: every public name of gpax_tpu's package and subpackage
``__init__`` lists (and of the modules named below) exists in gpax_torch,
except the deliberate omissions listed here, each with its reason. An
omission that the port has since filled must leave the list."""

import importlib

import pytest

import gpax_torch

OMITTED: dict = {}
OMITTED_MODULES: dict = {}
# the names and the module omitted until the port filled them: x64 mode,
# the blocked-scheme rule, the vmap in_axes helper and the parallel package
PORTED_LATE = [("", "enable_x64"), ("utils", "enable_x64"), ("config", "enable_x64"),
               ("config", "is_x64"), ("ops", "blocked_eligible"),
               ("kernels.mtkernels", "get_in_axes"), ("parallel", "sharded_linalg")]

# the package, its subpackages, and modules whose names users reach directly
MODULES = ["", "acquisition", "distributions", "distributions.constraints", "infer",
           "kernels", "kernels.mtkernels", "models", "nn", "ops", "ppl", "priors", "utils",
           "hypo", "config", "parallel"]


def _public(mod) -> list:
    """The module's ``__all__``, else its public names defined in gpax_tpu."""
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    return [n for n in dir(mod) if not n.startswith("_")
            and getattr(getattr(mod, n), "__module__", "").startswith("gpax_tpu")]


@pytest.mark.parametrize("name", MODULES)
def test_port_exports_every_reference_name(name):
    jmod = importlib.import_module("gpax_tpu" + ("." + name if name else ""))
    if name in OMITTED_MODULES:
        with pytest.raises(ImportError):
            importlib.import_module("gpax_torch." + name)
        return
    tmod = importlib.import_module("gpax_torch" + ("." + name if name else ""))
    missing = sorted(n for n in _public(jmod)
                     if not hasattr(tmod, n) and (name, n) not in OMITTED)
    assert not missing, f"gpax_torch.{name or '__init__'} lacks {missing}"
    if hasattr(tmod, "__all__"):
        assert not [n for n in tmod.__all__ if not hasattr(tmod, n)]


def test_omissions_are_still_missing():
    """Each named omission is still absent from the port; once it is
    ported, it leaves OMITTED (now empty: the port has every name)."""
    for name, attr in OMITTED:
        tmod = importlib.import_module("gpax_torch" + ("." + name if name else ""))
        assert not hasattr(tmod, attr), f"{attr} is ported now: drop it from OMITTED"
    assert not OMITTED and not OMITTED_MODULES


@pytest.mark.parametrize("key", PORTED_LATE)
def test_late_ports_match_the_reference(key):
    """The names that were omitted exist in the port and in gpax_tpu, and
    the parallel package is importable as a module of the port."""
    name, attr = key
    for pkg in ("gpax_tpu", "gpax_torch"):
        mod = importlib.import_module(pkg + ("." + name if name else ""))
        assert callable(getattr(mod, attr)), f"{pkg}.{name}.{attr}"


def test_top_level_names():
    """The names this slice added at the top level and in utils."""
    assert {"priors", "hypo", "sample_next"} <= set(gpax_torch.__all__)
    for n in ("save_model", "load_model", "save_pytree", "load_pytree", "profile", "timed",
              "fit_report", "debug_nans", "split_dict", "random_sample_dict", "dviz",
              "gamma_dist", "uniform_dist"):
        assert n in gpax_torch.utils.__all__
    assert gpax_torch.ops.tri_solve is not None


# the JAX Config's fields that the port leaves out, with the reason: the port
# picks kernels by device and pins fp32 matmuls (gpax_torch/config.py)
CONFIG_OMITTED = {
    "matmul_precision": "fp32 matmuls are pinned; no XLA precision knob",
    "use_pallas": "K1 launches on a CUDA tensor, its twin runs on a CPU tensor",
    "pallas_min_elems": "no size threshold chooses K1",
    "use_pallas_chol": "K2/K3 launch on a CUDA tensor, their twins run on a CPU tensor",
    "pallas_chol_min_n": "no size threshold chooses K2/K3",
}


def test_config_fields_match_the_reference():
    """Every field of gpax_tpu's Config is a field of the port's Config, or
    one of the named omissions, which set_config refuses with its reason."""
    import dataclasses

    import gpax_tpu.config as jconfig
    from gpax_torch import config as tconfig

    jfields = {f.name for f in dataclasses.fields(jconfig.Config)}
    tfields = {f.name for f in dataclasses.fields(tconfig.Config)}
    assert set(CONFIG_OMITTED) <= jfields
    assert not (jfields - tfields - set(CONFIG_OMITTED)), jfields - tfields
    assert not (tfields & set(CONFIG_OMITTED))
    for name in CONFIG_OMITTED:
        with pytest.raises(NotImplementedError, match="not ported"):
            tconfig.set_config(**{name: getattr(jconfig.Config(), name)})
