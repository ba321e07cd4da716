"""Export parity: every public name of gpax_tpu's package and subpackage
``__init__`` lists (and of the modules named below) exists in gpax_torch,
except the deliberate omissions listed here, each with its reason. An
omission that the port has since filled must leave the list."""

import importlib

import pytest

import gpax_torch

OMITTED = {
    # the TPU dispatch threshold of the Pallas tile kernels: the port takes
    # K2 and K3 at every n (gpax_torch/ops/linalg.py)
    ("ops", "blocked_eligible"): "TPU dispatch threshold, not carried over",
    # a jax.vmap in_axes helper; torch has no counterpart to feed
    ("kernels.mtkernels", "get_in_axes"): "vmap in_axes helper of the JAX package",
    # x64 mode waits for K1's float64 question (ROADMAP Queue 1 item 5)
    ("", "enable_x64"): "float64 mode: ROADMAP Queue 1 item 5",
    ("utils", "enable_x64"): "float64 mode: ROADMAP Queue 1 item 5",
    ("config", "enable_x64"): "float64 mode: ROADMAP Queue 1 item 5",
    ("config", "is_x64"): "float64 mode: ROADMAP Queue 1 item 5",
}
# a whole subpackage not ported: it shards over a JAX mesh, and one card
# has nothing to shard (ROADMAP Queue 1 item 8)
OMITTED_MODULES = {"parallel": "mesh sharding: ROADMAP Queue 1 item 8"}

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


@pytest.mark.parametrize("key", sorted(OMITTED))
def test_omissions_are_still_missing(key):
    """Each named omission is still absent from the port; once it is
    ported, it leaves OMITTED."""
    name, attr = key
    tmod = importlib.import_module("gpax_torch" + ("." + name if name else ""))
    assert not hasattr(tmod, attr), f"{attr} is ported now: drop it from OMITTED"


def test_top_level_names():
    """The names this slice added at the top level and in utils."""
    assert {"priors", "hypo", "sample_next"} <= set(gpax_torch.__all__)
    for n in ("save_model", "load_model", "save_pytree", "load_pytree", "profile", "timed",
              "fit_report", "debug_nans", "split_dict", "random_sample_dict", "dviz",
              "gamma_dist", "uniform_dist"):
        assert n in gpax_torch.utils.__all__
    assert gpax_torch.ops.tri_solve is not None
