from .checkpoint import load_model, load_pytree, save_model, save_pytree
from .convert import (
    load_vi_state,
    load_vidkl_state,
    samples_from_numpy,
    vi_state_from_jax,
    vidkl_state_from_jax,
)
from .fn import _set_noise_kernel_fn, call_batched, set_fn, set_kernel_fn
from .monitor import debug_nans, fit_report, profile, timed
from .utils import (
    device_memory_budget,
    dviz,
    enable_x64,
    get_haiku_dict,
    get_keys,
    host_bool,
    host_syncs,
    initialize_inducing_points,
    preprocess_sparse_image,
    random_sample_dict,
    reset_host_syncs,
    resolve_device,
    spawn,
    split_dict,
    split_in_batches,
    tree_map,
)

# the JAX package's compat re-export of the prior factories through utils
# (gpax_tpu/utils/__init__.py:22-28)
from ..priors.priors import (  # noqa: E402
    gamma_dist,
    halfnormal_dist,
    lognormal_dist,
    normal_dist,
    uniform_dist,
)

__all__ = [
    "enable_x64",
    "normal_dist",
    "lognormal_dist",
    "halfnormal_dist",
    "gamma_dist",
    "uniform_dist",
    "save_model",
    "load_model",
    "save_pytree",
    "load_pytree",
    "profile",
    "timed",
    "fit_report",
    "debug_nans",
    "get_keys",
    "spawn",
    "resolve_device",
    "split_in_batches",
    "split_dict",
    "random_sample_dict",
    "dviz",
    "device_memory_budget",
    "host_bool",
    "host_syncs",
    "reset_host_syncs",
    "initialize_inducing_points",
    "preprocess_sparse_image",
    "samples_from_numpy",
    "vi_state_from_jax",
    "load_vi_state",
    "vidkl_state_from_jax",
    "load_vidkl_state",
    "get_haiku_dict",
    "tree_map",
    "set_fn",
    "set_kernel_fn",
    "_set_noise_kernel_fn",
    "call_batched",
]
