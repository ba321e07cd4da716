from .convert import load_vi_state, samples_from_numpy, vi_state_from_jax
from .utils import (
    device_memory_budget,
    get_keys,
    host_bool,
    host_syncs,
    initialize_inducing_points,
    preprocess_sparse_image,
    reset_host_syncs,
    resolve_device,
    spawn,
    split_in_batches,
)

__all__ = [
    "get_keys",
    "spawn",
    "resolve_device",
    "split_in_batches",
    "device_memory_budget",
    "host_bool",
    "host_syncs",
    "reset_host_syncs",
    "initialize_inducing_points",
    "preprocess_sparse_image",
    "samples_from_numpy",
    "vi_state_from_jax",
    "load_vi_state",
]
