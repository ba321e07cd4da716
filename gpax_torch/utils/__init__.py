from .convert import samples_from_numpy
from .utils import (
    device_memory_budget,
    get_keys,
    host_bool,
    host_syncs,
    reset_host_syncs,
    spawn,
    split_in_batches,
)

__all__ = [
    "get_keys",
    "spawn",
    "split_in_batches",
    "device_memory_budget",
    "host_bool",
    "host_syncs",
    "reset_host_syncs",
    "samples_from_numpy",
]
