"""General utilities (counterpart of ``gpax_tpu/utils/utils.py``): RNG
generators, batching, the device memory budget, and the count of host reads
of device values."""

from __future__ import annotations

from typing import List, Optional, Union

import torch

__all__ = ["get_keys", "spawn", "split_in_batches", "device_memory_budget",
           "host_bool", "host_syncs", "reset_host_syncs"]

_MAX_SEED = 2**62

_host_reads = [0]


def get_keys(seed: int = 0):
    """Two independent generators (fit, predict) from one integer seed
    (``utils.py:32-34``). They live on the CPU; the samplers derive their own
    generators on the data's device from them with :func:`spawn`."""
    root = torch.Generator().manual_seed(seed)
    return spawn(root), spawn(root)


def spawn(key: Union[torch.Generator, int],
          device: Optional[torch.device] = None) -> torch.Generator:
    """A new generator on ``device`` (default CPU), seeded from ``key`` — the
    port's ``jax.random.split``. ``key`` is a CPU generator (advanced by one
    draw) or an integer seed."""
    if isinstance(key, int):
        key = torch.Generator().manual_seed(key)
    if key.device.type != "cpu":
        raise ValueError("spawn: derive generators from a CPU generator "
                         "(reading a device generator's draw would sync)")
    s = int(torch.randint(_MAX_SEED, (), generator=key))
    return torch.Generator(device=device or "cpu").manual_seed(s)


def split_in_batches(X_new: torch.Tensor, batch_size: int = 100, dim: int = 0) -> List:
    """Chunk a tensor along dim 0 or 1 (trailing remainder kept as a short
    chunk)."""
    if dim not in (0, 1):
        raise NotImplementedError("'dim' must be 0 or 1")
    return list(torch.split(X_new, batch_size, dim=dim))


def device_memory_budget(device: Optional[torch.device] = None,
                         fraction: float = 0.4, default: int = 1 << 31) -> int:
    """Usable scratch budget in bytes for chunked computations: ``fraction``
    of the free memory that ``torch.cuda.mem_get_info`` reports on a CUDA
    device (at least 64 MiB), ``default`` (2 GiB) on the CPU."""
    device = torch.device(device or "cpu")
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return max(int(fraction * free), 64 << 20)
    return default


def host_bool(flag: torch.Tensor) -> bool:
    """Read a device flag on the host. On a CUDA tensor this waits for the
    device to produce it and stalls the launch queue, so every read is
    counted (:func:`host_syncs`)."""
    _host_reads[0] += 1
    return bool(flag)


def host_syncs() -> int:
    """Host reads of device flags since the last :func:`reset_host_syncs`."""
    return _host_reads[0]


def reset_host_syncs() -> None:
    _host_reads[0] = 0
