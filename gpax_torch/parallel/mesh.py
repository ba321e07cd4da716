"""Device meshes (counterpart of ``gpax_tpu/parallel/mesh.py``).

A :class:`Mesh` is a list of devices with named axes, as
``jax.sharding.Mesh`` is; the port's sharded entry points
(``parallel/sharded.py``, ``parallel/distributed_chol.py``) split their
work into one contiguous chunk per device of the mesh, run each chunk on
its device, and gather the results on the first. A slot may repeat a
device: ``Mesh([torch.device("cpu")] * 8, ("grid",))`` runs the same
chunking on the CPU, which is how the tests drive it.

torch has no single-process sharded tensor (the JAX package places one
array across devices with a ``NamedSharding``), so
:func:`shard_leading_axis` places a tree on a mesh of one device and
raises on a mesh of several.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


class Mesh:
    """Devices in a numpy object array (``.devices``, with ``.size`` and
    ``.flat`` as on ``jax.sharding.Mesh``) and the names of its axes."""

    def __init__(self, devices: Sequence, axis_names=("grid",)):
        devs = [torch.device(d) for d in np.asarray(devices, dtype=object).reshape(-1)]
        self.devices = np.empty(len(devs), dtype=object)
        self.devices[:] = devs
        self.axis_names = tuple(axis_names)

    def device_list(self) -> list:
        return list(self.devices.flat)

    def __repr__(self) -> str:
        return f"Mesh({self.device_list()}, {self.axis_names})"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> int:
    """Join a multi-process group and return its device count: the world
    size times this process's local devices (its CUDA cards, or 1 for the
    CPU). ``coordinator_address`` is ``host:port`` of process 0
    (``torch.distributed``'s ``tcp://`` rendezvous); without it the
    ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK`` environment
    variables are read. NCCL with a card, gloo without one. A group already
    initialized is kept."""
    import torch.distributed as dist

    cuda = torch.cuda.is_available()
    if not dist.is_initialized():
        init = "env://" if coordinator_address is None else f"tcp://{coordinator_address}"
        dist.init_process_group(
            "nccl" if cuda else "gloo", init_method=init,
            world_size=-1 if num_processes is None else num_processes,
            rank=-1 if process_id is None else process_id)
    return dist.get_world_size() * (torch.cuda.device_count() if cuda else 1)


def get_mesh(n_devices: Optional[int] = None, axis_name: str = "grid") -> Mesh:
    """1-D mesh over this process's first ``n_devices`` CUDA cards (default:
    all). Without a card it raises: a CPU mesh is built explicitly,
    ``Mesh([torch.device("cpu")] * k, (axis_name,))``."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "get_mesh spans the CUDA cards and none is available; build a CPU mesh "
            'explicitly: Mesh([torch.device("cpu")] * k, ("grid",))')
    devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices, (axis_name,))


def shard_leading_axis(tree, mesh: Mesh, axis_name: str = "grid"):
    """Every tensor of ``tree`` on the mesh's device, when the mesh has one
    (whatever its number of slots). A mesh of several distinct devices
    raises: torch has no single-process tensor split across devices, and
    the port's sharded entry points split their inputs themselves."""
    devices = set(mesh.device_list())
    if len(devices) > 1:
        raise NotImplementedError(
            "shard_leading_axis: torch has no single-process sharded tensor; on a mesh "
            "of several devices use sharded_predict/sharded_acquisition/sharded_linalg, "
            "which split their work over the mesh")
    (dev,) = devices

    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        return torch.as_tensor(x).to(dev)

    return put(tree)
