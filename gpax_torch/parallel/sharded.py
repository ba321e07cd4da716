"""Grid-split prediction and acquisition (counterpart of
``gpax_tpu/parallel/sharded.py``).

Active-learning grids (test points, acquisition candidates) are
embarrassingly parallel in the points dimension: each device needs the
whole training set (small) and a piece of the grid. The grid is padded to
a multiple of the mesh's size by repeating its last row, split into one
contiguous chunk per device, and chunk i runs through the model's own
entry point on device i (``device=`` of ``predict`` or of the acquisition
function); the outputs are gathered on the mesh's first device and sliced
back to the grid's size. On a mesh of one device this is one call, the
same call as the model's own.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .mesh import Mesh, get_mesh


def _pad_to_multiple(X: torch.Tensor, k: int):
    n = X.shape[0]
    pad = (-n) % k
    if pad == 0:
        return X, n
    return torch.cat([X, X[-1:].expand((pad,) + tuple(X.shape[1:]))], 0), n


def _grid(X, mesh: Mesh):
    """(the padded 2-D grid, its unpadded length, its chunks, the devices)."""
    X = torch.as_tensor(X)
    X = X if X.ndim > 1 else X[:, None]
    devices = mesh.device_list()
    Xp, n = _pad_to_multiple(X, len(devices))
    return Xp, n, torch.tensor_split(Xp, len(devices)), devices


def _gather(parts, ax: int, chunk: int, home) -> torch.Tensor:
    """The chunks' outputs joined along their grid axis ``ax`` on ``home``;
    an output without the grid axis is the same in every chunk and is taken
    from the first."""
    if len(parts) == 1 or parts[0].shape[ax % parts[0].ndim] != chunk:
        return parts[0]
    return torch.cat([p.to(home) for p in parts], dim=ax)


def sharded_predict(model, rng_key, X_new, mesh: Optional[Mesh] = None,
                    axis_name: str = "grid", grid_axes=(0, -1), **kwargs):
    """``model.predict`` with the test grid split over the mesh's devices.

    ``grid_axes`` names the grid axis of each predict output explicitly (the
    framework contract: the mean carries the grid on axis 0, draws and
    variances on the last axis); an output past the tuple's end takes its
    last entry. The axis is never inferred by shape matching, so a sample
    count that equals the padded grid's size cannot mis-slice an output.
    ``rng_key`` is passed to every chunk's call as it is.
    """
    if mesh is None:
        mesh = get_mesh(axis_name=axis_name)
    Xp, n, chunks, devices = _grid(X_new, mesh)
    outs = [model.predict(rng_key, c, device=d, **kwargs) for c, d in zip(chunks, devices)]
    single = not isinstance(outs[0], tuple)
    outs = [(o,) if single else o for o in outs]
    axes = tuple(grid_axes) + (grid_axes[-1],) * (len(outs[0]) - len(grid_axes))
    sliced = []
    for j, ax in enumerate(axes):
        o = _gather([out[j] for out in outs], ax, chunks[0].shape[0], devices[0])
        ax = ax % o.ndim
        if o.shape[ax] == Xp.shape[0]:
            o = o.narrow(ax, 0, n)
        sliced.append(o)
    return sliced[0] if single else tuple(sliced)


def sharded_acquisition(acq_fn: Callable, rng_key, model, X_cand,
                        mesh: Optional[Mesh] = None, axis_name: str = "grid",
                        **kwargs) -> torch.Tensor:
    """An acquisition function with the candidate grid split over the mesh's
    devices (each chunk's call gets ``device=`` its device); returns the
    whole acquisition vector on the mesh's first device."""
    if mesh is None:
        mesh = get_mesh(axis_name=axis_name)
    _, n, chunks, devices = _grid(X_cand, mesh)
    parts = [acq_fn(rng_key, model, c, device=d, **kwargs) for c, d in zip(chunks, devices)]
    acq = _gather(parts, -1, chunks[0].shape[0], devices[0])
    return acq.narrow(acq.ndim - 1, 0, n)
