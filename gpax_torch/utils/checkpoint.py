"""Posterior checkpoint and resume (counterpart of
``gpax_tpu/utils/checkpoint.py``).

A fitted model's state (posterior draws or variational parameters, the
training data, inducing points, network weights) is a nested dict of
tensors, kept as a path-keyed ``.npz`` with the JAX package's layout and
keys, so a file written by either package loads in the other. This and
``utils/convert.py`` are the two ways state crosses between them.

API:
    save_model(path, model)               - draws or params + training data
    load_model(path, model, device=None)  - onto a freshly built model
    save_pytree / load_pytree             - any nested dict of tensors
"""

from __future__ import annotations

import pathlib
from typing import Any, Dict

import numpy as np
import torch

from .convert import load_vi_state
from .utils import resolve_device, tree_map


def _flatten(tree: Dict, prefix: str = ""):
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from _flatten(v, path)
        else:
            yield path, v


def _unflatten(flat: Dict[str, Any]) -> Dict:
    out: Dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def save_pytree(path: str, tree: Dict) -> None:
    """Persist a nested dict of tensors or arrays as ``path`` (.npz)."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **{p: _numpy(v) for p, v in _flatten(tree)})


def load_pytree(path: str, device=None) -> Dict:
    """A nested dict saved with :func:`save_pytree` (by either package), as
    tensors on ``device`` (None: the CUDA card)."""
    p = str(path)
    if not p.endswith(".npz"):
        p = p + ".npz"
    dev = resolve_device(device)
    with np.load(p) as data:
        flat = {k: torch.as_tensor(data[k], device=dev) for k in data.files}
    return _unflatten(flat)


class _RestoredMCMC:
    """Read-only stand-in that serves a saved posterior through the MCMC API."""

    def __init__(self, samples_by_chain: Dict[str, torch.Tensor]):
        self._samples = samples_by_chain

    def get_samples(self, group_by_chain: bool = False):
        if group_by_chain:
            return self._samples
        return {k: v.reshape((-1,) + v.shape[2:]) for k, v in self._samples.items()}

    def print_summary(self, prob: float = 0.9):
        from ..infer import diagnostics

        diagnostics.print_summary(self._samples, prob)


def save_model(path: str, model) -> None:
    """Checkpoint what a fitted model needs to predict."""
    state: Dict[str, Any] = {}
    if getattr(model, "X_train", None) is not None:
        state["X_train"] = model.X_train
        state["y_train"] = model.y_train
    if getattr(model, "mcmc", None) is not None and hasattr(model.mcmc, "get_samples"):
        state["mcmc_samples"] = model.mcmc.get_samples(group_by_chain=True)
    if getattr(model, "kernel_params", None) is not None:
        state["kernel_params"] = model.kernel_params
        # SVI models take their point estimates through the guide, which is
        # not saved: the constrained medians are
        if getattr(model, "svi", None) is not None:
            state["vi_median"] = model.get_samples()
    if isinstance(getattr(model, "nn_params", None), dict):
        state["nn_params"] = model.nn_params
    if getattr(model, "Xu", None) is not None:
        state["Xu"] = model.Xu
    if getattr(model, "measured_noise", None) is not None:
        state["measured_noise"] = model.measured_noise
    save_pytree(path, state)


def load_model(path: str, model, device=None):
    """Restore a checkpoint onto a freshly built model of the same
    configuration, its tensors on ``device`` (None: the CUDA card). An SVI
    model's medians go through ``convert.load_vi_state``, as state carried
    from a JAX model does (viGP, viSparseGP). Returns the model."""
    dev = resolve_device(device)
    state = load_pytree(path, dev)
    if "X_train" in state:
        model.X_train = state["X_train"]
        model.y_train = state["y_train"]
    if "mcmc_samples" in state:
        model.mcmc = _RestoredMCMC(state["mcmc_samples"])
    if "kernel_params" in state:
        model.kernel_params = state["kernel_params"]
    if "nn_params" in state:
        model.nn_params = state["nn_params"]
    if "Xu" in state:
        model.Xu = state["Xu"]
    if "measured_noise" in state:
        model.measured_noise = state["measured_noise"]
    if "vi_median" in state and hasattr(model, "_restored_median"):
        vi = {"median": tree_map(_numpy, state["vi_median"]), "X_train": model.X_train,
              "y_train": model.y_train}
        if "Xu" in state:
            vi["Xu"] = state["Xu"]
        load_vi_state(model, vi, dev)
    return model
