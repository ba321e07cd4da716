"""Carry the JAX package's state across to the port.

These read a ``gpax_tpu`` object's arrays with ``np.asarray`` and import
nothing of JAX, so the port can take over a model fitted by the JAX package
and both can predict from the same state.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..config import resolve_dtype
from .utils import resolve_device, tree_map


def samples_from_numpy(samples: Dict[str, np.ndarray], device=None,
                       dtype: Optional[torch.dtype] = None,
                       chain_dim: bool = False) -> Dict[str, torch.Tensor]:
    """Posterior samples as numpy arrays (e.g. ``{"k_length": (S, d),
    "k_scale": (S,), "noise": (S,)}`` from ``gpax_tpu.ExactGP.get_samples()``,
    or any model's sites: VarNoiseGP's ``k_noise_*`` and ``log_var`` (S, n),
    UIGP's ``X_prime`` (S, n, d) and ``sigma_x``, vExactGP's per-task
    (S, T, …)) as the port's dict of tensors on ``device``. With
    ``chain_dim``, the arrays are grouped by chain, (C, S, …) as
    ``get_samples(chain_dim=True)`` gives them, and are flattened to
    (C·S, …), the draws that ``predict`` takes. The tensors own their
    memory: arrays read from JAX are read-only, and a tensor sharing such a
    buffer would be written in place at undefined behaviour."""
    dtype = resolve_dtype(dtype)
    out = {k: torch.as_tensor(np.array(v), dtype=dtype, device=device)
           for k, v in samples.items()}
    if chain_dim:
        out = {k: v.reshape((-1,) + v.shape[2:]) for k, v in out.items()}
    return out


def vi_state_from_jax(model) -> Dict[str, object]:
    """The fitted state of a ``gpax_tpu`` ``viGP`` or ``viSparseGP`` as numpy
    arrays: ``{"median": the guide medians (its get_samples()), "X_train",
    "y_train"}`` and, for ``viSparseGP``, ``"Xu"``, the fitted inducing
    points."""
    state = {"median": {k: np.array(v) for k, v in model.get_samples().items()},
             "X_train": np.array(model.X_train), "y_train": np.array(model.y_train)}
    if getattr(model, "Xu", None) is not None:
        state["Xu"] = np.array(model.Xu)
    return state


def load_vi_state(model, state: Dict[str, object], device=None) -> None:
    """Give a port ``viGP`` or ``viSparseGP`` the state of
    :func:`vi_state_from_jax` on ``device`` (None: the CUDA card): its
    training data, inducing points and the medians that ``get_samples``
    then returns, as after the JAX package's checkpoint restore."""
    model.X_train, model.y_train = state["X_train"], state["y_train"]
    if "Xu" in state:
        model.Xu = state["Xu"]
    model._set_training_data(device=device)
    model._restored_median = samples_from_numpy(state["median"], model.X_train.device,
                                                model.dtype)


def vidkl_state_from_jax(model) -> Dict[str, object]:
    """The fitted state of a ``gpax_tpu`` ``viDKL`` or ``viMTDKL`` as numpy
    arrays: ``{"nn_params": the network's nested dict, "kernel_params",
    "X_train", "y_train"}``, each with any leading ensemble or channel dim
    it has."""
    return {"nn_params": tree_map(np.array, model.nn_params),
            "kernel_params": tree_map(np.array, model.kernel_params),
            "X_train": np.array(model.X_train), "y_train": np.array(model.y_train)}


def load_vidkl_state(model, state: Dict[str, object], device=None) -> None:
    """Give a port ``viDKL`` or ``viMTDKL`` the state of
    :func:`vidkl_state_from_jax` on ``device`` (None: the CUDA card), after
    which it predicts and embeds as the JAX model does."""
    dev = resolve_device(device)

    def tensor(v):
        return torch.as_tensor(np.asarray(v), dtype=model.dtype, device=dev)

    model.X_train, model.y_train = tensor(state["X_train"]), tensor(state["y_train"])
    model.nn_params = tree_map(tensor, state["nn_params"])
    model.kernel_params = tree_map(tensor, state["kernel_params"])
