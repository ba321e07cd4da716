"""Carry the JAX package's state across to the port.

These read a ``gpax_tpu`` object's arrays with ``np.asarray`` and import
nothing of JAX, so the port can take over a model fitted by the JAX package
and both can predict from the same state.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def samples_from_numpy(samples: Dict[str, np.ndarray], device=None,
                       dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """Posterior samples as numpy arrays (e.g. ``{"k_length": (S, d),
    "k_scale": (S,), "noise": (S,)}`` from ``gpax_tpu.ExactGP.get_samples()``)
    as the port's dict of tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
            for k, v in samples.items()}


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
