"""Carry the JAX package's state across to the port."""

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
