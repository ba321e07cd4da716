"""Penalties that discourage re-evaluating recent points (counterpart of
``gpax_tpu/acquisition/penalties.py``): "delta" puts +inf on candidates
equal to a recent point, "inverse_distance" the recency-weighted sum of
1/(distance + 1)."""

from __future__ import annotations

import torch


def _as_points(p, like: torch.Tensor) -> torch.Tensor:
    p = torch.as_tensor(p, dtype=like.dtype, device=like.device)
    return p[:, None] if p.ndim == 1 else p


def penalty_point(x: torch.Tensor, recent_points) -> torch.Tensor:
    """The inverse-distance penalty of candidates x (…, d): Σ 1/(‖r − x‖ + 1)
    over the recent points r, the k-th of R divided by R + 1 − k (by 1 if
    there is one)."""
    recent = _as_points(recent_points, x)
    distances = torch.linalg.vector_norm(recent - x[..., None, :], dim=-1)
    R = recent.shape[0]
    timestamps = 1 if R == 1 else torch.arange(R + 1, 1, -1, dtype=x.dtype, device=x.device)
    return (1.0 / (distances + 1.0) / timestamps).sum(-1)


def find_and_replace_point_indices(points: torch.Tensor, other_points) -> torch.Tensor:
    """+inf at the points equal to any of ``other_points``, 0 elsewhere."""
    pts = points if points.ndim > 1 else points[:, None]
    others = _as_points(other_points, pts)
    match = (pts[:, None, :] == others[None, :, :]).all(-1).any(-1)
    out = torch.zeros(len(points), dtype=pts.dtype, device=pts.device)
    return torch.where(match, torch.inf, out)


def compute_penalty(X: torch.Tensor, recent_points, penalty_type: str = "delta",
                    penalty_factor: float = 1.0) -> torch.Tensor:
    """Penalty vector over the candidates X given the recently visited points."""
    if penalty_type not in ("delta", "inverse_distance", "inverse distance"):
        raise NotImplementedError("Available penalty types are 'delta' and 'inverse distance'")
    X = torch.as_tensor(X)
    if penalty_type == "delta":
        return find_and_replace_point_indices(X, recent_points)
    return penalty_factor * penalty_point(_as_points(X, X), recent_points)
