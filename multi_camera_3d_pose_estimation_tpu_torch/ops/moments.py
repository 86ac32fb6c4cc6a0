"""Heatmap -> 2D Gaussian moments (batched torch).

Counterpart of the JAX package's ``ops/moments.py``: values under
``threshold`` become 0, each map is normalised to a distribution, and the
centred moments [mean_x, mean_y, var_x, cov_xy, cov_xy, var_y] are returned.
A map whose thresholded sum is not positive gives an all-zero row.
"""

from __future__ import annotations

import torch

__all__ = ["heatmap_moments"]


def heatmap_moments(heatmaps: torch.Tensor, threshold: float = 0.01) -> torch.Tensor:
    """Compress heatmaps (..., H, W) to Gaussian moments (..., 6)."""
    H, W = heatmaps.shape[-2], heatmaps.shape[-1]
    hm = heatmaps if heatmaps.is_floating_point() else heatmaps.float()
    hm = torch.where(hm < threshold, torch.zeros_like(hm), hm)
    ys = torch.arange(H, dtype=hm.dtype, device=hm.device)[:, None]
    xs = torch.arange(W, dtype=hm.dtype, device=hm.device)[None, :]

    total = hm.sum(dim=(-2, -1))
    empty = total <= 0
    denom = torch.where(empty, torch.ones_like(total), total)
    mean_x = (hm * xs).sum(dim=(-2, -1)) / denom
    mean_y = (hm * ys).sum(dim=(-2, -1)) / denom
    dx = xs - mean_x[..., None, None]
    dy = ys - mean_y[..., None, None]
    var_x = (hm * dx * dx).sum(dim=(-2, -1)) / denom
    var_y = (hm * dy * dy).sum(dim=(-2, -1)) / denom
    cov_xy = (hm * dx * dy).sum(dim=(-2, -1)) / denom

    out = torch.stack([mean_x, mean_y, var_x, cov_xy, cov_xy, var_y], dim=-1)
    return torch.where(empty[..., None], torch.zeros_like(out), out)
