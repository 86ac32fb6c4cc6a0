"""Heatmap keypoint decode: argmax + quarter-pixel shift (batched torch).

Counterpart of the JAX package's ``ops/heatmap_decode.py::heatmap_argmax_decode``.
"""

from __future__ import annotations

import torch

__all__ = ["heatmap_argmax_decode"]


def heatmap_argmax_decode(heatmaps: torch.Tensor, shift: float = 0.25):
    """Decode heatmaps (..., H, W) -> (xy (..., 2), score (...,)).

    First-occurrence argmax in row-major order, the peak value as score, and
    a ``shift``·sign step toward the larger of the two (clamped) neighbours
    on each axis.  ``xy`` is in heatmap pixels.
    """
    H, W = heatmaps.shape[-2], heatmaps.shape[-1]
    flat = heatmaps.reshape(heatmaps.shape[:-2] + (H * W,))
    idx = torch.argmax(flat, dim=-1)
    score = torch.gather(flat, -1, idx[..., None])[..., 0]
    y = idx // W
    x = idx % W

    def at(yy, xx):
        lin = yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)
        return torch.gather(flat, -1, lin[..., None])[..., 0]

    dx = torch.sign(at(y, x + 1) - at(y, x - 1))
    dy = torch.sign(at(y + 1, x) - at(y - 1, x))
    fx = x.to(flat.dtype) + shift * dx
    fy = y.to(flat.dtype) + shift * dy
    return torch.stack([fx, fy], dim=-1), score
