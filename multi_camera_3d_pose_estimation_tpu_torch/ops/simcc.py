"""SimCC coordinate-classification decode (RTMPose's head output), torch.

Counterpart of the JAX package's ``ops/simcc.py``: per joint, 1-D logits
over x and y bins at ``split_ratio`` x the input resolution, decoded by the
first argmax of each axis's softmax (optionally refined by the softmax
expectation within ±``refine_radius`` bins) and divided by the split ratio.
"""

from __future__ import annotations

import torch

__all__ = ["simcc_decode"]


def _decode_axis(logits: torch.Tensor, use_softmax_refine: bool, refine_radius: int):
    prob = torch.softmax(logits, dim=-1)
    idx = torch.argmax(prob, dim=-1, keepdim=True)  # the first maximum, as jnp.argmax
    peak = torch.gather(prob, -1, idx)[..., 0]
    loc = idx[..., 0].to(prob.dtype)
    if use_softmax_refine and refine_radius > 0:
        coords = torch.arange(logits.shape[-1], dtype=prob.dtype, device=prob.device)
        w = torch.where((coords - loc[..., None]).abs() <= refine_radius, prob,
                        torch.zeros_like(prob))
        wsum = w.sum(-1)
        loc = (w * coords).sum(-1) / torch.where(wsum > 0, wsum, torch.ones_like(wsum))
    return loc, peak


def simcc_decode(simcc_x: torch.Tensor, simcc_y: torch.Tensor, split_ratio: float = 2.0,
                 use_softmax_refine: bool = False, refine_radius: int = 0):
    """SimCC logits ``simcc_x`` (..., Wx), ``simcc_y`` (..., Wy) -> (xy (..., 2)
    in input pixels, score (...,) = min of the two axes' softmax peaks)."""
    lx, px = _decode_axis(simcc_x, use_softmax_refine, refine_radius)
    ly, py = _decode_axis(simcc_y, use_softmax_refine, refine_radius)
    return torch.stack([lx, ly], dim=-1) / split_ratio, torch.minimum(px, py)

