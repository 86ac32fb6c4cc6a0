"""Planar homography estimation (normalized DLT), closed form, batched (torch).

Counterpart of the JAX package's ``calib/homography.py``: Hartley-normalized
9-parameter DLT, the null vector of the stacked 2N×9 system from its SVD.
Leading batch dimensions take the place of JAX's ``vmap`` over views.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["find_homography"]


def _tensor(x, device) -> torch.Tensor:
    """A tensor keeps its own device; anything else goes to ``device``."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=device)


def _normalize_2d(pts: torch.Tensor):
    """Similarity transform sending points (..., N, 2) to mean 0, mean radius √2."""
    mean = pts.mean(-2)
    d = torch.sqrt(((pts - mean[..., None, :]) ** 2).sum(-1))
    scale = math.sqrt(2.0) / torch.clamp(d.mean(-1), min=1e-12)
    zero, one = torch.zeros_like(scale), torch.ones_like(scale)
    T = torch.stack([torch.stack([scale, zero, -scale * mean[..., 0]], -1),
                     torch.stack([zero, scale, -scale * mean[..., 1]], -1),
                     torch.stack([zero, zero, one], -1)], -2)
    return (pts - mean[..., None, :]) * scale[..., None, None], T


def find_homography(src, dst, device="cuda") -> torch.Tensor:
    """H (..., 3, 3) with dst ~ H @ src for planar points src/dst (..., N, 2).

    Tensors stay on their device; arrays go to ``device``.
    """
    src = _tensor(src, device)
    dst = _tensor(dst, src.device).to(src.device)
    sn, Ts = _normalize_2d(src)
    dn, Td = _normalize_2d(dst)
    X, Y = sn[..., 0], sn[..., 1]
    u, v = dn[..., 0], dn[..., 1]
    zeros = torch.zeros_like(X)
    ones = torch.ones_like(X)
    r1 = torch.stack([X, Y, ones, zeros, zeros, zeros, -u * X, -u * Y, -u], dim=-1)
    r2 = torch.stack([zeros, zeros, zeros, X, Y, ones, -v * X, -v * Y, -v], dim=-1)
    A = torch.cat([r1, r2], dim=-2)  # (..., 2N, 9)
    _, _, Vh = torch.linalg.svd(A, full_matrices=False)
    Hn = Vh[..., -1, :].reshape(Vh.shape[:-2] + (3, 3))
    H = torch.linalg.solve(Td, Hn @ Ts)
    return H / H[..., 2:3, 2:3]
