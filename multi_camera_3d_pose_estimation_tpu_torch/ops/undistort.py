"""Iterative point undistortion (batched torch).

Counterpart of the JAX package's ``ops/undistort.py`` (OpenCV's
``cv.undistortPoints`` semantics).  The camera parameters broadcast against
the points: one camera (``K`` (3, 3), ``dist`` (5,)) or one per view on the
points' second-to-last axis (``K`` (C, 3, 3), ``dist`` (C, 5) with points
(..., C, 2)).
"""

from __future__ import annotations

import torch

__all__ = ["undistort_points", "normalize_pixels"]


def normalize_pixels(pts: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixel coordinates (..., 2) -> normalized camera coordinates (..., 2)."""
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    skew = K[..., 0, 1]
    y = (pts[..., 1] - cy) / fy
    x = (pts[..., 0] - cx - skew * y) / fx
    return torch.stack([x, y], dim=-1)


def undistort_points(
    pts: torch.Tensor,
    K: torch.Tensor,
    dist: torch.Tensor | None,
    P: torch.Tensor | None = None,
    n_iter: int = 10,
) -> torch.Tensor:
    """Invert the 5-coefficient (k1, k2, p1, p2, k3) model for pixel points.

    Normalizes by ``K``, runs ``n_iter`` unrolled fixed-point steps, then
    re-projects with ``P`` when given: a (3, 3) camera matrix, or a (3, 4)
    projection of the normalized ray (z = 1).
    """
    xy0 = normalize_pixels(pts, K)
    x0, y0 = xy0[..., 0], xy0[..., 1]
    x, y = x0, y0
    if dist is not None:
        if dist.dim() == 2 and dist.shape[0] == 1:
            dist = dist[0]
        k1, k2, p1, p2, k3 = dist.unbind(-1)
        for _ in range(n_iter):
            r2 = x * x + y * y
            icdist = 1.0 / (1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2)
            dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
            dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
            x, y = (x0 - dx) * icdist, (y0 - dy) * icdist

    if P is None:
        return torch.stack([x, y], dim=-1)
    if P.shape[-2:] == (3, 3):
        fx, fy = P[..., 0, 0], P[..., 1, 1]
        cx, cy = P[..., 0, 2], P[..., 1, 2]
        skew = P[..., 0, 1]
        return torch.stack([fx * x + skew * y + cx, fy * y + cy], dim=-1)
    ones = torch.ones_like(x)
    ray = torch.stack([x, y, ones, ones], dim=-1)
    uvw = torch.matmul(P, ray[..., None])[..., 0]
    return uvw[..., :2] / uvw[..., 2:3]
