"""Camera geometry (batched torch).  Counterpart of the JAX package's
``ops/geometry.py``; this slice needs only the projection matrix."""

from __future__ import annotations

import torch

__all__ = ["projection_matrix"]


def projection_matrix(K: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """P = K [R|t], shape (..., 3, 4).

    ``K`` (..., 3, 3), ``R`` (..., 3, 3), ``t`` (..., 3) or (..., 3, 1).
    """
    if t.shape[-1] == 1 and t.dim() >= 2 and t.shape[-2] == 3:
        t = t[..., 0]
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    Rt = torch.cat([R, t[..., None]], dim=-1)  # (..., 3, 4)
    return torch.matmul(K, Rt)
