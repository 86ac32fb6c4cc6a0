"""The 3D half in plain PyTorch, float64: undistortion, best-two-view
selection and DLT, and the gap by which a triangulated point misses the
DLT's optimum.

- Undistortion: OpenCV's ``undistortPoints`` model (k1, k2, p1, p2, k3)
  inverted by fixed-point steps from the normalized point, run until it
  stops moving, re-projected with the camera's own K.
- View selection: the two views of highest confidence (a stable ascending
  sort, NaN last in rank, taking the last two); a joint whose selected
  views are not both finite has no 3D point (NaN).
- DLT: per view the rows y·P₂ − P₁ and P₀ − x·P₂ of P = K[R|T]; the
  columns of the 4×4 system are scaled to unit norm (column equilibration,
  the triangulation's documented convention), and the solution is the
  eigenvector of the smallest eigenvalue of the scaled normal matrix,
  unscaled, then dehomogenized.

`dlt_gap` judges a point computed elsewhere: (gᵀBg − λ_min) / trace(B),
with B the scaled normal matrix and g the point in the scaled coordinates.
It is 0 at the optimum, and small wherever two eigenvalues nearly tie (any
point along the tie fits the views as well), so a point that is as good
as the reference's passes even where rounding picks another along the tie.
"""

from __future__ import annotations

import torch

from .lowp import EXACT

__all__ = ["undistort", "projections", "select_views", "normal_matrix", "triangulate_top2",
           "dlt_gap"]

_CHUNK = 1 << 14  # matrices per batched eigen-solve (cuSOLVER refuses very large batches)


def _eigh(B: torch.Tensor, values_only: bool = False):
    """torch.linalg.eigh / eigvalsh of (..., 4, 4), in chunks of the batch."""
    flat = B.reshape(-1, 4, 4)
    fn = torch.linalg.eigvalsh if values_only else torch.linalg.eigh
    parts = [fn(flat[i:i + _CHUNK]) for i in range(0, flat.shape[0], _CHUNK)]
    if values_only:
        return torch.cat(parts).reshape(B.shape[:-1])
    return (torch.cat([p[0] for p in parts]).reshape(B.shape[:-1]),
            torch.cat([p[1] for p in parts]).reshape(B.shape))


def undistort(pts: torch.Tensor, K: torch.Tensor, dist: torch.Tensor,
              steps: int = 40) -> torch.Tensor:
    """pts (..., C, 2) pixels of cameras K (C, 3, 3), dist (C, 5) ->
    undistorted pixels (..., C, 2), float64."""
    pts, K, dist = pts.double(), K.double(), dist.double()
    fx, fy, cx, cy, skew = K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2], K[:, 0, 1]
    y0 = (pts[..., 1] - cy) / fy
    x0 = (pts[..., 0] - cx - skew * y0) / fx
    k1, k2, p1, p2, k3 = dist.unbind(-1)
    x, y = x0, y0
    for _ in range(steps):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x, y = (x0 - dx) / radial, (y0 - dy) / radial
    return torch.stack([fx * x + skew * y + cx, fy * y + cy], -1)


def projections(rig: dict) -> torch.Tensor:
    """(C, 3, 4) P = K [R | T], float64."""
    K, R, T = rig["K"].double(), rig["R"].double(), rig["T"].double()
    return K @ torch.cat([R, T[:, :, None]], -1)


def select_views(conf: torch.Tensor) -> torch.Tensor:
    """conf (..., C) -> the indices (..., 2) of the second-best and best view."""
    c = torch.where(torch.isfinite(conf), conf, -torch.inf)
    order = torch.argsort(c, dim=-1, stable=True)
    return order[..., -2:]


def normal_matrix(und: torch.Tensor, P: torch.Tensor, views: torch.Tensor, rounding=EXACT):
    """The column-scaled DLT normal matrix of each point: und (..., C, 2)
    undistorted pixels, P (C, 3, 4), views (..., 2) -> (B (..., 4, 4),
    column norms (..., 4), finite (...))."""
    r = rounding.host
    idx = views[..., None].expand(views.shape + (2,))
    pts = torch.gather(und, -2, idx)  # (..., 2, 2)
    Pv = P[views]  # (..., 2, 3, 4)
    finite = torch.isfinite(pts).all(-1).all(-1)
    pts = torch.where(finite[..., None, None], pts, 0.0)
    x, y = pts[..., 0:1], pts[..., 1:2]
    rows = torch.stack([y * Pv[..., 2, :] - Pv[..., 1, :], Pv[..., 0, :] - x * Pv[..., 2, :]],
                       -2)  # (..., 2 views, 2 rows, 4)
    A = r(rows.reshape(rows.shape[:-3] + (4, 4)))
    norm = torch.linalg.vector_norm(A, dim=-2)
    norm = torch.where(norm > 0, norm, 1.0)
    A = A / norm[..., None, :]
    B = r(A.transpose(-1, -2) @ A)
    eye = torch.eye(4, dtype=B.dtype, device=B.device)
    return torch.where(finite[..., None, None], B, eye), norm, finite


def triangulate_top2(xy: torch.Tensor, conf: torch.Tensor, rig: dict,
                     rounding=EXACT) -> torch.Tensor:
    """xy (..., C, 2) pixels (NaN where gated), conf (..., C) -> (..., 3)."""
    r = rounding.host
    und = r(undistort(r(xy.double()), rig["K"], rig["dist"]))
    B, norm, finite = normal_matrix(und, projections(rig).to(und.device), select_views(conf),
                                    rounding)
    _, vecs = _eigh(B)
    h = vecs[..., 0] / norm
    xyz = r(h[..., :3] / h[..., 3:4])
    return torch.where(finite[..., None], xyz, torch.nan)


def dlt_gap(xy: torch.Tensor, conf: torch.Tensor, xyz: torch.Tensor, rig: dict):
    """How far points ``xyz`` (..., 3) miss the DLT optimum of views ``xy``
    (..., C, 2) chosen by ``conf`` (..., C): (gap (...) float64, with 0
    where both the reference and ``xyz`` give no point and +inf where only
    one of them does)."""
    und = undistort(xy.double(), rig["K"], rig["dist"])
    B, norm, finite = normal_matrix(und, projections(rig).to(und.device), select_views(conf))
    have = torch.isfinite(xyz).all(-1)
    hom = torch.cat([torch.where(have[..., None], xyz.double(), 0.0),
                     torch.ones_like(xyz[..., :1], dtype=torch.float64)], -1) * norm
    g = hom / torch.linalg.vector_norm(hom, dim=-1, keepdim=True)
    lam = _eigh(B, values_only=True)[..., 0]
    trace = torch.diagonal(B, dim1=-2, dim2=-1).sum(-1)
    gap = ((g[..., None, :] @ B @ g[..., :, None])[..., 0, 0] - lam) / trace
    gap = torch.where(finite & have, gap.clamp(min=0.0), 0.0)
    return torch.where(finite != have, torch.inf, gap)
