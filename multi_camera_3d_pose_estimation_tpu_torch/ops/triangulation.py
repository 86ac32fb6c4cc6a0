"""Batched DLT triangulation (torch).

Counterpart of the JAX package's ``ops/triangulation.py``: every point's
4x4 DLT normal matrix is solved at once by the shifted-power smallest
eigenvector with 12 matrix squarings (not ``torch.linalg.eigh``), with the
same column equilibration, NaN-in -> NaN-out masking and stable top-2 view
selection.
"""

from __future__ import annotations

import torch

from .geometry import projection_matrix
from .undistort import undistort_points

__all__ = ["triangulate_dlt", "triangulate_top2"]


def _dlt_system(pts_a, pts_b, P_a, P_b):
    """The 4 DLT rows per point, (..., 4, 4):
    y_a*P_a[2] - P_a[1], P_a[0] - x_a*P_a[2], and the same for view b."""
    def rows(pts, P):
        x = pts[..., 0:1]
        y = pts[..., 1:2]
        r0 = y * P[..., 2, :] - P[..., 1, :]
        r1 = P[..., 0, :] - x * P[..., 2, :]
        return torch.stack([r0, r1], dim=-2)

    return torch.cat([rows(pts_a, P_a), rows(pts_b, P_b)], dim=-2)


def _smallest_eigvec_4x4(B: torch.Tensor, n_squarings: int = 12) -> torch.Tensor:
    """Eigenvector of the smallest eigenvalue of symmetric PSD (..., 4, 4).

    M = trace(B)·I − B, squared ``n_squarings`` times with max-abs
    renormalisation, applied to the start v0 = (0.9, 0.5, 0.5, 0.5).
    """
    c = torch.diagonal(B, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    M = c * torch.eye(4, dtype=B.dtype, device=B.device) - B
    for _ in range(n_squarings):
        M = torch.matmul(M, M)
        scale = M.abs().amax(dim=(-2, -1), keepdim=True)
        M = M / torch.clamp(scale, min=1e-30)
    v0 = torch.tensor([0.9, 0.5, 0.5, 0.5], dtype=B.dtype, device=B.device)
    v = torch.matmul(M, v0)
    n = torch.sqrt(torch.clamp((v * v).sum(-1, keepdim=True), min=1e-30))
    return v / n


def triangulate_dlt(pts_a, pts_b, P_a, P_b) -> torch.Tensor:
    """Triangulate point pairs (..., 2) under projections (..., 3, 4).

    Non-finite input coordinates give NaN outputs.
    """
    bad = ~(torch.isfinite(pts_a).all(-1) & torch.isfinite(pts_b).all(-1))
    safe_a = torch.where(bad[..., None], torch.zeros_like(pts_a), pts_a)
    safe_b = torch.where(bad[..., None], torch.zeros_like(pts_b), pts_b)

    A = _dlt_system(safe_a, safe_b, P_a, P_b)
    # Column equilibration (scaling columns leaves the residual weighting
    # alone); the solution of the scaled system is D·h, undone below.
    colnorm = torch.linalg.vector_norm(A, dim=-2, keepdim=True)
    colnorm = torch.where(colnorm > 0, colnorm, torch.ones_like(colnorm))
    A = A / colnorm
    B = torch.matmul(A.transpose(-1, -2), A)
    eye = torch.eye(4, dtype=B.dtype, device=B.device)
    B = torch.where(bad[..., None, None], eye, B)
    h = _smallest_eigvec_4x4(B)
    h = h / colnorm[..., 0, :]
    w = h[..., 3]
    tiny = torch.where(w < 0, torch.full_like(w, -1e-12), torch.full_like(w, 1e-12))
    w = torch.where(w.abs() < 1e-12, tiny, w)
    xyz = h[..., :3] / w[..., None]
    return torch.where(bad[..., None], torch.full_like(xyz, float("nan")), xyz)


def triangulate_top2(kpts, conf, Ks, dists, Rs, Ts, n_undistort_iter: int = 10):
    """Confidence-gated best-two-view triangulation.

    ``kpts`` (..., n_cams, 2) pixels, ``conf`` (..., n_cams); stacked camera
    parameters ``Ks`` (n_cams, 3, 3), ``dists`` (n_cams, 5), ``Rs``
    (n_cams, 3, 3), ``Ts`` (n_cams, 3).  Views are picked by a stable
    ascending argsort of the confidences (NaN counts as -inf), taking the
    last two.  Returns (..., 3).
    """
    n_cams = kpts.shape[-2]
    if n_cams < 2:
        raise ValueError(f"triangulation needs >= 2 camera views, got {n_cams}")
    # Every view undistorted with its own intrinsics, re-projected with P = K.
    und = undistort_points(kpts, Ks, dists, P=Ks, n_iter=n_undistort_iter)
    Ps = projection_matrix(Ks, Rs, Ts)  # (n_cams, 3, 4)

    conf_safe = torch.where(torch.isfinite(conf), conf, torch.full_like(conf, -float("inf")))
    order = torch.argsort(conf_safe, dim=-1, stable=True)
    top2 = order[..., n_cams - 2:]  # [second-best, best]

    def pick(i):
        idx = top2[..., i:i + 1, None].expand(top2.shape[:-1] + (1, 2))
        return torch.gather(und, -2, idx)[..., 0, :]

    return triangulate_dlt(pick(0), pick(1), Ps[top2[..., 0]], Ps[top2[..., 1]])
