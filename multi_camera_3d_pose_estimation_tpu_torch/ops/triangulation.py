"""Batched DLT triangulation (torch).

Counterpart of the JAX package's ``ops/triangulation.py``: every point's
4x4 DLT normal matrix is solved at once by the shifted-power smallest
eigenvector with 12 matrix squarings (not ``torch.linalg.eigh``), with the
same column equilibration, NaN-in -> NaN-out masking, stable top-2 view
selection, the robust confidence-weighted n-view solve and the
reference-layout `get_pose_3d` entry.
"""

from __future__ import annotations

import numpy as np
import torch

from .device_tables import device_table
from .geometry import projection_matrix
from .undistort import undistort_points

__all__ = ["triangulate_dlt", "triangulate_points", "triangulate_top2", "triangulate_nview",
           "get_pose_3d"]


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


def _dlt_start() -> np.ndarray:
    """The power iteration's start vector."""
    return np.array([0.9, 0.5, 0.5, 0.5])


def _smallest_eigvec_4x4(B: torch.Tensor, n_squarings: int = 12) -> torch.Tensor:
    """Eigenvector of the smallest eigenvalue of symmetric PSD (..., 4, 4).

    M = trace(B)·I − B, squared ``n_squarings`` times with max-abs
    renormalisation, applied to the start v0 = (0.9, 0.5, 0.5, 0.5), which
    stays on the device (`device_table`): no host copy, no wait on the card.
    """
    c = torch.diagonal(B, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    M = c * torch.eye(4, dtype=B.dtype, device=B.device) - B
    for _ in range(n_squarings):
        M = torch.matmul(M, M)
        scale = M.abs().amax(dim=(-2, -1), keepdim=True)
        M = M / torch.clamp(scale, min=1e-30)
    v0 = device_table(_dlt_start, device=B.device, dtype=B.dtype)
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
    und = _undistort_all_views(kpts, Ks, dists, n_undistort_iter)
    Ps = projection_matrix(Ks, Rs, Ts)  # (n_cams, 3, 4)

    conf_safe = torch.where(torch.isfinite(conf), conf, torch.full_like(conf, -float("inf")))
    order = torch.argsort(conf_safe, dim=-1, stable=True)
    top2 = order[..., n_cams - 2:]  # [second-best, best]

    def pick(i):
        idx = top2[..., i:i + 1, None].expand(top2.shape[:-1] + (1, 2))
        return torch.gather(und, -2, idx)[..., 0, :]

    return triangulate_dlt(pick(0), pick(1), Ps[top2[..., 0]], Ps[top2[..., 1]])


def _undistort_all_views(kpts, Ks, dists, n_undistort_iter):
    """Every view (..., C, 2) undistorted with its own intrinsics and
    re-projected with P = K (OpenCV's ``undistortPoints(..., P=K)``)."""
    return undistort_points(kpts, Ks, dists, P=Ks, n_iter=n_undistort_iter)


def triangulate_points(kpts_2d, cmtx1, dist1, R1, T1, cmtx2, dist2, R2, T2,
                       n_undistort_iter: int = 10) -> torch.Tensor:
    """Two-view triangulation of pixel points ``kpts_2d`` (..., 2 views, 2), a
    tensor:
    each view undistorted (re-projected with its own camera matrix), then
    DLT under P = K[R|T].  Camera parameters may be arrays or tensors; they
    take the points' dtype and device.  Returns (..., 3)."""
    def t(a):
        return None if a is None else torch.as_tensor(a, dtype=kpts_2d.dtype,
                                                      device=kpts_2d.device)

    K1, K2 = t(cmtx1), t(cmtx2)
    u1 = undistort_points(kpts_2d[..., 0, :], K1, t(dist1), P=K1, n_iter=n_undistort_iter)
    u2 = undistort_points(kpts_2d[..., 1, :], K2, t(dist2), P=K2, n_iter=n_undistort_iter)
    P1 = projection_matrix(K1, t(R1), t(T1).reshape(3))
    P2 = projection_matrix(K2, t(R2), t(T2).reshape(3))
    return triangulate_dlt(u1, u2, P1, P2)


def _weighted_dlt(und, Ps, w, bad):
    """Weighted n-view DLT: min Σ_c w_c ||A_c h||², ||h|| = 1.

    ``und`` (..., C, 2) finite undistorted points, ``Ps`` (C, 3, 4), ``w``
    (..., C) non-negative weights (0 drops a view), ``bad`` (...) unsolvable
    points (NaN out).  The normal matrix stays 4x4 for any C.
    """
    x = und[..., 0:1]
    y = und[..., 1:2]
    r0 = y * Ps[..., 2, :] - Ps[..., 1, :]  # (..., C, 4)
    r1 = Ps[..., 0, :] - x * Ps[..., 2, :]
    A = torch.stack([r0, r1], dim=-2) * torch.sqrt(w)[..., None, None]  # (..., C, 2, 4)
    A = A.reshape(A.shape[:-3] + (2 * A.shape[-3], 4))
    colnorm = torch.linalg.vector_norm(A, dim=-2, keepdim=True)
    colnorm = torch.where(colnorm > 0, colnorm, torch.ones_like(colnorm))
    A = A / colnorm
    B = torch.matmul(A.transpose(-1, -2), A)
    eye = torch.eye(4, dtype=B.dtype, device=B.device)
    B = torch.where(bad[..., None, None], eye, B)
    h = _smallest_eigvec_4x4(B)
    h = h / colnorm[..., 0, :]
    wh = h[..., 3]
    tiny = torch.where(wh < 0, torch.full_like(wh, -1e-12), torch.full_like(wh, 1e-12))
    wh = torch.where(wh.abs() < 1e-12, tiny, wh)
    xyz = h[..., :3] / wh[..., None]
    return torch.where(bad[..., None], torch.full_like(xyz, float("nan")), xyz)


def _masked_lower_median(r2, mask):
    """Lower median of ``r2`` over ``mask`` entries along the last axis
    (sort with +inf padding, then gather); +inf where the mask is empty."""
    r2s = torch.sort(torch.where(mask, r2, torch.full_like(r2, float("inf"))), dim=-1).values
    k = torch.clamp(mask.sum(-1) - 1, min=0) // 2
    med = torch.gather(r2s, -1, k[..., None])[..., 0]
    return torch.where(torch.isfinite(med), med, torch.full_like(med, float("inf")))


def triangulate_nview(kpts, conf, Ks, dists, Rs, Ts, n_undistort_iter: int = 10,
                      conf_weighted: bool = True, reject_sigma: float = 2.5,
                      sigma_floor_px: float = 1.0, min_views: int = 2) -> torch.Tensor:
    """Robust confidence-weighted DLT over all finite views.

    Same arguments and return as `triangulate_top2`.  C + 1 hypotheses (all
    views, and each view left out once) are solved as one batched weighted
    DLT and scored by the LOWER median of their included views' squared
    reprojection residuals (undistorted pixels); the best (ties to the
    all-view hypothesis 0) sets a threshold reject_sigma² · max(median
    residual, sigma_floor_px²) under which views are kept, unless fewer
    than ``min_views`` would be; a final weighted DLT solves over the kept
    views.  NaN where fewer than two finite views.
    """
    n_cams = kpts.shape[-2]
    if n_cams < 2:
        raise ValueError(f"triangulation needs >= 2 camera views, got {n_cams}")
    und = _undistort_all_views(kpts, Ks, dists, n_undistort_iter)
    Ps = projection_matrix(Ks, Rs, Ts)

    finite = torch.isfinite(und).all(-1) & torch.isfinite(conf)
    und_safe = torch.where(finite[..., None], torch.nan_to_num(und), torch.zeros_like(und))
    bad = finite.sum(-1) < 2
    if conf_weighted:
        # A valid view never gets a hard zero from conf == 0: the 1e-3 floor
        # keeps the normal matrix well posed.
        w0 = torch.where(finite, torch.clamp(torch.clamp(conf, min=0.0), min=1e-3),
                         torch.zeros_like(conf))
    else:
        w0 = finite.to(und.dtype)

    def residuals2(X, target):
        """Squared reprojection residual per view: X (..., 3) against
        ``target`` (..., C, 2) -> (..., C)."""
        Xh = torch.cat([torch.nan_to_num(X), torch.ones_like(X[..., :1])], dim=-1)
        proj = torch.einsum("cij,...j->...ci", Ps, Xh)
        z = proj[..., 2:3]
        z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
        return ((proj[..., :2] / z - target) ** 2).sum(-1)

    eye = torch.eye(n_cams, dtype=w0.dtype, device=w0.device)
    w_hyp = torch.cat([w0[..., None, :], w0[..., None, :] * (1.0 - eye)], dim=-2)  # (..., C+1, C)
    inc = w_hyp > 0
    hyp_ok = inc.sum(-1) >= 2
    X_hyp = _weighted_dlt(und_safe[..., None, :, :], Ps, w_hyp, ~hyp_ok)
    r2_hyp = residuals2(X_hyp, und_safe[..., None, :, :])
    score = _masked_lower_median(r2_hyp, inc & finite[..., None, :])
    score = torch.where(hyp_ok, score, torch.full_like(score, float("inf")))
    best = torch.argmin(score, dim=-1)  # the first of equal scores: hypothesis 0 wins ties
    X_best = torch.gather(X_hyp, -2, best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]

    r2 = residuals2(X_best, und_safe)
    med_r2 = _masked_lower_median(r2, finite)
    med_r2 = torch.where(torch.isfinite(med_r2), med_r2, torch.zeros_like(med_r2))
    thresh = (reject_sigma ** 2) * torch.clamp(med_r2, min=sigma_floor_px ** 2)
    keep = finite & (r2 <= thresh[..., None])
    enough = keep.sum(-1) >= min_views
    w1 = torch.where(enough[..., None], w0 * keep, w0)
    return _weighted_dlt(und_safe, Ps, w1, bad)


def get_pose_3d(kpts_2d, camera_params: dict, camera_indices=None, world_trans_rot=None,
                ignore_nonlinear_distortions: bool = False, method: str = "top2",
                device="cuda") -> torch.Tensor:
    """Lift 2D keypoints in the reference wire layout to 3D, in float64.

    - ``kpts_2d``: (T, K, 3, C) array, (x, y, conf) with the camera last.
    - ``camera_params``: {camera_ID: [K, R, T, dist]}; None R/T/dist mean
      identity/zero.
    - ``camera_indices``: the camera IDs to use (default all), each with its
      own parameters.
    - ``world_trans_rot``: optional (R_W0, T_W0); the output is rotated by
      R_W0⁻¹.
    - ``method``: "top2" or "nview" (`triangulate_nview`).

    Returns (T, K, 3) float64 on ``device``, NaN where fewer than two
    finite views.
    """
    tri = {"top2": triangulate_top2, "nview": triangulate_nview}
    if method not in tri:
        raise ValueError(f"unknown triangulation method '{method}'")
    dev = torch.device(device)
    ids = list(camera_params.keys())
    if camera_indices is None:
        camera_indices = ids
    pos = [ids.index(c) for c in camera_indices]

    Ks, Rs, Ts, ds = [], [], [], []
    for cid in camera_indices:
        Kc, Rc, Tc, dc = camera_params[cid]
        Ks.append(np.asarray(Kc, np.float64))
        Rs.append(np.eye(3) if Rc is None else np.asarray(Rc, np.float64).reshape(3, 3))
        Ts.append(np.zeros(3) if Tc is None else np.asarray(Tc, np.float64).reshape(3))
        d = np.zeros(5) if dc is None else np.asarray(dc, np.float64).reshape(-1)[:5]
        ds.append(np.pad(d, (0, 5 - d.size)))
    if ignore_nonlinear_distortions:
        ds = [d * 0 for d in ds]

    def t(a):
        return torch.as_tensor(np.array(a, np.float64), device=dev)

    sub = t(kpts_2d)[..., pos]  # (T, K, 3, C_sel)
    xy = sub[:, :, :2, :].transpose(-1, -2)  # (T, K, C_sel, 2)
    conf = sub[:, :, 2, :] if sub.shape[2] > 2 else torch.ones(xy.shape[:-1], dtype=xy.dtype,
                                                               device=dev)
    p3ds = tri[method](xy, conf, t(np.stack(Ks)), t(np.stack(ds)), t(np.stack(Rs)),
                       t(np.stack(Ts)))
    if world_trans_rot is not None:
        R_inv = torch.linalg.inv(t(world_trans_rot[0]))
        p3ds = torch.einsum("ij,tpj->tpi", R_inv, p3ds)
    return p3ds
