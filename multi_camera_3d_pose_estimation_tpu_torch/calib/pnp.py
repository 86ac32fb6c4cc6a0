"""Perspective-n-Point: DLT or homography init + Levenberg-Marquardt (torch).

Counterpart of the JAX package's ``calib/pnp.py`` (its `cv.solvePnP`
replacement): the 2N×12 DLT on normalized, undistorted points (general
clouds) or a plane homography (coplanar clouds, the checkerboard), chosen
per problem by `torch.where` on the cloud's singular values, then LM on
the full (distorted) reprojection error.  Batched over a leading view axis
(JAX ``vmap``s the solver), each view with its own LM damping.
"""

from __future__ import annotations

import torch

from ..ops.geometry import project_cameras, rodrigues_matrix, rodrigues_vector
from ..ops.undistort import undistort_points
from .homography import _tensor, find_homography
from .lm import levenberg_marquardt

__all__ = ["solve_pnp"]


def _dlt_pnp(obj_pts: torch.Tensor, norm_pts: torch.Tensor) -> torch.Tensor:
    """P (..., 3, 4) from 3D↔normalized-2D correspondences via DLT."""
    Xh = torch.cat([obj_pts, torch.ones_like(obj_pts[..., :1])], dim=-1)  # (..., N, 4)
    u = norm_pts[..., 0:1]
    v = norm_pts[..., 1:2]
    zeros = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, zeros, -u * Xh], dim=-1)  # (..., N, 12)
    r2 = torch.cat([zeros, Xh, -v * Xh], dim=-1)
    A = torch.cat([r1, r2], dim=-2)
    _, _, Vh = torch.linalg.svd(A, full_matrices=False)
    return Vh[..., -1, :].reshape(Vh.shape[:-2] + (3, 4))


def _pose_nonplanar(obj_points, norm):
    """DLT-12 init for general (non-coplanar) point clouds."""
    P = _dlt_pnp(obj_points, norm)
    M = P[..., :3]
    det = torch.linalg.det(M)
    scale = torch.clamp(det.abs().pow(1.0 / 3.0), min=1e-12)[..., None]  # |det|^(1/3)
    sign = torch.sign(det)[..., None]
    M = M * sign[..., None] / scale[..., None]
    t = P[..., 3] * sign / scale
    U, _, Vh = torch.linalg.svd(M)
    R = U @ Vh
    # Ensure the object sits in front of the camera.
    cam_z = (obj_points @ R.transpose(-1, -2) + t[..., None, :])[..., 2]
    flip = cam_z.mean(-1) < 0
    R = torch.where(flip[..., None, None], -R, R)
    t = torch.where(flip[..., None], -t, t)
    # det(R) must stay +1 after any flip (−R has det −1 for 3×3).
    U2, _, Vh2 = torch.linalg.svd(R)
    d = torch.sign(torch.linalg.det(U2 @ Vh2))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1))
    return U2 @ D @ Vh2, t


def _pose_planar(obj_points, norm):
    """Homography init for coplanar clouds (the checkerboard case: the
    12-parameter DLT is rank-deficient there)."""
    mean = obj_points.mean(-2)
    centered = obj_points - mean[..., None, :]
    _, _, Vh = torch.linalg.svd(centered, full_matrices=False)
    e1, e2 = Vh[..., 0, :], Vh[..., 1, :]
    e3 = torch.linalg.cross(e1, e2, dim=-1)
    uv = torch.stack([(centered @ e1[..., None])[..., 0],
                      (centered @ e2[..., None])[..., 0]], dim=-1)  # plane coords
    H = find_homography(uv, norm)  # K = I in normalized coordinates
    h1, h2, h3 = H[..., :, 0], H[..., :, 1], H[..., :, 2]
    lam = 1.0 / torch.clamp(torch.linalg.vector_norm(h1, dim=-1), min=1e-12)
    # In-front disambiguation: flip λ if the plane centre lands behind.
    lam = torch.where(h3[..., 2] * lam < 0, -lam, lam)[..., None]
    r1 = lam * h1
    r2 = lam * h2
    r3 = torch.linalg.cross(r1, r2, dim=-1)
    Rp = torch.stack([r1, r2, r3], dim=-1)  # plane frame -> camera
    U, _, Vh2 = torch.linalg.svd(Rp)
    Rp = U @ Vh2
    Rp = Rp * torch.sign(torch.linalg.det(Rp))[..., None, None]
    tp = lam * h3
    E = torch.stack([e1, e2, e3], dim=-1)  # world -> plane basis (orthonormal)
    R = Rp @ E.transpose(-1, -2)
    t = tp - (R @ mean[..., None])[..., 0]
    return R, t


def solve_pnp(obj_points, img_points, K, dist=None, n_lm_iter: int = 40, device="cuda"):
    """Pose of ≥6 3D points (..., N, 3) observed at pixels (..., N, 2).

    One problem, or a batch on one leading axis (V views of one camera:
    ``K`` (3, 3) and ``dist`` are shared), each solved with its own LM.
    Handles general and coplanar clouds (the init chosen per problem by
    the smallest/largest singular value of the centered points).  Returns
    ``(rvec (..., 3), tvec (..., 3))`` tensors on the points' device,
    axis-angle like `cv.solvePnP`.  The dtype is the image points'.
    """
    img_points = _tensor(img_points, device)
    dev, dtype = img_points.device, img_points.dtype
    obj_points = _tensor(obj_points, dev).to(dev, dtype)
    K = _tensor(K, dev).to(dev, dtype)
    d_coef = None if dist is None else _tensor(dist, dev).to(dev, dtype).reshape(-1)

    norm = undistort_points(img_points, K, d_coef)  # normalized coordinates

    R_g, t_g = _pose_nonplanar(obj_points, norm)
    R_p, t_p = _pose_planar(obj_points, norm)
    sv = torch.linalg.svdvals(obj_points - obj_points.mean(-2, keepdim=True))
    planar = sv[..., -1] < 1e-6 * torch.clamp(sv[..., 0], min=1e-12)
    R = torch.where(planar[..., None, None], R_p, R_g)
    t = torch.where(planar[..., None], t_p, t_g)

    batched = obj_points.dim() == 3
    x0 = torch.cat([rodrigues_vector(R), t], dim=-1)
    objs, imgs = (obj_points, img_points) if batched else (obj_points[None], img_points[None])

    def residuals(x):  # (B, 6) -> (B, 2N); row b reads only x[b]
        proj = project_cameras(objs, K, rodrigues_matrix(x[:, :3])[:, None], x[:, None, 3:],
                               d_coef)
        return (proj - imgs).reshape(x.shape[0], -1)

    x, _, _ = levenberg_marquardt(residuals, x0 if batched else x0[None], n_iter=n_lm_iter)
    if not batched:
        x = x[0]
    return x[..., :3], x[..., 3:]
