"""Stereo extrinsic calibration with fixed intrinsics (torch).

Counterpart of the JAX package's ``calib/stereo.py`` (its
`cv.stereoCalibrate(..., CALIB_FIX_INTRINSIC)` replacement): the rigid
transform (R, T) of camera 1 with respect to camera 0 from simultaneous
checkerboard views.

Init: per-view PnP in each camera (batched over views, each view with its
own LM) → per-view relative poses → chordal mean of the rotations and mean
translation.  Refine: joint LM over [rel rvec, rel tvec, (board rvec, tvec)
× views] on the reprojection error in both cameras, intrinsics fixed.
"""

from __future__ import annotations

import torch

from ..ops.geometry import project_cameras, rodrigues_matrix, rodrigues_vector
from .homography import _tensor
from .lm import levenberg_marquardt
from .pnp import solve_pnp

__all__ = ["stereo_calibrate", "mean_rotation"]


def mean_rotation(Rs, device="cuda") -> torch.Tensor:
    """Chordal L2 mean of rotation matrices (V, 3, 3) via SVD projection."""
    M = _tensor(Rs, device).sum(0)
    U, _, Vh = torch.linalg.svd(M)
    d = torch.sign(torch.linalg.det(U @ Vh))
    D = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d.to(M.dtype)]))
    return U @ D @ Vh


def stereo_calibrate(obj_points, img_points0, img_points1, K0, dist0, K1, dist1,
                     n_lm_iter: int = 60, device="cuda"):
    """Returns ``(rmse, R (3, 3), T (3, 1))`` (numpy) of camera 1 w.r.t. camera 0.

    - ``obj_points``: (V, N, 3) board coordinates per view (Z = 0 plane).
    - ``img_points0/1``: (V, N, 2) matching corner pixels in each camera;
      their dtype is the solve's.
    """
    img_points0 = _tensor(img_points0, device)
    dev, dtype = img_points0.device, img_points0.dtype

    def on_dev(a):
        return _tensor(a, dev).to(dev, dtype)

    img_points1, obj_points, K0, K1 = (on_dev(a) for a in (img_points1, obj_points, K0, K1))
    d0 = None if dist0 is None else on_dev(dist0).reshape(-1)
    d1 = None if dist1 is None else on_dev(dist1).reshape(-1)
    V, N = obj_points.shape[0], obj_points.shape[1]

    # Per-view PnP in both cameras (batched over views).
    rv0, tv0 = solve_pnp(obj_points, img_points0, K0, d0)
    rv1, tv1 = solve_pnp(obj_points, img_points1, K1, d1)

    # Relative pose per view: cam1 = rel ∘ cam0  →  R_rel = R1 R0ᵀ,
    # t_rel = t1 − R_rel t0.
    R_rels = rodrigues_matrix(rv1) @ rodrigues_matrix(rv0).transpose(-1, -2)
    t_rels = tv1 - (R_rels @ tv0[..., None])[..., 0]
    x0 = torch.cat([rodrigues_vector(mean_rotation(R_rels)), t_rels.mean(0),
                    rv0.reshape(-1), tv0.reshape(-1)])

    def unpack(x):
        return x[:3], x[3:6], x[6:6 + 3 * V].reshape(V, 3), x[6 + 3 * V:].reshape(V, 3)

    def residuals(x):
        rel_rv, rel_tv, rvs, tvs = unpack(x)
        R_rel = rodrigues_matrix(rel_rv)
        R_board = rodrigues_matrix(rvs)  # (V, 3, 3)
        r0 = project_cameras(obj_points, K0, R_board[:, None], tvs[:, None], d0) - img_points0
        # Compose as matrices: differentiating a matrix→axis-angle roundtrip
        # (arccos) is numerically fragile near θ ∈ {0, π}.
        R_c1 = R_rel @ R_board
        t_c1 = (R_rel @ tvs[..., None])[..., 0] + rel_tv
        r1 = project_cameras(obj_points, K1, R_c1[:, None], t_c1[:, None], d1) - img_points1
        return torch.cat([r0.reshape(V, -1), r1.reshape(V, -1)], dim=-1).reshape(-1)

    x, final_cost, _ = levenberg_marquardt(residuals, x0, n_iter=n_lm_iter)
    rel_rv, rel_tv, _, _ = unpack(x)
    rmse = torch.sqrt(final_cost / (2 * V * N))
    return (float(rmse), rodrigues_matrix(rel_rv).cpu().numpy(),
            rel_tv.reshape(3, 1).cpu().numpy())
