"""Intrinsic camera calibration: Zhang's closed form + Levenberg-Marquardt (torch).

Counterpart of the JAX package's ``calib/intrinsic.py`` (its `cv.calibrateCamera`
replacement):

1. per-view planar homographies (`find_homography`, batched over views);
2. Zhang's closed-form K from the image of the absolute conic;
3. per-view extrinsics from H's columns through K⁻¹, SVD-orthogonalized;
4. joint LM over [fx, fy, cx, cy, k1, k2, p1, p2, k3, (rvec, tvec) × views]
   on the full reprojection error (skew 0, 5 distortion coefficients).

Runs on ``device`` (the card unless the caller asks for the CPU), in the
dtype of the corner array.  The SVD's sign is free (cuSOLVER and LAPACK may
choose differently); every closed form here is invariant to it.
"""

from __future__ import annotations

import torch

from ..ops.geometry import project_cameras, rodrigues_matrix, rodrigues_vector
from .homography import _tensor, find_homography
from .lm import levenberg_marquardt

__all__ = ["calibrate_camera", "zhang_intrinsics_init", "extrinsics_from_homography"]


def _v_ij(H, i, j):
    return torch.stack([H[..., 0, i] * H[..., 0, j],
                        H[..., 0, i] * H[..., 1, j] + H[..., 1, i] * H[..., 0, j],
                        H[..., 1, i] * H[..., 1, j],
                        H[..., 2, i] * H[..., 0, j] + H[..., 0, i] * H[..., 2, j],
                        H[..., 2, i] * H[..., 1, j] + H[..., 1, i] * H[..., 2, j],
                        H[..., 2, i] * H[..., 2, j]], dim=-1)


def zhang_intrinsics_init(Hs, device="cuda") -> torch.Tensor:
    """K (3, 3) from ≥3 homographies (V, 3, 3) via the absolute-conic system.

    The closed form is invariant to the sign of the null vector b."""
    Hs = _tensor(Hs, device)
    V = torch.stack([_v_ij(Hs, 0, 1), _v_ij(Hs, 0, 0) - _v_ij(Hs, 1, 1)], dim=-2).reshape(-1, 6)
    _, _, Vh = torch.linalg.svd(V, full_matrices=False)
    b11, b12, b22, b13, b23, b33 = Vh[-1].unbind(-1)

    v0 = (b12 * b13 - b11 * b23) / (b11 * b22 - b12 * b12)
    lam = b33 - (b13 * b13 + v0 * (b12 * b13 - b11 * b23)) / b11
    alpha = torch.sqrt(torch.abs(lam / b11))
    beta = torch.sqrt(torch.abs(lam * b11 / (b11 * b22 - b12 * b12)))
    gamma = -b12 * alpha * alpha * beta / lam
    u0 = gamma * v0 / beta - b13 * alpha * alpha / lam
    # Skew is fixed to 0 downstream (OpenCV's default); keep the closed
    # form's principal point and focals.
    zero, one = torch.zeros_like(alpha), torch.ones_like(alpha)
    return torch.stack([torch.stack([alpha, zero, u0]), torch.stack([zero, beta, v0]),
                        torch.stack([zero, zero, one])])


def extrinsics_from_homography(H, K, device="cuda"):
    """(rvec (..., 3), tvec (..., 3)) of the plane from its homography (..., 3, 3)."""
    H = _tensor(H, device)
    K = _tensor(K, H.device).to(H.device)
    Kinv = torch.linalg.inv(K)
    h1, h2, h3 = H[..., :, 0], H[..., :, 1], H[..., :, 2]
    k1 = (Kinv @ h1[..., None])[..., 0]
    lam = 1.0 / torch.clamp(torch.linalg.vector_norm(k1, dim=-1), min=1e-12)
    r1 = lam[..., None] * k1
    r2 = lam[..., None] * (Kinv @ h2[..., None])[..., 0]
    r3 = torch.linalg.cross(r1, r2, dim=-1)
    R = torch.stack([r1, r2, r3], dim=-1)
    U, _, Vh = torch.linalg.svd(R)
    R = U @ Vh
    # Keep det(R) = +1 (flip the sign the SVD projection may introduce).
    sign = torch.sign(torch.linalg.det(R))
    R = R * sign[..., None, None]
    t = lam[..., None] * (Kinv @ h3[..., None])[..., 0] * sign[..., None]
    return rodrigues_vector(R), t


def calibrate_camera(obj_points, img_points, image_size=None, n_lm_iter: int = 60,
                     device="cuda"):
    """Calibrate one camera from V checkerboard views, on ``device``.

    - ``obj_points``: (V, N, 3) planar board coordinates (Z = 0) or (V, N, 2).
    - ``img_points``: (V, N, 2) detected corner pixels; their dtype is the
      solve's (float64 for calibration).

    Returns ``(rmse, K (3, 3), dist (1, 5), rvecs (V, 3), tvecs (V, 3))`` as
    numpy, the tuple layout of `cv.calibrateCamera`.
    """
    img_points = _tensor(img_points, device)
    dtype = img_points.dtype
    obj_points = _tensor(obj_points, img_points.device).to(img_points.device, dtype)
    if obj_points.shape[-1] == 2:
        obj_points = torch.cat([obj_points, torch.zeros_like(obj_points[..., :1])], dim=-1)
    V, N = obj_points.shape[0], obj_points.shape[1]

    # 1-3. Closed-form init.
    Hs = find_homography(obj_points[..., :2], img_points)
    K0 = zhang_intrinsics_init(Hs)
    rvecs0, tvecs0 = extrinsics_from_homography(Hs, K0)

    # 4. Joint LM over intrinsics + distortion + per-view poses.
    x0 = torch.cat([torch.stack([K0[0, 0], K0[1, 1], K0[0, 2], K0[1, 2]]),
                    torch.zeros(5, dtype=dtype, device=img_points.device),
                    rvecs0.reshape(-1), tvecs0.reshape(-1)])

    def unpack(x):
        fx, fy, cx, cy = x[0], x[1], x[2], x[3]
        zero, one = torch.zeros_like(fx), torch.ones_like(fx)
        K = torch.stack([torch.stack([fx, zero, cx]), torch.stack([zero, fy, cy]),
                         torch.stack([zero, zero, one])])
        dist = x[4:9]
        rvecs = x[9:9 + 3 * V].reshape(V, 3)
        tvecs = x[9 + 3 * V:].reshape(V, 3)
        return K, dist, rvecs, tvecs

    def residuals(x):
        K, dist, rvecs, tvecs = unpack(x)
        proj = project_cameras(obj_points, K, rodrigues_matrix(rvecs)[:, None],
                               tvecs[:, None], dist)
        return (proj - img_points).reshape(-1)

    x, final_cost, _ = levenberg_marquardt(residuals, x0, n_iter=n_lm_iter)
    K, dist, rvecs, tvecs = unpack(x)
    rmse = torch.sqrt(final_cost / (V * N))  # OpenCV's per-point RMS convention
    return (float(rmse), K.cpu().numpy(), dist.reshape(1, 5).cpu().numpy(),
            rvecs.cpu().numpy(), tvecs.cpu().numpy())
