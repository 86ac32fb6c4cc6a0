"""Camera geometry (batched torch): rigid transforms, rotations, projection.

Counterpart of the JAX package's ``ops/geometry.py``.  Every function takes
arbitrary leading batch dimensions and is differentiable by autograd (the
refiners learn axis-angle extrinsics through `project_points`).
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "make_homogeneous_rep_matrix",
    "projection_matrix",
    "rodrigues_matrix",
    "rodrigues_vector",
    "rotation_conversion",
    "distort_normalized",
    "project_points",
    "project_cameras",
]


def make_homogeneous_rep_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[R|t; 0 0 0 1]: ``R`` (..., 3, 3), ``t`` (..., 3) or (..., 3, 1) ->
    (..., 4, 4)."""
    if t.dim() >= 2 and t.shape[-2:] == (3, 1):
        t = t[..., 0]
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)  # (..., 3, 4)
    bottom = torch.zeros(batch + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def projection_matrix(K: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """P = K [R|t], shape (..., 3, 4).

    ``K`` (..., 3, 3), ``R`` (..., 3, 3), ``t`` (..., 3) or (..., 3, 1).
    """
    Rt = make_homogeneous_rep_matrix(R, t)[..., :3, :]
    return torch.matmul(K, Rt)


def rodrigues_matrix(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle vectors (..., 3) -> rotation matrices (..., 3, 3).

    R = I + sin(θ)K + (1 − cos θ)K².  θ comes from a clamped sum of squares,
    sqrt(max(Σr², 1e-24)): the norm's gradient at exactly 0 is NaN, and the
    origin camera's rvec is exactly zero, so without the clamp a NaN would
    reach every parameter through global-norm clipping.  With it, u = r/θ
    and K vanish at 0, R = I exactly, and dR = [dr]× there.
    """
    sumsq = (rvec * rvec).sum(-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(sumsq, min=1e-24))  # (..., 1)
    u = rvec / theta
    ux, uy, uz = u.unbind(-1)
    zero = torch.zeros_like(ux)
    K = torch.stack([torch.stack([zero, -uz, uy], dim=-1),
                     torch.stack([uz, zero, -ux], dim=-1),
                     torch.stack([-uy, ux, zero], dim=-1)], dim=-2)
    th = theta[..., None]  # (..., 1, 1)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(K.shape)
    return eye + torch.sin(th) * K + (1.0 - torch.cos(th)) * torch.matmul(K, K)


def rodrigues_vector(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> axis-angle vectors (..., 3).

    θ = acos((tr R − 1)/2), clipped; the axis from the skew part, and near
    θ = π from the diagonal of (R + I)/2 = uuᵀ, the signs fixed from the
    off-diagonal sums relative to the largest component (the three cases
    chosen per row by `torch.where`); zero below θ = 1e-7.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    sin_theta = torch.sin(theta)

    denom = torch.where(sin_theta.abs() < 1e-7, torch.ones_like(sin_theta), 2.0 * sin_theta)
    ax = torch.stack([(R[..., 2, 1] - R[..., 1, 2]) / denom,
                      (R[..., 0, 2] - R[..., 2, 0]) / denom,
                      (R[..., 1, 0] - R[..., 0, 1]) / denom], dim=-1)

    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    u_abs = torch.sqrt(torch.clamp((diag + 1.0) / 2.0, min=0.0))
    k = torch.argmax(u_abs, dim=-1)  # first of equal values, as jnp.argmax
    s01 = torch.sign(R[..., 0, 1] + R[..., 1, 0])
    s02 = torch.sign(R[..., 0, 2] + R[..., 2, 0])
    s12 = torch.sign(R[..., 1, 2] + R[..., 2, 1])
    a0, a1, a2 = u_abs.unbind(-1)
    cases = (torch.stack([a0, s01 * a1, s02 * a2], dim=-1),  # axis 0 largest
             torch.stack([s01 * a0, a1, s12 * a2], dim=-1),
             torch.stack([s02 * a0, s12 * a1, a2], dim=-1))
    kk = k[..., None]
    u_pi = torch.where(kk == 0, cases[0], torch.where(kk == 1, cases[1], cases[2]))

    near_pi = (math.pi - theta) < 1e-4
    axis = torch.where(near_pi[..., None], u_pi, ax)
    rvec = theta[..., None] * axis
    small = theta < 1e-7
    return torch.where(small[..., None], torch.zeros_like(rvec), rvec)


def rotation_conversion(rotation_rep: torch.Tensor, to_vector: bool = True) -> torch.Tensor:
    """(3, 3) with ``to_vector`` -> axis-angle (3,); (3,) without it ->
    matrix (3, 3); anything else passes through."""
    if rotation_rep.shape[-2:] == (3, 3) and to_vector:
        return rodrigues_vector(rotation_rep)
    if (rotation_rep.dim() >= 1 and rotation_rep.shape[-1:] == (3,) and not to_vector
            and rotation_rep.shape[-2:] != (3, 3)):
        return rodrigues_matrix(rotation_rep)
    return rotation_rep


def distort_normalized(xy: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """The 5-coefficient (k1, k2, p1, p2, k3) radial + tangential model on
    normalized coordinates (..., 2).  ``dist`` is (5,) or (1, 5) for one
    camera, or (..., 5) broadcasting against ``xy[..., 0]``."""
    if dist.dim() == 2 and dist.shape[0] == 1:
        dist = dist[0]
    k1, k2, p1, p2, k3 = dist[..., :5].unbind(-1)
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def project_cameras(points: torch.Tensor, K: torch.Tensor, R: torch.Tensor, T: torch.Tensor,
                    dist: torch.Tensor | None = None,
                    ignore_distortions: bool = False) -> torch.Tensor:
    """Pinhole + distortion projection with rotation MATRICES, batched.

    ``points`` (..., 3); ``K`` (..., 3, 3), ``R`` (..., 3, 3), ``T`` (..., 3)
    and ``dist`` (..., 5) broadcast against the points' leading dims (one
    camera: no batch dims; C cameras over (C, B, J) points: (C, 1, 1, ...)).
    Returns pixels (..., 2).
    """
    cam = torch.matmul(R, points[..., None])[..., 0] + T
    x = cam[..., 0] / cam[..., 2]
    y = cam[..., 1] / cam[..., 2]
    xy = torch.stack([x, y], dim=-1)
    if not ignore_distortions and dist is not None:
        xy = distort_normalized(xy, dist)
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    skew = K[..., 0, 1]
    u = fx * xy[..., 0] + skew * xy[..., 1] + cx
    v = fy * xy[..., 1] + cy
    return torch.stack([u, v], dim=-1)


def project_points(points: torch.Tensor, K: torch.Tensor, R: torch.Tensor, T: torch.Tensor,
                   dist_coeffs: torch.Tensor | None = None,
                   ignore_distortions: bool = False) -> torch.Tensor:
    """Project world points (..., 3) through ONE camera to pixels (..., 2).

    ``R`` is a (3, 3) matrix or a (3,) axis-angle vector; ``T`` anything of
    3 elements; ``dist_coeffs`` (5,), (1, 5) or None.  Differentiable.
    """
    if R.shape[-2:] != (3, 3):
        R = rodrigues_matrix(R)
    return project_cameras(points, K, R, T.reshape(3), dist_coeffs, ignore_distortions)
