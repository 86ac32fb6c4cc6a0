"""Calibration verification: world-axis overlays + world-origin anchoring.

Counterpart of the JAX package's ``calib/verify.py`` (the reference's
utils.py:464-552, 639-700, headless):

- `check_calibration`: project shifted world axes into both cameras and
  draw them onto given frames (or blank canvases), returning and
  optionally saving the overlays;
- `get_world_space_origin`: anchor the world frame to a checkerboard
  photographed by the origin camera, by the planar `solve_pnp` on
  ``device``;
- `get_cam1_to_world_transforms`: compose the stereo pose with the world
  anchor and draw axes in both views.

The axes are projected on the host in float64 (four points); cv2 is
imported only to draw or save.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.geometry import project_points, rodrigues_matrix
from .checkerboard import board_object_points
from .corners import find_checkerboard_corners
from .pnp import solve_pnp

__all__ = [
    "draw_world_axes",
    "check_calibration",
    "get_world_space_origin",
    "get_cam1_to_world_transforms",
]

_AXIS_COLORS = [(0, 0, 255), (0, 255, 0), (255, 0, 0)]  # BGR for XYZ


def _f64(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def draw_world_axes(frame, K, R, T, dist=None, axis_length: float = 5.0,
                    origin_shift=(0.0, 0.0, 0.0)):
    """Draw the projected world X/Y/Z axes onto a copy of ``frame``.

    ``R`` is a (3, 3) matrix or a (3,) axis-angle vector.  Returns
    (frame_with_axes, axis_points_2d (4, 2)); without cv2 the copy is
    returned undrawn.
    """
    pts3d = axis_length * np.array(
        [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float64
    ) + np.asarray(origin_shift, np.float64)
    d = None if dist is None else _f64(dist).reshape(-1)
    pts2d = project_points(_f64(pts3d), _f64(K), _f64(R), _f64(T).reshape(3),
                           dist_coeffs=d).numpy()
    out = np.ascontiguousarray(np.asarray(frame).copy())
    try:
        import cv2
    except ImportError:
        return out, pts2d
    origin = tuple(np.round(pts2d[0]).astype(int))
    for color, p in zip(_AXIS_COLORS, pts2d[1:]):
        cv2.line(out, origin, tuple(np.round(p).astype(int)), color, 2)
    return out, pts2d


def check_calibration(camera0_name, camera0_data, camera1_name, camera1_data,
                      frames=None, z_shift: float = 50.0, save_dir=None):
    """Project shifted world axes into both cameras; return the overlays.

    ``camera*_data``: [K, dist, R, T] (the reference's layout at
    utils.py:466-474).  ``frames``: optional (frame0, frame1); blank
    canvases otherwise.  With ``save_dir`` the overlays are written as
    ``check_calibration_<name>.png``.
    """
    K0, d0, R0, T0 = camera0_data
    K1, d1, R1, T1 = camera1_data
    if frames is None:
        frames = (np.zeros((720, 1280, 3), np.uint8),) * 2
    shift = (0.0, 0.0, float(z_shift))
    out0, pts0 = draw_world_axes(frames[0], K0, R0, T0, d0, origin_shift=shift)
    out1, pts1 = draw_world_axes(frames[1], K1, R1, T1, d1, origin_shift=shift)
    if save_dir:
        import cv2

        cv2.imwrite(os.path.join(save_dir, f"check_calibration_{camera0_name}.png"), out0)
        cv2.imwrite(os.path.join(save_dir, f"check_calibration_{camera1_name}.png"), out1)
    return (out0, out1), (pts0, pts1)


def get_world_space_origin(K, dist, image, rows: int, columns: int,
                           square_size: float = 1.0, device="cuda"):
    """(R (3, 3), T (3, 1)) numpy anchoring the world frame to a photographed
    checkerboard; the PnP solve runs on ``device`` in float64."""
    found, corners = find_checkerboard_corners(image, rows, columns)
    if not found:
        raise RuntimeError("checkerboard not found in world-origin image")
    obj = board_object_points(rows, columns, square_size)
    rvec, tvec = solve_pnp(obj, corners.astype(np.float64), K, dist, device=device)
    return rodrigues_matrix(rvec).cpu().numpy(), tvec.reshape(3, 1).cpu().numpy()


def get_cam1_to_world_transforms(K0, dist0, R_W0, T_W0, K1, dist1, R_01, T_01,
                                 frame0=None, frame1=None, axis_length: float = 5.0,
                                 save_dir=None):
    """Compose the world anchor with the stereo pose; draw axes in both views.

    Returns ``(R_W1, T_W1, (overlay0, overlay1))``.
    """
    R_W0 = np.asarray(R_W0)
    T_W0 = np.asarray(T_W0).reshape(3, 1)
    R_01 = np.asarray(R_01)
    T_01 = np.asarray(T_01).reshape(3, 1)
    R_W1 = R_01 @ R_W0
    T_W1 = R_01 @ T_W0 + T_01

    if frame0 is None:
        frame0 = np.zeros((720, 1280, 3), np.uint8)
    if frame1 is None:
        frame1 = np.zeros((720, 1280, 3), np.uint8)
    out0, _ = draw_world_axes(frame0, K0, R_W0, T_W0, dist0, axis_length)
    out1, _ = draw_world_axes(frame1, K1, R_W1, T_W1, dist1, axis_length)
    if save_dir:
        import cv2

        cv2.imwrite(os.path.join(save_dir, "world_axes_cam0.png"), out0)
        cv2.imwrite(os.path.join(save_dir, "world_axes_cam1.png"), out1)
    return R_W1, T_W1, (out0, out1)
