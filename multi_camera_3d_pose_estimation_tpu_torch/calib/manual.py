"""Manual extrinsics from tape measurements (reference utils.py:703-717).

A copy of the JAX package's ``calib/manual.py`` (host numpy).

Approximate (R, T) of a camera from its measured world-space position and
an X-Z right triangle toward the origin camera's axis: the rotation is
about Y only (yaw), derived from the triangle's legs; T = −R·C with C the
camera centre — behaviour parity with `compute_extrinsic_from_measurments`.
"""

from __future__ import annotations

import numpy as np

__all__ = ["compute_extrinsic_from_measurements"]


def compute_extrinsic_from_measurements(
    camera_position_xyz,
    triangle_adjacent: float,
    triangle_opposite: float,
):
    """Returns ``(R (3,3), T (3,1))``.

    - ``camera_position_xyz``: the camera centre C in world coordinates
      (same units as the calibration scale).
    - ``triangle_adjacent`` / ``triangle_opposite``: legs of the measured
      X-Z right triangle giving the yaw angle toward the origin camera,
      tan(yaw) = opposite / adjacent.
    """
    C = np.asarray(camera_position_xyz, np.float64).reshape(3)
    yaw = np.arctan2(float(triangle_opposite), float(triangle_adjacent))
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    T = -R @ C
    return R, T.reshape(3, 1)
