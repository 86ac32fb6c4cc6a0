"""The camera rig and the project directory the estimate step reads.

A ring of ``cameras`` cameras at ``radius_m`` from the origin and
``height_m`` above the floor (z up), spread over ``arc_deg`` of the ring,
each looking at a point ``target_m`` above the origin, with the pinhole
K of a ``hfov_deg`` lens at the traffic's frame size and the five
distortion coefficients ``dist`` (OpenCV's k1, k2, p1, p2, k3).  Written
in the estimate step's text formats:

- ``intrinsic_camera_parameters/<name>.dat``: ``intrinsic:``, the 3 rows
  of K, ``distortion:``, one row of 5 coefficients;
- ``extrinsic_camera_parameters/rot_trans_<name>.dat``: ``R:`` and its 3
  rows, ``T:`` and its 3 rows (world to camera: x_cam = R·x + T);
- ``extrinsic_camera_parameters/camera_names.pkl``: a pickled
  ({index: name}, origin camera name).
"""

from __future__ import annotations

import math
import os
import pickle

import numpy as np

__all__ = ["make_rig", "write_project"]


def make_rig(spec: dict, width: int, height: int) -> dict:
    """{"names": [...], "K" (C, 3, 3), "R" (C, 3, 3), "T" (C, 3), "dist" (C, 5)},
    float64 numpy."""
    C = int(spec["cameras"])
    f = (width / 2) / math.tan(math.radians(spec["hfov_deg"]) / 2)
    K = np.array([[f, 0.0, (width - 1) / 2], [0.0, f, (height - 1) / 2], [0.0, 0.0, 1.0]])
    target = np.array([0.0, 0.0, spec["target_m"]])
    Ks, Rs, Ts = [], [], []
    for c in range(C):
        yaw = math.radians(spec["arc_deg"]) * (c / max(C - 1, 1) - 0.5)
        pos = np.array([spec["radius_m"] * math.sin(yaw), -spec["radius_m"] * math.cos(yaw),
                        spec["height_m"]])
        fwd = (target - pos) / np.linalg.norm(target - pos)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd])
        Ks.append(K)
        Rs.append(R)
        Ts.append(-R @ pos)
    dist = np.tile(np.asarray(spec["dist"], np.float64), (C, 1))
    return {"names": [f"cam{c}" for c in range(C)], "K": np.stack(Ks), "R": np.stack(Rs),
            "T": np.stack(Ts), "dist": dist}


def _rows(f, rows) -> None:
    for row in np.atleast_2d(rows):
        f.write(" ".join(repr(float(v)) for v in row) + " \n")


def write_project(root: str, rig: dict) -> None:
    """Write ``rig`` as a project directory under ``root``."""
    intr = os.path.join(root, "intrinsic_camera_parameters")
    extr = os.path.join(root, "extrinsic_camera_parameters")
    os.makedirs(intr, exist_ok=True)
    os.makedirs(extr, exist_ok=True)
    for c, name in enumerate(rig["names"]):
        with open(os.path.join(intr, f"{name}.dat"), "w") as f:
            f.write("intrinsic:\n")
            _rows(f, rig["K"][c])
            f.write("distortion:\n")
            _rows(f, rig["dist"][c][None])
        with open(os.path.join(extr, f"rot_trans_{name}.dat"), "w") as f:
            f.write("R:\n")
            _rows(f, rig["R"][c])
            f.write("T:\n")
            _rows(f, rig["T"][c][:, None])
    with open(os.path.join(extr, "camera_names.pkl"), "wb") as f:
        pickle.dump(({c: n for c, n in enumerate(rig["names"])}, rig["names"][0]), f)
