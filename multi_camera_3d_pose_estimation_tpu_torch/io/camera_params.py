"""Camera parameters on disk, in the JAX package's ``.dat`` format (the
files are interchangeable):

- ``intrinsic_camera_parameters/<name>.dat``: an "intrinsic:" header, the 3
  rows of K, a "distortion:" header, one row of 5 coefficients;
- ``extrinsic_camera_parameters/rot_trans_<name>.dat``: "R:" and its 3
  rows, "T:" and its 3 rows.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.geometry import projection_matrix

__all__ = ["save_camera_intrinsics", "read_camera_parameters",
           "save_extrinsic_calibration_parameters", "read_rotation_translation",
           "get_params_from_name", "CameraParams", "stack_camera_params"]


def _write_rows(f, rows) -> None:
    for row in np.atleast_2d(np.asarray(rows)):
        f.write(" ".join(str(v) for v in row) + " \n")


def save_camera_intrinsics(camera_matrix, distortion_coefs, camera_name, root_path=None) -> str:
    """Write ``<root>/intrinsic_camera_parameters/<name>.dat``."""
    root_path = root_path or os.getcwd()
    folder = os.path.join(root_path, "intrinsic_camera_parameters")
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, camera_name + ".dat")
    with open(path, "w") as f:
        f.write("intrinsic:\n")
        _write_rows(f, camera_matrix)
        f.write("distortion:\n")
        _write_rows(f, np.asarray(distortion_coefs).reshape(1, -1))
    return path


def _read_rows(path: str) -> list:
    with open(path) as f:
        return [ln.split() for ln in f.read().splitlines() if ln.strip()]


def read_camera_parameters(camera_name: str, params_dir: str = ""):
    """K (3, 3) and distortion (1, k) from ``<dir>/<name>.dat``."""
    lines = _read_rows(os.path.join(params_dir or os.getcwd(), camera_name + ".dat"))
    # lines[0] is the "intrinsic:" header, 1-3 K, 4 "distortion:", 5 the coefficients.
    cmtx = np.array([[float(v) for v in lines[i]] for i in (1, 2, 3)])
    return cmtx, np.array([[float(v) for v in lines[5]]])


def save_extrinsic_calibration_parameters(R, T, camera_name, root_dir=None):
    """Write ``<root>/extrinsic_camera_parameters/rot_trans_<name>.dat``."""
    root_dir = root_dir or os.getcwd()
    folder = os.path.join(root_dir, "extrinsic_camera_parameters")
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, f"rot_trans_{camera_name}.dat"), "w") as f:
        f.write("R:\n")
        _write_rows(f, R)
        f.write("T:\n")
        _write_rows(f, np.asarray(T).reshape(3, 1))
    return R, T


def read_rotation_translation(camera_name: str, params_dir: str = ""):
    """R (3, 3) and T (3, 1) from ``<dir>/rot_trans_<name>.dat``."""
    lines = _read_rows(os.path.join(params_dir or os.getcwd(), "rot_trans_" + camera_name + ".dat"))
    rot = np.array([[float(v) for v in lines[i]] for i in (1, 2, 3)])
    return rot, np.array([[float(v) for v in lines[i]] for i in (5, 6, 7)])


@dataclass
class CameraParams:
    """One camera's parameters (K, R, T, dist); missing ones are None."""

    K: np.ndarray | None
    R: np.ndarray | None
    T: np.ndarray | None
    dist: np.ndarray | None

    @property
    def P(self) -> np.ndarray | None:
        """K [R|T] (3, 4) float64, or None without K, R or T."""
        if self.K is None or self.R is None or self.T is None:
            return None
        K, R, T = (torch.as_tensor(np.asarray(a, np.float64)) for a in (self.K, self.R, self.T))
        return projection_matrix(K, R, T).numpy()

    def as_list(self):
        """[K, R, T, dist]."""
        return [self.K, self.R, self.T, self.dist]


def get_params_from_name(camera_name, intrinsic_params_dir="", extrinsic_params_dir=""):
    """``(P, [K, R, T, dist])`` of a camera by name; a missing file gives
    None entries instead of raising."""
    intrinsic_params_dir = intrinsic_params_dir or os.path.join(
        os.getcwd(), "intrinsic_camera_parameters")
    extrinsic_params_dir = extrinsic_params_dir or os.path.join(
        os.getcwd(), "extrinsic_camera_parameters")
    cmtx = dist = R = T = None
    try:
        cmtx, dist = read_camera_parameters(camera_name, params_dir=intrinsic_params_dir)
    except OSError:
        pass
    try:
        R, T = read_rotation_translation(camera_name, params_dir=extrinsic_params_dir)
    except OSError:
        pass
    cam = CameraParams(cmtx, R, T, dist)
    return cam.P, cam.as_list()


def stack_camera_params(cams: dict | list) -> dict[str, np.ndarray]:
    """Per-camera [K, R, T, dist] lists (a dict in key order, or a list) ->
    float64 {"K": (n, 3, 3), "R": (n, 3, 3), "T": (n, 3), "dist": (n, 5)}
    (a None dist is zeros; fewer than 5 coefficients are zero-padded)."""
    items = [cams[k] for k in sorted(cams)] if isinstance(cams, dict) else list(cams)
    Ks, Rs, Ts, ds = [], [], [], []
    for K, R, T, dist in items:
        Ks.append(np.asarray(K, np.float64))
        Rs.append(np.asarray(R, np.float64).reshape(3, 3))
        Ts.append(np.asarray(T, np.float64).reshape(3))
        d = np.zeros(5) if dist is None else np.asarray(dist, np.float64).reshape(-1)
        if d.size < 5:
            d = np.pad(d, (0, 5 - d.size))
        ds.append(d[:5])
    return {"K": np.stack(Ks), "R": np.stack(Rs), "T": np.stack(Ts), "dist": np.stack(ds)}
