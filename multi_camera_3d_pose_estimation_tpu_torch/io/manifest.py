"""Run manifests: ``recording_log.yaml``, ``camera_names.pkl`` and numbered
run folders, as the JAX package's ``io/manifest.py`` writes them (the files
are interchangeable).  PyYAML is imported only by the recording-log
functions."""

from __future__ import annotations

import os
import pickle

import numpy as np

__all__ = ["create_new_numbered_folder", "load_if_exists", "write_recording_log",
           "read_recording_log", "save_camera_names", "load_camera_names"]


def create_new_numbered_folder(base_dir: str) -> int:
    """Create ``<base_dir>/<n>`` where n = max(existing ints)+1; return n."""
    os.makedirs(base_dir, exist_ok=True)
    subdirs = [int(d) for d in os.listdir(base_dir) if d.isdigit()]
    new_num = max(subdirs, default=-1) + 1
    os.makedirs(os.path.join(base_dir, str(new_num)))
    return new_num


def load_if_exists(path: str):
    """``np.load`` the file if present, else None."""
    if path and os.path.exists(path):
        return np.load(path)
    return None


def write_recording_log(recordings_folder: str, recording_paths, estimator_model: str,
                        detector_model: str, extra: dict | None = None) -> str:
    """Write ``<folder>/recording_log.yaml``: the recordings, the three
    artifact paths and the two model names (plus ``extra``)."""
    import yaml

    log = {
        "recording_paths": [str(p) for p in recording_paths],
        "kpts_2d": str(os.path.join(recordings_folder, "kpts_2d.npy")),
        "heatmaps_2d": str(os.path.join(recordings_folder, "heatmaps_2d.npy")),
        "kpts_3d": str(os.path.join(recordings_folder, "kpts_3d.npy")),
        "estimator_model": estimator_model,
        "detector_model": detector_model,
    }
    if extra:
        log.update(extra)
    path = os.path.join(recordings_folder, "recording_log.yaml")
    with open(path, "w") as f:
        yaml.dump(log, f)
    return path


def read_recording_log(path: str) -> dict:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def save_camera_names(cameras: dict, origin_camera, save_dir: str) -> str:
    """Pickle ``(index -> name dict, origin_camera)`` to
    ``<dir>/extrinsic_camera_parameters/camera_names.pkl``."""
    folder = os.path.join(save_dir, "extrinsic_camera_parameters")
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, "camera_names.pkl")
    with open(path, "wb") as f:
        pickle.dump((cameras, origin_camera), f)
    return path


def load_camera_names(extrinsic_params_dir: str):
    """``(cameras, origin_camera)`` from ``<dir>/camera_names.pkl``."""
    path = os.path.join(extrinsic_params_dir, "camera_names.pkl")
    with open(path, "rb") as f:
        return pickle.load(f)
