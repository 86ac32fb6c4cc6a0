"""Skeleton metadata: edge lists, the COCO joint table, body-part lengths.

The port's own copy of the JAX package's ``utils/skeleton.py`` (the tables
are data; the functions work on torch tensors).  The ``<start>_<end>`` edge
names of `generate_connectivity_names` are the schema of
``body_part_lengths.yaml``, so the tables must match the JAX package's
exactly (a test compares them).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "CONNECTIVITY_DICT",
    "POINT_INFO",
    "BODYPARTS",
    "generate_connectivity_names",
    "get_body_part_vects",
    "get_body_part_lengths",
    "body_length_edges",
    "change_origin",
]

# Edge lists per skeleton convention.
CONNECTIVITY_DICT = {
    "cmu": [
        (0, 2), (0, 9), (1, 0), (1, 17), (2, 12), (3, 0), (4, 3), (5, 4),
        (6, 2), (7, 6), (8, 7), (9, 10), (10, 11), (12, 13), (13, 14),
        (15, 1), (16, 15), (17, 18),
    ],
    "coco": [
        (0, 1), (0, 2), (1, 3), (2, 4), (5, 7), (7, 9), (6, 8), (8, 10),
        (11, 13), (13, 15), (12, 14), (14, 16), (5, 6), (5, 11), (6, 12),
        (11, 12),
    ],
    "mpii": [
        (0, 1), (1, 2), (2, 6), (5, 4), (4, 3), (3, 6), (6, 7), (7, 8),
        (8, 9), (8, 12), (8, 13), (10, 11), (11, 12), (13, 14), (14, 15),
    ],
    "human36m": [
        (0, 1), (1, 2), (2, 6), (5, 4), (4, 3), (3, 6), (6, 7), (7, 8),
        (8, 9), (9, 16), (8, 12), (11, 12), (10, 11), (8, 13), (13, 14),
        (14, 15),
    ],
    "kth": [
        (0, 1), (1, 2), (5, 4), (4, 3), (6, 7), (7, 8), (11, 10), (10, 9),
        (2, 3), (3, 9), (2, 8), (9, 12), (8, 12), (12, 13),
    ],
}

# COCO-17 joint table (name, color, upper/lower, left/right swap partner).
_COCO_JOINTS = [
    ("nose", [51, 153, 255], "upper", ""),
    ("left_eye", [51, 153, 255], "upper", "right_eye"),
    ("right_eye", [51, 153, 255], "upper", "left_eye"),
    ("left_ear", [51, 153, 255], "upper", "right_ear"),
    ("right_ear", [51, 153, 255], "upper", "left_ear"),
    ("left_shoulder", [0, 255, 0], "upper", "right_shoulder"),
    ("right_shoulder", [255, 128, 0], "upper", "left_shoulder"),
    ("left_elbow", [0, 255, 0], "upper", "right_elbow"),
    ("right_elbow", [255, 128, 0], "upper", "left_elbow"),
    ("left_wrist", [0, 255, 0], "upper", "right_wrist"),
    ("right_wrist", [255, 128, 0], "upper", "left_wrist"),
    ("left_hip", [0, 255, 0], "lower", "right_hip"),
    ("right_hip", [255, 128, 0], "lower", "left_hip"),
    ("left_knee", [0, 255, 0], "lower", "right_knee"),
    ("right_knee", [255, 128, 0], "lower", "left_knee"),
    ("left_ankle", [0, 255, 0], "lower", "right_ankle"),
    ("right_ankle", [255, 128, 0], "lower", "left_ankle"),
]

POINT_INFO = {
    "coco": {
        i: {"name": n, "id": i, "color": c, "type": t, "swap": s}
        for i, (n, c, t, s) in enumerate(_COCO_JOINTS)
    }
}

# Body-part groups for plotting.
BODYPARTS = {
    "coco": {
        "torso": [[11, 12]],
        "armr": [[6, 8], [8, 10]],
        "arml": [[5, 7], [7, 9]],
        "legr": [[11, 13], [13, 15]],
        "legl": [[12, 14], [14, 16]],
    }
}


def generate_connectivity_names(connectivity_list, point_names) -> dict[int, str]:
    """Edge index -> "<start_name>_<end_name>"."""
    return {idx: f"{point_names[a]['name']}_{point_names[b]['name']}"
            for idx, (a, b) in enumerate(connectivity_list)}


def get_body_part_vects(pose: torch.Tensor, connectivity_type: str = "coco") -> dict:
    """Per-edge vectors (end − start): pose (..., J, D) -> {edge_name: (..., D)}."""
    edges = CONNECTIVITY_DICT[connectivity_type]
    names = generate_connectivity_names(edges, POINT_INFO[connectivity_type])
    return {names[i]: pose[..., b, :] - pose[..., a, :] for i, (a, b) in enumerate(edges)}


def get_body_part_lengths(pose: torch.Tensor, connectivity_type: str = "coco") -> dict:
    """Per-edge Euclidean lengths: {edge_name: (...,)}."""
    return {k: torch.linalg.vector_norm(v, dim=-1)
            for k, v in get_body_part_vects(pose, connectivity_type).items()}


def body_length_edges(target_lengths: dict, connectivity_type: str = "coco"):
    """A body-length dict {edge_name: length} as index arrays (start (E,),
    end (E,), target (E,)) in the dict's key order."""
    edges = CONNECTIVITY_DICT[connectivity_type]
    names = generate_connectivity_names(edges, POINT_INFO[connectivity_type])
    by_name = {v: edges[k] for k, v in names.items()}
    starts, ends, targets = [], [], []
    for name, length in target_lengths.items():
        if name not in by_name:
            raise KeyError(f"unknown body segment '{name}'; valid names: {sorted(by_name)}")
        a, b = by_name[name]
        starts.append(a)
        ends.append(b)
        targets.append(float(length))
    return np.array(starts, np.int32), np.array(ends, np.int32), np.array(targets, np.float64)


def change_origin(points: torch.Tensor, height) -> torch.Tensor:
    """Flip the pixel y-origin (top-left <-> bottom-left) of (..., 2) points."""
    return torch.stack([points[..., 0], height - points[..., 1]], dim=-1)
