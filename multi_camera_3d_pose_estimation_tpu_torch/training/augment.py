"""Pose augmentation.  So far the horizontal-flip joint permutation, from
the ``swap`` column of `utils.skeleton.POINT_INFO` (counterpart of the JAX
package's ``training/augment.py::flip_permutation``)."""

from __future__ import annotations

import numpy as np

from ..utils.skeleton import POINT_INFO

__all__ = ["flip_permutation"]


def flip_permutation(connectivity_type: str = "coco") -> np.ndarray:
    """Joint index permutation under horizontal flip (left <-> right)."""
    info = POINT_INFO[connectivity_type]
    name_to_idx = {v["name"]: k for k, v in info.items()}
    perm = np.arange(len(info))
    for idx, entry in info.items():
        if entry["swap"]:
            perm[idx] = name_to_idx[entry["swap"]]
    return perm
