"""Keypoint-schema conversion (COCO/AIC/CrowdPose -> H36M / MPI-INF-3DHP).

A copy of the JAX package's ``utils/keypoint_convert.py`` (the reference's
utils.py:915-1063, for pose-lifter compatibility; not used by the live
pipeline), as declarative rules: direct copies, midpoints and affine blends
of source joints.  It takes a numpy array or a tensor on any device and
returns the same kind; each blend accumulates in float64 with a separate
multiply and add per term (no fused multiply-add), so that the result is
the JAX package's bit for bit on every device.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["convert_keypoint_definition"]

_COCO_STYLE = {
    "TopDownCocoDataset",
    "TopDownPoseTrack18Dataset",
    "TopDownPoseTrack18VideoDataset",
}

# The reference applies a site-specific inverse permutation after the
# standard COCO->H36M mapping (utils.py:957-960).  Reproduced as data.
_COCO_H36M_FIX_PERM = [6, 2, 1, 0, 3, 4, 5, 7, 8, 16, 9, 13, 14, 15, 12, 11, 10]


def _blend(kpts, rules, n_out=17):
    """Apply (target, [(source, weight), ...]) blend rules."""
    if isinstance(kpts, torch.Tensor):
        out = torch.zeros((n_out, kpts.shape[1]), dtype=kpts.dtype, device=kpts.device)
        for target, terms in rules:
            acc = torch.zeros(kpts.shape[1], dtype=torch.float64, device=kpts.device)
            for src, w in terms:
                acc = acc + torch.mul(kpts[src].to(torch.float64), w)
            out[target] = acc.to(kpts.dtype)
        return out
    out = np.zeros((n_out, kpts.shape[1]), dtype=kpts.dtype)
    for target, terms in rules:
        acc = np.zeros(kpts.shape[1], dtype=np.float64)
        for src, w in terms:
            acc = acc + w * np.asarray(kpts[src], dtype=np.float64)
        out[target] = acc.astype(kpts.dtype)
    return out


def _div(x, d):
    """``x / d``, correctly rounded on every device: PyTorch's CUDA kernels
    multiply by the reciprocal of a Python scalar divisor (a bit off for
    3), but divide by a tensor."""
    if isinstance(x, torch.Tensor):
        return x / torch.tensor(d, dtype=x.dtype, device=x.device)
    return x / d


def convert_keypoint_definition(keypoints, pose_det_dataset, pose_lift_dataset):
    """Convert 2D keypoints (K, 2 or 3) between dataset joint conventions;
    a numpy array or a tensor (on any device) in, the same kind out."""
    if pose_lift_dataset not in ("Body3DH36MDataset", "Body3DMpiInf3dhpDataset"):
        raise ValueError(
            "pose_lift_dataset must be Body3DH36MDataset or Body3DMpiInf3dhpDataset, "
            f"got {pose_lift_dataset}"
        )
    kpts = keypoints if isinstance(keypoints, torch.Tensor) else np.asarray(keypoints)

    if pose_lift_dataset == "Body3DH36MDataset":
        if pose_det_dataset == "TopDownH36MDataset":
            return kpts.clone() if isinstance(kpts, torch.Tensor) else kpts.copy()
        if pose_det_dataset in _COCO_STYLE:
            rules = [
                (0, [(11, 0.5), (12, 0.5)]),   # pelvis = mid-hips
                (8, [(5, 0.5), (6, 0.5)]),     # thorax = mid-shoulders
                (10, [(1, 0.5), (2, 0.5)]),    # head = mid-eyes
                (1, [(12, 1.0)]), (2, [(14, 1.0)]), (3, [(16, 1.0)]),
                (4, [(11, 1.0)]), (5, [(13, 1.0)]), (6, [(15, 1.0)]),
                (9, [(0, 1.0)]),
                (11, [(5, 1.0)]), (12, [(7, 1.0)]), (13, [(9, 1.0)]),
                (14, [(6, 1.0)]), (15, [(8, 1.0)]), (16, [(10, 1.0)]),
            ]
            out = _blend(kpts, rules)
            # spine = mid(pelvis, thorax)
            out[7] = _div(out[0] + out[8], 2)
            inverse = [_COCO_H36M_FIX_PERM.index(i) for i in range(17)]
            return out[inverse]
        if pose_det_dataset == "TopDownAicDataset":
            rules = [
                (0, [(9, 0.5), (6, 0.5)]),
                (8, [(3, 0.5), (0, 0.5)]),
                (9, [(13, 0.75), (12, 0.25)]),
                (10, [(13, 5 / 12), (12, 7 / 12)]),
                (1, [(6, 1.0)]), (2, [(7, 1.0)]), (3, [(8, 1.0)]),
                (4, [(9, 1.0)]), (5, [(10, 1.0)]), (6, [(11, 1.0)]),
                (11, [(3, 1.0)]), (12, [(4, 1.0)]), (13, [(5, 1.0)]),
                (14, [(0, 1.0)]), (15, [(1, 1.0)]), (16, [(2, 1.0)]),
            ]
            out = _blend(kpts, rules)
            out[7] = _div(out[0] + out[8], 2)
            return out
        if pose_det_dataset == "TopDownCrowdPoseDataset":
            rules = [
                (0, [(6, 0.5), (7, 0.5)]),
                (8, [(0, 0.5), (1, 0.5)]),
                (9, [(13, 0.75), (12, 0.25)]),
                (10, [(13, 5 / 12), (12, 7 / 12)]),
                (1, [(7, 1.0)]), (2, [(9, 1.0)]), (3, [(11, 1.0)]),
                (4, [(6, 1.0)]), (5, [(8, 1.0)]), (6, [(10, 1.0)]),
                (11, [(0, 1.0)]), (12, [(2, 1.0)]), (13, [(4, 1.0)]),
                (14, [(1, 1.0)]), (15, [(3, 1.0)]), (16, [(5, 1.0)]),
            ]
            out = _blend(kpts, rules)
            out[7] = _div(out[0] + out[8], 2)
            return out
        raise NotImplementedError(
            f"unsupported conversion {pose_det_dataset} -> {pose_lift_dataset}"
        )

    # Body3DMpiInf3dhpDataset
    if pose_det_dataset in _COCO_STYLE:
        rules = [
            (14, [(11, 0.5), (12, 0.5)]),  # pelvis
            (1, [(5, 0.5), (6, 0.5)]),     # neck
            (16, [(1, 0.5), (2, 0.5)]),    # head
            (2, [(6, 1.0)]), (3, [(8, 1.0)]), (4, [(10, 1.0)]),
            (5, [(5, 1.0)]), (6, [(7, 1.0)]), (7, [(9, 1.0)]),
            (8, [(12, 1.0)]), (9, [(14, 1.0)]), (10, [(16, 1.0)]),
            (11, [(11, 1.0)]), (12, [(13, 1.0)]), (13, [(15, 1.0)]),
        ]
        out = _blend(kpts, rules)
        out[15] = _div(out[1] + out[14], 2)  # spine
        if "PoseTrack18" in pose_det_dataset:
            out[0] = kpts[1]
            if kpts.shape[1] > 2:
                out[16, 2] = out[0, 2]
        else:
            out[0] = _div(4 * out[16] - out[1], 3)  # head-top extrapolation
            if kpts.shape[1] > 2:
                out[0, 2] = out[16, 2]
        return out
    if pose_det_dataset == "TopDownAicDataset":
        rules = [
            (0, [(12, 1.0)]), (1, [(13, 1.0)]),
            (14, [(9, 0.5), (6, 0.5)]),
            (16, [(13, 5 / 12), (12, 7 / 12)]),
        ] + [(2 + i, [(i, 1.0)]) for i in range(12)]
        out = _blend(kpts, rules)
        out[15] = _div(out[1] + out[14], 2)
        return out
    if pose_det_dataset == "TopDownCrowdPoseDataset":
        arm_leg = [1, 3, 5, 0, 2, 4, 7, 9, 11, 6, 8, 10]
        rules = [
            (0, [(12, 1.0)]),
            (1, [(0, 0.5), (1, 0.5)]),
            (14, [(7, 0.5), (6, 0.5)]),
            (16, [(13, 5 / 12), (12, 7 / 12)]),
        ] + [(2 + i, [(src, 1.0)]) for i, src in enumerate(arm_leg)]
        out = _blend(kpts, rules)
        out[15] = _div(out[1] + out[14], 2)
        return out
    raise NotImplementedError(
        f"unsupported conversion {pose_det_dataset} -> {pose_lift_dataset}"
    )
