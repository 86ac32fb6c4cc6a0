"""Pose augmentation: horizontal flip with joint swapping, random affine parameters.

Counterpart of the JAX package's ``training/augment.py``.  The flip's joint
permutation comes from the ``swap`` column of `utils.skeleton.POINT_INFO`,
so left and right joints exchange labels.

Each random function is a draw and a deterministic apply.  The draws come
from a CPU ``torch.Generator`` (the card and the CPU draw the same numbers,
not ``jax.random``'s); the applies take the drawn mask or uniforms and
compute what the JAX functions compute from theirs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.skeleton import POINT_INFO

__all__ = ["flip_permutation", "draw_flip_mask", "apply_flip_pose", "random_flip_pose",
           "affine_params_from_uniform", "random_affine_params"]


def flip_permutation(connectivity_type: str = "coco") -> np.ndarray:
    """Joint index permutation under horizontal flip (left <-> right)."""
    info = POINT_INFO[connectivity_type]
    name_to_idx = {v["name"]: k for k, v in info.items()}
    perm = np.arange(len(info))
    for idx, entry in info.items():
        if entry["swap"]:
            perm[idx] = name_to_idx[entry["swap"]]
    return perm


def draw_flip_mask(generator: torch.Generator, batch: int, prob: float = 0.5,
                   device="cuda") -> torch.Tensor:
    """(batch,) bool: which items to mirror, each with probability ``prob``."""
    return (torch.rand(batch, generator=generator) < prob).to(device)


def apply_flip_pose(mask, images, keypoints, visibility, perm):
    """Mirror the items where ``mask`` (B,) is true: images (B, H, W, C)
    left-right, keypoints (B, K, 2) to x' = W − 1 − x with the joints
    permuted by ``perm``, visibility (B, K) permuted with them."""
    W = images.shape[2]
    mask = torch.as_tensor(mask, device=images.device)
    perm = torch.as_tensor(perm, device=images.device)
    images = torch.where(mask[:, None, None, None], torch.flip(images, dims=[2]), images)
    kp_f = torch.stack([W - 1 - keypoints[..., 0], keypoints[..., 1]], dim=-1)[:, perm]
    keypoints = torch.where(mask[:, None, None], kp_f, keypoints)
    visibility = torch.where(mask[:, None], visibility[:, perm], visibility)
    return images, keypoints, visibility


def random_flip_pose(generator: torch.Generator, images, keypoints, visibility, perm,
                     prob: float = 0.5):
    """Randomly mirror images (B, H, W, C) and keypoints (B, K, 2) together."""
    mask = draw_flip_mask(generator, images.shape[0], prob, images.device)
    return apply_flip_pose(mask, images, keypoints, visibility, perm)


def _uniform(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jax.random.uniform``'s map of [0, 1) draws to [lo, hi), in u's dtype:
    u·(hi − lo) + lo as one fused multiply-add, as XLA compiles it."""
    lo_t = torch.tensor(lo, dtype=u.dtype, device=u.device)
    hi_t = torch.tensor(hi, dtype=u.dtype, device=u.device)
    return torch.maximum(torch.addcmul(lo_t, u, hi_t - lo_t), lo_t)


def affine_params_from_uniform(u_scale, u_rot, u_trans, scale_range=(0.75, 1.25),
                               rot_deg: float = 30.0, translate_frac: float = 0.1):
    """Per-item (scale (B,), rotation in radians (B,), translation (B, 2))
    from [0, 1) draws of the same shapes."""
    scale = _uniform(u_scale, scale_range[0], scale_range[1])
    rot = _uniform(u_rot, -1.0, 1.0) * (rot_deg * math.pi / 180.0)
    trans = _uniform(u_trans, -translate_frac, translate_frac)
    return scale, rot, trans


def random_affine_params(generator: torch.Generator, batch: int, scale_range=(0.75, 1.25),
                         rot_deg: float = 30.0, translate_frac: float = 0.1, device="cuda"):
    """Draw per-item (scale (B,), rotation rad (B,), translation (B, 2)):
    scale and translation fold into the crop box, the rotation rotates the
    keypoint targets (axis-aligned crops keep one resampler)."""
    u = torch.rand(4 * batch, generator=generator).to(device)
    return affine_params_from_uniform(u[:batch], u[batch:2 * batch],
                                      u[2 * batch:].view(batch, 2), scale_range, rot_deg,
                                      translate_frac)
