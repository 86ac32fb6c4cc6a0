"""Training losses of the three model families, joint-masked and batched.

Counterpart of the JAX package's ``training/losses.py``: the heatmap MSE
(HRNet, Swin), the SimCC KL divergence (RTMPose) and the CenterNet focal
loss, with the same arithmetic; autograd gives their gradients.
"""

from __future__ import annotations

import torch

__all__ = ["heatmap_mse_loss", "simcc_kl_loss", "centernet_focal_loss"]


def heatmap_mse_loss(pred, target, weights):
    """Joint-masked MSE: pred/target (..., K, H, W), weights (..., K)."""
    per_joint = ((pred - target) ** 2).mean((-2, -1))  # (..., K)
    w = weights.to(per_joint.dtype)
    return (per_joint * w).sum() / torch.clamp(w.sum(), min=1.0)


def simcc_kl_loss(pred_x, pred_y, lab_x, lab_y, weights):
    """KL(label ‖ softmax(logits)) per axis, joint-masked (RTMPose's loss):
    the cross-entropy minus the labels' entropy, whose ``labels·log labels``
    counts only bins with labels > 0."""

    def axis(logits, labels):
        ce = -(labels * torch.log_softmax(logits, dim=-1)).sum(-1)  # (..., K)
        plogp = labels * torch.log(torch.clamp(labels, min=1e-12))
        ent = -torch.where(labels > 0, plogp, torch.zeros_like(plogp)).sum(-1)
        return ce - ent  # the true KL: >= 0, 0 at a perfect match

    kl = axis(pred_x, lab_x) + axis(pred_y, lab_y)
    w = weights.to(kl.dtype)
    return (kl * w).sum() / torch.clamp(w.sum(), min=1.0)


def centernet_focal_loss(outputs: dict, center_target, wh_target, offset_target, mask,
                         alpha: float = 2.0, beta: float = 4.0, wh_weight: float = 0.1,
                         offset_weight: float = 1.0):
    """CenterNet's penalty-reduced focal loss plus masked L1 size and offset
    terms.

    - ``outputs``: the `models.CenterNetDetector` head dict (``center``
      logits (B, h, w), ``wh`` and ``offset`` (B, h, w, 2)) at stride 16;
    - ``center_target`` (B, h, w) in [0, 1]; ``mask`` (B, h, w) 1 at the
      exact centre cells (`targets.render_centernet_targets`).
    """
    p = torch.clamp(torch.sigmoid(outputs["center"]), 1e-6, 1.0 - 1e-6)
    pos_loss = -((1 - p) ** alpha) * torch.log(p)
    neg_loss = -((1 - center_target) ** beta) * (p ** alpha) * torch.log(1 - p)
    n_pos = torch.clamp(mask.sum(), min=1.0)
    cls = torch.where(mask > 0, pos_loss, neg_loss).sum() / n_pos
    wh = ((outputs["wh"] - wh_target).abs() * mask[..., None]).sum() / n_pos
    off = ((outputs["offset"] - offset_target).abs() * mask[..., None]).sum() / n_pos
    return cls + wh_weight * wh + offset_weight * off
