"""Supervised targets: Gaussian heatmaps, SimCC label vectors and CenterNet maps.

Counterpart of the JAX package's ``training/targets.py``, with its
arithmetic:

- `render_heatmap_targets`: per-joint 2D Gaussian maps (the MSE targets of
  HRNet and Swin; σ in heatmap pixels);
- `render_simcc_targets`: per-axis 1-D Gaussian label vectors at
  ``split_ratio``× resolution, normalised (σ in bins; RTMPose's soft labels);
- `render_centernet_targets`: the CenterNet detector's centre, size and
  offset maps from top-1 person boxes.

A joint that is unlabeled (visibility ≤ 0) or outside the map gets zero
targets and weight 0, so the losses ignore it.  Inputs go to ``device``
(the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import torch

__all__ = ["render_heatmap_targets", "render_simcc_targets", "render_centernet_targets"]


def render_heatmap_targets(keypoints, visibility, heatmap_size: tuple[int, int],
                           sigma: float = 2.0, device="cuda"):
    """keypoints (..., K, 2) in heatmap pixels, visibility (..., K) ->
    (targets (..., K, H, W), weights (..., K)) for ``heatmap_size`` (H, W)."""
    H, W = heatmap_size
    kp = torch.as_tensor(keypoints, device=device)
    vis = torch.as_tensor(visibility, device=device) > 0
    ys = torch.arange(H, dtype=kp.dtype, device=kp.device)[:, None]
    xs = torch.arange(W, dtype=kp.dtype, device=kp.device)[None, :]
    dx = xs - kp[..., 0][..., None, None]
    dy = ys - kp[..., 1][..., None, None]
    hm = torch.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma))
    inside = (kp[..., 0] >= 0) & (kp[..., 0] < W) & (kp[..., 1] >= 0) & (kp[..., 1] < H)
    w = (vis & inside).to(kp.dtype)
    return hm * w[..., None, None], w


def render_simcc_targets(keypoints, visibility, input_size: tuple[int, int],
                         split_ratio: float = 2.0, sigma: float = 6.0, device="cuda"):
    """keypoints (..., K, 2) in input pixels, visibility (..., K) ->
    (x_labels (..., K, W·r), y_labels (..., K, H·r), weights (..., K)) for
    ``input_size`` (W, H): Gaussians normalised over their bins (the norm
    floored at 1e-12)."""
    w_px, h_px = input_size
    n_x, n_y = int(w_px * split_ratio), int(h_px * split_ratio)
    kp = torch.as_tensor(keypoints, device=device) * split_ratio
    vis = torch.as_tensor(visibility, device=device) > 0

    def axis_labels(loc, n):
        bins = torch.arange(n, dtype=kp.dtype, device=kp.device)
        g = torch.exp(-((bins - loc[..., None]) ** 2) / (2.0 * sigma * sigma))
        return g / torch.clamp(g.sum(-1, keepdim=True), min=1e-12)

    x_lab = axis_labels(kp[..., 0], n_x)
    y_lab = axis_labels(kp[..., 1], n_y)
    inside = (kp[..., 0] >= 0) & (kp[..., 0] < n_x) & (kp[..., 1] >= 0) & (kp[..., 1] < n_y)
    w = (vis & inside).to(kp.dtype)
    return x_lab * w[..., None], y_lab * w[..., None], w


def _gaussian_radius(width, height, min_overlap: float = 0.7):
    """The CornerNet/CenterNet radius at which a box keeps IoU ≥ ``min_overlap``."""
    zero = torch.zeros((), dtype=width.dtype, device=width.device)
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 - torch.sqrt(torch.maximum(b1 * b1 - 4 * 1.0 * c1, zero))) / 2
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 - torch.sqrt(torch.maximum(b2 * b2 - 4 * 4.0 * c2, zero))) / (2 * 4.0)
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + torch.sqrt(torch.maximum(b3 * b3 - 4 * a3 * c3, zero))) / (2 * a3)
    return torch.minimum(torch.minimum(r1, r2), r3)


def render_centernet_targets(bboxes, out_size: tuple[int, int], stride: int = 16,
                             min_radius: float = 1.0, device="cuda"):
    """Targets of `losses.centernet_focal_loss` from top-1 person boxes
    (B, 4) xyxy in input pixels, for head maps of ``out_size`` (h, w).

    Returns (center (B, h, w) Gaussians in [0, 1], wh (B, h, w, 2) box sizes
    in input pixels, offset (B, h, w, 2) sub-stride offsets, mask (B, h, w)
    1 at the centre cell), all f32; the radius follows the overlap-0.7 rule,
    at least ``min_radius``.
    """
    h, w = out_size
    b = torch.as_tensor(bboxes, dtype=torch.float32, device=device)
    cx = (b[:, 0] + b[:, 2]) * 0.5 / stride
    cy = (b[:, 1] + b[:, 3]) * 0.5 / stride
    bw = (b[:, 2] - b[:, 0]) / stride
    bh = (b[:, 3] - b[:, 1]) / stride
    r = torch.clamp(_gaussian_radius(bw, bh), min=min_radius)
    sigma = r / 3.0

    ix = torch.clamp(torch.floor(cx), 0, w - 1)
    iy = torch.clamp(torch.floor(cy), 0, h - 1)
    xs = torch.arange(w, dtype=torch.float32, device=b.device)[None, None, :]
    ys = torch.arange(h, dtype=torch.float32, device=b.device)[None, :, None]
    dx = xs - ix[:, None, None]
    dy = ys - iy[:, None, None]
    center = torch.exp(-(dx * dx + dy * dy) / (2.0 * sigma * sigma)[:, None, None])
    mask = ((dx.abs() < 0.5) & (dy.abs() < 0.5)).to(torch.float32)
    B = b.shape[0]
    wh = (torch.stack([bw, bh], -1)[:, None, None, :] * stride).expand(B, h, w, 2)
    off = torch.stack([cx - ix, cy - iy], -1)[:, None, None, :].expand(B, h, w, 2)
    return center, wh, off, mask
