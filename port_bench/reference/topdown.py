"""The top-down 2D half in plain PyTorch: the crop of each (full-frame) box,
the 2D model, and the heatmap decode, in float32 (float64 for the moments
and the crop's geometry).

- Box to crop: the box is padded by ``bbox_padding`` and widened or
  heightened to the input's aspect ratio w/h, about its centre.
- Crop resample: ``jax.image.scale_and_translate(method="linear")``, which
  MMPose's affine warp approximates: per output sample i of an axis,
  its position in the input is s_i = (i + 0.5) / scale − t / scale − 0.5
  (t = −x0·scale), the weights of input samples j are the triangle
  max(0, 1 − |s_i − j| / k) with k = max(1, 1 / scale) (wider when it
  downscales: antialiasing), normalised to sum 1 (0 where the sum is not
  above 1000·eps of float32), and 0 where s_i lies outside
  [−0.5, n − 0.5].  Then ImageNet's mean and std per channel.
- Decode: per map, the first-occurrence argmax and its value (the
  score), a quarter-pixel step on each axis toward the larger of the two
  neighbours (clamped at the edge; no step where they are equal), and the
  Gaussian moments of the map with values under ``heatmap_threshold`` set
  to 0 (mean, then centred second moments; a map with no mass gives
  zeros).  Keypoints and moments go back to image pixels through the
  crop's scale and offset, at stride input / heatmap.

``rounding.model`` applies to the crop resample's products, ``rounding.host``
to the maps the decode reads and to its results (see `lowp`).
"""

from __future__ import annotations

import numpy as np
import torch

from .lowp import EXACT

__all__ = ["crop_geometry", "crop", "decode_maps", "moments", "to_image", "IMAGENET_MEAN",
           "IMAGENET_STD"]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
_EPS32 = float(np.finfo(np.float32).eps)


def crop_geometry(boxes: torch.Tensor, input_wh, padding: float):
    """boxes (N, 4) x0, y0, x1, y1 -> (x0, y0 of the crop window (N, 2),
    scale out/in per axis (N, 2)), float64."""
    boxes = boxes.double()
    in_w, in_h = input_wh
    aspect = in_w / in_h
    cx, cy = (boxes[:, 0] + boxes[:, 2]) / 2, (boxes[:, 1] + boxes[:, 3]) / 2
    w, h = (boxes[:, 2] - boxes[:, 0]) * padding, (boxes[:, 3] - boxes[:, 1]) * padding
    w, h = torch.maximum(w, h * aspect), torch.maximum(h, w / aspect)
    origin = torch.stack([cx - w / 2, cy - h / 2], -1)
    return origin, torch.stack([in_w / w, in_h / h], -1)


def _weights(n_in: int, n_out: int, scale: torch.Tensor, origin: torch.Tensor):
    """(N, n_out, n_in) float32 resample weights of one axis."""
    dev = scale.device
    s = ((torch.arange(n_out, dtype=torch.float32, device=dev)[None] + 0.5) / scale[:, None]
         + origin[:, None] - 0.5)
    k = torch.clamp(1.0 / scale, min=1.0)[:, None, None]
    dist = (s[:, :, None] - torch.arange(n_in, dtype=torch.float32, device=dev)).abs()
    w = torch.clamp(1.0 - dist / k, min=0.0)
    total = w.sum(-1, keepdim=True)
    w = torch.where(total > 1000.0 * _EPS32, w / torch.where(total > 0, total, 1.0), 0.0)
    inside = (s >= -0.5) & (s <= n_in - 0.5)
    return torch.where(inside[:, :, None], w, 0.0)


def crop(frames: torch.Tensor, origin: torch.Tensor, scale: torch.Tensor, input_wh,
         rounding=EXACT) -> torch.Tensor:
    """frames (N, H, W, 3) float32 in [0, 1] -> normalized crops (N, 3, in_h,
    in_w) float32."""
    in_w, in_h = input_wh
    N, H, W, _ = frames.shape
    r = rounding.model
    wy = _weights(H, in_h, scale[:, 1].float(), origin[:, 1].float())
    wx = _weights(W, in_w, scale[:, 0].float(), origin[:, 0].float())
    rows = torch.bmm(r(wy), r(frames.reshape(N, H, W * 3))).reshape(N, in_h, W, 3)
    out = torch.einsum("nxw,nywc->nyxc", r(wx), r(rows))
    mean = torch.tensor(IMAGENET_MEAN, device=frames.device)
    std = torch.tensor(IMAGENET_STD, device=frames.device)
    return ((out - mean) / std).permute(0, 3, 1, 2).contiguous()


def decode_maps(maps: torch.Tensor, threshold: float, rounding=EXACT):
    """maps (N, K, h, w) -> (xy (N, K, 2) heatmap px with the quarter step,
    score (N, K), moments (N, K, 6) heatmap px: mean x, mean y, var x,
    cov, cov, var y), float64 (rounded by ``rounding.host``)."""
    r = rounding.host
    maps = r(maps.float())
    N, K, h, w = maps.shape
    flat = maps.reshape(N, K, h * w)
    score, idx = flat.max(-1)  # the first occurrence of the maximum
    y, x = idx // w, idx % w

    def at(yy, xx):
        lin = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
        return torch.gather(flat, -1, lin[..., None])[..., 0]

    dx = torch.sign(at(y, x + 1) - at(y, x - 1))
    dy = torch.sign(at(y + 1, x) - at(y - 1, x))
    xy = torch.stack([x + 0.25 * dx, y + 0.25 * dy], -1).double()

    return xy, score.double(), moments(maps, threshold, rounding)


def moments(maps: torch.Tensor, threshold: float, rounding=EXACT) -> torch.Tensor:
    """maps (N, K, h, w) -> Gaussian moments (N, K, 6) in heatmap px, float64:
    values under ``threshold`` set to 0, the mean, then the centred second
    moments; zeros for a map with no mass."""
    r = rounding.host
    h, w = maps.shape[-2:]
    m = torch.where(maps < threshold, 0.0, maps)
    if rounding.exact:
        m = m.double()
    ys = torch.arange(h, dtype=m.dtype, device=m.device)[:, None]
    xs = torch.arange(w, dtype=m.dtype, device=m.device)[None, :]
    mass = m.sum((-2, -1))
    empty = mass <= 0
    denom = torch.where(empty, 1.0, mass)
    mx = r((m * xs).sum((-2, -1)) / denom)
    my = r((m * ys).sum((-2, -1)) / denom)
    ddx, ddy = xs - mx[..., None, None], ys - my[..., None, None]
    vx = r((m * ddx * ddx).sum((-2, -1)) / denom)
    vy = r((m * ddy * ddy).sum((-2, -1)) / denom)
    cxy = r((m * ddx * ddy).sum((-2, -1)) / denom)
    mom = torch.stack([mx, my, vx, cxy, cxy, vy], -1).double()
    return torch.where(empty[..., None], 0.0, mom)


def to_image(xy_hm: torch.Tensor, mom_hm: torch.Tensor, origin: torch.Tensor,
             scale: torch.Tensor, stride: float, rounding=EXACT):
    """Heatmap-pixel keypoints (N, K, 2) and moments (N, K, 6) -> image
    pixels, float64 (rounded by ``rounding.host``)."""
    r = rounding.host
    px = stride / scale[:, None, :]  # image px per heatmap px, (N, 1, 2)
    xy = r(xy_hm * px + origin[:, None, :])
    mean = r(mom_hm[..., :2] * px + origin[:, None, :])
    sx, sy = px[..., 0], px[..., 1]
    cov = torch.stack([mom_hm[..., 2] * sx * sx, mom_hm[..., 3] * sx * sy,
                       mom_hm[..., 4] * sx * sy, mom_hm[..., 5] * sy * sy], -1)
    return xy, torch.cat([mean, r(cov)], -1)
