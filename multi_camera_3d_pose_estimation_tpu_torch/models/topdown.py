"""Top-down 2D pose pipeline: bbox -> crop -> model -> decode -> image space.

Counterpart of the JAX package's ``models/topdown.py``: the heatmap decode
for the HRNet and Swin families (with flip-TTA and the DARK decode) and the
SimCC decode for RTMPose (flip-TTA averages probabilities; a diagonal
covariance from each axis's softmax variance).  Layouts follow the JAX package:
frames (B, H, W, 3), crops (B, in_h, in_w, 3), heatmaps (B, K, h, w),
keypoints (B, K, 3) = (x_px, y_px, score), gaussians (B, K, 6) =
[mean_x, mean_y, var_x, cov_xy, cov_xy, var_y] in image pixels.

The crop resample reproduces ``jax.image.scale_and_translate(method="linear")``,
which antialiases when it downscales: per box, a (out, in) triangle-kernel
weight matrix per axis, widened by 1/scale when scale < 1, renormalised per
output sample and zero where the sample falls outside the image, applied as
two batched matmuls.  ``F.interpolate`` and ``grid_sample`` do not compute
this.  The weights come from f32 scale and offset; only the pixel data
follows the frames' dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.fused_decode import fused_heatmap_decode
from ..ops.heatmap_decode import heatmap_argmax_decode, heatmap_dark_decode
from ..ops.moments import heatmap_moments
from ..ops.simcc import simcc_decode
from .rtmpose import RTMPose
from .swin import SwinPose

__all__ = [
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "center_scale_from_bbox",
    "crop_frames",
    "preprocess_crops",
    "TopDownEstimator",
]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_F32_EPS = float(np.finfo(np.float32).eps)


def center_scale_from_bbox(bboxes: torch.Tensor, aspect_ratio: float, padding: float = 1.25):
    """(x0, y0, x1, y1) boxes (..., 4) -> center (..., 2), size (..., 2),
    the box padded and expanded to the aspect ratio w/h."""
    x0, y0, x1, y1 = bboxes.unbind(-1)
    center = torch.stack([(x0 + x1) * 0.5, (y0 + y1) * 0.5], dim=-1)
    w = (x1 - x0) * padding
    h = (y1 - y0) * padding
    w_fit = torch.maximum(w, h * aspect_ratio)
    h_fit = torch.maximum(h, w / aspect_ratio)
    return center, torch.stack([w_fit, h_fit], dim=-1)


def _weight_mat(in_size: int, out_size: int, scale: torch.Tensor,
                translation: torch.Tensor) -> torch.Tensor:
    """Per-box linear resample weights (B, out_size, in_size), as
    ``jax.image`` computes them (``compute_weight_mat``, antialias on)."""
    dt, dev = scale.dtype, scale.device
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = ((torch.arange(out_size, dtype=dt, device=dev) + 0.5)[None, :] * inv_scale[:, None]
                - (translation * inv_scale)[:, None] - 0.5)  # (B, out)
    x = (sample_f[:, :, None] - torch.arange(in_size, dtype=dt, device=dev)[None, None, :]).abs()
    weights = torch.clamp(1.0 - x / kernel_scale[:, None, None], min=0.0)
    total = weights.sum(-1, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * _F32_EPS,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, :, None], weights, torch.zeros_like(weights))


def crop_frames(frames: torch.Tensor, center: torch.Tensor, size: torch.Tensor,
                out_hw: tuple[int, int]):
    """Axis-aligned affine crop (B, H, W, 3) -> (B, out_h, out_w, 3).

    Returns (crops, scale (B, 2), offset (B, 2)) with
    ``img_xy = crop_xy / scale + offset``.
    """
    out_h, out_w = out_hw
    B, H, W, ch = frames.shape
    x0 = center[:, 0] - size[:, 0] * 0.5
    y0 = center[:, 1] - size[:, 1] * 0.5
    sx = out_w / size[:, 0]
    sy = out_h / size[:, 1]
    wy = _weight_mat(H, out_h, sy, -y0 * sy).to(frames.dtype)  # (B, out_h, H)
    wx = _weight_mat(W, out_w, sx, -x0 * sx).to(frames.dtype)  # (B, out_w, W)
    rows = torch.matmul(wy, frames.reshape(B, H, W * ch)).reshape(B, out_h, W, ch)
    crops = torch.matmul(wx[:, None], rows)  # (B, out_h, out_w, ch)
    return crops, torch.stack([sx, sy], dim=-1), torch.stack([x0, y0], dim=-1)


def preprocess_crops(frames, bboxes, input_size, bbox_padding: float = 1.25):
    """Aspect-fitted padded crop, linear resample and ImageNet normalization
    in ``frames.dtype``.  Returns (crops (B, in_h, in_w, 3), scale, offset)."""
    in_w, in_h = input_size
    center, size = center_scale_from_bbox(bboxes, in_w / in_h, bbox_padding)
    crops, scale, offset = crop_frames(frames, center, size, (in_h, in_w))
    mean = torch.as_tensor(IMAGENET_MEAN, device=crops.device).to(crops.dtype)
    std = torch.as_tensor(IMAGENET_STD, device=crops.device).to(crops.dtype)
    return (crops - mean) / std, scale, offset


class TopDownEstimator:
    """Batched top-down 2D pose estimator.

    - ``model``: the port's `HRNet` or `SwinPose` (``decode="heatmap"``) or
      `RTMPose` (``decode="simcc"``), weights loaded, on ``device``.
    - ``input_size``: (width, height) of the crop fed to the model.
    - ``use_fused_decode``: decode through the CUDA kernel
      (`ops.fused_heatmap_decode`) instead of `heatmap_argmax_decode` +
      `heatmap_moments`; heatmap decode only, ignored for SimCC.
    - ``use_fused_stage1``: run HRNet's stage 1 through the Bottleneck
      kernel (`ops.make_fused_stage1`).  A `SwinPose` picks its kernels
      itself (``use_pallas_attention``).  ``use_pallas_stage1`` is its JAX
      name; giving both with different values raises ``ValueError``.
    - ``flip_test``: flip-TTA: the mirrored crops through the model again,
      their heatmaps mirrored back, left/right joints swapped (the
      ``connectivity_type`` swap table), shifted one heatmap pixel right
      when ``flip_shift``, and averaged with the direct ones; for SimCC the
      two softmaxes are averaged (x bins reversed, joints swapped, no
      shift) and decoded as ``log(p + 1e-12)``.
    - ``decode_mode``: "default" (argmax + ±0.25 shift) or "dark"
      (`ops.heatmap_dark_decode`); applies to the unfused decode only, as in
      the JAX package: with ``use_fused_decode`` the kernel decodes.
    """

    def __init__(self, model, input_size=(192, 256), decode: str = "heatmap",
                 heatmap_threshold: float = 0.01, bbox_padding: float = 1.25,
                 use_fused_decode: bool = False, use_fused_stage1: bool | None = None,
                 flip_test: bool = False, flip_shift: bool = True, decode_mode: str = "default",
                 connectivity_type: str = "coco", device="cuda",
                 use_pallas_stage1: bool | None = None):
        if (use_fused_stage1 is not None and use_pallas_stage1 is not None
                and bool(use_fused_stage1) != bool(use_pallas_stage1)):
            raise ValueError(f"use_fused_stage1={use_fused_stage1} and its JAX name "
                             f"use_pallas_stage1={use_pallas_stage1} disagree")
        if use_fused_stage1 is None:
            use_fused_stage1 = bool(use_pallas_stage1)
        if decode not in ("heatmap", "simcc"):
            raise ValueError(f"unknown decode '{decode}'")
        if decode_mode not in ("default", "dark"):
            raise ValueError(f"unknown decode_mode '{decode_mode}'")
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.family = ("swin" if isinstance(model, SwinPose)
                       else "rtmpose" if isinstance(model, RTMPose) else "hrnet")
        self.input_size = tuple(input_size)
        self.decode = decode
        self.heatmap_threshold = float(heatmap_threshold)
        self.bbox_padding = float(bbox_padding)
        self.use_fused_decode = bool(use_fused_decode) and decode == "heatmap"
        self.flip_shift = bool(flip_shift)
        self.decode_mode = decode_mode
        self.flip_perm = None  # the joint permutation when flip-TTA is on
        if flip_test:
            from ..training.augment import flip_permutation

            perm = flip_permutation(connectivity_type)
            n_joints = getattr(model, "num_joints", None)
            if n_joints is not None and n_joints != len(perm):
                raise ValueError(f"flip_test needs the '{connectivity_type}' swap table "
                                 f"({len(perm)} joints) to match the model ({n_joints} joints)")
            self.flip_perm = torch.as_tensor(perm, device=self.device)
        self.fused_stage1 = None
        if use_fused_stage1:
            if self.family != "hrnet":
                raise ValueError("use_fused_stage1 applies to HRNet only")
            from ..ops.bottleneck import make_fused_stage1

            self.fused_stage1 = make_fused_stage1(self.model)

    @torch.inference_mode()
    def predict_batch(self, frames, bboxes=None):
        """frames (B, H, W, 3) uint8 or float, bboxes (B, 4) or None (full
        frame) -> {"keypoints" (B, K, 3), "gaussians" (B, K, 6)}."""
        frames = torch.as_tensor(frames, device=self.device)
        if frames.dtype == torch.uint8:
            frames = frames.float() / 255.0
        B, H, W = frames.shape[:3]
        if bboxes is None:
            bboxes = torch.tensor([0.0, 0.0, float(W), float(H)], device=self.device).expand(B, 4)
        bboxes = torch.as_tensor(bboxes, dtype=torch.float32, device=self.device)
        return _predict(self, frames, bboxes)


def _predict(est: TopDownEstimator, frames: torch.Tensor, bboxes: torch.Tensor) -> dict:
    in_w, in_h = est.input_size
    crops, scale, offset = preprocess_crops(frames, bboxes, est.input_size, est.bbox_padding)
    if est.decode == "simcc":
        return _predict_simcc(est, crops, scale, offset)
    heat = _heatmaps(est, crops)  # (B, K, h, w) f32
    if est.flip_perm is not None:
        # Flip-TTA: the mirrored crops, their maps mirrored back (torch.flip:
        # torch has no negative-step slice) with left/right joints swapped.
        heat_f = _heatmaps(est, torch.flip(crops, dims=[2]))
        heat_f = torch.flip(heat_f, dims=[-1])[:, est.flip_perm]
        if est.flip_shift:
            # The mirrored peak lands (s-1)/s heatmap px left of the truth
            # under the x = h·stride decode; one pixel right is the best
            # integer correction.
            heat_f = torch.cat([heat_f[..., :1], heat_f[..., :-1]], dim=-1)
        heat = 0.5 * (heat + heat_f)
    if est.use_fused_decode:
        moments, xy_hm, score = fused_heatmap_decode(heat, threshold=est.heatmap_threshold)
    else:
        if est.decode_mode == "dark":
            xy_hm, score = heatmap_dark_decode(heat)
        else:
            xy_hm, score = heatmap_argmax_decode(heat)
        moments = heatmap_moments(heat, threshold=est.heatmap_threshold)
    stride = in_h / heat.shape[-2]
    return _pushforward(xy_hm * stride, score, moments[..., :2] * stride,
                        moments[..., 2:] * stride * stride, scale, offset)


def _predict_simcc(est: TopDownEstimator, crops: torch.Tensor, scale, offset) -> dict:
    """RTMPose's logits -> SimCC decode -> image pixels, with its diagonal
    covariance: SimCC's two axes are independent classifiers, so the
    per-axis softmax variances (bins², /split_ratio² = 4 to crop px²) are
    the full second moments and the cross term is 0."""
    simcc_x, simcc_y = est.model(crops.permute(0, 3, 1, 2))
    if est.flip_perm is not None:
        # Average the mirrored pass in probability space: softmaxes are not
        # logit-additive, and softmax(log p) = p re-enters the decode.
        fx, fy = est.model(torch.flip(crops, dims=[2]).permute(0, 3, 1, 2))
        px = 0.5 * (torch.softmax(simcc_x, -1)
                    + torch.flip(torch.softmax(fx, -1)[:, est.flip_perm], dims=[-1]))
        py = 0.5 * (torch.softmax(simcc_y, -1) + torch.softmax(fy, -1)[:, est.flip_perm])
        simcc_x, simcc_y = torch.log(px + 1e-12), torch.log(py + 1e-12)
    xy_crop, score = simcc_decode(simcc_x, simcc_y)
    var_x = _simcc_axis_var(simcc_x) / 4.0  # split_ratio²
    var_y = _simcc_axis_var(simcc_y) / 4.0
    zeros = torch.zeros_like(var_x)
    return _pushforward(xy_crop, score, xy_crop, torch.stack([var_x, zeros, zeros, var_y], -1),
                        scale, offset)


def _simcc_axis_var(logits: torch.Tensor) -> torch.Tensor:
    """Variance of the per-axis softmax distribution, in bins²."""
    prob = torch.softmax(logits, dim=-1)
    coords = torch.arange(logits.shape[-1], dtype=prob.dtype, device=prob.device)
    mean = (prob * coords).sum(-1)
    return (prob * (coords - mean[..., None]) ** 2).sum(-1)


def _heatmaps(est: TopDownEstimator, crops: torch.Tensor) -> torch.Tensor:
    """The model on crops (B, in_h, in_w, 3) -> heatmaps (B, K, h, w)."""
    if est.family == "swin":
        return est.model(crops)  # SwinPose takes NHWC crops
    # (B, in_h, in_w, 3) viewed as NCHW is channels_last: no copy.
    return est.model(crops.permute(0, 3, 1, 2), fused_stage1=est.fused_stage1)


def _pushforward(xy_crop, score, mean_crop, cov_crop, scale, offset) -> dict:
    """Crop-pixel keypoints, means and covariances (var_x, cov, cov, var_y)
    -> image pixels through the crop's inverse affine."""
    inv_scale = 1.0 / scale
    xy_img = xy_crop * inv_scale[:, None, :] + offset[:, None, :]
    mean_img = mean_crop * inv_scale[:, None, :] + offset[:, None, :]
    sx = inv_scale[:, 0][:, None]
    sy = inv_scale[:, 1][:, None]
    var_x = cov_crop[..., 0] * sx * sx
    cov_xy = cov_crop[..., 1] * sx * sy
    var_y = cov_crop[..., 3] * sy * sy
    gaussians = torch.stack([mean_img[..., 0], mean_img[..., 1], var_x, cov_xy, cov_xy, var_y],
                            dim=-1)
    keypoints = torch.cat([xy_img, score[..., None]], dim=-1)
    return {"keypoints": keypoints, "gaussians": gaussians}
