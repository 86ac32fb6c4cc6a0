"""Top-down 2D pose pipeline: bbox -> crop -> model -> decode -> image space.

Counterpart of the JAX package's ``models/topdown.py``: the heatmap decode
for the HRNet and Swin families (with flip-TTA and the DARK decode) and the
SimCC decode for RTMPose (flip-TTA averages probabilities; a diagonal
covariance from each axis's softmax variance).  Layouts follow the JAX package:
frames (B, H, W, 3), crops (B, in_h, in_w, 3), heatmaps (B, K, h, w),
keypoints (B, K, 3) = (x_px, y_px, score), gaussians (B, K, 6) =
[mean_x, mean_y, var_x, cov_xy, cov_xy, var_y] in image pixels.

The crop (box fit, antialiased resample, normalize) is `ops.crop_resample`:
one CUDA kernel on the card, `crop_frames` + the normalize on the CPU.  The
default heatmap decode is `ops.fused_heatmap_decode`: one CUDA kernel on the
card, its plain form on the CPU.  The models pick their own kernels
(`models.batchnorm.runs_kernels`).
"""

from __future__ import annotations

import torch

from ..ops.crop_resample import (IMAGENET_MEAN, IMAGENET_STD, center_scale_from_bbox,
                                 crop_frames, crop_resample, full_frame_boxes)
from ..ops.fused_decode import fused_heatmap_decode
from ..ops.heatmap_decode import heatmap_dark_decode
from ..ops.moments import heatmap_moments
from ..ops.simcc import simcc_decode
from ..utils.profiling import span
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


def preprocess_crops(frames, bboxes, input_size, bbox_padding: float = 1.25):
    """Aspect-fitted padded crop, linear resample and ImageNet normalization
    in ``frames.dtype`` (`ops.crop_resample`: the crop kernel for frames on
    the card).  Returns (crops (B, in_h, in_w, 3), scale, offset)."""
    return crop_resample(frames, bboxes, input_size, bbox_padding)


class TopDownEstimator:
    """Batched top-down 2D pose estimator.

    - ``model``: the port's `HRNet` or `SwinPose` (``decode="heatmap"``) or
      `RTMPose` (``decode="simcc"``), weights loaded, on ``device``.
    - ``input_size``: (width, height) of the crop fed to the model.
    - ``flip_test``: flip-TTA: the mirrored crops through the model again,
      their heatmaps mirrored back, left/right joints swapped (the
      ``connectivity_type`` swap table), shifted one heatmap pixel right
      when ``flip_shift``, and averaged with the direct ones; for SimCC the
      two softmaxes are averaged (x bins reversed, joints swapped, no
      shift) and decoded as ``log(p + 1e-12)``.
    - ``decode_mode``: "default", argmax + ±0.25 shift and the moments in
      one pass (`ops.fused_heatmap_decode`), or "dark"
      (`ops.heatmap_dark_decode` + `ops.heatmap_moments`).
    """

    def __init__(self, model, input_size=(192, 256), decode: str = "heatmap",
                 heatmap_threshold: float = 0.01, bbox_padding: float = 1.25,
                 flip_test: bool = False, flip_shift: bool = True, decode_mode: str = "default",
                 connectivity_type: str = "coco", device="cuda"):
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

    @torch.inference_mode()
    def predict_batch(self, frames, bboxes=None):
        """frames (B, H, W, 3) uint8 or float, bboxes (B, 4) or None (full
        frame) -> {"keypoints" (B, K, 3), "gaussians" (B, K, 6)}."""
        frames = torch.as_tensor(frames, device=self.device)
        if frames.dtype == torch.uint8:
            frames = frames.float() / 255.0
        B, H, W = frames.shape[:3]
        if bboxes is None:
            bboxes = full_frame_boxes((B,), H, W, self.device)
        bboxes = torch.as_tensor(bboxes, dtype=torch.float32, device=self.device)
        return _predict(self, frames, bboxes)


def _predict(est: TopDownEstimator, frames: torch.Tensor, bboxes: torch.Tensor) -> dict:
    """Crop, model and decode of a batch of frames (B, H, W, 3) to image
    pixels, under the spans ``mc3d.pipeline.crop``, ``mc3d.pipeline.model``
    (with the flip-TTA pass) and ``mc3d.pipeline.decode``
    (`utils.profiling.span`, timed on the card where the frames are)."""
    on_card = frames.is_cuda
    in_w, in_h = est.input_size
    with span("mc3d.pipeline.crop", device=on_card):
        crops, scale, offset = preprocess_crops(frames, bboxes, est.input_size, est.bbox_padding)
    if est.decode == "simcc":
        return _predict_simcc(est, crops, scale, offset)
    with span("mc3d.pipeline.model", device=on_card):
        heat = _heatmaps(est, crops)  # (B, K, h, w) f32
        if est.flip_perm is not None:
            # Flip-TTA: the mirrored crops, their maps mirrored back
            # (torch.flip: torch has no negative-step slice) with left/right
            # joints swapped.
            heat_f = _heatmaps(est, torch.flip(crops, dims=[2]))
            heat_f = torch.flip(heat_f, dims=[-1])[:, est.flip_perm]
            if est.flip_shift:
                # The mirrored peak lands (s-1)/s heatmap px left of the
                # truth under the x = h·stride decode; one pixel right is
                # the best integer correction.
                heat_f = torch.cat([heat_f[..., :1], heat_f[..., :-1]], dim=-1)
            heat = 0.5 * (heat + heat_f)
    with span("mc3d.pipeline.decode", device=on_card):
        if est.decode_mode == "dark":
            xy_hm, score = heatmap_dark_decode(heat)
            moments = heatmap_moments(heat, threshold=est.heatmap_threshold)
        else:
            moments, xy_hm, score = fused_heatmap_decode(heat, threshold=est.heatmap_threshold)
        stride = in_h / heat.shape[-2]
        return _pushforward(xy_hm * stride, score, moments[..., :2] * stride,
                            moments[..., 2:] * stride * stride, scale, offset)


def _predict_simcc(est: TopDownEstimator, crops: torch.Tensor, scale, offset) -> dict:
    """RTMPose's logits -> SimCC decode -> image pixels, with its diagonal
    covariance: SimCC's two axes are independent classifiers, so the
    per-axis softmax variances (bins², /split_ratio² = 4 to crop px²) are
    the full second moments and the cross term is 0."""
    on_card = crops.is_cuda
    with span("mc3d.pipeline.model", device=on_card):
        simcc_x, simcc_y = est.model(crops.permute(0, 3, 1, 2))
        if est.flip_perm is not None:
            # Average the mirrored pass in probability space: softmaxes are
            # not logit-additive, and softmax(log p) = p re-enters the decode.
            fx, fy = est.model(torch.flip(crops, dims=[2]).permute(0, 3, 1, 2))
            px = 0.5 * (torch.softmax(simcc_x, -1)
                        + torch.flip(torch.softmax(fx, -1)[:, est.flip_perm], dims=[-1]))
            py = 0.5 * (torch.softmax(simcc_y, -1) + torch.softmax(fy, -1)[:, est.flip_perm])
            simcc_x, simcc_y = torch.log(px + 1e-12), torch.log(py + 1e-12)
    with span("mc3d.pipeline.decode", device=on_card):
        xy_crop, score = simcc_decode(simcc_x, simcc_y)
        var_x = _simcc_axis_var(simcc_x) / 4.0  # split_ratio²
        var_y = _simcc_axis_var(simcc_y) / 4.0
        zeros = torch.zeros_like(var_x)
        return _pushforward(xy_crop, score, xy_crop,
                            torch.stack([var_x, zeros, zeros, var_y], -1), scale, offset)


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
    return est.model(crops.permute(0, 3, 1, 2))


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
