"""The top-down crop: box fit, antialiased linear resample and ImageNet
normalize, as one CUDA kernel.

`crop_frames` reproduces ``jax.image.scale_and_translate(method="linear")``,
which antialiases when it downscales: per box, a (out, in) triangle-kernel
weight matrix per axis, widened by 1/scale when scale < 1, renormalised per
output sample and zero where the sample falls outside the image, applied as
two batched matmuls.  ``F.interpolate`` and ``grid_sample`` do not compute
this.  The weights come from f32 scale and offset; only the pixel data
follows the frames' dtype.  `crop_and_normalize` adds the box fit and the
normalize in the frames' dtype: the plain form.

The kernel (``csrc/crop_resample.cu``) computes the same function from each
output's few non-zero taps in one pass: f32 weights and sums, one rounding
to the frames' dtype after the normalize (the plain form rounds the weights,
the rows between the axes and the normalize's two steps).  Its box fit
rounds as the CPU's torch does, so card and CPU give the same scale and
offset.  Its reference is the plain form computed in f32 and rounded once.
`crop_resample` launches the kernel for a CUDA tensor (or raises) and runs
`crop_and_normalize` for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _native
from .device_tables import device_table

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "center_scale_from_bbox", "crop_and_normalize",
           "crop_frames", "crop_resample", "full_frame_boxes"]

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


def _full_frame(width: int, height: int) -> np.ndarray:
    return np.array([0.0, 0.0, width, height])


def full_frame_boxes(shape, height: int, width: int, device) -> torch.Tensor:
    """The f32 box (0, 0, width, height) expanded to ``(*shape, 4)``: made
    once per device and frame size (`device_table`), so no call copies it
    from the host or waits on the card.  A read-only view."""
    box = device_table(_full_frame, int(width), int(height), device=device, dtype=torch.float32)
    return box.expand(*shape, 4)


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


def crop_and_normalize(frames, bboxes, input_size, bbox_padding: float = 1.25):
    """The plain form: aspect-fitted padded crop, linear resample and
    ImageNet normalization in ``frames.dtype``.  Returns (crops (B, in_h,
    in_w, 3), scale, offset)."""
    in_w, in_h = input_size
    center, size = center_scale_from_bbox(bboxes, in_w / in_h, bbox_padding)
    crops, scale, offset = crop_frames(frames, center, size, (in_h, in_w))
    mean = torch.as_tensor(IMAGENET_MEAN, device=crops.device).to(crops.dtype)
    std = torch.as_tensor(IMAGENET_STD, device=crops.device).to(crops.dtype)
    return (crops - mean) / std, scale, offset


def _launch(frames: torch.Tensor, bboxes: torch.Tensor, input_size, bbox_padding: float):
    if frames.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the crop kernel takes bf16 or f32 frames, got {frames.dtype}")
    if bboxes.dtype != torch.float32:
        raise TypeError(f"the crop kernel takes f32 boxes, got {bboxes.dtype}")
    if frames.dim() != 4 or frames.shape[-1] != 3 or bboxes.shape != (frames.shape[0], 4):
        raise ValueError(f"the crop kernel takes frames (B, H, W, 3) and boxes (B, 4), got "
                         f"{tuple(frames.shape)} and {tuple(bboxes.shape)}")
    if bboxes.device != frames.device:
        raise ValueError(f"boxes on {bboxes.device}, frames on {frames.device}")
    frames, bboxes = frames.contiguous(), bboxes.contiguous()
    B, H, W, _ = frames.shape
    in_w, in_h = input_size
    lib = _native.library("crop_resample")
    fn = lib.mc3d_crop_resample
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((B, in_h, in_w, 3), dtype=frames.dtype, device=frames.device)
    scale = torch.empty((B, 2), dtype=torch.float32, device=frames.device)
    offset = torch.empty((B, 2), dtype=torch.float32, device=frames.device)
    vec_ok = frames.data_ptr() % 16 == 0 and (W * 3 * frames.element_size()) % 16 == 0
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream(frames.device).cuda_stream
        rc = fn(frames.data_ptr(), bboxes.data_ptr(), out.data_ptr(), scale.data_ptr(),
                offset.data_ptr(), B, H, W, in_h, in_w, float(bbox_padding), in_w / in_h,
                int(frames.dtype == torch.bfloat16), int(vec_ok), stream)
    _native.check(rc, "mc3d_crop_resample")
    crop_resample.launches += 1
    return out, scale, offset


def crop_resample(frames, bboxes, input_size, bbox_padding: float = 1.25):
    """Crops (B, in_h, in_w, 3) in ``frames.dtype``, scale (B, 2) and offset
    (B, 2) of frames (B, H, W, 3) and boxes (B, 4); ``input_size`` is (w, h).

    A CUDA tensor launches the crop kernel (bf16 or f32 frames, f32 boxes;
    else it raises); a CPU tensor runs `crop_and_normalize`.  Refuses
    autograd (`_native.refuse_autograd`).
    """
    _native.refuse_autograd("crop kernel (crop_resample)", frames, bboxes)
    if frames.device.type == "cuda":
        return _launch(frames, bboxes, input_size, bbox_padding)
    if frames.device.type != "cpu":
        raise ValueError(f"unsupported device {frames.device}")
    return crop_and_normalize(frames, bboxes, input_size, bbox_padding)


crop_resample.launches = 0
