"""Person detection for the top-down pipeline (torch).

Counterpart of the JAX package's ``models/detector.py``:

- `full_frame_bboxes`: the whole frame as the person box;
- `CenterNetDetector`: the single-class centre-point detector (stride 16:
  centre logits, sizes, offsets);
- `decode_top1` / `decode_topk`: candidates of CenterNet maps or of the
  RTMDet/YOLOX flat set -> the top box, or the top k (CenterNet's after a
  3x3 local-max test), scores as probabilities;
- `select_consistent_boxes`: per frame and camera the candidate most
  consistent with the subject's cross-view, temporally smooth 3-D centre;
- `SinglePersonDetector`: a detector model with its threshold and selection
  policy; ``detect()`` gives per-frame top-1 boxes or the full frame.

Ties break as in JAX: argmax takes the first index; top-k is a stable
descending sort, so equal scores keep index order (``lax.top_k``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.geometry import project_points
from ..ops.triangulation import triangulate_top2
from .batchnorm import BatchNorm, batch_norm

__all__ = ["full_frame_bboxes", "CenterNetDetector", "SinglePersonDetector", "decode_top1",
           "decode_topk", "select_consistent_boxes", "clip_boxes", "nanmedian_dim1", "same_pads"]


def full_frame_bboxes(frames: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> (B, 4) f32 boxes covering the whole frame."""
    B, H, W = frames.shape[:3]
    return torch.tensor([0.0, 0.0, float(W), float(H)], device=frames.device).expand(B, 4)


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA's ``padding="SAME"`` along one axis: (low, high), the extra
    element high (at stride 2: (0, 1) for an even n, (1, 1) for an odd one)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class _ConvBNReLU(nn.Module):
    """3x3 conv (no bias, SAME padding) -> BatchNorm -> ReLU."""

    def __init__(self, cin: int, cout: int, stride: int = 1, dtype=torch.bfloat16):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, cout, 3, stride, bias=False)
        self.BatchNorm_0 = BatchNorm(cout)
        self.stride, self.dtype = stride, dtype

    def forward(self, x):
        ph, pw = (same_pads(n, 3, self.stride) for n in x.shape[-2:])
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        y = F.conv2d(x, self.Conv_0.weight.to(self.dtype), None, self.stride)
        return torch.relu(batch_norm(y, self.BatchNorm_0, self.dtype))


class CenterNetDetector(nn.Module):
    """Single-class centre-point detector on frames (B, 3, H, W) float.

    Returns the stride-16 head maps ``center`` (B, h, w) logits, ``wh``
    (B, h, w, 2) sizes in input px (softplus) and ``offset`` (B, h, w, 2),
    all f32.
    """

    def __init__(self, width: int = 32, dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        self.dtype = dtype
        w = width
        specs = [(3, w, 2), (w, w, 1), (w, 2 * w, 2), (2 * w, 2 * w, 1), (2 * w, 4 * w, 2),
                 (4 * w, 4 * w, 1), (4 * w, 8 * w, 2), (8 * w, 8 * w, 1), (8 * w, 4 * w, 1)]
        for i, (cin, cout, stride) in enumerate(specs):
            self.add_module(f"_ConvBNReLU_{i}", _ConvBNReLU(cin, cout, stride, dtype))
        self.Conv_0 = nn.Conv2d(4 * w, 1, 1)  # centre
        self.Conv_1 = nn.Conv2d(4 * w, 2, 1)  # wh
        self.Conv_2 = nn.Conv2d(4 * w, 2, 1)  # offset
        self.to(device=device, memory_format=torch.channels_last).eval()

    def _head(self, x, conv):
        return F.conv2d(x, conv.weight.to(self.dtype), conv.bias.to(self.dtype)).float()

    def forward(self, x) -> dict:
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        for i in range(9):
            x = getattr(self, f"_ConvBNReLU_{i}")(x)
        wh = self._head(x, self.Conv_1).permute(0, 2, 3, 1)
        return {"center": self._head(x, self.Conv_0)[:, 0],
                "wh": torch.logaddexp(wh, torch.zeros_like(wh)),  # softplus, as jax.nn
                "offset": self._head(x, self.Conv_2).permute(0, 2, 3, 1)}


def _gather_rows(m: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """m (B, N, d), idx (B, k) -> (B, k, d)."""
    return torch.gather(m, 1, idx[..., None].expand(idx.shape + (m.shape[-1],)))


def _centernet_boxes(outputs: dict, idx: torch.Tensor, stride: int) -> torch.Tensor:
    """Boxes (B, k, 4) of CenterNet map cells ``idx`` (B, k)."""
    B, h, w = outputs["center"].shape
    cy = torch.div(idx, w, rounding_mode="floor").float()
    cx = (idx % w).float()
    wh = _gather_rows(outputs["wh"].reshape(B, h * w, 2), idx)
    off = _gather_rows(outputs["offset"].reshape(B, h * w, 2), idx)
    cxy = (torch.stack([cx, cy], dim=-1) + off) * stride
    half = wh * 0.5
    return torch.cat([cxy - half, cxy + half], dim=-1)


def decode_top1(outputs: dict, stride: int = 16) -> tuple[torch.Tensor, torch.Tensor]:
    """Head maps or flat candidates -> top-1 box (B, 4) and score (B,)."""
    if "boxes_all" in outputs:
        scores = outputs["scores_all"]
        idx = torch.argmax(scores, dim=-1)[:, None]
        return _gather_rows(outputs["boxes_all"], idx)[:, 0], torch.gather(scores, 1, idx)[:, 0]
    center = outputs["center"]
    flat = center.reshape(center.shape[0], -1)
    idx = torch.argmax(flat, dim=-1)[:, None]
    score = torch.sigmoid(torch.gather(flat, 1, idx)[:, 0])
    return _centernet_boxes(outputs, idx, stride)[:, 0], score


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: descending, equal values in index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def decode_topk(outputs: dict, k: int, stride: int = 16) -> tuple[torch.Tensor, torch.Tensor]:
    """Head maps -> top-k boxes (B, k, 4) and scores (B, k), sorted.

    CenterNet: 3x3 local-max test (``center >= max of its -inf padded 3x3
    neighbourhood``), then top-k of the peaks, non-peaks at -inf (score 0).
    RTMDet/YOLOX candidates: a plain top-k of the scores.
    """
    if "boxes_all" in outputs:
        vals, idx = _top_k(outputs["scores_all"], k)
        return _gather_rows(outputs["boxes_all"], idx), vals
    center = outputs["center"]
    B = center.shape[0]
    pooled = F.max_pool2d(center[:, None], 3, 1, 1)[:, 0]  # pads with -inf
    peaks = torch.where(center >= pooled, center, torch.full_like(center, -float("inf")))
    vals, idx = _top_k(peaks.reshape(B, -1), k)
    return _centernet_boxes(outputs, idx, stride), torch.sigmoid(vals)


def nanmedian_dim1(x: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmedian(x, axis=1)``: NaN ignored, the mean of the two middle
    values for an even count, NaN where all are NaN (``torch.nanmedian``
    would return the lower middle value)."""
    nan = torch.isnan(x)
    vals = torch.sort(torch.where(nan, torch.full_like(x, float("inf")), x), dim=1).values
    n = (~nan).sum(1, keepdim=True)
    lo = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), min=0)
    hi = torch.clamp(torch.div(n, 2, rounding_mode="floor"), min=0)
    med = (torch.gather(vals, 1, lo) + torch.gather(vals, 1, hi))[:, 0] * 0.5
    return torch.where(n[:, 0] > 0, med, torch.full_like(med, float("nan")))


def select_consistent_boxes(boxes: torch.Tensor, scores: torch.Tensor, cam: dict, *,
                            det_thr: float = 0.3, frame_wh=None, window: int = 9,
                            n_rounds: int = 2, lam: float = 4.0):
    """Per frame and camera, the candidate most consistent with the subject's
    cross-view, temporally smooth 3-D centre.

    ``boxes`` (T, C, k, 4), ``scores`` (T, C, k) from `decode_topk`; ``cam``
    the stacked {"K", "R", "T", "dist"}.  Start from candidate 0 (the top
    score); each round: triangulate the picked centres whose score passes
    ``det_thr`` (top-2 DLT, one point per frame), take the nanmedian over
    ``window`` frames (indices clipped at both ends), project it into each
    camera, and re-pick by ``score - lam · distance / clip(diagonal, 32,
    ½·hypot(W, H))``, the score alone where that is NaN, -1e9 under
    ``det_thr``.  Returns (boxes (T, C, 4), scores (T, C)).
    """
    T, C, k = scores.shape
    dev = scores.device
    centers = (boxes[..., :2] + boxes[..., 2:]) * 0.5  # (T, C, k, 2)
    dwh = boxes[..., 2:] - boxes[..., :2]
    hi = 0.5 * float(np.hypot(frame_wh[0], frame_wh[1])) if frame_wh is not None else float("inf")
    diag = torch.clamp(torch.sqrt((dwh * dwh).sum(-1)), 32.0, hi)  # (T, C, k)
    offs = np.arange(window) - window // 2
    t_idx = torch.as_tensor(np.clip(np.arange(T)[:, None] + offs[None, :], 0, T - 1), device=dev)

    def take(x, pick):  # x (T, C, k, ...) at pick (T, C) -> (T, C, ...)
        idx = pick.reshape(T, C, 1, *([1] * (x.dim() - 3)))
        return torch.gather(x, 2, idx.expand(T, C, 1, *x.shape[3:]))[:, :, 0]

    pick = torch.zeros((T, C), dtype=torch.long, device=dev)
    for _ in range(max(n_rounds, 1)):
        sel_c, sel_s = take(centers, pick), take(scores, pick)
        sel_xy = torch.where(sel_s[..., None] > det_thr, sel_c, torch.full_like(sel_c, float("nan")))
        anchor = triangulate_top2(sel_xy[:, None], sel_s[:, None], cam["K"], cam["dist"],
                                  cam["R"], cam["T"])[:, 0]  # (T, 3)
        smooth = nanmedian_dim1(anchor[t_idx])  # (T, 3)
        proj = torch.stack([project_points(smooth, cam["K"][c], cam["R"][c], cam["T"][c],
                                           cam["dist"][c]) for c in range(C)], dim=1)
        dv = centers - proj[:, :, None, :]
        util = scores - lam * (torch.sqrt((dv * dv).sum(-1)) / diag)
        util = torch.where(torch.isnan(util), scores, util)
        util = torch.where(scores > det_thr, util, torch.full_like(util, -1e9))
        pick = torch.argmax(util, dim=-1)
    return take(boxes, pick), take(scores, pick)


class SinglePersonDetector:
    """A detector model with its threshold and selection policy.

    - ``model``: `CenterNetDetector`, `RTMDet` or `YOLOX` on ``device`` with
      its weights, or None for the full-frame detector.
    - ``bbox_thr``: below it a detection is discarded and the full frame (or
      the caller's box) is used.
    - ``select``: "top1" (the reference's argmax) or "consistent"
      (`decode_topk` with ``topk`` candidates, then
      `select_consistent_boxes` over ``select_window`` frames with
      ``select_lam``); the pipeline applies it, ``detect()`` is per frame and
      always top-1.
    """

    def __init__(self, model=None, bbox_thr: float = 0.3, select: str = "top1", topk: int = 4,
                 select_window: int = 9, select_lam: float = 4.0, device="cuda"):
        if select not in ("top1", "consistent"):
            raise ValueError(f"unknown select mode '{select}'")
        self.device = torch.device(device)
        self.model = model.to(self.device).eval() if model is not None else None
        self.bbox_thr = float(bbox_thr)
        self.select = select
        self.topk = int(topk)
        self.select_window = int(select_window)
        self.select_lam = float(select_lam)

    @torch.inference_mode()
    def detect(self, frames) -> torch.Tensor:
        """frames (B, H, W, 3) uint8 (scaled to [0, 1] in f32) or float ->
        boxes (B, 4): the top-1 box clipped to the frame where its score
        passes ``bbox_thr``, else the full frame."""
        frames = torch.as_tensor(frames, device=self.device)
        if frames.dtype == torch.uint8:
            frames = frames.float() / 255.0
        fallback = full_frame_bboxes(frames)
        if self.model is None:
            return fallback
        boxes, score = decode_top1(self.model(frames.permute(0, 3, 1, 2)))
        H, W = frames.shape[1:3]
        boxes = clip_boxes(boxes, W, H)
        return torch.where((score > self.bbox_thr)[:, None], boxes, fallback)


def clip_boxes(boxes: torch.Tensor, W: int, H: int) -> torch.Tensor:
    """Boxes (..., 4) clipped to [0, W] x [0, H]."""
    lim = torch.tensor([W, H, W, H], dtype=boxes.dtype, device=boxes.device)
    return torch.minimum(torch.clamp(boxes, min=0.0), lim)
