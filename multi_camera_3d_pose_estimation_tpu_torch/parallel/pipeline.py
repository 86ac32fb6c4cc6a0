"""Multi-camera block pipeline: detection, 2D top-down inference + DLT, one device.

Counterpart of the JAX package's ``parallel/pipeline.py::ShardedPosePipeline``
and ``_pipeline_fn`` without a mesh: a (T, C, H, W, 3) frame block goes
through the person detector (optional), crop, the 2D model and decode as one
batch of T·C crops, joints under the confidence threshold become NaN, and
each joint is triangulated from its best two views (``triangulation="top2"``)
or from all finite views by the robust n-view solve (``"nview"``).  Outputs
keep the reference's wire layouts: kpts_2d (T, K, 3, C), heatmaps_2d (T, C,
K, 6), kpts_3d (T, K, 3).
"""

from __future__ import annotations

import torch

from ..models.detector import clip_boxes, decode_top1, decode_topk, select_consistent_boxes
from ..models.topdown import _predict
from ..ops.triangulation import triangulate_nview, triangulate_top2

__all__ = ["ShardedPosePipeline"]


class ShardedPosePipeline:
    """2D + 3D estimation of frame blocks on one device.

    - ``estimator``: a `models.TopDownEstimator`.
    - ``cam_stack``: {"K" (C,3,3), "R" (C,3,3), "T" (C,3), "dist" (C,5)}.
    - ``mesh``: must be None (multi-device runs are not ported yet).
    - ``detector``: a `models.SinglePersonDetector` (or None).  With a model,
      ``run(frames)`` detects on the bf16 [0, 1] full frames (no ImageNet
      normalisation) and crops to its box, top-1 or by consistent selection
      (its ``select``), where the score passes its ``bbox_thr``; elsewhere
      the full frame.  ``run(frames, bboxes)`` with boxes skips it.
    - ``triangulation``: "top2" (the reference's best two views) or "nview"
      (`ops.triangulate_nview`).
    """

    def __init__(self, estimator, cam_stack: dict, mesh=None, conf_threshold: float = 0.3,
                 detector=None, triangulation: str = "top2", device="cuda"):
        if mesh is not None:
            raise NotImplementedError("the port runs the block pipeline on one device only")
        if triangulation not in ("top2", "nview"):
            raise ValueError(f"unknown triangulation '{triangulation}'")
        self.triangulation = triangulation
        self.device = torch.device(device)
        for part in (estimator, detector):
            if part is not None and part.device != self.device:
                raise ValueError(f"{type(part).__name__} is on {part.device}, "
                                 f"pipeline on {self.device}")
        self.estimator = estimator
        self.detector = detector
        self.conf_threshold = float(conf_threshold)
        self.cam_stack = {k: torch.as_tensor(v, dtype=torch.float32, device=self.device)
                          for k, v in cam_stack.items()}

    @property
    def has_detector(self) -> bool:
        return self.detector is not None and self.detector.model is not None

    @torch.inference_mode()
    def run(self, frames, bboxes=None) -> dict:
        """frames (T, C, H, W, 3) uint8 or float, bboxes (T, C, 4) or None."""
        frames = torch.as_tensor(frames, device=self.device)
        T, C, H, W = frames.shape[:4]
        use_detector = bboxes is None and self.has_detector
        if bboxes is None:
            bboxes = torch.tensor([0.0, 0.0, float(W), float(H)],
                                  device=self.device).expand(T, C, 4)
        bboxes = torch.as_tensor(bboxes, dtype=torch.float32, device=self.device)
        frames = _pixels(frames)
        if use_detector:
            bboxes = _detect_boxes(self.detector, frames, bboxes, self.cam_stack)[0]
        return _pipeline_fn(self.estimator, self.conf_threshold, self.triangulation, frames,
                            bboxes, self.cam_stack)

    @torch.inference_mode()
    def detect(self, frames) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The boxes ``run(frames)`` crops to: (boxes (T, C, 4), the selected
        candidate's score (T, C), kept (T, C): score > ``bbox_thr``, else the
        full frame).  Needs a detector with a model."""
        frames = _pixels(torch.as_tensor(frames, device=self.device))
        T, C, H, W = frames.shape[:4]
        full = torch.tensor([0.0, 0.0, float(W), float(H)], device=self.device).expand(T, C, 4)
        return _detect_boxes(self.detector, frames, full, self.cam_stack)


def _pixels(frames: torch.Tensor) -> torch.Tensor:
    """bf16 [0, 1] frames: the pixel path's compute dtype (cast, detector,
    crop resample, normalize); boxes, decode and triangulation stay f32."""
    if frames.dtype == torch.uint8:
        return frames.to(torch.bfloat16) / 255.0
    if frames.dtype == torch.float32:
        return frames.to(torch.bfloat16)
    return frames


def _detect_boxes(det, frames: torch.Tensor, bboxes: torch.Tensor, cam: dict):
    """The detector on the bf16 frames (T, C, H, W, 3): the selected boxes
    clipped to the frame where their score passes ``det.bbox_thr``, else
    ``bboxes``; returns (boxes (T, C, 4), score (T, C), kept (T, C))."""
    T, C, H, W, _ = frames.shape
    out = det.model(frames.reshape(T * C, H, W, 3).permute(0, 3, 1, 2))
    if det.select == "consistent":
        # The top-k candidates, clipped, then re-picked by cross-view and
        # temporal consistency of the subject's 3-D centre.
        boxes_k, scores_k = decode_topk(out, k=det.topk)
        boxes, score = select_consistent_boxes(
            clip_boxes(boxes_k, W, H).reshape(T, C, det.topk, 4),
            scores_k.reshape(T, C, det.topk), cam, det_thr=det.bbox_thr, frame_wh=(W, H),
            window=det.select_window, lam=det.select_lam)
    else:
        boxes, score = decode_top1(out)
        boxes, score = clip_boxes(boxes, W, H).reshape(T, C, 4), score.reshape(T, C)
    keep = score > det.bbox_thr
    return torch.where(keep[..., None], boxes, bboxes), score, keep


def _pipeline_fn(est, conf_thr: float, triangulation: str, frames: torch.Tensor,
                 bboxes: torch.Tensor, cam: dict) -> dict:
    T, C, H, W, _ = frames.shape
    out = _predict(est, frames.reshape(T * C, H, W, 3), bboxes.reshape(T * C, 4))
    kpts = out["keypoints"].reshape(T, C, -1, 3)
    gauss = out["gaussians"].reshape(T, C, -1, 6)

    conf = kpts[..., 2]  # (T, C, K)
    # Low-confidence joints -> NaN, the pipeline's missing-data mechanism.
    xy = torch.where(conf[..., None] > conf_thr, kpts[..., :2],
                     torch.full_like(kpts[..., :2], float("nan")))
    xy_jc = xy.transpose(1, 2)  # (T, K, C, 2)
    conf_jc = conf.transpose(1, 2)  # (T, K, C)
    tri = triangulate_nview if triangulation == "nview" else triangulate_top2
    kpts_3d = tri(xy_jc, conf_jc, cam["K"], cam["dist"], cam["R"], cam["T"])
    kpts_2d = torch.cat([xy_jc, conf_jc[..., None]], dim=-1).transpose(-1, -2)  # (T, K, 3, C)
    return {"kpts_2d": kpts_2d, "heatmaps_2d": gauss, "kpts_3d": kpts_3d}
