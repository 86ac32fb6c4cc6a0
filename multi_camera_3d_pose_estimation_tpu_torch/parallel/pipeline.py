"""Multi-camera block pipeline: 2D top-down inference + DLT, one device.

Counterpart of the JAX package's ``parallel/pipeline.py::ShardedPosePipeline``
and ``_pipeline_fn`` without a detector and without a mesh: a (T, C, H, W, 3)
frame block goes through crop, the 2D model and decode as one batch of T·C
crops, joints under the confidence threshold become NaN, and each joint is
triangulated from its best two views (``triangulation="top2"``) or from all
finite views by the robust n-view solve (``"nview"``).  Outputs keep the reference's wire layouts:
kpts_2d (T, K, 3, C), heatmaps_2d (T, C, K, 6), kpts_3d (T, K, 3).
"""

from __future__ import annotations

import torch

from ..models.topdown import _predict
from ..ops.triangulation import triangulate_nview, triangulate_top2

__all__ = ["ShardedPosePipeline"]


class ShardedPosePipeline:
    """2D + 3D estimation of frame blocks on one device.

    - ``estimator``: a `models.TopDownEstimator`.
    - ``cam_stack``: {"K" (C,3,3), "R" (C,3,3), "T" (C,3), "dist" (C,5)}.
    - ``mesh``: must be None (multi-device runs are not ported yet).
    - ``triangulation``: "top2" (the reference's best two views) or "nview"
      (`ops.triangulate_nview`).
    """

    def __init__(self, estimator, cam_stack: dict, mesh=None, conf_threshold: float = 0.3,
                 triangulation: str = "top2", device="cuda"):
        if mesh is not None:
            raise NotImplementedError("the port runs the block pipeline on one device only")
        if triangulation not in ("top2", "nview"):
            raise ValueError(f"unknown triangulation '{triangulation}'")
        self.triangulation = triangulation
        self.device = torch.device(device)
        if estimator.device != self.device:
            raise ValueError(f"estimator is on {estimator.device}, pipeline on {self.device}")
        self.estimator = estimator
        self.conf_threshold = float(conf_threshold)
        self.cam_stack = {k: torch.as_tensor(v, dtype=torch.float32, device=self.device)
                          for k, v in cam_stack.items()}

    @torch.inference_mode()
    def run(self, frames, bboxes=None) -> dict:
        """frames (T, C, H, W, 3) uint8 or float, bboxes (T, C, 4) or None."""
        frames = torch.as_tensor(frames, device=self.device)
        T, C, H, W = frames.shape[:4]
        if bboxes is None:
            bboxes = torch.tensor([0.0, 0.0, float(W), float(H)],
                                  device=self.device).expand(T, C, 4)
        bboxes = torch.as_tensor(bboxes, dtype=torch.float32, device=self.device)
        return _pipeline_fn(self.estimator, self.conf_threshold, self.triangulation, frames,
                            bboxes, self.cam_stack)


def _pipeline_fn(est, conf_thr: float, triangulation: str, frames: torch.Tensor,
                 bboxes: torch.Tensor, cam: dict) -> dict:
    T, C, H, W, _ = frames.shape
    # bf16 is the pixel path's compute dtype (cast, crop resample, normalize);
    # boxes, decode and triangulation stay f32.
    if frames.dtype == torch.uint8:
        frames = frames.to(torch.bfloat16) / 255.0
    elif frames.dtype == torch.float32:
        frames = frames.to(torch.bfloat16)
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
