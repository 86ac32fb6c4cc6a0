"""Build the block pipeline: a person detector (optional), HRNet, Swin or
RTMPose 2D (optionally with flip-TTA) + top-2 or n-view DLT 3D over a
synthetic camera rig.

Counterpart of the JAX repo's ``__graft_entry__._build_pipeline`` (one device).  The rig is the same: C cameras
with f = 600 px at the frame centre, yawed from -20 to +20 degrees,
translated (40·c − 20, 0, 10·c), no distortion.
"""

from __future__ import annotations

import numpy as np

from .models.detector import SinglePersonDetector
from .models.registry import build_detector, build_model
from .models.topdown import TopDownEstimator
from .parallel.pipeline import ShardedPosePipeline

__all__ = ["build_pipeline", "synthetic_rig"]


def synthetic_rig(n_cams: int, H: int, W: int) -> dict:
    """Stacked camera parameters {"K", "R", "T", "dist"} (f32 numpy)."""
    Ks = np.tile(np.array([[600.0, 0, W / 2], [0, 600.0, H / 2], [0, 0, 1]]), (n_cams, 1, 1))
    Rs, Ts = [], []
    for c in range(n_cams):
        th = np.deg2rad(-20.0 + 40.0 * c / max(n_cams - 1, 1))
        Rs.append(np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                            [-np.sin(th), 0, np.cos(th)]]))
        Ts.append(np.array([40.0 * c - 20.0, 0.0, 10.0 * c]))
    return {"K": np.asarray(Ks, np.float32), "R": np.asarray(Rs, np.float32),
            "T": np.asarray(Ts, np.float32), "dist": np.zeros((n_cams, 5), np.float32)}


def build_pipeline(cfg, input_size, frames_shape, device="cuda", variables=None,
                   seed: int = 0, family: str = "hrnet", triangulation: str = "top2",
                   flip_test: bool = False, flip_shift: bool = True,
                   decode_mode: str = "default", connectivity_type: str = "coco",
                   detector=None, detector_select: str = "top1") -> ShardedPosePipeline:
    """The C-camera 2D+3D block pipeline on ``device``, bf16, so with the
    kernels of its model and decode (`models.batchnorm.runs_kernels`):
    HRNet's stage-1 Bottleneck, or, for ``family="swin"``, the
    whole-SwinBlock kernels, and the heatmap decode; ``family="rtmpose"``
    (SimCC decode) reaches only the crop and ConvBN epilogue kernels.
    ``triangulation``, ``flip_test``, ``flip_shift``, ``decode_mode`` and
    ``connectivity_type``: as in `ShardedPosePipeline` and
    `TopDownEstimator`.

    - ``cfg``: `models.hrnet.HRNET_W32`, `models.swin.SWIN_B` or
      `models.rtmpose.RTMPOSE_T`-style config; ``input_size`` (w, h).
    - ``frames_shape``: (T, C, H, W, 3) of the blocks it will run.
    - ``variables``: a flax ``{"params", "batch_stats"}`` tree of numpy
      arrays; None draws random weights from ``torch.Generator`` seed ``seed``.
    - ``detector``: a `models.registry.DETECTOR_REGISTRY` name (random
      weights from seed ``seed``, selection ``detector_select``: "top1" or
      "consistent") or a ready `models.SinglePersonDetector`; None runs on
      the full frame.
    """
    T, C, H, W, _ = frames_shape
    model = build_model(family, cfg, device, variables, seed, input_size)
    est = TopDownEstimator(model, input_size=input_size,
                           decode="simcc" if family == "rtmpose" else "heatmap",
                           flip_test=flip_test, flip_shift=flip_shift, decode_mode=decode_mode,
                           connectivity_type=connectivity_type, device=device)
    if isinstance(detector, str):
        detector = build_detector(detector, device=device, seed=seed, select=detector_select)
    elif detector is not None and not isinstance(detector, SinglePersonDetector):
        raise TypeError(f"detector must be a registry name or a SinglePersonDetector, "
                        f"not {type(detector).__name__}")
    return ShardedPosePipeline(est, synthetic_rig(C, H, W), detector=detector,
                               triangulation=triangulation, device=device)
