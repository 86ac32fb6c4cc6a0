"""Build the block pipeline: HRNet or Swin 2D + top-2 DLT 3D over a synthetic
camera rig.

Counterpart of the JAX repo's ``__graft_entry__._build_pipeline`` (HRNet and
Swin families, no detector, one device).  The rig is the same: C cameras
with f = 600 px at the frame centre, yawed from -20 to +20 degrees,
translated (40·c − 20, 0, 10·c), no distortion.
"""

from __future__ import annotations

import numpy as np

from .models.registry import build_model
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
                   seed: int = 0, family: str = "hrnet") -> ShardedPosePipeline:
    """The C-camera 2D+3D block pipeline on ``device``, bf16, with the
    kernels on (as on the accelerator): HRNet's stage-1 Bottleneck and the
    heatmap decode, or, for ``family="swin"``, the whole-SwinBlock kernels
    and the heatmap decode.

    - ``cfg``: `models.hrnet.HRNET_W32` or `models.swin.SWIN_B`-style
      config; ``input_size`` (w, h).
    - ``frames_shape``: (T, C, H, W, 3) of the blocks it will run.
    - ``variables``: a flax ``{"params", "batch_stats"}`` tree of numpy
      arrays; None draws random weights from ``torch.Generator`` seed ``seed``.
    """
    T, C, H, W, _ = frames_shape
    model = build_model(family, cfg, device, variables, seed)
    est = TopDownEstimator(model, input_size=input_size, use_fused_decode=True,
                           use_fused_stage1=family == "hrnet", device=device)
    return ShardedPosePipeline(est, synthetic_rig(C, H, W), device=device)
