"""Build the headline block pipeline: HRNet 2D + top-2 DLT 3D over a
synthetic camera rig.

Counterpart of the JAX repo's ``__graft_entry__._build_pipeline`` (HRNet
family, no detector, one device).  The rig is the same: C cameras with
f = 600 px at the frame centre, yawed from -20 to +20 degrees, translated
(40·c − 20, 0, 10·c), no distortion.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .models.convert import load_hrnet_from_flax
from .models.hrnet import HRNet
from .models.topdown import TopDownEstimator
from .parallel.pipeline import ShardedPosePipeline

__all__ = ["build_pipeline", "synthetic_rig", "init_hrnet_"]


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


@torch.no_grad()
def init_hrnet_(model: HRNet, generator: torch.Generator) -> HRNet:
    """Random weights from ``generator``, drawn on the CPU: convs
    N(0, 1/fan_in) (flax's LeCun scale), BatchNorm at identity, zero head bias."""
    for name, p in model.named_parameters():
        if p.dim() == 4:
            fan_in = p.shape[1] * p.shape[2] * p.shape[3]
            w = torch.randn(p.shape, generator=generator) / math.sqrt(fan_in)
            p.copy_(w.to(p.device))
        elif name.endswith("BatchNorm_0.weight"):
            p.fill_(1.0)
        else:
            p.zero_()
    for name, b in model.named_buffers():
        if name.endswith("running_var"):
            b.fill_(1.0)
        else:
            b.zero_()
    return model


def build_pipeline(cfg, input_size, frames_shape, device="cuda", variables=None,
                   seed: int = 0) -> ShardedPosePipeline:
    """The C-camera HRNet 2D+3D block pipeline on ``device``, bf16, with the
    stage-1 Bottleneck and heatmap decode kernels on (as on the accelerator).

    - ``cfg``: `models.hrnet.HRNET_W32`-style config; ``input_size`` (w, h).
    - ``frames_shape``: (T, C, H, W, 3) of the blocks it will run.
    - ``variables``: a flax HRNet ``{"params", "batch_stats"}`` tree of numpy
      arrays; None draws random weights from ``torch.Generator`` seed ``seed``.
    """
    T, C, H, W, _ = frames_shape
    model = HRNet(num_joints=17, cfg=cfg, device=device)
    if variables is None:
        init_hrnet_(model, torch.Generator().manual_seed(seed))
    else:
        load_hrnet_from_flax(model, variables)
    est = TopDownEstimator(model, input_size=input_size, use_fused_decode=True,
                           use_fused_stage1=True, device=device)
    return ShardedPosePipeline(est, synthetic_rig(C, H, W), device=device)
