"""The plain reference the benchmark judges the program by: float32 PyTorch
(float64 for the geometry), with TF32 off while it runs, written from the
published descriptions (MMPose's HRNet and Swin pose models, the
antialiased linear crop, the heatmap decode, OpenCV's distortion model and
the DLT).  It imports nothing of the program and takes nothing the program
made: it gets the seeded state dict and the rig arrays the benchmark wrote
for both sides, and recomputes the rest.
"""

from __future__ import annotations

import contextlib

import torch

from .hrnet import HRNetRef
from .lowp import CONTROL, EXACT, MODEL_CONTROL, Rounding
from .swin import SwinRef

__all__ = ["build_model", "no_tf32", "EXACT", "CONTROL", "MODEL_CONTROL", "Rounding",
           "HEAD_KEY"]

_FAMILIES = {"hrnet": HRNetRef, "swin": SwinRef}


def build_model(cfg: dict, device="cpu", rounding: Rounding = EXACT) -> torch.nn.Module:
    """The reference model of configuration ``cfg`` (float32, eval mode) on
    ``device`` ("meta" for names and shapes only), its products rounded by
    ``rounding``."""
    with torch.device(device):
        model = _FAMILIES[cfg["family"]](cfg, cfg["num_joints"])
    for m in model.modules():
        if hasattr(type(m), "rounding") or hasattr(m, "rounding"):
            m.rounding = rounding
    return model.eval()


# The state-dict key of the final 1x1 conv's kernel, in both families.
HEAD_KEY = "head.final_layer.weight"


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
