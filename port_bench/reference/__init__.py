"""The plain reference the benchmark judges the program by: float32 PyTorch
(float64 for the geometry), with TF32 off while it runs, written from the
published descriptions: one module a model family (``<family>.py``, found
by a configuration's ``family``; see `port_bench.catalog`), one a pipeline
of the reference's block and its judge (``pipelines/<name>.py``), and the
stages they share (the antialiased linear crop, the heatmap decode,
OpenCV's distortion model and the DLT).  It imports nothing of the program
and takes nothing the program made: it gets the seeded state dicts and the
rig arrays the benchmark wrote for both sides, and recomputes the rest.
"""

from __future__ import annotations

import contextlib
import os

import torch

from ..catalog import find_family
from .lowp import CONTROL, EXACT, MODEL_CONTROL, Rounding

__all__ = ["build_model", "no_tf32", "EXACT", "CONTROL", "MODEL_CONTROL", "Rounding"]

# The checkout that holds this package.
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_model(cfg: dict, device="cpu", rounding: Rounding = EXACT,
                root: str = _ROOT) -> torch.nn.Module:
    """The reference model of configuration ``cfg`` (a pose configuration,
    or its ``detector``): ``MODEL(cfg)`` of the family module that
    ``cfg["family"]`` names under ``root`` (`catalog.find_family`), float32, in
    eval mode, on ``device`` ("meta" for names and shapes only), its
    products rounded by ``rounding``."""
    family = find_family(root, cfg["family"])
    with torch.device(device):
        model = family.MODEL(cfg)
    for m in model.modules():
        if hasattr(type(m), "rounding") or hasattr(m, "rounding"):
            m.rounding = rounding
    return model.eval()


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
