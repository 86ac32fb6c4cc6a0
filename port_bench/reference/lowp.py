"""Rounding for the benchmark's control: the reference computed one step
below the precision that the configuration states for each stage.

The configurations state bf16 for the pixel path and the 2D model and f32
for the decode and the triangulation.  The control rounds the operands of
each product of a bf16 stage to float8 e4m3 with one scale per tensor (the
fp8 GEMM a later change might be tempted by) and the inputs and outputs of
each f32 stage to bf16.  ``None`` leaves a tensor in float32.
``MODEL_CONTROL`` rounds the 2D model's stages alone (fp8 products, decode
and triangulation in float32): the fp8 model a later change might serve
behind the float32 decode, judged by its keypoints' positions on the maps.
"""

from __future__ import annotations

import torch

__all__ = ["fp8", "bf16", "Rounding", "EXACT", "CONTROL", "MODEL_CONTROL"]

_E4M3_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one per-tensor scale (its largest
    magnitude maps to e4m3's largest finite value), returned in x's dtype."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / _E4M3_MAX, torch.ones_like(amax))
    q = (x.float() / scale).to(torch.float8_e4m3fn).float() * scale
    return q.to(x.dtype)


def bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16, returned in x's dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


class Rounding:
    """Which rounding each stage's operands take: ``model`` for the crop
    resample and the 2D model's products, ``host`` for the decode and the
    triangulation (each a function or None)."""

    def __init__(self, model=None, host=None):
        self._model, self._host = model, host

    def model(self, x: torch.Tensor) -> torch.Tensor:
        return x if self._model is None else self._model(x)

    def host(self, x: torch.Tensor) -> torch.Tensor:
        return x if self._host is None else self._host(x)

    @property
    def exact(self) -> bool:
        return self._model is None and self._host is None


EXACT = Rounding()
CONTROL = Rounding(model=fp8, host=bf16)
MODEL_CONTROL = Rounding(model=fp8)
