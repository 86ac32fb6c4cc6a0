"""Single-pass heatmap decode (moments + argmax) as a CUDA kernel.

Counterpart of the JAX package's ``ops/pallas/fused_decode.py``.  The kernel
(``csrc/fused_decode.cu``) reads each map once and returns 12 values per map:
the thresholded raw moments [Σv, Σvx, Σvy, Σvx², Σvxy, Σvy²], the peak, the
first-occurrence argmax and the map at the argmax's 4 clamped neighbours.
`heatmap_decode_raw_plain` computes the same (N, 12) result in plain
PyTorch; the wrapper `heatmap_decode_raw` runs it for a CPU tensor, and only
there.  `fused_heatmap_decode` finishes in plain torch: same thresholding,
zero-sum -> zero moments and quarter-pixel shift as `ops.heatmap_moments` +
`ops.heatmap_argmax_decode`; the moments are centred from raw sums, which
costs up to ~1e-3 absolute on the covariance terms.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _native

__all__ = ["finish_decode", "fused_heatmap_decode", "heatmap_decode_raw",
           "heatmap_decode_raw_plain"]

N_OUT = 12


def heatmap_decode_raw_plain(flat: torch.Tensor, W: int, threshold: float) -> torch.Tensor:
    """The kernel's (N, 12) result for maps ``flat`` (N, H·W) f32, in plain PyTorch."""
    N, HW = flat.shape
    H = HW // W
    lin = torch.arange(HW, device=flat.device)
    xf = (lin % W).to(flat.dtype)
    yf = (lin // W).to(flat.dtype)
    v = torch.where(flat < threshold, torch.zeros_like(flat), flat)
    vx, vy = v * xf, v * yf
    sums = [v.sum(-1), vx.sum(-1), vy.sum(-1), (vx * xf).sum(-1), (vx * yf).sum(-1),
            (vy * yf).sum(-1)]
    peak, amax = flat.max(-1)  # first occurrence of the maximum
    ax, ay = amax % W, amax // W

    def at(yy, xx):
        lin_n = yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)
        return torch.gather(flat, -1, lin_n[:, None])[:, 0]

    cols = sums + [peak, amax.to(flat.dtype), at(ay, ax + 1), at(ay, ax - 1),
                   at(ay + 1, ax), at(ay - 1, ax)]
    return torch.stack(cols, dim=-1)


def _launch(flat: torch.Tensor, W: int, threshold: float) -> torch.Tensor:
    N, HW = flat.shape
    if flat.dtype != torch.float32 or not flat.is_contiguous():
        raise ValueError("the decode kernel takes contiguous f32 maps")
    if HW % 4 or HW % W:
        raise ValueError(f"the decode kernel needs H*W % 4 == 0, got H*W = {HW}, W = {W}")
    lib = _native.library("fused_decode")
    fn = lib.mc3d_heatmap_decode
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((N, N_OUT), dtype=torch.float32, device=flat.device)
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        rc = fn(flat.data_ptr(), out.data_ptr(), N, HW, W, float(threshold), stream)
    _native.check(rc, "mc3d_heatmap_decode")
    heatmap_decode_raw.launches += 1
    return out


def heatmap_decode_raw(flat: torch.Tensor, W: int, threshold: float = 0.01) -> torch.Tensor:
    """(N, 12) raw decode of maps ``flat`` (N, H·W) f32 with rows of width ``W``.

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs
    `heatmap_decode_raw_plain`.  Refuses autograd (`_native.refuse_autograd`).
    """
    _native.refuse_autograd("heatmap decode kernel (heatmap_decode_raw)", flat)
    if flat.device.type == "cuda":
        return _launch(flat, W, threshold)
    if flat.device.type != "cpu":
        raise ValueError(f"unsupported device {flat.device}")
    return heatmap_decode_raw_plain(flat, W, threshold)


heatmap_decode_raw.launches = 0


def finish_decode(out: torch.Tensor, W: int, shift: float = 0.25):
    """(N, 12) raw decode -> (moments (N, 6), xy (N, 2), score (N,))."""
    s0 = out[:, 0]
    empty = s0 <= 0
    denom = torch.where(empty, torch.ones_like(s0), s0)
    mean_x = out[:, 1] / denom
    mean_y = out[:, 2] / denom
    var_x = out[:, 3] / denom - mean_x * mean_x
    var_y = out[:, 5] / denom - mean_y * mean_y
    cov_xy = out[:, 4] / denom - mean_x * mean_y
    moments = torch.stack([mean_x, mean_y, var_x, cov_xy, cov_xy, var_y], dim=-1)
    moments = torch.where(empty[:, None], torch.zeros_like(moments), moments)

    amax = out[:, 7].to(torch.int64)
    ax = (amax % W).to(torch.float32)
    ay = (amax // W).to(torch.float32)
    dx = torch.sign(out[:, 8] - out[:, 9])
    dy = torch.sign(out[:, 10] - out[:, 11])
    xy = torch.stack([ax + shift * dx, ay + shift * dy], dim=-1)
    return moments, xy, out[:, 6]


def fused_heatmap_decode(heatmaps: torch.Tensor, threshold: float = 0.01,
                         shift: float = 0.25):
    """Decode heatmaps (..., H, W) -> (moments (..., 6), xy (..., 2), score (...,))."""
    *batch, H, W = heatmaps.shape
    flat = heatmaps.to(torch.float32).reshape(-1, H * W).contiguous()
    moments, xy, score = finish_decode(heatmap_decode_raw(flat, W, threshold), W, shift)
    bshape = tuple(batch)
    return moments.reshape(bshape + (6,)), xy.reshape(bshape + (2,)), score.reshape(bshape)
