"""Heatmap keypoint decode (batched torch): argmax + quarter-pixel shift,
and the DARK log-Taylor refinement.

Counterpart of the JAX package's ``ops/heatmap_decode.py``.
"""

from __future__ import annotations

import torch

__all__ = ["heatmap_argmax_decode", "heatmap_dark_decode"]


def heatmap_argmax_decode(heatmaps: torch.Tensor, shift: float = 0.25):
    """Decode heatmaps (..., H, W) -> (xy (..., 2), score (...,)).

    First-occurrence argmax in row-major order, the peak value as score, and
    a ``shift``·sign step toward the larger of the two (clamped) neighbours
    on each axis.  ``xy`` is in heatmap pixels.
    """
    H, W = heatmaps.shape[-2], heatmaps.shape[-1]
    flat = heatmaps.reshape(heatmaps.shape[:-2] + (H * W,))
    idx = torch.argmax(flat, dim=-1)
    score = torch.gather(flat, -1, idx[..., None])[..., 0]
    y = idx // W
    x = idx % W

    def at(yy, xx):
        lin = yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)
        return torch.gather(flat, -1, lin[..., None])[..., 0]

    dx = torch.sign(at(y, x + 1) - at(y, x - 1))
    dy = torch.sign(at(y + 1, x) - at(y - 1, x))
    fx = x.to(flat.dtype) + shift * dx
    fy = y.to(flat.dtype) + shift * dy
    return torch.stack([fx, fy], dim=-1), score


def _blur_last(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Zero-padded 1-D blur of the last axis: out[i] = Σ_j g[j]·pad(x)[i + j].

    This is the JAX package's ``jnp.convolve(row, g, "valid")`` over the
    padded row with the kernel flipped; the Gaussian is symmetric, so the
    flip changes nothing.  Written as k shifted multiply-adds, one rounding
    each, rather than ``F.conv1d``: cuDNN may run an f32 convolution in
    TF32, and the card should give the CPU's sums.
    """
    k = g.shape[0]
    n = x.shape[-1]
    padded = torch.nn.functional.pad(x, (k // 2, k // 2))
    out = g[0] * padded[..., 0:n]
    for j in range(1, k):
        out = out + g[j] * padded[..., j:j + n]
    return out


def heatmap_dark_decode(heatmaps: torch.Tensor, blur_kernel: int = 11, eps: float = 1e-10):
    """DARK decode (..., H, W) -> (xy (..., 2) heatmap pixels, score (...,)).

    Separable Gaussian blur (σ from the kernel size, the cv2 convention),
    renormalised to the map's peak, log, then the argmax corrected by
    −H⁻¹∇ from central differences on clamped 3x3 / 5x5 neighbours; the
    step is clipped to ±1 px and dropped where |det H| ≤ eps.  The score is
    the raw map's peak.
    """
    H, W = heatmaps.shape[-2], heatmaps.shape[-1]
    k = int(blur_kernel) | 1
    sigma = 0.3 * ((k - 1) * 0.5 - 1) + 0.8
    xs = torch.arange(k, dtype=heatmaps.dtype, device=heatmaps.device) - (k - 1) / 2.0
    g = torch.exp(-(xs * xs) / (2.0 * sigma * sigma))
    g = g / g.sum()

    flat_shape = heatmaps.shape[:-2]
    hm = heatmaps.reshape(-1, H, W)
    peak = hm.amax(dim=(-2, -1), keepdim=True)
    sm = _blur_last(hm, g)
    sm = _blur_last(sm.transpose(-1, -2), g).transpose(-1, -2)
    sm = sm * peak / torch.clamp(sm.amax(dim=(-2, -1), keepdim=True), min=eps)
    lg = torch.log(torch.clamp(sm, min=eps)).reshape(hm.shape[0], -1)

    flat = hm.reshape(hm.shape[0], -1)
    idx = torch.argmax(flat, dim=-1)
    score = torch.gather(flat, -1, idx[:, None])[:, 0]
    x0 = idx % W
    y0 = idx // W

    def at(dy, dx):
        lin = (y0 + dy).clamp(0, H - 1) * W + (x0 + dx).clamp(0, W - 1)
        return torch.gather(lg, -1, lin[:, None])[:, 0]

    dx = 0.5 * (at(0, 1) - at(0, -1))
    dy = 0.5 * (at(1, 0) - at(-1, 0))
    dxx = 0.25 * (at(0, 2) - 2.0 * at(0, 0) + at(0, -2))
    dyy = 0.25 * (at(2, 0) - 2.0 * at(0, 0) + at(-2, 0))
    dxy = 0.25 * (at(1, 1) - at(1, -1) - at(-1, 1) + at(-1, -1))

    det = dxx * dyy - dxy * dxy
    ok = det.abs() > eps
    det_safe = torch.where(ok, det, torch.ones_like(det))
    zero = torch.zeros_like(det)
    off_x = torch.where(ok, torch.clamp(-(dyy * dx - dxy * dy) / det_safe, -1.0, 1.0), zero)
    off_y = torch.where(ok, torch.clamp(-(dxx * dy - dxy * dx) / det_safe, -1.0, 1.0), zero)
    xy = torch.stack([x0.to(lg.dtype) + off_x, y0.to(lg.dtype) + off_y], dim=-1)
    return xy.reshape(flat_shape + (2,)), score.reshape(flat_shape)
