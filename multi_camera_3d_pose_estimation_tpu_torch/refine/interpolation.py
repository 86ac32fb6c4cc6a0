"""Outlier-filtered windowed linear interpolation (batched torch).

Counterpart of the JAX package's ``refine/interpolation.py``: a sliding
window of k frames becomes a gather into a (T, W, N) tensor, the mean/std
and median/MAD outlier gates become masked reductions, and the per-window
degree-1 fit its closed form.

- Windows are truncated at the sequence ends (masked statistics).
- A NaN in a window makes its statistics NaN, so no point survives and the
  fallback applies.
- Fewer than 2 surviving points: the original point is kept, or 0 with
  ``strict_zero_fallback`` (the reference's behaviour).
"""

from __future__ import annotations

import torch

__all__ = ["linear_interpolation"]


def _masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median over the ``mask`` entries along axis 1 of (T, W, N): the mean
    of the two middle values (sort with +inf padding, then gather); NaN if
    any masked-in value is NaN."""
    vals = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf"))), dim=1).values
    n = mask.sum(1)  # (T, N)
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = torch.clamp(n // 2, min=0)
    med = 0.5 * (torch.gather(vals, 1, lo[:, None])[:, 0] + torch.gather(vals, 1, hi[:, None])[:, 0])
    has_nan = (mask & torch.isnan(x)).any(1)
    return torch.where(has_nan, torch.full_like(med, float("nan")), med)


def _interp_core(x: torch.Tensor, k: int, k_std: float, median_std: float,
                 use_rolling_average: bool, filter_distance_from_median: bool,
                 strict_zero_fallback: bool) -> torch.Tensor:
    T, N = x.shape
    half = k // 2
    offsets = torch.arange(-half, half + 1, device=x.device)
    t_idx = torch.arange(T, device=x.device)[:, None] + offsets[None, :]  # (T, W)
    in_bounds = (t_idx >= 0) & (t_idx < T)
    win = x[t_idx.clamp(0, T - 1)]  # (T, W, N)
    mask = in_bounds[..., None]
    mask_f = mask.to(x.dtype)

    n = mask_f.sum(1)
    mean = (win * mask_f).sum(1) / n
    std = torch.sqrt((mask_f * (win - mean[:, None]) ** 2).sum(1) / n)

    mask_b = mask.expand(win.shape)
    med = _masked_median(win, mask_b)
    mad = _masked_median((win - med[:, None]).abs(), mask_b)

    valid = mask_b & ((win - mean[:, None]).abs() <= k_std * std[:, None])
    if filter_distance_from_median:
        valid = valid & ((win - med[:, None]).abs() <= median_std * mad[:, None])
    vf = valid.to(x.dtype)
    nv = vf.sum(1)
    enough = nv >= 2
    safe_nv = torch.where(enough, nv, torch.full_like(nv, 2.0))
    mean_v = (win * vf).sum(1) / safe_nv

    if use_rolling_average:
        fitted = mean_v
    else:
        times = t_idx.to(x.dtype)[..., None]  # (T, W, 1)
        mean_t = (times * vf).sum(1) / safe_nv
        st2 = (vf * (times - mean_t[:, None]) ** 2).sum(1)
        stx = (vf * (times - mean_t[:, None]) * (win - mean_v[:, None])).sum(1)
        slope = stx / torch.where(st2 > 0, st2, torch.ones_like(st2))
        t_now = torch.arange(T, dtype=x.dtype, device=x.device)[:, None]
        fitted = mean_v + slope * (t_now - mean_t)

    fallback = torch.zeros_like(x) if strict_zero_fallback else x
    return torch.where(enough, fitted, fallback)


def linear_interpolation(points, k: int = 5, k_std: float = 2, median_std: float = 2,
                         use_rolling_average: bool = False,
                         filter_distance_from_median: bool = True,
                         strict_zero_fallback: bool = False, device="cuda") -> torch.Tensor:
    """Smooth ``points`` ((T, P, D) or (T, P)) by outlier-robust local fits.

    Returns a floating tensor of the input's shape on ``device``: the input's
    dtype if it is float64, else float32.
    """
    pts = torch.as_tensor(points, device=device)
    squeeze = pts.dim() == 2
    if squeeze:
        pts = pts[..., None]
    T, P, D = pts.shape
    dtype = torch.float64 if pts.dtype == torch.float64 else torch.float32
    out = _interp_core(pts.reshape(T, P * D).to(dtype), int(k), float(k_std), float(median_std),
                       bool(use_rolling_average), bool(filter_distance_from_median),
                       bool(strict_zero_fallback)).reshape(T, P, D)
    return out[..., 0] if squeeze else out
