"""What decides ``correct``: every block the timed path finished, judged
against the reference's outputs for its frames.

Numbers over every joint of every finished block, the worst joint's or
the mean (`MEANS`); a cell compares those its limits file names:

- ``score_gap``: |program's confidence − the reference map's peak|, over
  the median reference peak (the 2D model's values);
- ``peak_gap`` / ``peak_mean``: by how much the reference map at the
  pixel the program decoded lies below the reference's peak, and each
  quarter-pixel step against the reference's neighbours (0 where they
  agree or tie), over the same median peak; a decoded position that is not
  a pixel ± a quarter, off the map, or a joint whose NaN disagrees with the
  0.3 gate on its own confidence is +inf.  A tie within rounding splits two
  bf16 paths (their argmaxes differ); this number does not punish a pick
  that the reference itself rates as good as its best.  Where random
  weights amplify rounding, one joint of a bf16 run can read half of an
  fp8 model's worst; the mean over every joint keeps them some ten times
  apart;
- ``gauss_err`` / ``gauss_mean``: the Gaussian moments' mean and
  covariance against the reference's, in image pixels, over the
  reference's spread (at least one heatmap pixel), times the map's mass
  over the decode's threshold (0.01) over the median map's, at most 1.
  Pixels within rounding of the threshold fall on either side of it on two
  paths; in a map with little mass over it they move the moments
  wholesale, by a share that grows as the mass shrinks, so an error counts
  by the map's share of the typical mass;
- ``tri_gap`` / ``tri_mean``: the program's 3D points in the DLT of its own
  2D points (`reference.triangulate.dlt_gap`): the triangulation stage,
  judged from the 2D outputs that the numbers above judge.  The program
  finds the DLT's eigenvector by 12 squarings of a shifted 4x4 matrix, which
  leave a joint whose two smallest eigenvalues lie within about 1/4096 of
  the trace of each other short of the optimum by up to ~1e-4 of the trace:
  a rare joint's gap as large as bf16's, by design; the mean over the run
  is what separates the two.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference.triangulate import dlt_gap

__all__ = ["NAMES", "MEANS", "judge"]

NAMES = ("score_gap", "peak_gap", "peak_mean", "gauss_err", "gauss_mean", "tri_gap",
         "tri_mean")
# The numbers that are means over every joint of the run (the others are
# the worst joint of the run).
MEANS = ("peak_mean", "gauss_mean", "tri_mean")
_INF = float("inf")


def _worst(x: torch.Tensor) -> torch.Tensor:
    """Per block (dim 0): the largest value, NaN counting as +inf."""
    x = torch.nan_to_num(x.double(), nan=_INF)
    return x.reshape(x.shape[0], -1).amax(-1)


def _mass(ref: dict, cfg: dict) -> torch.Tensor:
    """Each reference map's mass over the decode's threshold, (T·C, K)."""
    maps = ref["maps"]
    return torch.where(maps >= cfg["heatmap_threshold"], maps, 0.0).double().sum((-2, -1))


def _block_numbers(k2, hm, k3, ref: dict, rig: dict, cfg: dict, s: float,
                   mass_med: float) -> dict:
    """Program outputs of nb blocks of one source: k2 (nb, T, K, 3, C), hm
    (nb, T, C, K, 6), k3 (nb, T, K, 3) float64 -> {name: (nb,)}."""
    nb, T, K, _, C = k2.shape
    maps = ref["maps"].double()
    h, w = maps.shape[-2:]
    flat = maps.reshape(T, C, K, h * w)
    peak = ref["score"].reshape(T, C, K)
    xy = k2[:, :, :, :2].permute(0, 1, 4, 2, 3)  # (nb, T, C, K, 2)
    conf = k2[:, :, :, 2].permute(0, 1, 3, 2)  # (nb, T, C, K)
    out = {"score_gap": _worst((conf - peak).abs() / s)}

    origin = ref["origin"].reshape(T, C, 1, 2)
    scale = ref["scale"].reshape(T, C, 1, 2)
    hm_xy = (xy - origin) * scale / ref["stride"]
    pix = torch.round(hm_xy)
    step = (hm_xy - pix) / 0.25
    sign = torch.round(step)
    finite = torch.isfinite(xy).all(-1)
    ok = (((step - sign).abs() < 0.04) & (sign.abs() <= 1)).all(-1)
    ok &= (pix[..., 0] >= 0) & (pix[..., 0] < w) & (pix[..., 1] >= 0) & (pix[..., 1] < h)
    px = torch.where(finite, pix[..., 0], 0).long().clamp(0, w - 1)
    py = torch.where(finite, pix[..., 1], 0).long().clamp(0, h - 1)
    ti = torch.arange(T, device=maps.device)[None, :, None, None]
    ci = torch.arange(C, device=maps.device)[None, None, :, None]
    ki = torch.arange(K, device=maps.device)[None, None, None, :]

    def at(yy, xx):
        return flat[ti, ci, ki, yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)]

    gap = (peak - at(py, px)) / s
    for axis, (fwd, back) in enumerate((((py, px + 1), (py, px - 1)),
                                        ((py + 1, px), (py - 1, px)))):
        diff = at(*fwd) - at(*back)
        gap = torch.maximum(gap, torch.where(sign[..., axis] == torch.sign(diff), 0.0,
                                             diff.abs() / s))
    gap = torch.where(finite, torch.where(ok, gap, _INF), 0.0)
    gap = torch.where(finite == (conf > cfg["conf_threshold"]), gap, _INF)
    out["peak_gap"] = _worst(gap)
    out["peak_mean"] = gap.reshape(nb, -1).mean(-1)

    ref_g = ref["heatmaps_2d"].double()  # (T, C, K, 6)
    px_img = ref["stride"] / scale  # image px per heatmap px
    spread = torch.maximum(ref_g[..., 2] + ref_g[..., 5], (px_img * px_img).sum(-1))
    d = hm - ref_g
    err = torch.maximum(torch.linalg.vector_norm(d[..., :2], dim=-1) / spread.sqrt(),
                        d[..., 2:].abs().amax(-1) / spread)
    weight = (_mass(ref, cfg).reshape(T, C, K) / mass_med).clamp(max=1.0)
    dup = torch.where(hm[..., 3] == hm[..., 4], 0.0, _INF)
    gauss = torch.nan_to_num(torch.maximum(err * weight, dup), nan=_INF)
    out["gauss_err"] = _worst(gauss)
    out["gauss_mean"] = gauss.reshape(nb, -1).mean(-1)

    xy_jc = k2[:, :, :, :2].transpose(-1, -2)  # (nb, T, K, C, 2)
    conf_jc = k2[:, :, :, 2]  # (nb, T, K, C)
    tri = torch.nan_to_num(dlt_gap(xy_jc, conf_jc, k3, rig), nan=_INF)
    out["tri_gap"] = _worst(tri)
    out["tri_mean"] = tri.reshape(nb, -1).mean(-1)
    return out


@torch.no_grad()
def judge(outputs: tuple, n_blocks: int, refs: list, rig: dict, cfg: dict,
          device) -> dict:
    """``outputs``: the program's stacked (kpts_2d, heatmaps_2d, kpts_3d)
    numpy arrays of ``n_blocks`` blocks, block b made from source block
    b % len(refs); ``refs``: `reference.pipeline.run_block` of each source.
    Returns {"numbers": {name: worst}, "per_block": {name: (n_blocks,)
    numpy}}."""
    k2, hm, k3 = outputs
    n_src = len(refs)
    T = refs[0]["kpts_3d"].shape[0]
    if k2.shape[0] != n_blocks * T:
        raise ValueError(f"{k2.shape[0]} frames came back for {n_blocks} blocks of {T}")
    s = float(torch.cat([r["score"].flatten() for r in refs]).abs().median().clamp(min=1e-6))
    mass_med = float(torch.cat([_mass(r, cfg).flatten() for r in refs]).median().clamp(
        min=1e-6))
    per_block = {name: np.zeros(n_blocks) for name in NAMES}
    blocks = np.arange(n_blocks)

    def cut(a, idx):
        a = torch.as_tensor(a.reshape((n_blocks, T) + a.shape[1:])[idx], device=device)
        return a.double()

    for src in range(n_src):
        idx = blocks[blocks % n_src == src]
        if idx.size == 0:
            continue
        nums = _block_numbers(cut(k2, idx), cut(hm, idx), cut(k3, idx), refs[src], rig, cfg, s,
                              mass_med)
        for name in NAMES:
            per_block[name][idx] = nums[name].cpu().numpy()
    numbers = {name: float(per_block[name].mean() if name in MEANS else per_block[name].max())
               if n_blocks else _INF for name in NAMES}
    return {"numbers": numbers, "per_block": per_block}
