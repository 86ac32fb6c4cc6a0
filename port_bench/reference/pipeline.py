"""One block of frames through the whole reference: full-frame boxes, crop,
the 2D model, decode, the confidence gate and the best-two-view DLT, with
the program's output layouts (kpts_2d (T, K, 3, C), heatmaps_2d (T, C, K,
6), kpts_3d (T, K, 3)) beside what the judge reads (the maps, the crop
geometry, the decoded peaks and moments in heatmap pixels)."""

from __future__ import annotations

import torch

from .lowp import EXACT
from .topdown import crop, crop_geometry, decode_maps, to_image
from .triangulate import triangulate_top2

__all__ = ["run_block", "crops_of"]


def _full_frames(frames_u8: torch.Tensor, cfg: dict):
    """frames (T, C, H, W, 3) uint8 -> (frames (T·C, H, W, 3), the crop
    window's origin and scale of each full-frame box)."""
    T, C, H, W, _ = frames_u8.shape
    frames = frames_u8.reshape(T * C, H, W, 3)
    boxes = torch.tensor([0.0, 0.0, float(W), float(H)], device=frames.device).expand(T * C, 4)
    return (frames,) + crop_geometry(boxes, cfg["input_size"], cfg["bbox_padding"])


def crops_of(frames_u8: torch.Tensor, cfg: dict) -> torch.Tensor:
    """The normalized full-frame crops (T·C, 3, in_h, in_w) of frames (T, C,
    H, W, 3) uint8, float32."""
    frames, origin, scale = _full_frames(frames_u8, cfg)
    return crop(frames.float() / 255.0, origin, scale, cfg["input_size"])


@torch.no_grad()
def run_block(model, frames_u8: torch.Tensor, cfg: dict, rig: dict, rounding=EXACT,
              chunk: int = 64) -> dict:
    """frames_u8 (T, C, H, W, 3) uint8 on the model's device."""
    T, C = frames_u8.shape[:2]
    N = T * C
    frames, origin, scale = _full_frames(frames_u8, cfg)
    maps = []
    for s in range(0, N, chunk):
        x = crop(frames[s:s + chunk].float() / 255.0, origin[s:s + chunk], scale[s:s + chunk],
                 cfg["input_size"], rounding)
        maps.append(model(x).float())
    maps = torch.cat(maps)
    xy_hm, score, mom_hm = decode_maps(maps, cfg["heatmap_threshold"], rounding)
    stride = cfg["input_size"][1] / maps.shape[-2]
    xy, gauss = to_image(xy_hm, mom_hm, origin, scale, stride, rounding)
    K = xy.shape[1]
    xy = xy.reshape(T, C, K, 2).transpose(1, 2)  # (T, K, C, 2)
    conf = score.reshape(T, C, K).transpose(1, 2)  # (T, K, C)
    xy = torch.where((conf > cfg["conf_threshold"])[..., None], xy, torch.nan)
    kpts_3d = triangulate_top2(xy, conf, rig, rounding)
    return {"maps": maps, "origin": origin, "scale": scale, "stride": stride,
            "xy_hm": xy_hm, "score": score, "mom_hm": mom_hm,
            "kpts_2d": torch.cat([xy, conf[..., None]], -1).transpose(-1, -2),
            "heatmaps_2d": gauss.reshape(T, C, K, 6), "kpts_3d": kpts_3d}
