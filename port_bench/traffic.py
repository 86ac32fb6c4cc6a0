"""The one traffic generator: host blocks of synchronized multi-camera
frames, made from the seed, as a recording's decoder would hand them to
the estimate step.

A traffic file (``traffic/<name>.json``) gives the frame size, the cameras,
the block size, the pipeline depth the estimate loop keeps in flight, how
many distinct blocks are made and cycled, the warm-up blocks, the rig
(`rig.make_rig`) and the content:

- ``content.cell_px``: the frames are smooth random colour fields, one
  uniform random value per ``cell_px`` × ``cell_px`` cell and channel,
  upsampled bicubically (structure at the scale of a person in the crop,
  so the maps have structure too, unlike crops of white noise, which the
  antialiased downscale averages to grey);
- ``content.noise``: plus N(0, noise²) per pixel (sensor noise), then
  clamped to [0, 1] and quantized to uint8.

Every seed gives the same sizes and the same number of blocks; only the
values differ.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .weights import sub_seed

__all__ = ["make_blocks", "cycle_blocks"]


def make_blocks(traffic: dict, seed: int, device) -> list:
    """The ``distinct_blocks`` uint8 host blocks (C-contiguous numpy (T, C, H,
    W, 3), as a decoder fills them), drawn on ``device`` from ``seed``."""
    T, C = traffic["block_size"], traffic["rig"]["cameras"]
    H, W = traffic["height"], traffic["width"]
    cell, noise = traffic["content"]["cell_px"], traffic["content"]["noise"]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    blocks = []
    for _ in range(traffic["distinct_blocks"]):
        coarse = torch.rand((T * C, 3, -(-H // cell) + 1, -(-W // cell) + 1), generator=gen,
                            device=device)
        img = F.interpolate(coarse, size=(H, W), mode="bicubic", align_corners=False)
        img = img + noise * torch.randn(img.shape, generator=gen, device=device)
        u8 = (img.clamp(0.0, 1.0) * 255.0).round().to(torch.uint8)
        blocks.append(u8.permute(0, 2, 3, 1).contiguous().reshape(T, C, H, W, 3).cpu().numpy())
        del coarse, img, u8
    return blocks


def cycle_blocks(blocks: list, count: int | None = None, on_handoff=None):
    """``(block, n_valid)`` items cycling through ``blocks``: ``count`` of
    them, or until ``on_handoff(i)`` returns False.  ``on_handoff(i)`` is
    called as item i is handed over."""
    i = 0
    while count is None or i < count:
        if on_handoff is not None and not on_handoff(i):
            return
        block = blocks[i % len(blocks)]
        yield block, block.shape[0]
        i += 1
