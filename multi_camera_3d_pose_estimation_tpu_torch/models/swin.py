"""Swin Transformer top-down heatmap pose model (torch, NHWC tokens).

Counterpart of the JAX package's ``models/swin.py``: the MMPose
td-hm_swin-{b,l}-p4-w7 backbone (patch 4, window 7) with its HeatmapHead,
the same numerics and submodules named after the flax names
(``backbone.stage_{i}_block_{j}.attn.qkv``, ``deconv_bn_0``, ...) so a flax
variables tree maps onto the ``state_dict`` mechanically (`models.convert`).
Parameters are f32; the compute dtype is ``dtype`` (bf16 by default):

- LayerNorm statistics in f32 (E[x²] − E[x]², clamped at 0, eps 1e-5), the
  result cast to ``dtype``; Dense layers as ``dtype(x @ W) + dtype(b)``;
- feature maps are zero-padded on the right and bottom to window
  multiples AFTER LN1 and before qkv, so pad tokens carry k/v = bias and
  take part in attention; only the shifted-window region mask (−100) is
  applied;
- PatchMerging concatenates each 2×2 neighbourhood channel-major
  (index c·4 + dy·2 + dx);
- `Deconv` is ``conv_transpose2d`` (k4 s2 p1); the head BatchNorm
  (`models.batchnorm`) computes in f32 and casts to ``dtype``.

``use_pallas_attention`` picks the attention path with the JAX values:
``"block"`` (default) runs every SwinBlock as `ops.swin_block.fused_swin_block`
(the swin_gemm and window-attention kernels), with each stage's tokens kept
in window order between blocks and moved by one `window_roll_perm` gather;
``True``/``"packed"`` and ``"loop"`` run only the attention core through the
window-attention kernel (`packed_window_attention` / `fused_window_attention`);
``False`` runs the plain einsum path.  On a CPU tensor every choice runs the
plain versions.  The patch-embed conv, PatchMerging's reduction, the
deconvolutions and the final 1×1 conv stay cuDNN/`torch.matmul`, as the
JAX package leaves them to XLA.

In ``"block"`` mode the environment variable ``MC3D_SWIN_FIXED``, read at
every forward with the JAX parsing, picks the layout of the multi-block
stages: ``"0"`` (the default) the chained window layout above, ``"1"``
every such stage in fixed order, any other value a comma list of channel
widths whose stages go fixed.  A fixed stage runs `fixed_partition` →
`ops.swin_block.fused_swin_stage_fixed` → `fixed_reverse`: tokens stay in
shift-0 window order for the whole stage and each shifted block reads its
windows through a row table, so no gather runs between blocks.  The one
difference from the JAX package: it has no VMEM gate (``feasible_fixed``),
so ``"1"`` also puts Swin-B's stage 0 in fixed order, where the JAX package
falls back to the chained layout.  Both layouts compute the same function.
"""

from __future__ import annotations

import os
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import swin_block as swin_ops
from ..ops.swin_block import prepare_swin_block
from ..ops.swin_geometry import (device_table, fixed_partition, fixed_reverse, padded_dims,
                                 partition_windows, rel_position_index, reverse_windows,
                                 shift_mask, shift_regions, window_roll_perm)
from ..ops.window_attention import (fused_window_attention, packed_window_attention,
                                    window_attention_plain)
from .batchnorm import BatchNorm, batch_norm_act

__all__ = ["SwinPose", "SwinTransformer", "SwinBlock", "WindowAttention", "PatchMerging",
           "Deconv", "SWIN_B", "SWIN_L", "SWIN_T", "ATTENTION_MODES"]

# MMPose td-hm_swin-{b,l}-p4-w7_coco-256x192 backbones + HeatmapHead.
SWIN_B = {"embed": 128, "depths": (2, 2, 18, 2), "heads": (4, 8, 16, 32),
          "window": 7, "mlp_ratio": 4, "deconv": (256, 256, 256)}
SWIN_L = {"embed": 192, "depths": (2, 2, 18, 2), "heads": (6, 12, 24, 48),
          "window": 7, "mlp_ratio": 4, "deconv": (256, 256, 256)}
SWIN_T = {"embed": 96, "depths": (2, 2, 6, 2), "heads": (3, 6, 12, 24),
          "window": 7, "mlp_ratio": 4, "deconv": (256, 256, 256)}

ATTENTION_MODES = ("block", True, "packed", "loop", False)


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.LayerNorm``: f32 statistics (fast variance, clamped at 0),
    ``(x − μ)·(rsqrt(var + eps)·γ) + β`` in f32, cast to ``dtype``."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    mul = torch.rsqrt(var + ln.eps) * ln.weight
    return ((xf - mu) * mul + ln.bias).to(dtype)


def dense(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense`` in ``dtype``: ``dtype(x @ W)`` plus ``dtype(b)``."""
    y = F.linear(x.to(dtype), lin.weight.to(dtype))
    return y + lin.bias.to(dtype) if lin.bias is not None else y


class WindowAttention(nn.Module):
    """Multi-head self-attention inside (optionally shifted) windows of a
    (B, H, W, C) map: pad, roll, partition, attend with the relative
    position bias (+ shift mask), reverse, roll back, crop."""

    def __init__(self, dim: int, heads: int, window: int, shift: int = 0,
                 dtype=torch.bfloat16):
        super().__init__()
        if dim % heads:
            raise ValueError(f"channels {dim} not divisible by heads {heads}")
        self.heads, self.window, self.shift, self.dtype = heads, window, shift, dtype
        self.bias_table = nn.Parameter(torch.zeros((2 * window - 1) ** 2, heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def relative_bias(self) -> torch.Tensor:
        """(heads, n, n) f32 relative-position bias."""
        n = self.window ** 2
        idx = device_table(rel_position_index, self.window, device=self.bias_table.device,
                           dtype=torch.long)
        return self.bias_table.float()[idx.reshape(-1)].reshape(n, n, -1).permute(2, 0, 1)

    def forward(self, x: torch.Tensor, mode=False) -> torch.Tensor:
        B, H, W, C = x.shape
        win, shift, dev = self.window, self.shift, x.device
        Hp, Wp = padded_dims(H, W, win)
        if Hp != H or Wp != W:
            x = F.pad(x, (0, 0, 0, Wp - W, 0, Hp - H))
        if shift:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        qkv = dense(partition_windows(x, win), self.qkv, self.dtype).contiguous()
        bias = self.relative_bias().contiguous()
        if mode in (True, "packed"):
            regions = shift_regions(Hp, Wp, win, shift) if shift else None
            out = packed_window_attention(qkv, bias, regions, self.heads)
        else:
            mask = (device_table(shift_mask, Hp, Wp, win, shift, device=dev,
                                 dtype=torch.float32) if shift else None)
            attend = fused_window_attention if mode == "loop" else window_attention_plain
            out = attend(qkv, bias, mask, self.heads)
        out = reverse_windows(dense(out, self.proj, self.dtype), win, B, Hp, Wp)
        if shift:
            out = torch.roll(out, (shift, shift), dims=(1, 2))
        return out[:, :H, :W, :]


class SwinBlock(nn.Module):
    """LN → (S)W-MSA → residual; LN → MLP(ratio·C, exact GELU) → residual."""

    def __init__(self, dim: int, heads: int, window: int, shift: int = 0, mlp_ratio: int = 4,
                 dtype=torch.bfloat16):
        super().__init__()
        self.heads, self.window, self.shift = heads, window, shift
        self.mlp_ratio, self.dtype = mlp_ratio, dtype
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, heads, window, shift, dtype)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.ffn_fc1 = nn.Linear(dim, mlp_ratio * dim)
        self.ffn_fc2 = nn.Linear(mlp_ratio * dim, dim)
        self._prepared, self._prepared_key = None, None

    def prepared(self) -> dict:
        """`prepare_swin_block` of this block in its compute dtype: made at
        the first call and again only after a parameter was replaced (moved,
        reloaded) or written in place (its version counter moved)."""
        key = tuple((p.data_ptr(), p._version) for p in self.parameters())
        if self._prepared_key != key:
            self._prepared = prepare_swin_block(self, self.dtype)
            self._prepared_key = key
        return self._prepared

    def forward(self, x: torch.Tensor, mode=False, pre_part=None, emit_part: bool = False):
        """``mode == "block"``: the whole block through `fused_swin_block`;
        ``pre_part=(B, H, W)`` takes this block's window-order tokens and
        ``emit_part`` returns them (pads zeroed), as in the JAX package."""
        if mode == "block":
            return swin_ops.fused_swin_block(
                x.to(self.dtype), self.prepared(), heads=self.heads,
                window=self.window, shift=self.shift, mlp_ratio=self.mlp_ratio,
                pre_partitioned=pre_part, emit_partitioned=emit_part)
        if pre_part is not None or emit_part:
            raise ValueError("the chained window layout needs mode='block'")
        y = x + self.attn(layer_norm(x, self.norm1, self.dtype), mode)
        h = dense(layer_norm(y, self.norm2, self.dtype), self.ffn_fc1, self.dtype)
        h = F.gelu(h.float()).to(self.dtype)
        return y + dense(h, self.ffn_fc2, self.dtype)


class PatchMerging(nn.Module):
    """2×2 → 1 token downsample: channel-major concat → LN → Linear 4C→2C."""

    def __init__(self, dim: int, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        if H % 2 or W % 2:
            raise ValueError(f"PatchMerging needs even dims, got {(H, W)}")
        x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 5, 2, 4)
        x = x.reshape(B, H // 2, W // 2, 4 * C)
        return dense(layer_norm(x, self.norm, self.dtype), self.reduction, self.dtype)


def fixed_layout(C: int) -> bool:
    """Whether ``MC3D_SWIN_FIXED`` puts the stage of channel width C in
    fixed order (the JAX package's parsing)."""
    env = os.environ.get("MC3D_SWIN_FIXED", "0")
    return env != "0" if env in ("0", "1") else str(C) in env.split(",")


class SwinTransformer(nn.Module):
    """Swin backbone: (B, H, W, 3) → the LN'd 1/32 (NHWC) feature map of the
    last stage (out_indices=(3,), as the MMPose pose configs)."""

    def __init__(self, cfg=None, dtype=torch.bfloat16, use_pallas_attention="block"):
        super().__init__()
        cfg = cfg or SWIN_B
        if use_pallas_attention not in ATTENTION_MODES:
            raise ValueError(f"use_pallas_attention must be one of {ATTENTION_MODES}")
        self.cfg, self.dtype, self.mode = cfg, dtype, use_pallas_attention
        embed, win, ratio = cfg["embed"], cfg["window"], cfg.get("mlp_ratio", 4)
        self.patch_embed_projection = nn.Conv2d(3, embed, 4, 4)
        self.patch_embed_norm = nn.LayerNorm(embed, eps=1e-5)
        dim = embed
        for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["heads"])):
            for j in range(depth):
                self.add_module(f"stage_{i}_block_{j}", SwinBlock(
                    dim, heads, win, (win // 2) if j % 2 else 0, ratio, dtype))
            if i < len(cfg["depths"]) - 1:
                self.add_module(f"downsample_{i}", PatchMerging(dim, dtype))
                dim *= 2
        self.out_norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[1:3]
        if H % 32 or W % 32:
            raise ValueError("Swin input height/width must be divisible by 32 (patch4 + "
                             f"three even patch-merges); got {(H, W)}")
        dt, win = self.dtype, self.cfg["window"]
        conv = self.patch_embed_projection
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), conv.weight.to(dt), None, 4)
        x = (y.permute(0, 2, 3, 1) + conv.bias.to(dt)).contiguous()
        x = layer_norm(x, self.patch_embed_norm, dt)
        depths: Sequence[int] = self.cfg["depths"]
        for i, depth in enumerate(depths):
            blocks = [getattr(self, f"stage_{i}_block_{j}") for j in range(depth)]
            if self.mode == "block" and depth > 1 and fixed_layout(x.shape[-1]):
                # Fixed order: the stage's tokens stay in shift-0 window order.
                B, Hc, Wc, _ = x.shape
                b0 = blocks[0]
                xw = swin_ops.fused_swin_stage_fixed(
                    fixed_partition(x.to(dt), win).contiguous(), [b.prepared() for b in blocks],
                    heads=b0.heads, window=win, shifts=[b.shift for b in blocks],
                    mlp_ratio=b0.mlp_ratio, geom=(B, Hc, Wc))
                x = fixed_reverse(xw, B, Hc, Wc, win)
            elif self.mode == "block" and depth > 1:
                # Chained window layout: tokens stay in window order between
                # the blocks of a stage; one gather per transition.
                B, Hc, Wc, C = x.shape
                xw = blocks[0](x, "block", emit_part=True)
                for j in range(1, depth):
                    perm = device_table(window_roll_perm, Hc, Wc, win, blocks[j - 1].shift,
                                        blocks[j].shift, device=x.device, dtype=torch.long)
                    xw = xw.view(B, -1, C).index_select(1, perm).view(-1, C)
                    xw = blocks[j](xw, "block", pre_part=(B, Hc, Wc), emit_part=j < depth - 1)
                x = xw
            else:
                for blk in blocks:
                    x = blk(x, self.mode)
            if i < len(depths) - 1:
                x = getattr(self, f"downsample_{i}")(x)
        return layer_norm(x, self.out_norm, dt)


class Deconv(nn.Module):
    """``ConvTranspose2d(k, s, p, bias=False)``; ``weight`` (in, out, k, k)."""

    def __init__(self, cin: int, cout: int, kernel: int = 4, stride: int = 2, pad: int = 1):
        super().__init__()
        self.stride, self.pad = stride, pad
        self.weight = nn.Parameter(torch.zeros(cin, cout, kernel, kernel))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight.to(dtype), None, self.stride, self.pad)


class SwinPose(nn.Module):
    """Swin heatmap pose estimator.

    ``forward(x)``: normalized crops (B, H, W, 3) NHWC -> heatmaps
    (B, num_joints, H/4, W/4) f32 (an NCHW view of channels-last data).
    Backbone (1/32) + MMPose HeatmapHead: 3 × [deconv 4s2 → BN → ReLU],
    then a 1×1 conv to K.
    """

    def __init__(self, num_joints: int = 17, cfg=None, dtype=torch.bfloat16,
                 use_pallas_attention="block", device="cuda"):
        super().__init__()
        cfg = cfg or SWIN_B
        self.cfg, self.num_joints, self.dtype = cfg, num_joints, dtype
        self.backbone = SwinTransformer(cfg, dtype, use_pallas_attention)
        ch = cfg["embed"] * 2 ** (len(cfg["depths"]) - 1)
        for d, out in enumerate(cfg["deconv"]):
            self.add_module(f"deconv_{d}", Deconv(ch, out))
            self.add_module(f"deconv_bn_{d}", BatchNorm(out))
            ch = out
        self.final_layer = nn.Conv2d(ch, num_joints, 1)
        self.to(device=device).eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = self.backbone(x).permute(0, 3, 1, 2)  # NCHW view of NHWC tokens
        for d in range(len(self.cfg["deconv"])):
            y = getattr(self, f"deconv_{d}")(y, dt)
            y = batch_norm_act(y, getattr(self, f"deconv_bn_{d}"), dt, relu=True)
        head = self.final_layer
        heat = F.conv2d(y, head.weight.to(dt)) + head.bias.to(dt)[:, None, None]
        return heat.float()
