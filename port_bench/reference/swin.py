"""Swin Transformer top-down heatmap model in plain PyTorch, float32, with
MMPose's module names (``backbone.stages.2.blocks.5.attn.w_msa.qkv``,
``backbone.norm3``, ``head.deconv_layers.3``), so that a state dict in
MMPose's checkpoint format loads into it with ``strict=True``.

The architecture is MMPose's ``SwinTransformer`` (the mmseg-derived one,
``out_indices=(3,)``) with ``HeatmapHead``, as in
``td-hm_swin-b-p4-w7_8xb32-210e_coco-256x192.py``:

- patch embedding: a 4x4 stride-4 conv, then LayerNorm;
- each block: LN1, then (shifted) window attention, then the residual; LN2,
  the MLP (Linear, exact GELU, Linear), the residual.  The attention pads
  the LN1 output with zeros on the right and bottom to window multiples
  (the pad tokens take part, as keys and values equal to the bias), rolls
  by −shift on odd blocks (shift = window // 2), splits into windows, adds
  the relative-position bias and, when shifted, the −100 region mask,
  then reverses all of it and crops.  The window never shrinks to the map;
- patch merging: each 2x2 neighbourhood concatenated channel-major
  (``nn.Unfold`` order: channel c of offset (dy, dx) at c·4 + dy·2 + dx),
  LayerNorm, a Linear to twice the channels without bias;
- ``norm3`` on the last stage, then three ConvTranspose2d(4, 2, 1) + BN +
  ReLU and a 1x1 conv to the joints.

Every LayerNorm and BatchNorm is applied as written.  ``rounding.model``
(see `lowp`) is applied to both operands of every product (the linears,
convs, q·kᵀ and attention·v); the exact reference leaves them in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .lowp import EXACT

__all__ = ["SwinRef", "relative_position_index", "shift_mask"]


class _Linear(nn.Linear):
    rounding = EXACT

    def forward(self, x):
        r = self.rounding.model
        return F.linear(r(x), r(self.weight), None if self.bias is None else r(self.bias))


class _Conv(nn.Conv2d):
    rounding = EXACT

    def forward(self, x):
        r = self.rounding.model
        return F.conv2d(r(x), r(self.weight), None if self.bias is None else r(self.bias),
                        self.stride, self.padding)


class _Deconv(nn.ConvTranspose2d):
    rounding = EXACT

    def forward(self, x):
        r = self.rounding.model
        return F.conv_transpose2d(r(x), r(self.weight), None, self.stride, self.padding)


def relative_position_index(w: int) -> torch.Tensor:
    """(w², w²) index of token pair (a, b) of a window into the
    (2w−1)² bias table: ((ya − yb) + w − 1)·(2w − 1) + (xa − xb) + w − 1."""
    ys, xs = torch.meshgrid(torch.arange(w), torch.arange(w), indexing="ij")
    ys, xs = ys.reshape(-1), xs.reshape(-1)
    dy = ys[:, None] - ys[None, :] + w - 1
    dx = xs[:, None] - xs[None, :] + w - 1
    return dy * (2 * w - 1) + dx


def shift_mask(hp: int, wp: int, w: int, shift: int) -> torch.Tensor:
    """(nW, w², w²): 0 between tokens of one region of the rolled map, −100
    otherwise; regions are the 3 × 3 slices [0, hp−w), [hp−w, hp−shift),
    [hp−shift, hp) of each axis."""
    region = torch.zeros(hp, wp)
    cuts_h = (0, hp - w, hp - shift, hp)
    cuts_w = (0, wp - w, wp - shift, wp)
    count = 0
    for a in range(3):
        for b in range(3):
            region[cuts_h[a]:cuts_h[a + 1], cuts_w[b]:cuts_w[b + 1]] = count
            count += 1
    win = region.reshape(hp // w, w, wp // w, w).permute(0, 2, 1, 3).reshape(-1, w * w)
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, torch.tensor(-100.0), torch.tensor(0.0))


class WindowMSA(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads, self.window = heads, window
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * window - 1) ** 2,
                                                                     heads))
        self.qkv = _Linear(dim, 3 * dim)
        self.proj = _Linear(dim, dim)
        self.rounding = EXACT

    def forward(self, x, mask):
        """x (Bw, n, C); mask (nW, n, n) or None."""
        Bw, n, C = x.shape
        h = self.heads
        r = self.rounding.model
        qkv = self.qkv(x).reshape(Bw, n, 3, h, C // h).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * (C // h) ** -0.5, qkv[1], qkv[2]
        attn = r(q) @ r(k).transpose(-2, -1)
        idx = relative_position_index(self.window).to(x.device).reshape(-1)
        bias = self.relative_position_bias_table[idx].reshape(n, n, h).permute(2, 0, 1)
        attn = attn + bias[None]
        if mask is not None:
            nW = mask.shape[0]
            attn = attn.view(Bw // nW, nW, h, n, n) + mask[None, :, None]
            attn = attn.view(Bw, h, n, n)
        attn = torch.softmax(attn, dim=-1)
        out = (r(attn) @ r(v)).transpose(1, 2).reshape(Bw, n, C)
        return self.proj(out)


class ShiftWindowMSA(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int):
        super().__init__()
        self.window, self.shift = window, shift
        self.w_msa = WindowMSA(dim, heads, window)

    def forward(self, x):
        """x (B, H, W, C) -> (B, H, W, C)."""
        B, H, W, C = x.shape
        w, s = self.window, self.shift
        hp, wp = math.ceil(H / w) * w, math.ceil(W / w) * w
        x = F.pad(x, (0, 0, 0, wp - W, 0, hp - H))
        mask = None
        if s:
            x = torch.roll(x, (-s, -s), dims=(1, 2))
            mask = shift_mask(hp, wp, w, s).to(x.device)
        win = x.reshape(B, hp // w, w, wp // w, w, C).permute(0, 1, 3, 2, 4, 5)
        out = self.w_msa(win.reshape(-1, w * w, C), mask)
        out = out.reshape(B, hp // w, wp // w, w, w, C).permute(0, 1, 3, 2, 4, 5)
        out = out.reshape(B, hp, wp, C)
        if s:
            out = torch.roll(out, (s, s), dims=(1, 2))
        return out[:, :H, :W]


class _FFN(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.layers = nn.Sequential(nn.Sequential(_Linear(dim, hidden), nn.GELU()),
                                    _Linear(hidden, dim))

    def forward(self, x):
        return self.layers(x)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int, mlp_ratio: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = ShiftWindowMSA(dim, heads, window, shift)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.ffn = _FFN(dim, mlp_ratio * dim)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.ffn(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = _Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        B, H, W, C = x.shape
        x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 5, 2, 4)
        return self.reduction(self.norm(x.reshape(B, H // 2, W // 2, 4 * C)))


class _Stage(nn.Module):
    def __init__(self, dim, depth, heads, window, mlp_ratio, downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList(SwinBlock(dim, heads, window, (window // 2) if j % 2 else 0,
                                              mlp_ratio) for j in range(depth))
        if downsample:
            self.downsample = PatchMerging(dim)


class _PatchEmbed(nn.Module):
    def __init__(self, embed: int):
        super().__init__()
        self.projection = _Conv(3, embed, 4, 4)
        self.norm = nn.LayerNorm(embed, eps=1e-5)


class _Backbone(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        embed, win, ratio = cfg["embed"], cfg["window"], cfg["mlp_ratio"]
        self.patch_embed = _PatchEmbed(embed)
        self.stages = nn.ModuleList()
        dim, n = embed, len(cfg["depths"])
        for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["heads"])):
            self.stages.append(_Stage(dim, depth, heads, win, ratio, i < n - 1))
            if i < n - 1:
                dim *= 2
        self.add_module(f"norm{n - 1}", nn.LayerNorm(dim, eps=1e-5))
        self.n = n

    def forward(self, x):
        """x (B, 3, H, W) -> the normed last stage (B, H/32, W/32, C)."""
        x = self.patch_embed.projection(x).permute(0, 2, 3, 1)
        x = self.patch_embed.norm(x)
        for stage in self.stages:
            for block in stage.blocks:
                x = block(x)
            if hasattr(stage, "downsample"):
                x = stage.downsample(x)
        return getattr(self, f"norm{self.n - 1}")(x)


class _Head(nn.Module):
    def __init__(self, cin: int, deconv, num_joints: int):
        super().__init__()
        layers = []
        for cout in deconv:
            layers += [_Deconv(cin, cout, 4, 2, 1, bias=False), nn.BatchNorm2d(cout, eps=1e-5),
                       nn.ReLU()]
            cin = cout
        self.deconv_layers = nn.Sequential(*layers)
        self.final_layer = _Conv(cin, num_joints, 1)

    def forward(self, x):
        return self.final_layer(self.deconv_layers(x))


class SwinRef(nn.Module):
    """``forward(crops)``: normalized crops (B, 3, H, W) float32 -> heatmaps
    (B, K, H/4, W/4) float32."""

    def __init__(self, cfg: dict, num_joints: int = 17):
        super().__init__()
        self.backbone = _Backbone(cfg)
        cin = cfg["embed"] * 2 ** (len(cfg["depths"]) - 1)
        self.head = _Head(cin, cfg["deconv"], num_joints)

    def forward(self, x):
        return self.head(self.backbone(x).permute(0, 3, 1, 2))
