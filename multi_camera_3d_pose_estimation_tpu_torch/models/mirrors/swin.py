"""Torch Swin with MMPose's module registration (a copy of the JAX
package's ``models/mirrors/swin.py``).

Its ``state_dict()`` has the names and the order of an MMPose Swin
heatmap checkpoint: patch_embed -> stages[i].blocks[j] {norm1, attn.w_msa,
norm2, ffn} -> stages[i].downsample -> norm{last} -> head.deconv_layers ->
final_layer.  The structure follows the public MMPose Swin backbone (the
mmdet-lineage implementation: feature maps padded right/bottom to window
multiples, shift and region mask always, nn.Unfold channel-major patch
merging) and HeatmapHead (3 x [deconv 4s2, BN, ReLU], then a 1x1 conv).
Its forward is the second implementation that `models.checkpoint_verify`
compares the port's model with, stage by stage.  One change from the JAX
package's copy: the shift mask is built on the input's device, so that the
mirror runs on the card too.
"""

from __future__ import annotations

import torch
import torch.nn as nn


def _rel_position_index(w: int) -> torch.Tensor:
    coords = torch.stack(
        torch.meshgrid(torch.arange(w), torch.arange(w), indexing="ij")
    )
    flat = coords.flatten(1)  # (2, w²)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += w - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    return rel.sum(-1)  # (w², w²)


class WindowMSA(nn.Module):
    """Per-window MSA with relative position bias (mmcv WindowMSA)."""

    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.dim = dim
        self.heads = heads
        self.window = window
        self.scale = (dim // heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads)
        )
        self.register_buffer(
            "relative_position_index", _rel_position_index(window)
        )
        self.qkv = nn.Linear(dim, dim * 3, bias=True)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        B_, N, C = x.shape
        qkv = (
            self.qkv(x)
            .reshape(B_, N, 3, self.heads, C // self.heads)
            .permute(2, 0, 3, 1, 4)
        )
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = (q * self.scale) @ k.transpose(-2, -1)
        bias = self.relative_position_bias_table[
            self.relative_position_index.view(-1)
        ].view(N, N, -1)
        attn = attn + bias.permute(2, 0, 1).unsqueeze(0)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.view(B_ // nw, nw, self.heads, N, N) + mask[
                None, :, None
            ]
            attn = attn.view(-1, self.heads, N, N)
        attn = attn.softmax(dim=-1)
        x = (attn @ v).transpose(1, 2).reshape(B_, N, C)
        return self.proj(x)


class ShiftWindowMSA(nn.Module):
    """Pad → (roll) → window partition → WindowMSA → reverse → crop."""

    def __init__(self, dim: int, heads: int, window: int, shift: int):
        super().__init__()
        self.window = window
        self.shift = shift
        self.w_msa = WindowMSA(dim, heads, window)

    def forward(self, x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
        B, L, C = x.shape
        H, W = hw
        win, shift = self.window, self.shift
        x = x.view(B, H, W, C)
        pad_r = (win - W % win) % win
        pad_b = (win - H % win) % win
        x = nn.functional.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r

        mask = None
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            img = torch.zeros((Hp, Wp), device=x.device)
            cnt = 0
            for hs in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
                for ws in (
                    slice(0, -win),
                    slice(-win, -shift),
                    slice(-shift, None),
                ):
                    img[hs, ws] = cnt
                    cnt += 1
            m = img.view(Hp // win, win, Wp // win, win)
            m = m.permute(0, 2, 1, 3).reshape(-1, win * win)
            mask = torch.where(m[:, None, :] != m[:, :, None], -100.0, 0.0)

        # partition
        x = x.view(B, Hp // win, win, Wp // win, win, C)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, win * win, C)
        x = self.w_msa(x, mask)
        # reverse
        x = x.view(B, Hp // win, Wp // win, win, win, C)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        return x[:, :H, :W, :].reshape(B, H * W, C)


class FFN(nn.Module):
    """mmcv FFN layout: layers.0.0 Linear → GELU → layers.1 Linear."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Sequential(nn.Linear(dim, hidden), nn.GELU(), nn.Dropout(0.0)),
            nn.Linear(hidden, dim),
            nn.Dropout(0.0),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int, ratio: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = ShiftWindowMSA(dim, heads, window, shift)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.ffn = FFN(dim, ratio * dim)

    def forward(self, x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), hw)
        return x + self.ffn(self.norm2(x))


class PatchMerging(nn.Module):
    """nn.Unfold(2,2) channel-major concat → LN(4C) → Linear(4C→2C)."""

    def __init__(self, dim: int):
        super().__init__()
        self.sampler = nn.Unfold(kernel_size=2, stride=2)
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor, hw: tuple[int, int]):
        B, L, C = x.shape
        H, W = hw
        x = x.view(B, H, W, C).permute(0, 3, 1, 2)  # B C H W
        x = self.sampler(x)  # (B, 4C, L/4), channel-major (c·4 + dy·2 + dx)
        x = x.transpose(1, 2)  # (B, L/4, 4C)
        return self.reduction(self.norm(x)), (H // 2, W // 2)


class SwinBlockSequence(nn.Module):
    def __init__(self, dim, depth, heads, window, ratio, downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList(
            [
                SwinBlock(dim, heads, window, (window // 2) if j % 2 else 0, ratio)
                for j in range(depth)
            ]
        )
        self.downsample = PatchMerging(dim) if downsample else None

    def forward(self, x, hw):
        for blk in self.blocks:
            x = blk(x, hw)
        if self.downsample is not None:
            down, hw_down = self.downsample(x, hw)
            return down, hw_down, x, hw
        return x, hw, x, hw


class MMPoseSwinBackbone(nn.Module):
    """MMPose SwinTransformer, out_indices=(3,): returns 1/32 LN'd map."""

    def __init__(self, cfg: dict):
        super().__init__()
        embed = cfg["embed"]
        self.patch_embed = nn.Module()
        self.patch_embed.projection = nn.Conv2d(3, embed, 4, stride=4)
        self.patch_embed.norm = nn.LayerNorm(embed, eps=1e-5)
        depths = cfg["depths"]
        heads = cfg["heads"]
        ratio = cfg.get("mlp_ratio", 4)
        self.stages = nn.ModuleList()
        dim = embed
        for i, depth in enumerate(depths):
            self.stages.append(
                SwinBlockSequence(
                    dim, depth, heads[i], cfg["window"], ratio,
                    downsample=i < len(depths) - 1,
                )
            )
            if i < len(depths) - 1:
                dim *= 2
        # MMPose names the out_indices norm `norm{stage_index}` — norm3
        # for the production 4-stage cfgs, norm1 for 2-stage test cfgs.
        self._out_norm_name = f"norm{len(depths) - 1}"
        setattr(self, self._out_norm_name, nn.LayerNorm(dim, eps=1e-5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed.projection(x)  # B C H/4 W/4
        B, C, H, W = x.shape
        x = x.flatten(2).transpose(1, 2)  # B L C
        x = self.patch_embed.norm(x)
        hw = (H, W)
        out, out_hw = x, hw
        for stage in self.stages:
            x, hw, out, out_hw = stage(x, hw)
        out = getattr(self, self._out_norm_name)(out)
        return out.view(B, *out_hw, -1).permute(0, 3, 1, 2)  # B C H W


class HeatmapHead(nn.Module):
    """MMPose HeatmapHead: [ConvTranspose2d(4,2,1) BN ReLU]×n + 1×1 conv."""

    def __init__(self, in_ch: int, deconv: tuple, num_joints: int):
        super().__init__()
        layers = []
        for ch in deconv:
            layers += [
                nn.ConvTranspose2d(in_ch, ch, 4, stride=2, padding=1, bias=False),
                nn.BatchNorm2d(ch),
                nn.ReLU(inplace=True),
            ]
            in_ch = ch
        self.deconv_layers = nn.Sequential(*layers)
        self.final_layer = nn.Conv2d(in_ch, num_joints, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.final_layer(self.deconv_layers(x))


class MMPoseSwin(nn.Module):
    """backbone + head registered in MMPose's top-level order."""

    def __init__(self, cfg: dict, num_joints: int = 17):
        super().__init__()
        self.backbone = MMPoseSwinBackbone(cfg)
        final_dim = cfg["embed"] * 2 ** (len(cfg["depths"]) - 1)
        self.head = HeatmapHead(final_dim, cfg["deconv"], num_joints)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.backbone(x))


def randomize_(model: nn.Module, seed: int = 0) -> None:
    """Non-degenerate random weights incl. BN running stats (var > 0)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                m.weight.normal_(0, 0.05, generator=g)
                if m.bias is not None:
                    m.bias.normal_(0, 0.05, generator=g)
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0, 0.1, generator=g)
                m.running_mean.normal_(0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
            elif isinstance(m, nn.LayerNorm):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0, 0.1, generator=g)
            elif isinstance(m, WindowMSA):
                m.relative_position_bias_table.normal_(0, 0.5, generator=g)
