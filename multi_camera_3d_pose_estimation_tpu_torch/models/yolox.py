"""YOLOX person detector: CSPDarknet + PAFPN + decoupled head (torch, NCHW).

Counterpart of the JAX package's ``models/yolox.py`` (the reference's named
``yolox-tiny``): Focus stem (space-to-depth x2 in the order top-left,
bottom-left, top-right, bottom-right, then a 3x3 ConvModule), CSPDarknet P5
stages of DarknetBottleneck CSP layers with an SPP bottleneck in stage 4, the
YOLOX PAFPN neck with 1x1 out convs, and the decoupled anchor-free head (two
stacked ConvModules per branch, 1x1 cls/reg/obj per stride-8/16/32 level).
Widths are ``max(int(c·widen), 8)``, a floor, where CSPNeXt rounds.

``forward`` fuses the MMDet box decode: centre ``(reg_xy + grid)·s``, size
``exp(clip(reg_wh, -20, 9))·s``, score ``sigmoid(obj)·sigmoid(cls[person])``;
it returns ``{"boxes_all" (B, N, 4), "scores_all" (B, N), "raw": per level
(cls, reg, obj) f32 NHWC views}``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .rtmdet import STRIDES, prior_grid, upsample2
from .rtmpose import ConvModule, SPPBottleneck, _depth

__all__ = ["YOLOX", "CSPDarknet", "YOLOXPAFPN", "YOLOXHead", "DarknetBottleneck",
           "DarknetCSPLayer", "YOLOX_TINY", "YOLOX_S"]

YOLOX_TINY = {"widen": 0.375, "deepen": 0.33, "num_classes": 80}
YOLOX_S = {"widen": 0.5, "deepen": 0.33, "num_classes": 80}

# CSPDarknet P5 arch: (out_channels, num_blocks, add_identity, use_spp)
_DARKNET_P5 = ((128, 3, True, False), (256, 9, True, False),
               (512, 9, True, False), (1024, 3, False, True))


def _width(c: int, widen: float) -> int:
    return max(int(c * widen), 8)


class DarknetBottleneck(nn.Module):
    """1x1 ConvModule -> 3x3 ConvModule (+ identity)."""

    def __init__(self, cin: int, cout: int, add_identity: bool = True, dtype=torch.bfloat16):
        super().__init__()
        self.conv1 = ConvModule(cin, cout, 1, dtype=dtype)
        self.conv2 = ConvModule(cout, cout, 3, dtype=dtype)
        self.identity = add_identity and cin == cout

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return y + x if self.identity else y


class DarknetCSPLayer(nn.Module):
    """CSP layer of DarknetBottleneck blocks (no channel attention)."""

    def __init__(self, cin: int, cout: int, num_blocks: int, add_identity: bool = True,
                 dtype=torch.bfloat16):
        super().__init__()
        mid = cout // 2
        self.main_conv = ConvModule(cin, mid, 1, dtype=dtype)
        self.short_conv = ConvModule(cin, mid, 1, dtype=dtype)
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"blocks_{i}", DarknetBottleneck(mid, mid, add_identity, dtype))
        self.final_conv = ConvModule(2 * mid, cout, 1, dtype=dtype)

    def forward(self, x):
        main = self.main_conv(x)
        for i in range(self.num_blocks):
            main = getattr(self, f"blocks_{i}")(main)
        return self.final_conv(torch.cat([main, self.short_conv(x)], dim=1))


class CSPDarknet(nn.Module):
    """CSPDarknet-P5; returns the stride-8/16/32 maps."""

    def __init__(self, widen: float = 0.375, deepen: float = 0.33, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        w = lambda c: _width(c, widen)  # noqa: E731
        self.stem_conv = ConvModule(12, w(64), 3, dtype=dtype)
        cin = w(64)
        for s, (ch, nb, add_id, use_spp) in enumerate(_DARKNET_P5, start=1):
            self.add_module(f"stage{s}_down", ConvModule(cin, w(ch), 3, 2, dtype=dtype))
            if use_spp:
                self.add_module(f"stage{s}_spp", SPPBottleneck(w(ch), w(ch), dtype))
            self.add_module(f"stage{s}_csp", DarknetCSPLayer(w(ch), w(ch), _depth(nb, deepen),
                                                             add_id, dtype))
            cin = w(ch)

    def forward(self, x):
        x = x.to(self.dtype)
        # Focus: space-to-depth x2, channels in the order tl, bl, tr, br.
        x = torch.cat([x[:, :, ::2, ::2], x[:, :, 1::2, ::2], x[:, :, ::2, 1::2],
                       x[:, :, 1::2, 1::2]], dim=1)
        x = self.stem_conv(x.contiguous(memory_format=torch.channels_last))
        outs = []
        for s, spec in enumerate(_DARKNET_P5, start=1):
            x = getattr(self, f"stage{s}_down")(x)
            if spec[3]:
                x = getattr(self, f"stage{s}_spp")(x)
            x = getattr(self, f"stage{s}_csp")(x)
            if s >= 2:
                outs.append(x)
        return outs


class YOLOXPAFPN(nn.Module):
    """YOLOX PAFPN neck: top-down then bottom-up CSP fusion, 1x1 out convs."""

    def __init__(self, widen: float = 0.375, deepen: float = 0.33, dtype=torch.bfloat16):
        super().__init__()
        c3, c4, c5 = (_width(c, widen) for c in (256, 512, 1024))
        nb = _depth(3, deepen)

        def csp(cin, cout):
            return DarknetCSPLayer(cin, cout, nb, add_identity=False, dtype=dtype)

        self.reduce_0 = ConvModule(c5, c4, 1, dtype=dtype)
        self.top_down_0 = csp(2 * c4, c4)
        self.reduce_1 = ConvModule(c4, c3, 1, dtype=dtype)
        self.top_down_1 = csp(2 * c3, c3)
        self.downsample_0 = ConvModule(c3, c3, 3, 2, dtype=dtype)
        self.bottom_up_0 = csp(2 * c3, c4)
        self.downsample_1 = ConvModule(c4, c4, 3, 2, dtype=dtype)
        self.bottom_up_1 = csp(2 * c4, c5)
        for i, cin in enumerate((c3, c4, c5)):
            self.add_module(f"out_{i}", ConvModule(cin, c3, 1, dtype=dtype))

    def forward(self, feats):
        c3, c4, c5 = feats
        p5 = self.reduce_0(c5)
        p4 = self.reduce_1(self.top_down_0(torch.cat([upsample2(p5), c4], dim=1)))
        p3 = self.top_down_1(torch.cat([upsample2(p4), c3], dim=1))
        n4 = self.bottom_up_0(torch.cat([self.downsample_0(p3), p4], dim=1))
        n5 = self.bottom_up_1(torch.cat([self.downsample_1(n4), p5], dim=1))
        return [self.out_0(p3), self.out_1(n4), self.out_2(n5)]


class YOLOXHead(nn.Module):
    """Decoupled anchor-free head: per level cls/reg/obj predictions."""

    def __init__(self, widen: float = 0.375, num_classes: int = 80, stacked_convs: int = 2,
                 dtype=torch.bfloat16):
        super().__init__()
        ch = _width(256, widen)
        self.stacked_convs, self.dtype = stacked_convs, dtype
        for lvl in range(len(STRIDES)):
            for i in range(stacked_convs):
                for br in ("cls", "reg"):
                    self.add_module(f"{br}_convs_{lvl}_{i}", ConvModule(ch, ch, 3, dtype=dtype))
            self.add_module(f"conv_cls_{lvl}", nn.Conv2d(ch, num_classes, 1))
            self.add_module(f"conv_reg_{lvl}", nn.Conv2d(ch, 4, 1))
            self.add_module(f"conv_obj_{lvl}", nn.Conv2d(ch, 1, 1))

    def _pred(self, x, name: str):
        conv = getattr(self, name)
        return F.conv2d(x, conv.weight.to(self.dtype), conv.bias.to(self.dtype)).float()

    def forward(self, feats):
        outs = []
        for lvl, x in enumerate(feats):
            c, r = x, x
            for i in range(self.stacked_convs):
                c = getattr(self, f"cls_convs_{lvl}_{i}")(c)
                r = getattr(self, f"reg_convs_{lvl}_{i}")(r)
            outs.append((self._pred(c, f"conv_cls_{lvl}"), self._pred(r, f"conv_reg_{lvl}"),
                         self._pred(r, f"conv_obj_{lvl}")))
        return outs


class YOLOX(nn.Module):
    """Full YOLOX detector; ``forward(x)`` on frames (B, 3, H, W) (H, W
    multiples of 32) = backbone, neck, head and the fused box decode."""

    def __init__(self, widen: float = 0.375, deepen: float = 0.33, num_classes: int = 80,
                 person_class: int = 0, dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        self.person_class, self.dtype = person_class, dtype
        self.backbone = CSPDarknet(widen, deepen, dtype)
        self.neck = YOLOXPAFPN(widen, deepen, dtype)
        self.head = YOLOXHead(widen, num_classes, dtype=dtype)
        self.to(device=device, memory_format=torch.channels_last)

    def forward(self, x) -> dict:
        level_outs = self.head(self.neck(self.backbone(x)))
        boxes, scores, raw = [], [], []
        for (cls, reg, obj), stride in zip(level_outs, STRIDES):
            B, _, h, w = reg.shape
            reg_l = reg.permute(0, 2, 3, 1)  # (B, h, w, 4)
            grid = torch.stack(prior_grid(h, w, reg.device), dim=-1)  # (h, w, 2) xy
            cxy = (reg_l[..., :2] + grid) * float(stride)
            half = torch.exp(torch.clamp(reg_l[..., 2:], -20.0, 9.0)) * float(stride) * 0.5
            boxes.append(torch.cat([cxy - half, cxy + half], dim=-1).reshape(B, h * w, 4))
            scores.append((torch.sigmoid(obj[:, 0]) * torch.sigmoid(cls[:, self.person_class]))
                          .reshape(B, h * w))
            raw.append((cls.permute(0, 2, 3, 1), reg_l, obj.permute(0, 2, 3, 1)))
        return {"boxes_all": torch.cat(boxes, dim=1), "scores_all": torch.cat(scores, dim=1),
                "raw": raw}
