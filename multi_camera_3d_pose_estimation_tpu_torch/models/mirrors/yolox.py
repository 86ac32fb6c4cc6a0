"""Torch YOLOX with MMDetection naming (a copy of the JAX package's
``models/mirrors/yolox.py``).

Its ``state_dict()`` has the names and layout of an MMDetection YOLOX
checkpoint, independently of the port's module names; its forward is
MMDet's ``YOLOXHead._bbox_decode`` (priors offset 0, exp size decode), on
the input's device.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .rtmpose import ConvModule, SPPBottleneck, randomize_  # noqa: F401

# CSPDarknet P5 arch: (in, out, num_blocks, add_identity, use_spp) base.
_DARKNET_P5 = ((64, 128, 3, True, False), (128, 256, 9, True, False),
               (256, 512, 9, True, False), (512, 1024, 3, False, True))


class DarknetBottleneck(nn.Module):
    def __init__(self, cin, cout, add_identity=True):
        super().__init__()
        self.conv1 = ConvModule(cin, cout, 1)
        self.conv2 = ConvModule(cout, cout, 3)
        self.add_identity = add_identity and cin == cout

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return y + x if self.add_identity else y


class CSPLayer(nn.Module):
    """mmdet CSPLayer with DarknetBottleneck blocks, no attention."""

    def __init__(self, cin, cout, num_blocks, add_identity=True):
        super().__init__()
        mid = cout // 2
        self.main_conv = ConvModule(cin, mid, 1)
        self.short_conv = ConvModule(cin, mid, 1)
        self.final_conv = ConvModule(2 * mid, cout, 1)
        self.blocks = nn.Sequential(
            *[DarknetBottleneck(mid, mid, add_identity) for _ in range(num_blocks)]
        )

    def forward(self, x):
        main = self.blocks(self.main_conv(x))
        return self.final_conv(torch.cat([main, self.short_conv(x)], dim=1))


class Focus(nn.Module):
    def __init__(self, cin, cout, k=3):
        super().__init__()
        self.conv = ConvModule(cin * 4, cout, k)

    def forward(self, x):
        tl = x[..., ::2, ::2]
        bl = x[..., 1::2, ::2]
        tr = x[..., ::2, 1::2]
        br = x[..., 1::2, 1::2]
        return self.conv(torch.cat([tl, bl, tr, br], dim=1))


class CSPDarknet(nn.Module):
    def __init__(self, widen=0.375, deepen=0.33):
        super().__init__()

        def w(c):
            return max(int(c * widen), 8)

        def d(n):
            return max(round(n * deepen), 1)

        self.stem = Focus(3, w(64), 3)
        for s, (cin, cout, nb, add_id, use_spp) in enumerate(_DARKNET_P5, start=1):
            layers = [ConvModule(w(cin), w(cout), 3, stride=2)]
            if use_spp:
                layers.append(SPPBottleneck(w(cout), w(cout)))
            layers.append(CSPLayer(w(cout), w(cout), d(nb), add_id))
            setattr(self, f"stage{s}", nn.Sequential(*layers))

    def forward(self, x):
        x = self.stem(x)
        outs = []
        for s in range(1, 5):
            x = getattr(self, f"stage{s}")(x)
            if s >= 2:
                outs.append(x)
        return outs


class YOLOXPAFPN(nn.Module):
    def __init__(self, widen=0.375, deepen=0.33):
        super().__init__()

        def w(c):
            return max(int(c * widen), 8)

        nb = max(round(3 * deepen), 1)
        self.upsample = nn.Upsample(scale_factor=2, mode="nearest")
        self.reduce_layers = nn.ModuleList([
            ConvModule(w(1024), w(512), 1),
            ConvModule(w(512), w(256), 1),
        ])
        self.top_down_blocks = nn.ModuleList([
            CSPLayer(w(1024), w(512), nb, add_identity=False),
            CSPLayer(w(512), w(256), nb, add_identity=False),
        ])
        self.downsamples = nn.ModuleList([
            ConvModule(w(256), w(256), 3, stride=2),
            ConvModule(w(512), w(512), 3, stride=2),
        ])
        self.bottom_up_blocks = nn.ModuleList([
            CSPLayer(w(512), w(512), nb, add_identity=False),
            CSPLayer(w(1024), w(1024), nb, add_identity=False),
        ])
        self.out_convs = nn.ModuleList([
            ConvModule(w(256), w(256), 1),
            ConvModule(w(512), w(256), 1),
            ConvModule(w(1024), w(256), 1),
        ])

    def forward(self, inputs):
        # mmdet YOLOXPAFPN.forward, verbatim control flow.
        inner_outs = [inputs[-1]]
        for idx in range(len(inputs) - 1, 0, -1):
            feat_high = self.reduce_layers[len(inputs) - 1 - idx](inner_outs[0])
            inner_outs[0] = feat_high
            inner = self.top_down_blocks[len(inputs) - 1 - idx](
                torch.cat([self.upsample(feat_high), inputs[idx - 1]], dim=1)
            )
            inner_outs.insert(0, inner)
        outs = [inner_outs[0]]
        for idx in range(len(inputs) - 1):
            out = self.bottom_up_blocks[idx](
                torch.cat([self.downsamples[idx](outs[-1]), inner_outs[idx + 1]],
                          dim=1)
            )
            outs.append(out)
        return [conv(o) for conv, o in zip(self.out_convs, outs)]


class YOLOXHead(nn.Module):
    def __init__(self, widen=0.375, num_classes=80, stacked_convs=2, levels=3):
        super().__init__()
        feat = max(int(256 * widen), 8)

        def branch():
            return nn.Sequential(
                *[ConvModule(feat, feat, 3) for _ in range(stacked_convs)]
            )

        self.multi_level_cls_convs = nn.ModuleList([branch() for _ in range(levels)])
        self.multi_level_reg_convs = nn.ModuleList([branch() for _ in range(levels)])
        self.multi_level_conv_cls = nn.ModuleList(
            [nn.Conv2d(feat, num_classes, 1) for _ in range(levels)]
        )
        self.multi_level_conv_reg = nn.ModuleList(
            [nn.Conv2d(feat, 4, 1) for _ in range(levels)]
        )
        self.multi_level_conv_obj = nn.ModuleList(
            [nn.Conv2d(feat, 1, 1) for _ in range(levels)]
        )

    def forward(self, feats):
        outs = []
        for i, x in enumerate(feats):
            cls_feat = self.multi_level_cls_convs[i](x)
            reg_feat = self.multi_level_reg_convs[i](x)
            outs.append((
                self.multi_level_conv_cls[i](cls_feat),
                self.multi_level_conv_reg[i](reg_feat),
                self.multi_level_conv_obj[i](reg_feat),
            ))
        return outs


class MMDetYOLOX(nn.Module):
    """backbone/neck/bbox_head naming = the MMDet checkpoint surface."""

    def __init__(self, cfg=None, person_class: int = 0):
        super().__init__()
        cfg = cfg or {"widen": 0.375, "deepen": 0.33, "num_classes": 80}
        self.backbone = CSPDarknet(cfg["widen"], cfg["deepen"])
        self.neck = YOLOXPAFPN(cfg["widen"], cfg["deepen"])
        self.bbox_head = YOLOXHead(cfg["widen"], cfg["num_classes"])
        self.person_class = person_class

    def forward(self, x):
        """Returns (boxes_all (B,N,4) xyxy, scores_all (B,N)) — the MMDet
        YOLOXHead._bbox_decode on flattened levels (priors offset 0)."""
        level_outs = self.bbox_head(self.neck(self.backbone(x)))
        boxes, scores = [], []
        for (cls, reg, obj), stride in zip(level_outs, (8, 16, 32)):
            B, _, h, w = reg.shape
            gy, gx = torch.meshgrid(
                torch.arange(h, dtype=torch.float32, device=reg.device),
                torch.arange(w, dtype=torch.float32, device=reg.device), indexing="ij",
            )
            grid = torch.stack([gx, gy], dim=-1)  # (h, w, 2) xy
            reg = reg.permute(0, 2, 3, 1)  # (B, h, w, 4)
            cxy = (reg[..., :2] + grid) * stride
            wh = torch.exp(torch.clamp(reg[..., 2:], -20.0, 9.0)) * stride
            half = wh * 0.5
            b = torch.cat([cxy - half, cxy + half], dim=-1)
            s = (torch.sigmoid(obj[:, 0])
                 * torch.sigmoid(cls[:, self.person_class]))
            boxes.append(b.reshape(B, h * w, 4))
            scores.append(s.reshape(B, h * w))
        return torch.cat(boxes, dim=1), torch.cat(scores, dim=1)
