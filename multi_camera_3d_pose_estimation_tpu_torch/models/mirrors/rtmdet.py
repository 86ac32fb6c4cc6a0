"""Torch RTMDet with MMDetection naming (a copy of the JAX package's
``models/mirrors/rtmdet.py``).

Its ``state_dict()`` has the names and layout of an MMDetection RTMDet
checkpoint (the reference's primary detector, rtmdet_m_640-8xb32_coco-person),
independently of the port's module names; its forward is the MMDet decode
(priors offset 0, ``relu(reg)·stride`` distance boxes, sigmoid class scores,
no objectness), on the input's device.

The SepBN head reproduces mmdet's ``share_conv=True`` aliasing: the conv
modules are built per level, then the level>0 convs are rebound to level
0's (RTMDetSepBNHead._init_layers), so the state dict carries one identical
copy of each shared kernel per level, which the converter checks and folds.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .rtmpose import CSPNeXt, ConvModule, randomize_  # noqa: F401
from .rtmpose import ChannelAttention, CSPNeXtBlock  # noqa: F401


class CSPLayerNoAttn(nn.Module):
    """mmdet CSPLayer with channel_attention=False (the neck variant) —
    no `attention` submodule is registered, so its keys are absent."""

    def __init__(self, cin, cout, num_blocks, add_identity=False):
        super().__init__()
        mid = cout // 2
        self.main_conv = ConvModule(cin, mid, 1)
        self.short_conv = ConvModule(cin, mid, 1)
        self.final_conv = ConvModule(2 * mid, cout, 1)
        self.blocks = nn.Sequential(
            *[CSPNeXtBlock(mid, add_identity) for _ in range(num_blocks)]
        )

    def forward(self, x):
        short = self.short_conv(x)
        main = self.blocks(self.main_conv(x))
        return self.final_conv(torch.cat((main, short), dim=1))


class CSPNeXtDet(CSPNeXt):
    """mirrors.rtmpose.CSPNeXt with detection out_indices (2, 3, 4)."""

    def forward(self, x):
        x = self.stem(x)
        outs = []
        for s in range(1, 5):
            x = getattr(self, f"stage{s}")(x)
            if s >= 2:
                outs.append(x)
        return outs


class CSPNeXtPAFPN(nn.Module):
    def __init__(self, widen=0.75, num_csp_blocks=2, out_channels=192):
        super().__init__()

        def w(c):
            return max(int(round(c * widen)), 8)

        nb = num_csp_blocks
        self.upsample = nn.Upsample(scale_factor=2, mode="nearest")
        self.reduce_layers = nn.ModuleList([
            ConvModule(w(1024), w(512), 1),
            ConvModule(w(512), w(256), 1),
        ])
        self.top_down_blocks = nn.ModuleList([
            CSPLayerNoAttn(w(1024), w(512), nb),
            CSPLayerNoAttn(w(512), w(256), nb),
        ])
        self.downsamples = nn.ModuleList([
            ConvModule(w(256), w(256), 3, stride=2),
            ConvModule(w(512), w(512), 3, stride=2),
        ])
        self.bottom_up_blocks = nn.ModuleList([
            CSPLayerNoAttn(w(512), w(512), nb),
            CSPLayerNoAttn(w(1024), w(1024), nb),
        ])
        self.out_convs = nn.ModuleList([
            ConvModule(w(256), out_channels, 3),
            ConvModule(w(512), out_channels, 3),
            ConvModule(w(1024), out_channels, 3),
        ])

    def forward(self, inputs):
        # mmdet CSPNeXtPAFPN.forward, verbatim control flow.
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


class RTMDetSepBNHead(nn.Module):
    def __init__(self, feat=192, num_classes=1, stacked_convs=2, levels=3,
                 share_conv=True):
        super().__init__()
        self.stacked_convs = stacked_convs
        self.cls_convs = nn.ModuleList()
        self.reg_convs = nn.ModuleList()
        self.rtm_cls = nn.ModuleList()
        self.rtm_reg = nn.ModuleList()
        for _n in range(levels):
            self.cls_convs.append(nn.ModuleList(
                [ConvModule(feat, feat, 3) for _ in range(stacked_convs)]
            ))
            self.reg_convs.append(nn.ModuleList(
                [ConvModule(feat, feat, 3) for _ in range(stacked_convs)]
            ))
            self.rtm_cls.append(nn.Conv2d(feat, num_classes, 1))
            self.rtm_reg.append(nn.Conv2d(feat, 4, 1))
        if share_conv:
            # RTMDetSepBNHead._init_layers: rebind level>0 convs to level 0
            # (BN stays per level).  The state dict then carries identical
            # copies of each shared kernel under every level's key.
            for n in range(levels):
                for i in range(stacked_convs):
                    self.cls_convs[n][i].conv = self.cls_convs[0][i].conv
                    self.reg_convs[n][i].conv = self.reg_convs[0][i].conv

    def forward(self, feats):
        outs = []
        for idx, x in enumerate(feats):
            cls_feat = x
            for layer in self.cls_convs[idx]:
                cls_feat = layer(cls_feat)
            reg_feat = x
            for layer in self.reg_convs[idx]:
                reg_feat = layer(reg_feat)
            outs.append((self.rtm_cls[idx](cls_feat),
                         self.rtm_reg[idx](reg_feat)))
        return outs


class MMDetRTMDet(nn.Module):
    """backbone/neck/bbox_head naming = the MMDet checkpoint surface."""

    def __init__(self, cfg=None, person_class: int = 0):
        super().__init__()
        cfg = cfg or {"widen": 0.75, "deepen": 0.67, "num_classes": 1,
                      "neck_out": 192, "num_csp_blocks": 2}
        self.backbone = CSPNeXtDet(cfg["widen"], cfg["deepen"])
        self.neck = CSPNeXtPAFPN(cfg["widen"], cfg["num_csp_blocks"],
                                 cfg["neck_out"])
        self.bbox_head = RTMDetSepBNHead(cfg["neck_out"], cfg["num_classes"])
        self.person_class = person_class

    def forward(self, x):
        """Returns (boxes_all (B,N,4) xyxy, scores_all (B,N)) — the MMDet
        RTMDet decode: priors offset 0, relu(reg)·stride distances."""
        level_outs = self.bbox_head(self.neck(self.backbone(x)))
        boxes, scores = [], []
        for (cls, reg), stride in zip(level_outs, (8, 16, 32)):
            B, _, h, w = reg.shape
            gy, gx = torch.meshgrid(
                torch.arange(h, dtype=torch.float32, device=reg.device) * stride,
                torch.arange(w, dtype=torch.float32, device=reg.device) * stride,
                indexing="ij",
            )
            dist = F.relu(reg.permute(0, 2, 3, 1)) * stride  # (B,h,w,4) ltrb
            b = torch.stack([
                gx - dist[..., 0], gy - dist[..., 1],
                gx + dist[..., 2], gy + dist[..., 3],
            ], dim=-1)
            s = torch.sigmoid(cls[:, self.person_class])
            boxes.append(b.reshape(B, h * w, 4))
            scores.append(s.reshape(B, h * w))
        return torch.cat(boxes, dim=1), torch.cat(scores, dim=1)
