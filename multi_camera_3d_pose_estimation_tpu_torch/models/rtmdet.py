"""RTMDet person detector: CSPNeXt + CSPNeXtPAFPN + SepBN head (torch, NCHW).

Counterpart of the JAX package's ``models/rtmdet.py``, the reference's
primary named detector (``coco_base`` = RTMDet-m, person only):

- the CSPNeXt backbone of `models.rtmpose`, tapping the stride-8/16/32 maps;
- the CSPNeXtPAFPN neck: YOLOX PAFPN control flow with CSPNeXt-block CSP
  layers, no channel attention, 3x3 out convs to a common width;
- the RTMDetSepBNHead: one 3x3 conv per stack index shared by all three
  levels, each level with its own BatchNorm (+SiLU), 1x1 ``rtm_cls`` /
  ``rtm_reg`` with bias per level;
- the fused decode: priors ``(gx·s, gy·s)``, box = prior ∓ relu(reg)·s as
  (l, t, r, b) distances, score ``sigmoid(cls[person_class])``, the levels
  concatenated in stride order 8, 16, 32.

``forward`` returns ``{"boxes_all" (B, N, 4) xyxy input px, "scores_all"
(B, N), "raw": per level (cls, reg) f32 NHWC views}``, the candidate
contract `models.detector.decode_top1` / `decode_topk` consume.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .batchnorm import BatchNorm, batch_norm
from .rtmpose import CSPNeXt, ConvModule, CSPLayer, cspnext_width

__all__ = ["RTMDet", "CSPNeXtDet", "CSPNeXtPAFPN", "RTMDetSepBNHead", "RTMDET_M",
           "RTMDET_TINY", "upsample2", "prior_grid"]

RTMDET_M = {"widen": 0.75, "deepen": 0.67, "num_classes": 1,
            "neck_out": 192, "num_csp_blocks": 2}
RTMDET_TINY = {"widen": 0.375, "deepen": 0.167, "num_classes": 1,
               "neck_out": 96, "num_csp_blocks": 1}

STRIDES = (8, 16, 32)


def upsample2(x):
    """2x nearest-neighbour upsample."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def prior_grid(h: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Prior points (offset 0) of an (h, w) level in cells: gx, gy (h, w) f32,
    as ``jnp.meshgrid(arange(w), arange(h))`` ("xy" indexing)."""
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return gx, gy


class CSPNeXtDet(CSPNeXt):
    """CSPNeXt-P5 with detection taps: returns the stride-8/16/32 maps."""

    def forward(self, x):
        return self.stage_outputs(x)[1:]


class CSPNeXtPAFPN(nn.Module):
    """CSPNeXt PAFPN neck: top-down then bottom-up CSP fusion (no channel
    attention), 3x3 out convs to ``out_features`` channels."""

    def __init__(self, widen: float = 0.75, num_csp_blocks: int = 2, out_features: int = 192,
                 dtype=torch.bfloat16):
        super().__init__()
        c3, c4, c5 = (cspnext_width(c, widen) for c in (256, 512, 1024))

        def csp(cin, cout):
            return CSPLayer(cin, cout, num_csp_blocks, add_identity=False, use_attention=False,
                            dtype=dtype)

        self.reduce_0 = ConvModule(c5, c4, 1, dtype=dtype)
        self.top_down_0 = csp(2 * c4, c4)
        self.reduce_1 = ConvModule(c4, c3, 1, dtype=dtype)
        self.top_down_1 = csp(2 * c3, c3)
        self.downsample_0 = ConvModule(c3, c3, 3, 2, dtype=dtype)
        self.bottom_up_0 = csp(2 * c3, c4)
        self.downsample_1 = ConvModule(c4, c4, 3, 2, dtype=dtype)
        self.bottom_up_1 = csp(2 * c4, c5)
        for i, cin in enumerate((c3, c4, c5)):
            self.add_module(f"out_{i}", ConvModule(cin, out_features, 3, dtype=dtype))

    def forward(self, feats):
        c3, c4, c5 = feats
        p5 = self.reduce_0(c5)
        p4 = self.reduce_1(self.top_down_0(torch.cat([upsample2(p5), c4], dim=1)))
        p3 = self.top_down_1(torch.cat([upsample2(p4), c3], dim=1))
        n4 = self.bottom_up_0(torch.cat([self.downsample_0(p3), p4], dim=1))
        n5 = self.bottom_up_1(torch.cat([self.downsample_1(n4), p5], dim=1))
        return [self.out_0(p3), self.out_1(n4), self.out_2(n5)]


class RTMDetSepBNHead(nn.Module):
    """Shared-conv / separate-BN head: ``cls_conv_i`` / ``reg_conv_i`` serve
    every level, ``cls_bn_{lvl}_{i}`` / ``reg_bn_{lvl}_{i}`` are per level."""

    def __init__(self, features: int = 192, num_classes: int = 1, stacked_convs: int = 2,
                 dtype=torch.bfloat16):
        super().__init__()
        self.stacked_convs, self.dtype = stacked_convs, dtype
        for i in range(stacked_convs):
            for br in ("cls", "reg"):
                self.add_module(f"{br}_conv_{i}",
                                nn.Conv2d(features, features, 3, padding=1, bias=False))
        for lvl in range(len(STRIDES)):
            for i in range(stacked_convs):
                for br in ("cls", "reg"):
                    self.add_module(f"{br}_bn_{lvl}_{i}", BatchNorm(features))
            self.add_module(f"rtm_cls_{lvl}", nn.Conv2d(features, num_classes, 1))
            self.add_module(f"rtm_reg_{lvl}", nn.Conv2d(features, 4, 1))

    def _branch(self, x, br: str, lvl: int):
        for i in range(self.stacked_convs):
            w = getattr(self, f"{br}_conv_{i}").weight.to(self.dtype)
            x = F.silu(batch_norm(F.conv2d(x, w, None, 1, 1), getattr(self, f"{br}_bn_{lvl}_{i}"),
                                  self.dtype))
        return x

    def forward(self, feats):
        outs = []
        for lvl, x in enumerate(feats):
            c, r = self._branch(x, "cls", lvl), self._branch(x, "reg", lvl)
            pc, pr = getattr(self, f"rtm_cls_{lvl}"), getattr(self, f"rtm_reg_{lvl}")
            cls = F.conv2d(c, pc.weight.to(self.dtype), pc.bias.to(self.dtype)).float()
            reg = F.conv2d(r, pr.weight.to(self.dtype), pr.bias.to(self.dtype)).float()
            outs.append((cls, reg))
        return outs


class RTMDet(nn.Module):
    """Full RTMDet detector; ``forward(x)`` on frames (B, 3, H, W) (H, W
    multiples of 32) = backbone, neck, head and the fused distance decode."""

    def __init__(self, widen: float = 0.75, deepen: float = 0.67, num_classes: int = 1,
                 num_csp_blocks: int = 2, neck_out: int = 192, person_class: int = 0,
                 dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        self.person_class, self.dtype = person_class, dtype
        self.backbone = CSPNeXtDet(widen, deepen, dtype)
        self.neck = CSPNeXtPAFPN(widen, num_csp_blocks, neck_out, dtype)
        self.head = RTMDetSepBNHead(neck_out, num_classes, dtype=dtype)
        self.to(device=device, memory_format=torch.channels_last).eval()

    def forward(self, x) -> dict:
        feats = self.neck(self.backbone(x.contiguous(memory_format=torch.channels_last)))
        level_outs = self.head(feats)
        boxes, scores, raw = [], [], []
        for (cls, reg), stride in zip(level_outs, STRIDES):
            B, _, h, w = reg.shape
            gx, gy = prior_grid(h, w, reg.device)
            px, py = gx * float(stride), gy * float(stride)
            dist = torch.relu(reg.permute(0, 2, 3, 1)) * float(stride)  # (B, h, w, 4) l,t,r,b
            b = torch.stack([px - dist[..., 0], py - dist[..., 1],
                             px + dist[..., 2], py + dist[..., 3]], dim=-1)
            boxes.append(b.reshape(B, h * w, 4))
            scores.append(torch.sigmoid(cls[:, self.person_class]).reshape(B, h * w))
            raw.append((cls.permute(0, 2, 3, 1), reg.permute(0, 2, 3, 1)))
        return {"boxes_all": torch.cat(boxes, dim=1), "scores_all": torch.cat(scores, dim=1),
                "raw": raw}
