"""HRNet top-down heatmap model in plain PyTorch, float32, with MMPose's
module names (``backbone.layer1.0.conv1``, ``backbone.stage3.2.fuse_layers
.1.0.0.0``, ``head.final_layer``), so that a state dict in MMPose's
checkpoint format loads into it with ``strict=True``.

The architecture is MMPose's ``HRNet`` backbone with ``HeatmapHead``
(``deconv_out_channels=None``: one 1x1 conv), as in
``td-hm_hrnet-w32_8xb64-210e_coco-256x192.py``: a stride-4 stem of two
3x3 convs, stage 1 of four Bottlenecks (expansion 4, the first with a 1x1
downsample), stages 2-4 of HRModules (four BasicBlocks per branch, then
every branch fused into every output: 1x1 conv + BN + nearest upsample
from a lower resolution, chains of stride-2 3x3 conv + BN (+ ReLU but the
last) from a higher one, ReLU of the sum), the last module of stage 4
fusing into branch 0 only.  Every BatchNorm is applied as written, from
its running statistics, after its conv: nothing is folded.

``rounding.model`` (see `lowp`) is applied to both operands of every
convolution; the exact reference leaves them in float32.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .lowp import EXACT

__all__ = ["HRNetRef"]


class _Conv(nn.Conv2d):
    """``nn.Conv2d`` whose operands pass through the model's rounding."""

    rounding = EXACT

    def forward(self, x):
        r = self.rounding.model
        b = None if self.bias is None else r(self.bias)
        return F.conv2d(r(x), r(self.weight), b, self.stride, self.padding)


def _conv(cin, cout, k, stride=1, bias=False):
    return _Conv(cin, cout, k, stride, padding=k // 2, bias=bias)


def _bn(c):
    return nn.BatchNorm2d(c, eps=1e-5)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int = 64):
        super().__init__()
        out = planes * 4
        self.conv1, self.bn1 = _conv(cin, planes, 1), _bn(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3), _bn(planes)
        self.conv3, self.bn3 = _conv(planes, out, 1), _bn(out)
        self.downsample = (nn.Sequential(_conv(cin, out, 1), _bn(out)) if cin != out else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class BasicBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1, self.bn1 = _conv(c, c, 3), _bn(c)
        self.conv2, self.bn2 = _conv(c, c, 3), _bn(c)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(y)) + x)


class HRModule(nn.Module):
    def __init__(self, widths, num_blocks: int, multiscale_output: bool):
        super().__init__()
        n = len(widths)
        self.branches = nn.ModuleList(
            nn.Sequential(*[BasicBlock(w) for _ in range(num_blocks)]) for w in widths)
        self.fuse_layers = nn.ModuleList()
        for i in range(n if multiscale_output else 1):
            row = nn.ModuleList()
            for j in range(n):
                if j > i:
                    row.append(nn.Sequential(_conv(widths[j], widths[i], 1), _bn(widths[i]),
                                             nn.Upsample(scale_factor=2 ** (j - i),
                                                         mode="nearest")))
                elif j == i:
                    row.append(nn.Identity())
                else:
                    steps = []
                    for k in range(i - j):
                        last = k == i - j - 1
                        cout = widths[i] if last else widths[j]
                        layers = [_conv(widths[j], cout, 3, 2), _bn(cout)]
                        if not last:
                            layers.append(nn.ReLU())
                        steps.append(nn.Sequential(*layers))
                    row.append(nn.Sequential(*steps))
            self.fuse_layers.append(row)

    def forward(self, xs):
        xs = [branch(x) for branch, x in zip(self.branches, xs)]
        outs = []
        for row in self.fuse_layers:
            acc = None
            for j, layer in enumerate(row):
                y = layer(xs[j])
                acc = y if acc is None else acc + y
            outs.append(F.relu(acc))
        return outs


class _Backbone(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        widths, modules, stem = cfg["widths"], cfg["modules"], cfg["stem"]
        blocks = cfg.get("blocks", (4, 4, 4, 4))
        self.conv1, self.bn1 = _conv(3, stem, 3, 2), _bn(stem)
        self.conv2, self.bn2 = _conv(stem, stem, 3, 2), _bn(stem)
        self.layer1 = nn.Sequential(*[Bottleneck(stem if i == 0 else 256, 64)
                                      for i in range(blocks[0])])
        self.transition1 = nn.ModuleList([
            nn.Sequential(_conv(256, widths[0], 3), _bn(widths[0]), nn.ReLU()),
            nn.Sequential(nn.Sequential(_conv(256, widths[1], 3, 2), _bn(widths[1]), nn.ReLU())),
        ])
        for s in (2, 3, 4):
            n_br = s
            if s > 2:
                trans = nn.ModuleList([nn.Identity() for _ in range(n_br - 1)])
                trans.append(nn.Sequential(nn.Sequential(
                    _conv(widths[n_br - 2], widths[n_br - 1], 3, 2), _bn(widths[n_br - 1]),
                    nn.ReLU())))
                setattr(self, f"transition{s - 1}", trans)
            n_mod = modules[s - 1]
            stage = nn.Sequential(*[
                HRModule(widths[:n_br], blocks[s - 1],
                         multiscale_output=not (s == 4 and m == n_mod - 1))
                for m in range(n_mod)])
            setattr(self, f"stage{s}", stage)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = self.layer1(x)
        xs = [t(x) for t in self.transition1]
        for s in (2, 3, 4):
            if s > 2:
                trans = getattr(self, f"transition{s - 1}")
                xs = [trans[i](x) for i, x in enumerate(xs)] + [trans[-1](xs[-1])]
            for module in getattr(self, f"stage{s}"):
                xs = module(xs)
        return xs[0]


class _Head(nn.Module):
    def __init__(self, cin: int, num_joints: int):
        super().__init__()
        self.final_layer = _conv(cin, num_joints, 1, bias=True)

    def forward(self, x):
        return self.final_layer(x)


class HRNetRef(nn.Module):
    """``forward(crops)``: normalized crops (B, 3, H, W) float32 -> heatmaps
    (B, K, H/4, W/4) float32."""

    def __init__(self, cfg: dict, num_joints: int = 17):
        super().__init__()
        self.backbone = _Backbone(cfg)
        self.head = _Head(cfg["widths"][0], num_joints)

    def forward(self, x):
        return self.head(self.backbone(x))
