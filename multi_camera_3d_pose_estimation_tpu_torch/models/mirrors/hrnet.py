"""Torch HRNet with MMPose's module registration (a copy of the JAX
package's ``models/mirrors/hrnet.py``).

Its ``state_dict()`` has the names and the order of an MMPose HRNet
checkpoint: stem -> ``layer1`` -> ``transition1`` -> ``stage2`` ->
``transition2`` -> ``stage3`` -> ``transition3`` -> ``stage4`` ->
``final_layer`` (the public mmpose/mmcv HRNet backbone and HeatmapHead),
independently of the port's module names.  The forward is MMPose's
(float32, eager), the second implementation that `models.checkpoint_verify`
compares the port's model with, stage by stage.
"""

from __future__ import annotations

import torch
import torch.nn as nn


def conv3x3(cin, cout, stride=1):
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, downsample=None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = conv3x3(planes, planes)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        residual = self.downsample(x) if self.downsample is not None else x
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + residual)


class BasicBlock(nn.Module):
    def __init__(self, planes):
        super().__init__()
        self.conv1 = conv3x3(planes, planes)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = conv3x3(planes, planes)
        self.bn2 = nn.BatchNorm2d(planes)
        self.relu = nn.ReLU(inplace=True)

    def forward(self, x):
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return self.relu(y + x)


class HRModule(nn.Module):
    """Branches of BasicBlocks + MMPose-ordered fuse layers."""

    def __init__(self, widths, num_blocks=4, multiscale_output=True):
        super().__init__()
        n = len(widths)
        self.num_branches = n
        self.multiscale_output = multiscale_output
        self.branches = nn.ModuleList(
            [nn.Sequential(*[BasicBlock(w) for _ in range(num_blocks)]) for w in widths]
        )
        fuse_layers = []
        for i in range(n if multiscale_output else 1):
            layer = []
            for j in range(n):
                if j > i:
                    layer.append(
                        nn.Sequential(
                            nn.Conv2d(widths[j], widths[i], 1, bias=False),
                            nn.BatchNorm2d(widths[i]),
                            nn.Upsample(scale_factor=2 ** (j - i), mode="nearest"),
                        )
                    )
                elif j == i:
                    layer.append(None)
                else:
                    downs = []
                    for k in range(i - j):
                        last = k == i - j - 1
                        cout = widths[i] if last else widths[j]
                        mods = [conv3x3(widths[j], cout, 2), nn.BatchNorm2d(cout)]
                        if not last:
                            mods.append(nn.ReLU(inplace=True))
                        downs.append(nn.Sequential(*mods))
                    layer.append(nn.Sequential(*downs))
            fuse_layers.append(nn.ModuleList(layer))
        self.fuse_layers = nn.ModuleList(fuse_layers)
        self.relu = nn.ReLU(inplace=False)

    def forward(self, xs):
        xs = [branch(x) for branch, x in zip(self.branches, xs)]
        outs = []
        for i, layer in enumerate(self.fuse_layers):
            acc = None
            for j in range(self.num_branches):
                y = xs[j] if layer[j] is None else layer[j](xs[j])
                acc = y if acc is None else acc + y
            outs.append(self.relu(acc))
        return outs


class MMPoseHRNet(nn.Module):
    """Top-down heatmap HRNet: state-dict order == MMPose registration order."""

    def __init__(self, cfg, num_joints=17):
        super().__init__()
        widths = list(cfg["widths"])
        modules = cfg["modules"]
        stem = cfg["stem"]

        self.conv1 = conv3x3(3, stem, 2)
        self.bn1 = nn.BatchNorm2d(stem)
        self.conv2 = conv3x3(stem, stem, 2)
        self.bn2 = nn.BatchNorm2d(stem)
        self.relu = nn.ReLU(inplace=True)

        downsample = nn.Sequential(
            nn.Conv2d(stem, 256, 1, bias=False), nn.BatchNorm2d(256)
        )
        self.layer1 = nn.Sequential(
            Bottleneck(stem, 64, downsample),
            *[Bottleneck(256, 64) for _ in range(3)],
        )

        self.transition1 = nn.ModuleList(
            [
                nn.Sequential(
                    conv3x3(256, widths[0]), nn.BatchNorm2d(widths[0]), nn.ReLU(True)
                ),
                nn.Sequential(
                    nn.Sequential(
                        conv3x3(256, widths[1], 2),
                        nn.BatchNorm2d(widths[1]),
                        nn.ReLU(True),
                    )
                ),
            ]
        )
        self.stage2 = nn.Sequential(
            *[HRModule(widths[:2]) for _ in range(modules[1])]
        )

        self.transition2 = nn.ModuleList(
            [
                None,
                None,
                nn.Sequential(
                    nn.Sequential(
                        conv3x3(widths[1], widths[2], 2),
                        nn.BatchNorm2d(widths[2]),
                        nn.ReLU(True),
                    )
                ),
            ]
        )
        self.stage3 = nn.Sequential(
            *[HRModule(widths[:3]) for _ in range(modules[2])]
        )

        self.transition3 = nn.ModuleList(
            [
                None,
                None,
                None,
                nn.Sequential(
                    nn.Sequential(
                        conv3x3(widths[2], widths[3], 2),
                        nn.BatchNorm2d(widths[3]),
                        nn.ReLU(True),
                    )
                ),
            ]
        )
        self.stage4 = nn.Sequential(
            *[
                HRModule(widths[:4], multiscale_output=(m < modules[3] - 1))
                for m in range(modules[3])
            ]
        )

        self.final_layer = nn.Conv2d(widths[0], num_joints, 1)

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.relu(self.bn2(self.conv2(x)))
        x = self.layer1(x)
        xs = [self.transition1[0](x), self.transition1[1](x)]
        xs = self.stage2(xs)
        xs = xs + [self.transition2[2](xs[-1])]
        xs = self.stage3(xs)
        xs = xs + [self.transition3[3](xs[-1])]
        xs = self.stage4(xs)
        return self.final_layer(xs[0])


def randomize_(model: nn.Module, seed: int = 0) -> None:
    """Non-degenerate random weights incl. BN running stats (var > 0)."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            with torch.no_grad():
                m.weight.normal_(0, 0.05, generator=g)
                if m.bias is not None:
                    m.bias.normal_(0, 0.05, generator=g)
        elif isinstance(m, nn.BatchNorm2d):
            with torch.no_grad():
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0, 0.1, generator=g)
                m.running_mean.normal_(0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
