"""Torch RTMPose with MMPose/MMDet naming (a copy of the JAX package's
``models/mirrors/rtmpose.py``).

Its ``state_dict()`` has the names and layout of an MMPose RTMPose
checkpoint (MMDet's CSPNeXt backbone, MMPose's RTMCC head), independently
of the port's module names; its forward is the second implementation that
`models.checkpoint_verify` compares the port's model with.
"""

from __future__ import annotations

import torch
import torch.nn as nn

_P5 = ((128, 3, True, False), (256, 6, True, False),
       (512, 6, True, False), (1024, 3, False, True))


class ConvModule(nn.Module):
    def __init__(self, cin, cout, k=3, stride=1, groups=1, act=True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride, padding=k // 2, groups=groups,
                              bias=False)
        self.bn = nn.BatchNorm2d(cout)
        self.activate = nn.SiLU(inplace=True) if act else nn.Identity()

    def forward(self, x):
        return self.activate(self.bn(self.conv(x)))


class DepthwiseSeparableConvModule(nn.Module):
    def __init__(self, cin, cout, k=5):
        super().__init__()
        self.depthwise_conv = ConvModule(cin, cin, k, groups=cin)
        self.pointwise_conv = ConvModule(cin, cout, 1)

    def forward(self, x):
        return self.pointwise_conv(self.depthwise_conv(x))


class CSPNeXtBlock(nn.Module):
    def __init__(self, channels, add_identity=True):
        super().__init__()
        self.conv1 = ConvModule(channels, channels, 3)
        self.conv2 = DepthwiseSeparableConvModule(channels, channels, 5)
        self.add_identity = add_identity

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return y + x if self.add_identity else y


class ChannelAttention(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.global_avgpool = nn.AdaptiveAvgPool2d(1)
        self.fc = nn.Conv2d(channels, channels, 1, bias=True)
        self.act = nn.Hardsigmoid(inplace=True)

    def forward(self, x):
        return x * self.act(self.fc(self.global_avgpool(x)))


class CSPLayer(nn.Module):
    """mmdet CSPLayer registration order: main, short, final, blocks, attention."""

    def __init__(self, cin, cout, num_blocks, add_identity=True):
        super().__init__()
        mid = cout // 2
        self.main_conv = ConvModule(cin, mid, 1)
        self.short_conv = ConvModule(cin, mid, 1)
        self.final_conv = ConvModule(2 * mid, cout, 1)
        self.blocks = nn.Sequential(
            *[CSPNeXtBlock(mid, add_identity) for _ in range(num_blocks)]
        )
        self.attention = ChannelAttention(2 * mid)

    def forward(self, x):
        short = self.short_conv(x)
        main = self.blocks(self.main_conv(x))
        y = torch.cat((main, short), dim=1)
        y = self.attention(y)
        return self.final_conv(y)


class SPPBottleneck(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        mid = cin // 2
        self.conv1 = ConvModule(cin, mid, 1)
        self.poolings = nn.ModuleList(
            [nn.MaxPool2d(k, stride=1, padding=k // 2) for k in (5, 9, 13)]
        )
        self.conv2 = ConvModule(mid * 4, cout, 1)

    def forward(self, x):
        x = self.conv1(x)
        outs = [x] + [p(x) for p in self.poolings]
        return self.conv2(torch.cat(outs, dim=1))


class CSPNeXt(nn.Module):
    def __init__(self, widen=0.375, deepen=0.167):
        super().__init__()

        def w(c):
            return max(int(round(c * widen)), 8)

        def d(n):
            return max(int(round(n * deepen)), 1)

        self.stem = nn.Sequential(
            ConvModule(3, w(64) // 2, 3, 2),
            ConvModule(w(64) // 2, w(64) // 2, 3, 1),
            ConvModule(w(64) // 2, w(64), 3, 1),
        )
        cin = w(64)
        for s, (ch, nb, add_id, use_spp) in enumerate(_P5, start=1):
            cout = w(ch)
            mods = [ConvModule(cin, cout, 3, 2)]
            if use_spp:
                mods.append(SPPBottleneck(cout, cout))
            mods.append(CSPLayer(cout, cout, d(nb), add_id))
            self.add_module(f"stage{s}", nn.Sequential(*mods))
            cin = cout
        self.out_channels = cin

    def forward(self, x):
        x = self.stem(x)
        for s in range(1, 5):
            x = getattr(self, f"stage{s}")(x)
        return x


class ScaleNorm(nn.Module):
    def __init__(self, dim, eps=1e-5):
        super().__init__()
        self.scale = dim ** -0.5
        self.eps = eps
        self.g = nn.Parameter(torch.ones(1))

    def forward(self, x):
        norm = torch.norm(x, dim=-1, keepdim=True) * self.scale
        return x / norm.clamp(min=self.eps) * self.g


class Scale(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.scale


class RTMCCBlock(nn.Module):
    """GAU, mmpose registration order: o, uv, gamma, beta, ln, res_scale."""

    def __init__(self, dim, expansion=2, s=128):
        super().__init__()
        self.e = dim * expansion
        self.s = s
        self.o = nn.Linear(self.e, dim, bias=False)
        self.uv = nn.Linear(dim, 2 * self.e + s, bias=False)
        self.gamma = nn.Parameter(torch.rand(2, s))
        self.beta = nn.Parameter(torch.rand(2, s))
        self.ln = ScaleNorm(dim)
        self.res_scale = Scale(dim)
        self.act_fn = nn.SiLU(inplace=True)
        self.sqrt_s = s ** 0.5

    def forward(self, x):
        res = x
        x = self.ln(x)
        uv = self.act_fn(self.uv(x))
        u, v, base = torch.split(uv, [self.e, self.e, self.s], dim=-1)
        q = base * self.gamma[0] + self.beta[0]
        k = base * self.gamma[1] + self.beta[1]
        qk = torch.bmm(q, k.transpose(1, 2))
        kernel = torch.square(torch.relu(qk / self.sqrt_s))
        x = u * torch.bmm(kernel, v)
        return self.res_scale(res) + self.o(x)


class RTMCCHead(nn.Module):
    def __init__(self, in_channels, num_joints, flatten_dims, embed, wx, wy):
        super().__init__()
        self.final_layer = nn.Conv2d(in_channels, num_joints, 7, padding=3)
        self.mlp = nn.Sequential(
            ScaleNorm(flatten_dims), nn.Linear(flatten_dims, embed, bias=False)
        )
        self.gau = RTMCCBlock(embed)
        self.cls_x = nn.Linear(embed, wx, bias=False)
        self.cls_y = nn.Linear(embed, wy, bias=False)

    def forward(self, feats):
        y = self.final_layer(feats)          # (B, K, H, W)
        y = torch.flatten(y, 2)              # (B, K, H*W)
        y = self.mlp(y)
        y = self.gau(y)
        return self.cls_x(y), self.cls_y(y)


class MMPoseRTMPose(nn.Module):
    def __init__(self, cfg, input_size=(192, 256), num_joints=17, split_ratio=2.0):
        super().__init__()
        self.backbone = CSPNeXt(cfg["widen"], cfg["deepen"])
        w_in, h_in = input_size
        flatten_dims = (h_in // 32) * (w_in // 32)
        self.head = RTMCCHead(
            self.backbone.out_channels, num_joints, flatten_dims, cfg["embed"],
            int(w_in * split_ratio), int(h_in * split_ratio),
        )

    def forward(self, x):
        return self.head(self.backbone(x))


def randomize_(model: nn.Module, seed: int = 0) -> None:
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.weight.normal_(0, 0.05, generator=g)
                if m.bias is not None:
                    m.bias.normal_(0, 0.05, generator=g)
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0, 0.1, generator=g)
                m.running_mean.normal_(0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
            elif isinstance(m, ScaleNorm):
                m.g.uniform_(0.5, 1.5, generator=g)
            elif isinstance(m, Scale):
                m.scale.uniform_(0.5, 1.5, generator=g)
            elif isinstance(m, RTMCCBlock):
                m.gamma.uniform_(-1, 1, generator=g)
                m.beta.normal_(0, 0.1, generator=g)
