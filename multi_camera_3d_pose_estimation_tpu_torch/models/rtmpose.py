"""RTMPose SimCC pose model and the CSPNeXt building blocks (torch, NCHW).

Counterpart of the JAX package's ``models/rtmpose.py``: the CSPNeXt P5
backbone (3-conv stem, CSP stages of CSPNeXt blocks with hard-sigmoid
channel attention, SPP in stage 4) and the RTMCC head (7x7 conv -> ScaleNorm
+ Dense token embedding -> one Gated Attention Unit -> x/y bin classifiers).
The RTMDet and YOLOX detectors (`models.rtmdet`, `models.yolox`) are built
from the same blocks.

Numerics follow the flax modules: convs and Dense layers in the compute
dtype ``dtype`` (bf16 by default) on f32 parameters, BatchNorm
(`models.batchnorm`) applied in f32 and cast back, the channel attention's pooled mean and 1x1
``fc`` in f32, ScaleNorm in f32, the GAU's q·k and attention·v summed in f32.
Submodules carry the flax names (``stem_0``, ``stage2_csp``, ``blocks_0``,
``conv``/``bn``, ``gau``, ...) so a flax variables tree maps onto the
``state_dict`` mechanically (`models.convert`).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .batchnorm import BatchNorm, batch_norm

__all__ = ["RTMPose", "CSPNeXt", "ConvModule", "DepthwiseSeparableConv", "ChannelAttention",
           "CSPNeXtBlock", "CSPLayer", "SPPBottleneck", "ScaleNorm", "GAU",
           "cspnext_width", "RTMPOSE_T", "RTMPOSE_S", "RTMPOSE_M"]

# widen_factor / deepen_factor per RTMPose flavor
RTMPOSE_T = {"widen": 0.375, "deepen": 0.167, "embed": 256}
RTMPOSE_S = {"widen": 0.5, "deepen": 0.33, "embed": 256}
RTMPOSE_M = {"widen": 0.75, "deepen": 0.67, "embed": 256}

# CSPNeXt P5 arch: (out_channels, num_blocks, add_identity, use_spp)
_P5 = ((128, 3, True, False), (256, 6, True, False),
       (512, 6, True, False), (1024, 3, False, True))


def cspnext_width(c: int, widen: float) -> int:
    """CSPNeXt's channel count: ``max(round(c·widen), 8)`` (Python's round)."""
    return max(int(round(c * widen)), 8)


def _depth(n: int, deepen: float) -> int:
    return max(int(round(n * deepen)), 1)


class ConvModule(nn.Module):
    """conv (no bias, symmetric k//2 padding) -> BatchNorm -> SiLU?"""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1, groups: int = 1,
                 act: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, kernel // 2, groups=groups, bias=False)
        self.bn = BatchNorm(cout)
        self.act, self.dtype = act, dtype

    def forward(self, x):
        c = self.conv
        y = batch_norm(F.conv2d(x, c.weight.to(self.dtype), None, c.stride, c.padding, 1,
                                c.groups), self.bn, self.dtype)
        return F.silu(y) if self.act else y


class DepthwiseSeparableConv(nn.Module):
    """depthwise k x k ConvModule + pointwise 1x1 ConvModule."""

    def __init__(self, cin: int, cout: int, kernel: int = 5, dtype=torch.bfloat16):
        super().__init__()
        self.depthwise_conv = ConvModule(cin, cin, kernel, groups=cin, dtype=dtype)
        self.pointwise_conv = ConvModule(cin, cout, 1, dtype=dtype)

    def forward(self, x):
        return self.pointwise_conv(self.depthwise_conv(x))


class ChannelAttention(nn.Module):
    """Global mean (f32) -> 1x1 ``fc`` with bias (f32) -> hard sigmoid
    ``clip(g + 3, 0, 6) / 6``, cast to the activations' dtype, times x."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc = nn.Conv2d(channels, channels, 1, bias=True)

    def forward(self, x):
        g = x.float().mean((2, 3))
        # A 1x1 conv on a pooled vector is a product; F.linear keeps it f32
        # on the card (cuDNN may run an f32 conv in TF32).
        g = F.linear(g, self.fc.weight[:, :, 0, 0], self.fc.bias)
        gate = torch.clamp(g + 3.0, 0.0, 6.0) / 6.0
        return x * gate.to(x.dtype)[:, :, None, None]


class CSPNeXtBlock(nn.Module):
    """3x3 ConvModule -> 5x5 depthwise-separable ConvModule (+ identity)."""

    def __init__(self, cin: int, cout: int, add_identity: bool = True, dtype=torch.bfloat16):
        super().__init__()
        self.conv1 = ConvModule(cin, cout, 3, dtype=dtype)
        self.conv2 = DepthwiseSeparableConv(cout, cout, 5, dtype=dtype)
        self.identity = add_identity and cin == cout

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return y + x if self.identity else y


class CSPLayer(nn.Module):
    """Cross-stage partial layer: the main path through the blocks, concat
    (main, short), channel attention (optional), final 1x1."""

    def __init__(self, cin: int, cout: int, num_blocks: int, add_identity: bool = True,
                 use_attention: bool = True, dtype=torch.bfloat16):
        super().__init__()
        mid = cout // 2
        self.main_conv = ConvModule(cin, mid, 1, dtype=dtype)
        self.short_conv = ConvModule(cin, mid, 1, dtype=dtype)
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"blocks_{i}", CSPNeXtBlock(mid, mid, add_identity, dtype))
        if use_attention:
            self.attention = ChannelAttention(2 * mid)
        self.final_conv = ConvModule(2 * mid, cout, 1, dtype=dtype)

    def forward(self, x):
        main = self.main_conv(x)
        for i in range(self.num_blocks):
            main = getattr(self, f"blocks_{i}")(main)
        y = torch.cat([main, self.short_conv(x)], dim=1)
        if hasattr(self, "attention"):
            y = self.attention(y)
        return self.final_conv(y)


class SPPBottleneck(nn.Module):
    """Spatial pyramid pooling (max pools 5/9/13, stride 1, -inf padding)."""

    def __init__(self, cin: int, cout: int, dtype=torch.bfloat16):
        super().__init__()
        mid = cin // 2
        self.conv1 = ConvModule(cin, mid, 1, dtype=dtype)
        self.conv2 = ConvModule(4 * mid, cout, 1, dtype=dtype)

    def forward(self, x):
        x = self.conv1(x)
        pools = [F.max_pool2d(x, k, 1, k // 2) for k in (5, 9, 13)]
        return self.conv2(torch.cat([x] + pools, dim=1))


class CSPNeXt(nn.Module):
    """CSPNeXt-P5 backbone; ``forward`` returns the final 1/32 map."""

    def __init__(self, widen: float = 0.375, deepen: float = 0.167, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        w = lambda c: cspnext_width(c, widen)  # noqa: E731
        self.stem_0 = ConvModule(3, w(64) // 2, 3, 2, dtype=dtype)
        self.stem_1 = ConvModule(w(64) // 2, w(64) // 2, 3, dtype=dtype)
        self.stem_2 = ConvModule(w(64) // 2, w(64), 3, dtype=dtype)
        cin = w(64)
        for s, (ch, nb, add_id, use_spp) in enumerate(_P5, start=1):
            self.add_module(f"stage{s}_down", ConvModule(cin, w(ch), 3, 2, dtype=dtype))
            if use_spp:
                self.add_module(f"stage{s}_spp", SPPBottleneck(w(ch), w(ch), dtype))
            self.add_module(f"stage{s}_csp", CSPLayer(w(ch), w(ch), _depth(nb, deepen), add_id,
                                                      dtype=dtype))
            cin = w(ch)
        self.out_channels = cin

    def stage_outputs(self, x) -> list:
        """The four stages' outputs, strides 4, 8, 16 and 32."""
        x = self.stem_2(self.stem_1(self.stem_0(x.to(self.dtype))))
        outs = []
        for s, spec in enumerate(_P5, start=1):
            x = getattr(self, f"stage{s}_down")(x)
            if spec[3]:
                x = getattr(self, f"stage{s}_spp")(x)
            x = getattr(self, f"stage{s}_csp")(x)
            outs.append(x)
        return outs

    def forward(self, x):
        return self.stage_outputs(x)[-1]


class ScaleNorm(nn.Module):
    """x / max(‖x‖₂·d^-½, eps) · g in f32 (scalar gain g), cast to ``dtype``."""

    def __init__(self, dtype=torch.bfloat16, eps: float = 1e-5):
        super().__init__()
        self.g = nn.Parameter(torch.ones(1))
        self.dtype, self.eps = dtype, eps

    def forward(self, x):
        x32 = x.float()
        norm = x32.square().sum(-1, keepdim=True).sqrt() * (x.shape[-1] ** -0.5)
        return (x32 / torch.clamp(norm, min=self.eps) * self.g).to(self.dtype)


class GAU(nn.Module):
    """Gated Attention Unit over the joint axis: ScaleNorm -> uv (no bias)
    -> SiLU -> q, k = base·γ + β -> relu(q·kᵀ/√s)² -> u ⊙ (attn·v) -> o ->
    residual ``x·res_scale + out``."""

    def __init__(self, embed: int = 256, expansion: int = 2, s: int = 128, dtype=torch.bfloat16):
        super().__init__()
        e = embed * expansion
        self.e, self.s, self.dtype = e, s, dtype
        self.ln = ScaleNorm(dtype)
        self.uv = nn.Linear(embed, 2 * e + s, bias=False)
        self.gamma = nn.Parameter(torch.zeros(2, s))
        self.beta = nn.Parameter(torch.zeros(2, s))
        self.o = nn.Linear(e, embed, bias=False)
        self.res_scale = nn.Parameter(torch.ones(embed))

    def forward(self, x):  # (B, K, embed)
        dt = self.dtype
        uv = F.silu(F.linear(self.ln(x), self.uv.weight.to(dt)))
        u, v, base = torch.split(uv, [self.e, self.e, self.s], dim=-1)
        gamma, beta = self.gamma.to(dt), self.beta.to(dt)
        q = base * gamma[0] + beta[0]
        k = base * gamma[1] + beta[1]
        qk = torch.matmul(q.float(), k.float().transpose(-1, -2))  # bf16 products, f32 sums
        attn = torch.relu(qk / math.sqrt(self.s)) ** 2
        out = u * torch.matmul(attn.to(dt).float(), v.float()).to(dt)
        out = F.linear(out, self.o.weight.to(dt))
        return x * self.res_scale.to(dt) + out


class RTMPose(nn.Module):
    """SimCC pose model: crops (B, 3, H, W) normalized float, any memory
    format -> (simcc_x (B, K, Wx), simcc_y (B, K, Wy)) f32 logits with
    Wx, Wy = input_size · simcc_split_ratio.  ``input_size`` is (w, h)."""

    def __init__(self, num_joints: int = 17, input_size=(192, 256),
                 simcc_split_ratio: float = 2.0, cfg=None, dtype=torch.bfloat16, device="cuda"):
        super().__init__()
        cfg = cfg or RTMPOSE_T
        self.cfg, self.num_joints, self.dtype = cfg, num_joints, dtype
        self.input_size = tuple(input_size)
        self.backbone = CSPNeXt(cfg["widen"], cfg["deepen"], dtype)
        hf, wf = input_size[1], input_size[0]
        for _ in range(5):  # five stride-2 convs with k//2 padding: ceil(n / 2) each
            hf, wf = (hf + 1) // 2, (wf + 1) // 2
        self.final_layer = nn.Conv2d(self.backbone.out_channels, num_joints, 7, padding=3)
        self.mlp_ln = ScaleNorm(dtype)
        self.mlp_fc = nn.Linear(hf * wf, cfg["embed"], bias=False)
        self.gau = GAU(cfg["embed"], dtype=dtype)
        self.cls_x = nn.Linear(cfg["embed"], int(input_size[0] * simcc_split_ratio), bias=False)
        self.cls_y = nn.Linear(cfg["embed"], int(input_size[1] * simcc_split_ratio), bias=False)
        self.to(device=device, memory_format=torch.channels_last).eval()

    def forward(self, x):
        dt = self.dtype
        feats = self.backbone(x.contiguous(memory_format=torch.channels_last))
        fl = self.final_layer
        y = F.conv2d(feats, fl.weight.to(dt), fl.bias.to(dt), padding=3)  # (B, K, h, w)
        # Tokens in h·W + w order: the flax (B, h, w, K) map flattened, K first.
        y = self.mlp_ln(y.reshape(y.shape[0], self.num_joints, -1))
        y = self.gau(F.linear(y, self.mlp_fc.weight.to(dt)))
        return (F.linear(y, self.cls_x.weight.to(dt)).float(),
                F.linear(y, self.cls_y.weight.to(dt)).float())
