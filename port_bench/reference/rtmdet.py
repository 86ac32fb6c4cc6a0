"""RTMDet, MMDetection's one-stage detector, in plain PyTorch, float32, with
MMDet's module names (``backbone.stage4.1.conv1``, ``neck.top_down_blocks.0
.blocks.1.conv2.depthwise_conv``, ``bbox_head.cls_convs.2.0.bn``,
``bbox_head.rtm_reg.1``), so that a state dict in MMDet's checkpoint format
loads into it with ``strict=True``: the person detector of MMPose's
``demo/mmdetection_cfg/rtmdet_m_640-8xb32_coco-person.py``, which builds on
MMDet's ``configs/rtmdet/rtmdet_m_8xb32-300e_coco.py``.

- The CSPNeXt-P5 backbone (``widen``, ``deepen``): a stride-2 stem of three
  3x3 ConvModules, then four stages of a stride-2 3x3 ConvModule, in stage
  4 an SPP bottleneck (max pools 5, 9, 13), and a CSP layer of
  CSPNeXtBlocks (3x3 ConvModule, then a 5x5 depthwise and a 1x1 pointwise
  ConvModule; the identity added in the backbone) whose two halves are
  joined by channel attention (global mean, 1x1 conv, hard sigmoid) ahead
  of the final 1x1 ConvModule.  Widths ``int(c · widen)``, blocks
  ``max(round(n · deepen), 1)``; the stride-8/16/32 maps go on.
- The CSPNeXtPAFPN neck: top-down (1x1 reduce, nearest 2x upsample,
  concatenate, CSP layer without attention or identity), bottom-up
  (stride-2 3x3 ConvModule, concatenate, CSP layer), a 3x3 ConvModule to
  ``neck_out`` channels at each level.
- ``RTMDetSepBNHead`` (``share_conv=True``): two 3x3 ConvModules per branch
  whose convs serve every level (MMDet rebinds the level > 0 convs to level
  0's, so the state dict names each kernel once per level, one tensor) and
  whose BatchNorms are per level, then per level a 1x1 ``rtm_cls`` and
  ``rtm_reg`` with bias.  Candidates at the priors of MMDet's
  ``MlvlPointGenerator(offset=0)``, (gx·s, gy·s) for strides s = 8, 16, 32
  in that order, x fastest; ``DistancePointBBoxCoder``: a box is the prior
  ∓ the (l, t, r, b) distances ``exp(reg) · s`` (``exp_on_reg``, which the
  m configuration takes from ``rtmdet_l``; RTMDet-tiny and -s, without it,
  would need a family of their own); the score ``sigmoid(cls)`` of the one
  class, person.
- ConvModule: conv without bias, BatchNorm (eps 1e-5) from its running
  statistics, SiLU.

The configuration (the detector's, under ``detector`` in a pose
configuration) gives ``widen``, ``deepen``, ``neck_out``,
``num_csp_blocks`` and ``num_classes``.  ``rounding.model``
(see `lowp`) is applied to both operands of every convolution; the exact
reference leaves them in float32.

`preprocess` is MMDet's published test pipeline in float32: a keep-ratio
resize to 640 on the long side (scale ``min(640 / long, 640 / short)``,
size ``int(side · scale + 0.5)``), bottom and right padding to 640x640 with
114, BGR order, mean (103.53, 116.28, 123.675), std (57.375, 57.12,
58.395).  `to_frame` takes candidate boxes back to the frame's pixels.

Departures from MMDet: the resize is ``F.interpolate``'s bilinear taps
(half-pixel centres, no antialiasing, as cv2's ``INTER_LINEAR``) in
float32, rounded half to even to uint8 values, where cv2 uses 11-bit
fixed-point weights, so a resized pixel may differ by one level; `to_frame`
clips to the frame after the rescale, where MMDet clips to the network
input's image shape before it; there is no score threshold, top-k or NMS
(the candidates are what a selection reads).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .lowp import EXACT

__all__ = ["RTMDetRef", "MODEL", "weight_kind", "calibrate", "preprocess", "to_frame",
           "INPUT_SIZE", "STRIDES"]

INPUT_SIZE = 640
PAD_VALUE = 114.0
MEAN_BGR = (103.53, 116.28, 123.675)
STD_BGR = (57.375, 57.12, 58.395)
STRIDES = (8, 16, 32)
# (in, out, blocks, identity in the blocks, SPP) of CSPNeXt-P5's stages.
_P5 = ((64, 128, 3, True, False), (128, 256, 6, True, False), (256, 512, 6, True, False),
       (512, 1024, 3, False, True))
# The distances, in strides, that rtm_reg's bias gives every candidate
# (drawn as their logs): zero-mean logs would give half of the sides under
# a stride.
REG_STRIDES = (2.0, 4.0)
# rtm_reg's kernel, N(0, REG_GAIN² / fan_in): the features' tails reach ten
# standard deviations, and exp of them gave top-1 boxes of 1 px to 77,000
# px at gain 1 (32 VGA frames on 4 seeds, calibrated); 0.25 gives 13-158 px.
REG_GAIN = 0.25
# Frames of the cell's first that set the BatchNorm statistics: each is a
# 640x640 forward of ~39 GFLOP (m) on the CPU.
CALIBRATION_IMAGES = 2


class _Conv(nn.Conv2d):
    """``nn.Conv2d`` whose operands pass through the model's rounding."""

    rounding = EXACT

    def forward(self, x):
        r = self.rounding.model
        b = None if self.bias is None else r(self.bias)
        return F.conv2d(r(x), r(self.weight), b, self.stride, self.padding, self.dilation,
                        self.groups)


class ConvModule(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, groups: int = 1):
        super().__init__()
        self.conv = _Conv(cin, cout, k, stride, padding=k // 2, groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class DepthwiseSeparableConvModule(nn.Module):
    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.depthwise_conv = ConvModule(cin, cin, k, groups=cin)
        self.pointwise_conv = ConvModule(cin, cout, 1)

    def forward(self, x):
        return self.pointwise_conv(self.depthwise_conv(x))


class CSPNeXtBlock(nn.Module):
    def __init__(self, c: int, add_identity: bool):
        super().__init__()
        self.conv1 = ConvModule(c, c, 3)
        self.conv2 = DepthwiseSeparableConvModule(c, c, 5)
        self.add_identity = add_identity

    def forward(self, x):
        y = self.conv2(self.conv1(x))
        return y + x if self.add_identity else y


class ChannelAttention(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.fc = _Conv(c, c, 1, bias=True)

    def forward(self, x):
        return x * F.hardsigmoid(self.fc(x.mean((2, 3), keepdim=True)))


class CSPLayer(nn.Module):
    def __init__(self, cin: int, cout: int, num_blocks: int, add_identity: bool,
                 attention: bool):
        super().__init__()
        mid = int(cout * 0.5)
        self.main_conv = ConvModule(cin, mid, 1)
        self.short_conv = ConvModule(cin, mid, 1)
        self.final_conv = ConvModule(2 * mid, cout, 1)
        self.blocks = nn.Sequential(*[CSPNeXtBlock(mid, add_identity)
                                      for _ in range(num_blocks)])
        if attention:
            self.attention = ChannelAttention(2 * mid)

    def forward(self, x):
        y = torch.cat([self.blocks(self.main_conv(x)), self.short_conv(x)], 1)
        if hasattr(self, "attention"):
            y = self.attention(y)
        return self.final_conv(y)


class SPPBottleneck(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        mid = cin // 2
        self.conv1 = ConvModule(cin, mid, 1)
        self.conv2 = ConvModule(4 * mid, cout, 1)

    def forward(self, x):
        x = self.conv1(x)
        pools = [F.max_pool2d(x, k, 1, k // 2) for k in (5, 9, 13)]
        return self.conv2(torch.cat([x] + pools, 1))


class CSPNeXt(nn.Module):
    """CSPNeXt-P5; ``forward`` returns the stride-8, 16 and 32 maps."""

    def __init__(self, widen: float, deepen: float):
        super().__init__()
        half, stem = int(64 * widen // 2), int(64 * widen)
        self.stem = nn.Sequential(ConvModule(3, half, 3, 2), ConvModule(half, half, 3),
                                  ConvModule(half, stem, 3))
        for i, (cin, cout, n, identity, spp) in enumerate(_P5):
            cin, cout = int(cin * widen), int(cout * widen)
            layers = [ConvModule(cin, cout, 3, 2)]
            if spp:
                layers.append(SPPBottleneck(cout, cout))
            layers.append(CSPLayer(cout, cout, max(round(n * deepen), 1), identity, True))
            self.add_module(f"stage{i + 1}", nn.Sequential(*layers))

    def forward(self, x):
        x = self.stem(x)
        outs = []
        for i in range(1, 5):
            x = getattr(self, f"stage{i}")(x)
            if i >= 2:
                outs.append(x)
        return outs


class CSPNeXtPAFPN(nn.Module):
    def __init__(self, channels: tuple, out: int, num_blocks: int):
        super().__init__()
        c3, c4, c5 = channels

        def csp(cin, cout):
            return CSPLayer(cin, cout, num_blocks, False, False)

        self.reduce_layers = nn.ModuleList([ConvModule(c5, c4, 1), ConvModule(c4, c3, 1)])
        self.top_down_blocks = nn.ModuleList([csp(2 * c4, c4), csp(2 * c3, c3)])
        self.downsamples = nn.ModuleList([ConvModule(c3, c3, 3, 2), ConvModule(c4, c4, 3, 2)])
        self.bottom_up_blocks = nn.ModuleList([csp(2 * c3, c4), csp(2 * c4, c5)])
        self.out_convs = nn.ModuleList([ConvModule(c, out, 3) for c in channels])

    def forward(self, feats):
        inner = [feats[-1]]
        for i, idx in enumerate(range(len(feats) - 1, 0, -1)):
            high = self.reduce_layers[i](inner[0])
            inner[0] = high
            up = F.interpolate(high, scale_factor=2, mode="nearest")
            inner.insert(0, self.top_down_blocks[i](torch.cat([up, feats[idx - 1]], 1)))
        outs = [inner[0]]
        for i in range(len(feats) - 1):
            down = self.downsamples[i](outs[-1])
            outs.append(self.bottom_up_blocks[i](torch.cat([down, inner[i + 1]], 1)))
        return [conv(o) for conv, o in zip(self.out_convs, outs)]


class RTMDetSepBNHead(nn.Module):
    def __init__(self, num_classes: int, feat: int, stacked: int = 2):
        super().__init__()
        self.cls_convs, self.reg_convs = nn.ModuleList(), nn.ModuleList()
        self.rtm_cls, self.rtm_reg = nn.ModuleList(), nn.ModuleList()
        for _ in STRIDES:
            self.cls_convs.append(nn.ModuleList([ConvModule(feat, feat, 3) for _ in range(stacked)]))
            self.reg_convs.append(nn.ModuleList([ConvModule(feat, feat, 3) for _ in range(stacked)]))
            self.rtm_cls.append(_Conv(feat, num_classes, 1))
            self.rtm_reg.append(_Conv(feat, 4, 1))
        for lvl in range(1, len(STRIDES)):  # share_conv
            for i in range(stacked):
                self.cls_convs[lvl][i].conv = self.cls_convs[0][i].conv
                self.reg_convs[lvl][i].conv = self.reg_convs[0][i].conv

    def forward(self, feats) -> list:
        """Per level (cls (B, classes, h, w), reg (B, 4, h, w)): the 1x1
        convs' outputs."""
        outs = []
        for lvl, x in enumerate(feats):
            c, r = x, x
            for layer in self.cls_convs[lvl]:
                c = layer(c)
            for layer in self.reg_convs[lvl]:
                r = layer(r)
            outs.append((self.rtm_cls[lvl](c), self.rtm_reg[lvl](r)))
        return outs


class RTMDetRef(nn.Module):
    """``forward(x)`` on normalized inputs (B, 3, H, W) (`preprocess`; H, W
    multiples of 32) -> (boxes (B, N, 4) xyxy in the input's pixels, scores
    (B, N)) of every candidate, the levels in stride order."""

    def __init__(self, cfg: dict):
        super().__init__()
        widen = cfg["widen"]
        self.backbone = CSPNeXt(widen, cfg["deepen"])
        self.neck = CSPNeXtPAFPN(tuple(int(c * widen) for c in (256, 512, 1024)),
                                 cfg["neck_out"], cfg["num_csp_blocks"])
        self.bbox_head = RTMDetSepBNHead(cfg["num_classes"], cfg["neck_out"])

    def levels(self, x) -> list:
        """The head's per-level (cls, reg), before the decode."""
        return self.bbox_head(self.neck(self.backbone(x)))

    def forward(self, x):
        boxes, scores = [], []
        for (cls, reg), s in zip(self.levels(x), STRIDES):
            B, _, h, w = reg.shape
            dist = reg.exp().permute(0, 2, 3, 1) * s
            gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=reg.device) * s,
                                    torch.arange(w, dtype=torch.float32, device=reg.device) * s,
                                    indexing="ij")
            b = torch.stack([gx - dist[..., 0], gy - dist[..., 1], gx + dist[..., 2],
                             gy + dist[..., 3]], -1)
            boxes.append(b.reshape(B, h * w, 4))
            scores.append(torch.sigmoid(cls[:, 0]).reshape(B, h * w))
        return torch.cat(boxes, 1), torch.cat(scores, 1)


MODEL = RTMDetRef


def weight_kind(key: str, module: nn.Module, param: torch.Tensor):
    """rtm_reg's bias U(log `REG_STRIDES`) and its kernel N(0, `REG_GAIN`² /
    fan_in); the shared rules for the rest."""
    if key.startswith("bbox_head.rtm_reg."):
        if key.endswith(".bias"):
            return ("uniform", tuple(math.log(v) for v in REG_STRIDES))
        return ("normal", REG_GAIN / math.sqrt(param[0].numel()))
    return None


def preprocess(frames_u8: torch.Tensor) -> tuple:
    """Frames (N, H, W, 3) uint8 RGB of one size -> (the network's input
    (N, 3, 640, 640) float32, the resize's scale (sx, sy)): MMDet's test
    pipeline, on the frames' device."""
    N, H, W, _ = frames_u8.shape
    s = min(INPUT_SIZE / max(H, W), INPUT_SIZE / min(H, W))
    w, h = int(W * s + 0.5), int(H * s + 0.5)
    img = frames_u8.permute(0, 3, 1, 2).float()
    if (h, w) != (H, W):
        img = F.interpolate(img, size=(h, w), mode="bilinear", align_corners=False)
        img = img.round().clamp(0.0, 255.0)
    x = img.new_full((N, 3, INPUT_SIZE, INPUT_SIZE), PAD_VALUE)
    x[:, :, :h, :w] = img
    mean = torch.tensor(MEAN_BGR, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(STD_BGR, device=x.device).view(1, 3, 1, 1)
    return (x.flip(1) - mean) / std, (w / W, h / H)


def to_frame(boxes: torch.Tensor, scale: tuple, frame_hw: tuple) -> torch.Tensor:
    """Boxes (..., 4) xyxy in the network input's pixels -> the frame's
    (H, W) pixels: over the resize's ``scale``, clipped to the frame."""
    sx, sy = scale
    H, W = frame_hw
    b = boxes / boxes.new_tensor([sx, sy, sx, sy])
    return torch.stack([b[..., 0].clamp(0, W), b[..., 1].clamp(0, H), b[..., 2].clamp(0, W),
                        b[..., 3].clamp(0, H)], -1)


@torch.no_grad()
def calibrate(model: RTMDetRef, state: dict, frames_u8: torch.Tensor, cfg: dict) -> None:
    """Set every BatchNorm's running statistics in ``state`` (in place) from
    one forward of ``model`` (holding ``state``) over the first
    `CALIBRATION_IMAGES` frames through `preprocess`: the drawn ones, near
    identity, times the mean square of the layer's input over all its
    channels (the variance) and its root (the mean), so that each layer's
    output has about unit RMS and the channels keep the draw's spread (a
    BatchNorm applied with the wrong statistics still changes the result).
    With the drawn statistics alone each SiLU layer shrinks the scale until
    the BatchNorms' shifts carry the activations and every candidate scores
    about sigmoid(bias)."""
    x, _ = preprocess(frames_u8[:CALIBRATION_IMAGES])
    names = {mod: name for name, mod in model.named_modules() if isinstance(mod, nn.BatchNorm2d)}

    def set_statistics(mod, args):
        ms = args[0].double().square().mean()
        name = names[mod]
        mod.running_var.copy_(state[f"{name}.running_var"].double() * ms)
        mod.running_mean.copy_(state[f"{name}.running_mean"].double() * ms.sqrt())

    hooks = [mod.register_forward_pre_hook(set_statistics) for mod in names]
    try:
        model(x)
    finally:
        for hook in hooks:
            hook.remove()
    for mod, name in names.items():
        state[f"{name}.running_var"].copy_(mod.running_var)
        state[f"{name}.running_mean"].copy_(mod.running_mean)
