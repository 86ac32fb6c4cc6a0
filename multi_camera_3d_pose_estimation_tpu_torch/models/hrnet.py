"""HRNet top-down heatmap pose model (torch, NCHW in channels_last).

Counterpart of the JAX package's ``models/hrnet.py``: same architecture,
same numerics (convs in the compute dtype, BatchNorm applied in f32 and
cast back (`models.batchnorm`: running statistics, or the batch's in train
mode; in eval mode on the card one epilogue kernel a ConvBN, with its ReLU
and the residual or fusion sum), the head's output cast to f32), and submodules named
after the flax auto-names (``ConvBN_0``, ``Bottleneck_2``, ``HRModule_1``,
``FuseLayer_0``, ``head``, ...) so a flax variables tree maps onto the
``state_dict`` mechanically (`models.convert`).  Parameters are f32; the
compute dtype is ``dtype`` (bf16 by default).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .batchnorm import BatchNorm, batch_norm_act

__all__ = ["HRNet", "HRNET_W32", "HRNET_W48", "ConvBN", "Bottleneck", "BasicBlock",
           "FuseLayer", "HRModule"]

# (channels per branch, modules per stage, stem width)
HRNET_W32 = {"widths": (32, 64, 128, 256), "modules": (1, 1, 4, 3), "stem": 64}
HRNET_W48 = {"widths": (48, 96, 192, 384), "modules": (1, 1, 4, 3), "stem": 64}


def conv2d(x: torch.Tensor, w: torch.Tensor, stride, padding) -> torch.Tensor:
    """``F.conv2d`` without bias in ``x``'s dtype.  On the CPU a bf16 conv
    runs in f32 on the same bf16 values and rounds its output to bf16 (as
    XLA does there): PyTorch's CPU bf16 convolution (oneDNN, in the 2.13 CPU
    build) returns wrong values, NaN or inf for a stride-2 3x3 conv of a
    width-2 map at batches of about 24 and more (test_tiny's stage 4 at
    32x64)."""
    if x.device.type == "cpu" and x.dtype == torch.bfloat16:
        return F.conv2d(x.float(), w.float(), None, stride, padding).to(torch.bfloat16)
    return F.conv2d(x, w, None, stride, padding)


class ConvBN(nn.Module):
    """Conv (no bias, symmetric k//2 padding) -> BatchNorm -> ReLU?"""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 act: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, cout, kernel, stride, padding=kernel // 2, bias=False)
        self.BatchNorm_0 = BatchNorm(cout)
        self.act = act
        self.dtype = dtype

    def forward(self, x, residual=None, upsample: int = 0, relu: bool | None = None):
        """The conv, then `batch_norm_act`'s epilogue: the BatchNorm, its
        result upsampled by ``2**upsample``, ``residual +`` that, and the
        ReLU (``relu``, by default ``act``)."""
        y = conv2d(x, self.Conv_0.weight.to(self.dtype), self.Conv_0.stride,
                   self.Conv_0.padding)
        return batch_norm_act(y, self.BatchNorm_0, self.dtype, residual=residual,
                              upsample=upsample, relu=self.act if relu is None else relu)


class Bottleneck(nn.Module):
    """ResNet bottleneck, expansion 4 (HRNet stage-1 block)."""

    def __init__(self, cin: int, features: int = 64, dtype=torch.bfloat16):
        super().__init__()
        out_ch = features * 4
        self.ConvBN_0 = ConvBN(cin, features, 1, dtype=dtype)
        self.ConvBN_1 = ConvBN(features, features, 3, dtype=dtype)
        self.ConvBN_2 = ConvBN(features, out_ch, 1, act=False, dtype=dtype)
        if cin != out_ch:
            self.ConvBN_3 = ConvBN(cin, out_ch, 1, act=False, dtype=dtype)

    def forward(self, x):
        y = self.ConvBN_2(self.ConvBN_1(self.ConvBN_0(x)))
        residual = self.ConvBN_3(x) if hasattr(self, "ConvBN_3") else x
        return torch.relu(y + residual)


class BasicBlock(nn.Module):
    """Two 3x3 convs with identity shortcut (HRNet branch block)."""

    def __init__(self, features: int, dtype=torch.bfloat16):
        super().__init__()
        self.ConvBN_0 = ConvBN(features, features, 3, dtype=dtype)
        self.ConvBN_1 = ConvBN(features, features, 3, act=False, dtype=dtype)

    def forward(self, x):
        return self.ConvBN_1(self.ConvBN_0(x), residual=x, relu=True)


class FuseLayer(nn.Module):
    """Full cross-resolution fusion: output branch i sums every input j,
    lower resolutions through 1x1 ConvBN + nearest upsample, higher ones
    through a chain of stride-2 3x3 ConvBNs.  ``out_branches`` limits the
    outputs (the last stage-4 module fuses into branch 0 only)."""

    def __init__(self, widths: Sequence[int], out_branches: int | None = None,
                 dtype=torch.bfloat16):
        super().__init__()
        n = len(widths)
        self.n_out = out_branches if out_branches is not None else n
        self.paths: list[list[list[str]]] = []
        count = 0
        for i in range(self.n_out):
            row = []
            for j in range(n):
                names = []
                if j > i:
                    specs = [(widths[j], widths[i], 1, 1, False)]
                elif j < i:
                    specs = [(widths[j], widths[i] if k == i - j - 1 else widths[j], 3, 2,
                              k != i - j - 1) for k in range(i - j)]
                else:
                    specs = []
                for cin, cout, kernel, stride, act in specs:
                    name = f"ConvBN_{count}"
                    count += 1
                    self.add_module(name, ConvBN(cin, cout, kernel, stride, act, dtype))
                    names.append(name)
                row.append(names)
            self.paths.append(row)

    def forward(self, xs):
        """Row i sums its terms in order, (((t0 + t1) + t2) ...), each sum
        rounded to the compute dtype, then the ReLU.  A term's last ConvBN
        adds the running sum as its residual (after its nearest upsample
        where j > i), and the row's last term takes the ReLU; the identity
        term (j == i) is a plain add."""
        outs = []
        for i in range(self.n_out):
            acc = None
            for j, names in enumerate(self.paths[i]):
                last = j == len(self.paths[i]) - 1
                if not names:
                    acc = xs[j] if acc is None else acc + xs[j]
                    if last:
                        acc = torch.relu(acc)
                    continue
                y = xs[j]
                for name in names[:-1]:
                    y = getattr(self, name)(y)
                acc = getattr(self, names[-1])(y, residual=acc, upsample=max(j - i, 0),
                                               relu=last)
            outs.append(acc)
        return outs


class HRModule(nn.Module):
    """``num_blocks`` BasicBlocks per branch, then one fusion."""

    def __init__(self, widths: Sequence[int], num_blocks: int = 4,
                 multiscale_output: bool = True, dtype=torch.bfloat16):
        super().__init__()
        self.num_blocks = num_blocks
        self.n_branches = len(widths)
        for b, w in enumerate(widths):
            for k in range(num_blocks):
                self.add_module(f"BasicBlock_{b * num_blocks + k}", BasicBlock(w, dtype))
        self.FuseLayer_0 = FuseLayer(widths, None if multiscale_output else 1, dtype)

    def forward(self, xs):
        ys = []
        for b, x in enumerate(xs):
            for k in range(self.num_blocks):
                x = getattr(self, f"BasicBlock_{b * self.num_blocks + k}")(x)
            ys.append(x)
        return self.FuseLayer_0(ys)


class HRNet(nn.Module):
    """HRNet heatmap pose estimator.

    ``forward(x)``: x (B, 3, H, W) normalized float, any memory format ->
    heatmaps (B, num_joints, H/4, W/4) f32.  ``fused_stage1``: an optional
    ``fn(x) -> x`` that replaces the stage-1 Bottleneck chain in eval mode
    (`ops.bottleneck.make_fused_stage1`); in train mode the four Bottleneck
    modules run, as in the JAX package.  Built in eval mode.
    """

    def __init__(self, num_joints: int = 17, cfg=None, dtype=torch.bfloat16,
                 device="cuda"):
        super().__init__()
        cfg = cfg or HRNET_W32
        widths, modules, stem = cfg["widths"], cfg["modules"], cfg["stem"]
        self.cfg, self.num_joints, self.dtype = cfg, num_joints, dtype
        self.ConvBN_0 = ConvBN(3, stem, 3, 2, dtype=dtype)
        self.ConvBN_1 = ConvBN(stem, stem, 3, 2, dtype=dtype)
        cin = stem
        for i in range(4):
            self.add_module(f"Bottleneck_{i}", Bottleneck(cin, 64, dtype))
            cin = 256
        self.ConvBN_2 = ConvBN(256, widths[0], 3, dtype=dtype)
        self.ConvBN_3 = ConvBN(256, widths[1], 3, 2, dtype=dtype)
        self.ConvBN_4 = ConvBN(widths[1], widths[2], 3, 2, dtype=dtype)
        self.ConvBN_5 = ConvBN(widths[2], widths[3], 3, 2, dtype=dtype)
        final_ms = bool(cfg.get("final_multiscale", False))
        self.stage_modules: list[list[str]] = []
        m = 0
        for stage, n_br in ((1, 2), (2, 3), (3, 4)):
            names = []
            for k in range(modules[stage]):
                last = stage == 3 and k == modules[3] - 1
                self.add_module(f"HRModule_{m}", HRModule(
                    widths[:n_br], multiscale_output=final_ms or not last, dtype=dtype))
                names.append(f"HRModule_{m}")
                m += 1
            self.stage_modules.append(names)
        self.head = nn.Conv2d(widths[0], num_joints, 1)
        self.to(device=device, memory_format=torch.channels_last).eval()

    def forward(self, x, fused_stage1=None):
        H, W = x.shape[-2:]
        if H % 32 or W % 32:
            raise ValueError(f"HRNet input height/width must be divisible by 32; got {(H, W)}")
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        x = self.ConvBN_1(self.ConvBN_0(x))
        if fused_stage1 is not None and not self.training:
            x = fused_stage1(x)
        else:
            for i in range(4):
                x = getattr(self, f"Bottleneck_{i}")(x)
        xs = [self.ConvBN_2(x), self.ConvBN_3(x)]
        for name in self.stage_modules[0]:
            xs = getattr(self, name)(xs)
        xs = xs + [self.ConvBN_4(xs[-1])]
        for name in self.stage_modules[1]:
            xs = getattr(self, name)(xs)
        xs = xs + [self.ConvBN_5(xs[-1])]
        for name in self.stage_modules[2]:
            xs = getattr(self, name)(xs)
        heat = F.conv2d(xs[0], self.head.weight.to(self.dtype), self.head.bias.to(self.dtype))
        return heat.float()
