"""Model registry: name -> built estimator, the port's subset of the JAX
package's ``models/registry.py``.

The names and configurations are the JAX registry's for the HRNet and Swin
heatmap families.  The RTMPose (SimCC) family is not ported yet: its names
raise `NotImplementedError` (ROADMAP.md, Queue A item 8).  Weights come
from a flax variables tree (numpy arrays, through `models.convert`) or are
drawn from a seed (`init_hrnet_` / `init_swin_` below).
"""

from __future__ import annotations

import math
from typing import Any

import torch

from .convert import load_hrnet_from_flax, load_swin_from_flax
from .hrnet import HRNET_W32, HRNET_W48, HRNet
from .swin import SWIN_B, SWIN_L, SwinPose
from .topdown import TopDownEstimator

__all__ = ["MODEL_REGISTRY", "NOT_PORTED", "resolve_model_name", "build_estimator",
           "build_model", "init_hrnet_", "init_swin_"]

# name -> (family, cfg, decode, input_size (w, h))
MODEL_REGISTRY: dict[str, dict[str, Any]] = {
    "coco_hrnet_w32": {"family": "hrnet", "cfg": HRNET_W32, "decode": "heatmap",
                       "input_size": (192, 256)},
    "coco_hrnet_w48": {"family": "hrnet", "cfg": HRNET_W48, "decode": "heatmap",
                       "input_size": (288, 384)},
    # The reference's named flagship checkpoints (MMPose 256x192 crops).
    "coco_swin-b": {"family": "swin", "cfg": SWIN_B, "decode": "heatmap",
                    "input_size": (192, 256)},
    "coco_swin-l": {"family": "swin", "cfg": SWIN_L, "decode": "heatmap",
                    "input_size": (192, 256)},
    "test_tiny": {"family": "hrnet",
                  "cfg": {"widths": (8, 16, 32, 64), "modules": (1, 1, 1, 1), "stem": 16},
                  "decode": "heatmap", "input_size": (32, 64)},
    "test_small_128": {"family": "hrnet",
                       "cfg": {"widths": (16, 32, 64, 128), "modules": (1, 1, 1, 1),
                               "stem": 32},
                       "decode": "heatmap", "input_size": (128, 128)},
    "test_swin_128": {"family": "swin",
                      "cfg": {"embed": 24, "depths": (1, 1), "heads": (2, 4), "window": 4,
                              "mlp_ratio": 2, "deconv": (16,)},
                      "decode": "heatmap", "input_size": (128, 128)},
    "test_swin_192x256": {"family": "swin",
                          "cfg": {"embed": 48, "depths": (2, 2, 4, 2), "heads": (2, 4, 8, 16),
                                  "window": 7, "mlp_ratio": 2, "deconv": (64, 64, 64)},
                          "decode": "heatmap", "input_size": (192, 256)},
    "test_small_192x256": {"family": "hrnet",
                           "cfg": {"widths": (16, 32, 64, 128), "modules": (1, 1, 1, 1),
                                   "stem": 32},
                           "decode": "heatmap", "input_size": (192, 256)},
}

# Names of the JAX registry whose family the port does not have yet.
NOT_PORTED = ("coco_rtmpose-t", "coco_rtmpose-s", "coco_rtmpose-m")

_ALIASES = {"coco_swin_b": "coco_swin-b", "coco_swin_l": "coco_swin-l"}


def resolve_model_name(name: str) -> str:
    if name in NOT_PORTED:
        raise NotImplementedError(f"'{name}' (RTMPose, SimCC decode) is not ported yet; "
                                  "see ROADMAP.md, Queue A item 8")
    if name in MODEL_REGISTRY:
        return name
    if name in _ALIASES:
        return _ALIASES[name]
    raise KeyError(f"unknown model '{name}'; available: {sorted(MODEL_REGISTRY)} "
                   f"(aliases: {sorted(_ALIASES)})")


@torch.no_grad()
def init_hrnet_(model: HRNet, generator: torch.Generator) -> HRNet:
    """Random weights from ``generator``, drawn on the CPU: convs
    N(0, 1/fan_in) (flax's LeCun scale), BatchNorm at identity, zero head bias."""
    for name, p in model.named_parameters():
        if p.dim() == 4:
            fan_in = p.shape[1] * p.shape[2] * p.shape[3]
            w = torch.randn(p.shape, generator=generator) / math.sqrt(fan_in)
            p.copy_(w.to(p.device))
        elif name.endswith("BatchNorm_0.weight"):
            p.fill_(1.0)
        else:
            p.zero_()
    for name, b in model.named_buffers():
        if name.endswith("running_var"):
            b.fill_(1.0)
        else:
            b.zero_()
    return model


@torch.no_grad()
def init_swin_(model: SwinPose, generator: torch.Generator) -> SwinPose:
    """Random weights from ``generator``, drawn on the CPU: Dense and conv
    kernels N(0, 1/fan_in), relative-position tables N(0, 0.02²), LayerNorm
    and BatchNorm at identity, zero biases.  A transposed conv's fan-in is
    the taps that reach one output, in·(k/stride)², so the head keeps its
    activations' scale: random heatmaps then peak above the pipeline's 0.3
    confidence gate (with k·k·in they peak near 0.2, every joint is gated
    and the triangulation sees only NaN)."""
    for name, p in model.named_parameters():
        if name.endswith("bias_table"):
            w = 0.02 * torch.randn(p.shape, generator=generator)
        elif p.dim() >= 2:
            # Linear (out, in), Conv2d (out, in, kh, kw), Deconv (in, out, kh, kw).
            fan_in = p[0].numel()
            if name.startswith("deconv_"):
                fan_in = p[:, 0].numel() // getattr(model, name.split(".")[0]).stride ** 2
            w = torch.randn(p.shape, generator=generator) / math.sqrt(fan_in)
        elif name.endswith("weight"):  # LayerNorm / BatchNorm scale
            w = torch.ones(p.shape)
        else:
            w = torch.zeros(p.shape)
        p.copy_(w.to(p.device))
    for name, b in model.named_buffers():
        b.fill_(1.0 if name.endswith("running_var") else 0.0)
    return model


def build_model(family: str, cfg, device="cuda", variables=None, seed: int = 0):
    """A 17-joint bf16 HRNet or SwinPose (Swin: every block through the
    block kernels) on ``device``, with weights from ``variables`` (a flax
    variables tree of numpy arrays) or drawn from seed ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    if family == "hrnet":
        model = HRNet(cfg=cfg, device=device)
        return init_hrnet_(model, gen) if variables is None else load_hrnet_from_flax(
            model, variables)
    if family == "swin":
        model = SwinPose(cfg=cfg, device=device)
        return init_swin_(model, gen) if variables is None else load_swin_from_flax(
            model, variables)
    raise NotImplementedError(f"family {family!r} is not ported; see ROADMAP.md")


def build_estimator(name: str = "coco_hrnet_w32", device="cuda", variables=None,
                    seed: int = 0) -> TopDownEstimator:
    """A ready `TopDownEstimator` by registry name, on ``device``.
    ``variables``: a flax variables tree of numpy arrays for the model; None
    draws random weights from ``torch.Generator`` seed ``seed``."""
    spec = MODEL_REGISTRY[resolve_model_name(name)]
    model = build_model(spec["family"], spec["cfg"], device, variables, seed)
    return TopDownEstimator(model, input_size=spec["input_size"], device=device)
