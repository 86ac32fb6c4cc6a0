"""Model registry: name -> built estimator or detector, as the JAX
package's ``models/registry.py``.

The names and configurations are the JAX registry's: the HRNet and Swin
heatmap families and the RTMPose SimCC family (`MODEL_REGISTRY`), and the
person detectors (`DETECTOR_REGISTRY`: the full-frame detector, CenterNet,
YOLOX and RTMDet).  Weights come from a checkpoint (``checkpoint=``: the
JAX package's ``.npz``, or an MMPose/MMDet ``.pth`` through the name maps
of `models.convert`), from a flax variables tree (numpy arrays), or are
drawn from a seed (the ``init_*_`` functions below).
"""

from __future__ import annotations

import math
import os
from typing import Any

import torch

from .convert import (TORCH_LOADERS, load_centernet_from_flax, load_checkpoint_npz,
                      load_hrnet_from_flax, load_rtmdet_from_flax, load_rtmpose_from_flax,
                      load_swin_from_flax, load_yolox_from_flax)
from .detector import CenterNetDetector, SinglePersonDetector
from .hrnet import HRNET_W32, HRNET_W48, HRNet
from .rtmdet import RTMDet
from .batchnorm import calibrating_batch_norm
from .rtmpose import RTMPOSE_M, RTMPOSE_S, RTMPOSE_T, RTMPose
from .swin import SWIN_B, SWIN_L, SwinPose
from .topdown import TopDownEstimator
from .yolox import YOLOX

__all__ = ["MODEL_REGISTRY", "DETECTOR_REGISTRY", "resolve_model_name", "build_estimator",
           "build_model", "new_model", "build_detector", "load_checkpoint", "init_hrnet_",
           "init_swin_", "init_rtmpose_", "init_centernet_", "init_rtmdet_", "init_yolox_"]

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
    # The reference's SimCC family (`coco_rtmpose-t`, BASELINE config 3).
    "coco_rtmpose-t": {"family": "rtmpose", "cfg": RTMPOSE_T, "decode": "simcc",
                       "input_size": (192, 256)},
    "coco_rtmpose-s": {"family": "rtmpose", "cfg": RTMPOSE_S, "decode": "simcc",
                       "input_size": (192, 256)},
    "coco_rtmpose-m": {"family": "rtmpose", "cfg": RTMPOSE_M, "decode": "simcc",
                       "input_size": (256, 256)},
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

_ALIASES = {"coco_swin_b": "coco_swin-b", "coco_swin_l": "coco_swin-l"}


def resolve_model_name(name: str) -> str:
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


@torch.no_grad()
def _init_lecun_(model: torch.nn.Module, generator: torch.Generator,
                 batch: torch.Tensor) -> torch.nn.Module:
    """Random weights from ``generator``, drawn on the CPU: conv and Dense
    kernels N(0, 1/fan_in) (fan-in per group for depthwise convs), the GAU's
    γ N(0, 0.02²) and β 0 (flax's initialisers), BatchNorm, ScaleNorm gains
    and residual scales at 1, zero biases; then the BatchNorm statistics
    from one forward of ``batch`` on the CPU (`calibrating_batch_norm`: mean
    0, the variance of every channel the layer's mean square), so that
    every layer sees inputs of unit scale.
    With the statistics at identity, each SiLU layer shrinks the scale
    (RTMDet-m's head would see ~1e-7 and score every candidate
    sigmoid(bias)); a fixed gain instead overshoots through the residual
    sums; per-channel batch variances of random frames' deep, nearly
    constant maps amplify any other input.  On the CPU, so that the card and
    the CPU get the same weights."""
    for name, p in model.named_parameters():
        if name.endswith("gamma"):
            w = 0.02 * torch.randn(p.shape, generator=generator)
        elif p.dim() >= 2 and not name.endswith("beta"):
            w = torch.randn(p.shape, generator=generator) / math.sqrt(p[0].numel())
        elif name.endswith(("weight", ".g", "res_scale")):  # 1-d weights: BatchNorm scales
            w = torch.ones(p.shape)
        else:
            w = torch.zeros(p.shape)
        p.copy_(w.to(p.device))
    device = next(model.parameters()).device
    with calibrating_batch_norm():
        model.to("cpu")(batch)
    return model.to(device)


def _frames_batch(generator: torch.Generator) -> torch.Tensor:
    """The detectors' calibration batch: two random [0, 1] frames of 256x256."""
    return torch.rand((2, 3, 256, 256), generator=generator)


# Random-weight calibration of the heads (the ``init_*_`` below).
# cls_x / cls_y kernels x this: the logits' std goes from about 1 to 6 and
# 0.83 of the joints of random crops clear the 0.3 gate (rtmpose-t, 16 random
# 256x256 frames on the CPU; 0 at gain 1, 0.51 at 4, 0.96 at 8).
RTMPOSE_LOGIT_GAIN = 6.0
RTMDET_REG_BIAS = 3.0  # rtm_reg bias, in strides: boxes of about 6 strides
YOLOX_WH_BIAS = 2.0  # conv_reg's log-size bias: boxes of exp(2) ≈ 7.4 strides
CENTERNET_WH_BIAS = 48.0  # the wh head's bias: softplus(48) ≈ 48 px boxes


@torch.no_grad()
def init_rtmpose_(model: RTMPose, generator: torch.Generator) -> RTMPose:
    """`_init_lecun_` (calibrated on two N(0, 1) crops), with the SimCC
    classifiers ``cls_x`` / ``cls_y`` scaled by ``RTMPOSE_LOGIT_GAIN``: at
    unit scale, random logits over 384 and 512 bins peak near 0.02 after
    the softmax, under the pipeline's 0.3 confidence gate, and every joint
    would be NaN."""
    w, h = model.input_size
    _init_lecun_(model, generator, torch.randn((2, 3, h, w), generator=generator))
    model.cls_x.weight.mul_(RTMPOSE_LOGIT_GAIN)
    model.cls_y.weight.mul_(RTMPOSE_LOGIT_GAIN)
    return model


@torch.no_grad()
def init_rtmdet_(model: RTMDet, generator: torch.Generator) -> RTMDet:
    """`_init_lecun_`, with each level's ``rtm_reg`` bias at
    ``RTMDET_REG_BIAS``: zero-mean distances give relu(reg) = 0 on both sides
    of an axis for about 1/16 of the candidates, a box of zero size and an
    infinite crop scale; the bias makes random boxes span tens of pixels."""
    _init_lecun_(model, generator, _frames_batch(generator))
    for lvl in range(3):
        getattr(model.head, f"rtm_reg_{lvl}").bias.fill_(RTMDET_REG_BIAS)
    return model


@torch.no_grad()
def init_yolox_(model: YOLOX, generator: torch.Generator) -> YOLOX:
    """`_init_lecun_`, with each level's ``conv_reg`` log-size bias (channels
    2, 3) at ``YOLOX_WH_BIAS``, so that a random box is wider than the
    distance its centre strays from its cell and stays of positive size once
    clipped to the frame."""
    _init_lecun_(model, generator, _frames_batch(generator))
    for lvl in range(3):
        getattr(model.head, f"conv_reg_{lvl}").bias[2:].fill_(YOLOX_WH_BIAS)
    return model


@torch.no_grad()
def init_centernet_(model: CenterNetDetector, generator: torch.Generator) -> CenterNetDetector:
    """`_init_lecun_`, with the size head's bias at ``CENTERNET_WH_BIAS``
    (softplus of zero-mean logits gives boxes under a pixel wide)."""
    _init_lecun_(model, generator, _frames_batch(generator))
    model.Conv_1.bias.fill_(CENTERNET_WH_BIAS)
    return model


_MODEL_FAMILIES = {
    "hrnet": (HRNet, init_hrnet_, load_hrnet_from_flax),
    "swin": (SwinPose, init_swin_, load_swin_from_flax),
    "rtmpose": (RTMPose, init_rtmpose_, load_rtmpose_from_flax),
}


def new_model(family: str, cfg, device="cuda", input_size=(192, 256), num_joints: int = 17,
              dtype=torch.bfloat16) -> torch.nn.Module:
    """A ``num_joints``-joint HRNet, SwinPose or RTMPose (at ``input_size``
    (w, h)) computing in ``dtype``, on ``device``, with torch's default
    initialisation: weights to be loaded."""
    if family not in _MODEL_FAMILIES:
        raise ValueError(f"unknown family {family!r}")
    extra = {"input_size": input_size} if family == "rtmpose" else {}
    return _MODEL_FAMILIES[family][0](num_joints, cfg=cfg, dtype=dtype, device=device, **extra)


def build_model(family: str, cfg, device="cuda", variables=None, seed: int = 0,
                input_size=(192, 256), num_joints: int = 17, checkpoint: str | None = None,
                dtype=torch.bfloat16):
    """`new_model`, with weights from ``checkpoint`` (`load_checkpoint`),
    from ``variables`` (a flax variables tree of numpy arrays) or drawn from
    seed ``seed``."""
    model = new_model(family, cfg, device, input_size, num_joints, dtype)
    _, init, load = _MODEL_FAMILIES[family]
    if checkpoint:
        return load_checkpoint(model, checkpoint, family, cfg)
    if variables is not None:
        return load(model, variables)
    return init(model, torch.Generator().manual_seed(seed))


def load_checkpoint(model: torch.nn.Module, path: str, family: str,
                    cfg: dict | None = None) -> torch.nn.Module:
    """Load a checkpoint into ``model`` (of ``family``, built from ``cfg``):
    an MMPose/MMDet ``.pth`` / ``.pt`` file through the family's strict
    name map (`models.convert.TORCH_LOADERS`: hrnet, rtmpose, swin, yolox,
    rtmdet; any other family raises ``ValueError``), or the JAX package's
    ``.npz`` format (`models.convert.load_checkpoint_npz`).  Orbax
    directories and msgpack files raise ``NotImplementedError``."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if path.endswith((".pth", ".pt")):
        if family not in TORCH_LOADERS:
            raise ValueError(f"torch checkpoint conversion not implemented for {family}")
        return TORCH_LOADERS[family](model, path, cfg)
    if path.endswith(".npz"):
        return load_checkpoint_npz(model, path, family)
    raise NotImplementedError(f"{path}: the port reads torch .pth/.pt files and the JAX "
                              f"package's .npz checkpoints (orbax and msgpack are not read)")


def build_estimator(name: str = "coco_hrnet_w32", checkpoint: str | None = None,
                    num_joints: int = 17, seed: int = 0, device="cuda", variables=None,
                    dtype=torch.bfloat16, use_pallas_attention=None, use_pallas_stage1=None,
                    use_fused_stage1=None, use_fused_decode=None,
                    **estimator_kwargs) -> TopDownEstimator:
    """A ready `TopDownEstimator` by registry name, on ``device``, computing
    in ``dtype``.

    - ``checkpoint``: an MMPose ``.pth`` or the JAX package's ``.npz``
      checkpoint of the model (`load_checkpoint`); ``variables``: a flax
      variables tree of numpy arrays; with neither, random weights from
      ``torch.Generator`` seed ``seed``.
    - ``use_pallas_attention``, ``use_pallas_stage1`` (the JAX package's
      keywords), ``use_fused_stage1`` and ``use_fused_decode`` (the
      benchmark configurations' ``estimator_kwargs``) are accepted and
      select nothing: the models and the decode pick their kernels by one
      rule (`models.batchnorm.runs_kernels`).  ``use_pallas_attention`` on
      a model other than Swin raises ``ValueError``, as in JAX.
    - ``estimator_kwargs`` pass to `TopDownEstimator` (e.g.
      ``flip_test=True``, ``decode_mode="dark"``).
    """
    spec = MODEL_REGISTRY[resolve_model_name(name)]
    if use_pallas_attention is not None and spec["family"] != "swin":
        raise ValueError(f"use_pallas_attention applies to the swin family only, not "
                         f"'{name}' ({spec['family']})")
    model = build_model(spec["family"], spec["cfg"], device, variables, seed,
                        spec["input_size"], num_joints, checkpoint, dtype)
    return TopDownEstimator(model, input_size=spec["input_size"], decode=spec["decode"],
                            device=device, **estimator_kwargs)


# name -> (family, cfg): the JAX registry's detector names.
DETECTOR_REGISTRY: dict[str, dict[str, Any]] = {
    "full_frame": {"family": "full_frame", "cfg": None},
    "centernet_w32": {"family": "centernet", "cfg": {"width": 32}},
    "centernet_w16": {"family": "centernet", "cfg": {"width": 16}},
    "test_centernet_w8": {"family": "centernet", "cfg": {"width": 8}},
    # The reference's named zoo detector (`yolo_base`).
    "yolox_tiny": {"family": "yolox", "cfg": {"widen": 0.375, "deepen": 0.33, "num_classes": 80}},
    "yolox_s": {"family": "yolox", "cfg": {"widen": 0.5, "deepen": 0.33, "num_classes": 80}},
    "test_yolox_micro": {"family": "yolox",
                         "cfg": {"widen": 0.125, "deepen": 0.33, "num_classes": 80}},
    # The reference's primary named detector (`coco_base` = RTMDet-m, person only).
    "rtmdet_m": {"family": "rtmdet", "cfg": {"widen": 0.75, "deepen": 0.67, "num_classes": 1,
                                             "neck_out": 192, "num_csp_blocks": 2}},
    "rtmdet_tiny": {"family": "rtmdet", "cfg": {"widen": 0.375, "deepen": 0.167,
                                                "num_classes": 1, "neck_out": 96,
                                                "num_csp_blocks": 1}},
    "test_rtmdet_micro": {"family": "rtmdet", "cfg": {"widen": 0.125, "deepen": 0.167,
                                                      "num_classes": 1, "neck_out": 32,
                                                      "num_csp_blocks": 1}},
}

_DETECTOR_FAMILIES = {
    "centernet": (CenterNetDetector, init_centernet_, load_centernet_from_flax),
    "rtmdet": (RTMDet, init_rtmdet_, load_rtmdet_from_flax),
    "yolox": (YOLOX, init_yolox_, load_yolox_from_flax),
}


def build_detector(name: str = "full_frame", checkpoint: str | None = None,
                   bbox_thr: float = 0.3, seed: int = 0, select: str = "top1",
                   device="cuda", variables=None, topk: int = 4, select_window: int = 9,
                   select_lam: float = 4.0, dtype=torch.bfloat16,
                   input_hw=None) -> SinglePersonDetector:
    """A ready `SinglePersonDetector` by registry name, on ``device``,
    computing in ``dtype``.  ``"full_frame"`` has no model (``checkpoint`` is
    ignored, as in the JAX package); the others take their weights from
    ``checkpoint`` (an MMDet ``.pth`` for RTMDet and YOLOX, or the JAX
    package's ``.npz``: `load_checkpoint`), from ``variables`` (a flax
    variables tree of numpy arrays) or draw them from ``torch.Generator``
    seed ``seed``.  ``input_hw`` is accepted for the JAX signature and
    unused: the models are fully convolutional, and there it only seeds the
    parameter shapes.  The selection options: as `SinglePersonDetector`."""
    if name not in DETECTOR_REGISTRY:
        raise KeyError(f"unknown detector '{name}'; available: {sorted(DETECTOR_REGISTRY)}")
    spec = DETECTOR_REGISTRY[name]
    model = None
    if spec["family"] != "full_frame":
        cls, init, load = _DETECTOR_FAMILIES[spec["family"]]
        model = cls(**spec["cfg"], dtype=dtype, device=device)
        if checkpoint:
            model = load_checkpoint(model, checkpoint, spec["family"], spec["cfg"])
        elif variables is not None:
            model = load(model, variables)
        else:
            model = init(model, torch.Generator().manual_seed(seed))
    return SinglePersonDetector(model, bbox_thr=bbox_thr, select=select, topk=topk,
                                select_window=select_window, select_lam=select_lam,
                                device=device)
