"""Seeded weights in MMPose's checkpoint format.

The names and shapes are those of the reference model's ``state_dict``
(MMPose's or MMDet's names), the values are drawn on ``device`` from one
``torch.Generator`` seeded from ``--seed`` and the model's stream (`sub_seed`:
0 the pose model, 1 the traffic, 2 a detector), in two calls (one normal,
one uniform draw for every tensor at once), in float32: the type an MMPose
checkpoint holds.  A tensor that two names share (a module bound twice,
as MMDet's shared head convs are) is drawn once, under its first name in
sorted order, and the other names hold a copy.  The distributions (each a
scale of those two draws): what the family module's ``weight_kind(key,
module, param)`` gives, ``("normal", std)``, ``("uniform", (a, b))`` or
``("zero", None)``, asked first for every name; where it gives None (or
the family has none), the shared rules:

- conv, linear and transposed-conv kernels: N(0, 1 / fan_in), the fan-in
  of a transposed conv being the taps that reach one output,
  in · (k / stride)²;
- biases of convs and linears: N(0, 0.02²);
- BatchNorm and LayerNorm scales U(0.8, 1.2), shifts N(0, 0.05²); running
  means N(0, 0.05²), running variances U(0.8, 1.25): statistics that differ
  from identity, so that a BatchNorm dropped or applied with the wrong
  statistics changes the result;
- relative-position bias tables N(0, 1), the scale of trained tables
  (N(0, 0.02²) would move the attention by about 1e-3, under any check);
- ``num_batches_tracked``: 0;
- any other name raises.

Then the harness (`harness.Cell`) calibrates what was drawn, before any
checkpoint is written: a family module's ``calibrate(model, state,
frames_u8, cfg)``, where it has one (the detector's first, since the pose
model's crops may come from its boxes), changes ``state`` in place from a
forward pass of the f32 reference on the CPU over the cell's first frames
(a detector's BatchNorm statistics: with them near identity every SiLU
layer shrinks the scale until every candidate scores about sigmoid(bias));
on the CPU, so that the same seed gives the same bits in every process.
Then `calibrate_head` scales the pose model's final 1x1 conv (kernel and
bias) so that the reference's heatmaps of a few of the cell's own crops
peak at ``head_peak`` at the median: HRNet's activations grow through its
residual sums and fusions by a factor that swings tenfold from seed to
seed, and so would the heatmaps' scale against the confidence gate.
(Setting the BatchNorm statistics from a batch instead holds the scale
too, but its channels of large mean over spread amplify the bf16 rounding
of the conv outputs before them until one bf16 path differs from another
by half a peak; random statistics near identity do not.)
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

__all__ = ["draw_state_dict", "calibrate_head", "sub_seed"]

_MASK63 = (1 << 63) - 1


def sub_seed(seed: int, stream: int) -> int:
    """A generator seed for draw ``stream`` of run ``seed`` (any whole number)."""
    return (int(seed) * 1_000_003 + 7919 * (stream + 1)) & _MASK63


def _shared_kind(mod: nn.Module, pname: str, p: torch.Tensor):
    """The shared rules' (kind, scale) of parameter or buffer ``pname`` of
    ``mod``, or None where no rule covers it."""
    norm = isinstance(mod, (nn.BatchNorm2d, nn.LayerNorm))
    if pname == "num_batches_tracked":
        return ("zero", None)
    if pname == "running_var":
        return ("uniform", (0.8, 1.25))
    if pname == "running_mean":
        return ("normal", 0.05)
    if norm and pname == "weight":
        return ("uniform", (0.8, 1.2))
    if norm and pname == "bias":
        return ("normal", 0.05)
    if pname == "relative_position_bias_table":
        return ("normal", 1.0)
    if pname == "bias":
        return ("normal", 0.02)
    if pname == "weight" and p.dim() >= 2:
        if isinstance(mod, nn.ConvTranspose2d):
            fan_in = p.shape[0] * (p.shape[2] // mod.stride[0]) * (p.shape[3] // mod.stride[1])
        else:
            fan_in = p[0].numel()
        return ("normal", 1.0 / math.sqrt(fan_in))
    return None


def _kinds(model: nn.Module, weight_kind=None) -> dict:
    """{state_dict key: (kind, scale)}: kind "normal" or "uniform" (a, b),
    "zero"; ``weight_kind(key, module, param)`` first, the shared rules
    where it gives None."""
    kinds = {}
    for mname, mod in model.named_modules(remove_duplicate=False):
        prefix = f"{mname}." if mname else ""
        for pname, p in list(mod.named_parameters(recurse=False)) + list(
                mod.named_buffers(recurse=False)):
            key = prefix + pname
            kind = weight_kind(key, mod, p) if weight_kind is not None else None
            if kind is None:
                kind = _shared_kind(mod, pname, p)
            if kind is None:
                raise ValueError(f"no distribution for {key} ({type(mod).__name__}): add a "
                                 f"rule for it in the family module's weight_kind")
            kinds[key] = kind
    missing = set(model.state_dict()) - set(kinds)
    if missing:
        raise ValueError(f"no distribution for {sorted(missing)[:5]}: add a rule for them in "
                         f"the family module's weight_kind")
    return kinds


def draw_state_dict(model: nn.Module, seed: int, device, stream: int = 0,
                    weight_kind=None) -> dict:
    """The float32 state dict (on the CPU, views of one buffer) of
    ``model``'s names and shapes, drawn from stream ``stream`` of ``seed``
    on ``device``; ``weight_kind``: the family module's, or None."""
    kinds = _kinds(model, weight_kind)
    tensors = model.state_dict(keep_vars=True)
    first = {}
    for k in sorted(tensors):
        first.setdefault(id(tensors[k]), k)
    copies = {k: first[id(t)] for k, t in tensors.items() if first[id(t)] != k}
    shapes = {k: tuple(v.shape) for k, v in tensors.items() if k not in copies}
    keys = sorted(shapes)
    sizes = {k: math.prod(shapes[k]) for k in keys}
    n_normal = sum(sizes[k] for k in keys if kinds[k][0] == "normal")
    n_uniform = sum(sizes[k] for k in keys if kinds[k][0] == "uniform")
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, stream))
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device)
    parts, at_n, at_u = [], 0, 0
    for k in keys:
        kind, scale = kinds[k]
        n = sizes[k]
        if kind == "normal":
            parts.append(normal[at_n:at_n + n] * scale)
            at_n += n
        elif kind == "uniform":
            a, b = scale
            parts.append(uniform[at_u:at_u + n] * (b - a) + a)
            at_u += n
        else:
            parts.append(torch.zeros(n, device=device))
    flat = torch.cat(parts).cpu()
    out, at = {}, 0
    for k in keys:
        t = flat[at:at + sizes[k]].view(shapes[k])
        out[k] = t.long() if k.endswith("num_batches_tracked") else t
        at += sizes[k]
    for k, src in copies.items():
        out[k] = out[src].clone()
    return out


@torch.no_grad()
def calibrate_head(model: nn.Module, crops: torch.Tensor, state: dict, head_peak: float,
                   head_key: str) -> float:
    """Scale ``state``'s final conv (``head_key`` and its bias, in place) so
    that ``model`` (the reference, holding ``state``) peaks at ``head_peak``
    at the median over the maps of ``crops``; returns the scale."""
    maps = model(crops)
    median = float(maps.flatten(2).amax(-1).median())
    if not median > 0:
        raise ValueError(f"the reference's median heatmap peak is {median}: no scale gives "
                         f"peaks of {head_peak}")
    scale = head_peak / median
    bias_key = head_key.removesuffix("weight") + "bias"
    state[head_key].mul_(scale)
    state[bias_key].mul_(scale)
    return scale
