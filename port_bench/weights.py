"""Seeded weights in MMPose's checkpoint format.

The names and shapes are those of the reference model's ``state_dict``
(MMPose's names), the values are drawn on ``device`` from one
``torch.Generator`` seeded from ``--seed``, in two calls (one normal, one
uniform draw for every tensor at once), in float32: the type an MMPose
checkpoint holds.  The distributions (each a scale of those two draws):

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
- ``num_batches_tracked``: 0.

Then `calibrate_head` scales the final 1x1 conv (kernel and bias) so that
the reference's heatmaps of a few of the cell's own crops peak at
``head_peak`` at the median: HRNet's activations grow through its residual
sums and fusions by a factor that swings tenfold from seed to seed, and so
would the heatmaps' scale against the confidence gate.  (Setting the
BatchNorm statistics from a batch instead holds the scale too, but its
channels of large mean over spread amplify the bf16 rounding of the conv
outputs before them until one bf16 path differs from another by half a
peak; random statistics near identity do not.)
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


def _kinds(model: nn.Module) -> dict:
    """{state_dict key: (kind, scale)}: kind "normal" or "uniform" (a, b),
    "zero"."""
    kinds = {}
    for mname, mod in model.named_modules():
        prefix = f"{mname}." if mname else ""
        norm = isinstance(mod, (nn.BatchNorm2d, nn.LayerNorm))
        for pname, p in list(mod.named_parameters(recurse=False)) + list(
                mod.named_buffers(recurse=False)):
            key = prefix + pname
            if pname == "num_batches_tracked":
                kinds[key] = ("zero", None)
            elif pname == "running_var":
                kinds[key] = ("uniform", (0.8, 1.25))
            elif pname == "running_mean":
                kinds[key] = ("normal", 0.05)
            elif norm and pname == "weight":
                kinds[key] = ("uniform", (0.8, 1.2))
            elif norm and pname == "bias":
                kinds[key] = ("normal", 0.05)
            elif pname == "relative_position_bias_table":
                kinds[key] = ("normal", 1.0)
            elif pname == "bias":
                kinds[key] = ("normal", 0.02)
            elif pname == "weight" and p.dim() >= 2:
                if isinstance(mod, nn.ConvTranspose2d):
                    fan_in = p.shape[0] * (p.shape[2] // mod.stride[0]) * (
                        p.shape[3] // mod.stride[1])
                else:
                    fan_in = p[0].numel()
                kinds[key] = ("normal", 1.0 / math.sqrt(fan_in))
            else:
                raise ValueError(f"no distribution for {key} ({type(mod).__name__})")
    missing = set(model.state_dict()) - set(kinds)
    if missing:
        raise ValueError(f"no distribution for {sorted(missing)[:5]}")
    return kinds


def draw_state_dict(model: nn.Module, seed: int, device) -> dict:
    """The float32 state dict (on the CPU, views of one buffer) of
    ``model``'s names and shapes, drawn from ``seed`` on ``device``."""
    kinds = _kinds(model)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    keys = sorted(shapes)
    sizes = {k: math.prod(shapes[k]) for k in keys}
    n_normal = sum(sizes[k] for k in keys if kinds[k][0] == "normal")
    n_uniform = sum(sizes[k] for k in keys if kinds[k][0] == "uniform")
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 0))
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
