"""Carry HRNet and Swin weights from a flax variables tree to the port's
``state_dict``.

The port's submodules carry the flax names, so the map is mechanical:

- conv ``<path>/kernel`` (kh, kw, cin, cout) -> ``<path>.weight``
  (cout, cin, kh, kw); Swin's ``deconv_*/kernel`` -> (cin, cout, kh, kw), the
  ``conv_transpose2d`` layout; a Dense ``kernel`` (in, out) -> ``weight``
  (out, in) (Swin only: HRNet has no Dense layer);
- ``<path>/bias`` -> ``<path>.bias``; BatchNorm and LayerNorm ``scale`` ->
  ``weight``; Swin's ``bias_table`` stays ``bias_table``;
- batch stats ``mean`` / ``var`` -> ``running_mean`` / ``running_var``, plus
  ``num_batches_tracked`` = 0 for every BatchNorm.

Matching is strict: an unknown leaf, a missing or leftover key, or a shape
that differs from the model's raises.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["hrnet_state_dict_from_flax", "load_hrnet_from_flax", "swin_state_dict_from_flax",
           "load_swin_from_flax"]

_PARAM_NAMES = {"kernel": "weight", "bias": "bias", "scale": "weight"}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), value


def _state_dict_from_flax(variables: dict, kernel, param_names) -> dict[str, torch.Tensor]:
    leftover = set(variables) - {"params", "batch_stats"}
    if leftover:
        raise KeyError(f"unexpected variable collections: {sorted(leftover)}")
    sd: dict[str, torch.Tensor] = {}
    for path, value in _leaves(variables["params"]):
        name = param_names.get(path[-1])
        if name is None:
            raise KeyError(f"unmapped parameter {'/'.join(path)}")
        arr = np.asarray(value, np.float32)
        if path[-1] == "kernel":
            arr = kernel(path, arr)
        sd[".".join(path[:-1] + (name,))] = torch.from_numpy(arr.copy())
    for path, value in _leaves(variables.get("batch_stats", {})):
        name = _STAT_NAMES.get(path[-1])
        if name is None:
            raise KeyError(f"unmapped batch statistic {'/'.join(path)}")
        sd[".".join(path[:-1] + (name,))] = torch.from_numpy(np.asarray(value, np.float32).copy())
        sd[".".join(path[:-1] + ("num_batches_tracked",))] = torch.tensor(0, dtype=torch.long)
    return sd


def _hrnet_kernel(path, arr):
    if arr.ndim != 4:
        raise ValueError(f"{'/'.join(path)}: expected a 4-d conv kernel, got {arr.shape}")
    return arr.transpose(3, 2, 0, 1)


def _swin_kernel(path, arr):
    if arr.ndim == 2:
        return arr.T
    if arr.ndim != 4:
        raise ValueError(f"{'/'.join(path)}: expected a 2-d or 4-d kernel, got {arr.shape}")
    if path[-2].startswith("deconv_"):
        return arr.transpose(2, 3, 0, 1)
    return arr.transpose(3, 2, 0, 1)


def hrnet_state_dict_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` tree of numpy arrays -> the port's state_dict."""
    return _state_dict_from_flax(variables, _hrnet_kernel, _PARAM_NAMES)


def swin_state_dict_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """A flax `SwinPose` ``{"params", "batch_stats"}`` tree of numpy arrays ->
    the port's `models.swin.SwinPose` state_dict."""
    return _state_dict_from_flax(variables, _swin_kernel,
                                 dict(_PARAM_NAMES, bias_table="bias_table"))


def _load_strict(model: torch.nn.Module, sd: dict) -> torch.nn.Module:
    want = model.state_dict()
    missing = sorted(set(want) - set(sd))
    extra = sorted(set(sd) - set(want))
    if missing or extra:
        raise KeyError(f"state_dict mismatch: missing {missing[:8]} ({len(missing)}), "
                       f"leftover {extra[:8]} ({len(extra)})")
    for key, value in sd.items():
        if tuple(value.shape) != tuple(want[key].shape):
            raise ValueError(f"{key}: shape {tuple(value.shape)} vs the model's "
                             f"{tuple(want[key].shape)}")
    model.load_state_dict(sd, strict=True)
    return model


def load_hrnet_from_flax(model: torch.nn.Module, variables: dict) -> torch.nn.Module:
    """Load a flax HRNet variables tree into the port's `HRNet`, strictly."""
    return _load_strict(model, hrnet_state_dict_from_flax(variables))


def load_swin_from_flax(model: torch.nn.Module, variables: dict) -> torch.nn.Module:
    """Load a flax SwinPose variables tree into the port's `SwinPose`, strictly."""
    return _load_strict(model, swin_state_dict_from_flax(variables))
