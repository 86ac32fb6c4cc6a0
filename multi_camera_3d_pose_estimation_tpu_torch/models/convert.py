"""Carry weights from a flax variables tree to the port's ``state_dict``:
HRNet, Swin, RTMPose and the detectors (CenterNet, RTMDet, YOLOX).

The port's submodules carry the flax names, so the map is mechanical:

- conv ``<path>/kernel`` (kh, kw, cin, cout) -> ``<path>.weight``
  (cout, cin, kh, kw); Swin's ``deconv_*/kernel`` -> (cin, cout, kh, kw), the
  ``conv_transpose2d`` layout; a depthwise kernel (kh, kw, 1, C) -> (C, 1,
  kh, kw) by the same transpose; a Dense ``kernel`` (in, out) -> ``weight``
  (out, in) (Swin and RTMPose: HRNet and the detectors have no Dense layer);
- ``<path>/bias`` -> ``<path>.bias``; BatchNorm and LayerNorm ``scale`` ->
  ``weight``; Swin's ``bias_table`` stays ``bias_table``; RTMPose's
  ScaleNorm ``g`` and GAU ``gamma``, ``beta``, ``res_scale`` keep their names;
- batch stats ``mean`` / ``var`` -> ``running_mean`` / ``running_var``, plus
  ``num_batches_tracked`` = 0 for every BatchNorm.

Matching is strict: an unknown leaf, a missing or leftover key, or a shape
that differs from the model's raises.

The JAX package's ``.npz`` checkpoints (``save_checkpoint_npz``: ``p{i}`` =
the i-th leaf of ``jax.tree.flatten(variables)``) are read and written
without JAX: the flax leaf paths and shapes come from the model's own
``state_dict`` through the inverse of this map, in ``jax.tree.flatten``'s
order (dict keys sorted as strings at every level, so ``batch_stats``
before ``params`` and ``stage_10`` before ``stage_2``).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["hrnet_state_dict_from_flax", "load_hrnet_from_flax", "swin_state_dict_from_flax",
           "load_swin_from_flax", "rtmpose_state_dict_from_flax", "load_rtmpose_from_flax",
           "centernet_state_dict_from_flax", "load_centernet_from_flax",
           "rtmdet_state_dict_from_flax", "load_rtmdet_from_flax", "yolox_state_dict_from_flax",
           "load_yolox_from_flax", "flax_leaves", "load_checkpoint_npz", "save_checkpoint_npz"]

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


def _conv_kernel(path, arr):
    if arr.ndim != 4:
        raise ValueError(f"{'/'.join(path)}: expected a 4-d conv kernel, got {arr.shape}")
    return arr.transpose(3, 2, 0, 1)


def _dense_or_conv_kernel(path, arr):
    if arr.ndim == 2:
        return arr.T
    if arr.ndim != 4:
        raise ValueError(f"{'/'.join(path)}: expected a 2-d or 4-d kernel, got {arr.shape}")
    if path[-2].startswith("deconv_"):
        return arr.transpose(2, 3, 0, 1)
    return arr.transpose(3, 2, 0, 1)


# family -> (kernel layout, parameter names)
_FAMILIES = {
    "hrnet": (_conv_kernel, _PARAM_NAMES),
    "swin": (_dense_or_conv_kernel, dict(_PARAM_NAMES, bias_table="bias_table")),
    "rtmpose": (_dense_or_conv_kernel, dict(_PARAM_NAMES, g="g", gamma="gamma", beta="beta",
                                            res_scale="res_scale")),
    "centernet": (_conv_kernel, _PARAM_NAMES),
    "rtmdet": (_conv_kernel, _PARAM_NAMES),
    "yolox": (_conv_kernel, _PARAM_NAMES),
}


def hrnet_state_dict_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` tree of numpy arrays -> the port's state_dict."""
    return _state_dict_from_flax(variables, *_FAMILIES["hrnet"])


def swin_state_dict_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """A flax `SwinPose` ``{"params", "batch_stats"}`` tree of numpy arrays ->
    the port's `models.swin.SwinPose` state_dict."""
    return _state_dict_from_flax(variables, *_FAMILIES["swin"])


def rtmpose_state_dict_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """A flax `RTMPose` tree of numpy arrays -> the port's `models.rtmpose.RTMPose`
    state_dict."""
    return _state_dict_from_flax(variables, *_FAMILIES["rtmpose"])


def centernet_state_dict_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """A flax `CenterNetDetector` tree -> the port's `models.detector.CenterNetDetector`."""
    return _state_dict_from_flax(variables, *_FAMILIES["centernet"])


def rtmdet_state_dict_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """A flax `RTMDet` tree -> the port's `models.rtmdet.RTMDet` (the head's
    shared ``cls_conv_i`` / ``reg_conv_i`` are one leaf each on both sides)."""
    return _state_dict_from_flax(variables, *_FAMILIES["rtmdet"])


def yolox_state_dict_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """A flax `YOLOX` tree -> the port's `models.yolox.YOLOX`."""
    return _state_dict_from_flax(variables, *_FAMILIES["yolox"])


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


def load_rtmpose_from_flax(model: torch.nn.Module, variables: dict) -> torch.nn.Module:
    """Load a flax RTMPose variables tree into the port's `RTMPose`, strictly."""
    return _load_strict(model, rtmpose_state_dict_from_flax(variables))


def load_centernet_from_flax(model: torch.nn.Module, variables: dict) -> torch.nn.Module:
    """Load a flax CenterNetDetector variables tree into the port's, strictly."""
    return _load_strict(model, centernet_state_dict_from_flax(variables))


def load_rtmdet_from_flax(model: torch.nn.Module, variables: dict) -> torch.nn.Module:
    """Load a flax RTMDet variables tree into the port's `RTMDet`, strictly."""
    return _load_strict(model, rtmdet_state_dict_from_flax(variables))


def load_yolox_from_flax(model: torch.nn.Module, variables: dict) -> torch.nn.Module:
    """Load a flax YOLOX variables tree into the port's `YOLOX`, strictly."""
    return _load_strict(model, yolox_state_dict_from_flax(variables))


_LOADERS = {"hrnet": load_hrnet_from_flax, "swin": load_swin_from_flax,
            "rtmpose": load_rtmpose_from_flax, "centernet": load_centernet_from_flax,
            "rtmdet": load_rtmdet_from_flax, "yolox": load_yolox_from_flax}
_STAT_LEAVES = {v: k for k, v in _STAT_NAMES.items()}


def _kernel_order(kernel, path, ndim: int) -> list[int]:
    """The axis order that takes the port's kernel to the flax layout: the
    inverse of ``kernel``'s transpose, read off a probe of distinct sizes."""
    probe = kernel(path, np.empty(tuple(range(2, 2 + ndim)), np.float32)).shape
    return [int(i) for i in np.argsort([d - 2 for d in probe])]


def flax_leaves(model: torch.nn.Module, family: str) -> list:
    """The flax variables tree of ``model`` as leaves in ``jax.tree.flatten``
    order: (flax path, state_dict key, axis order or None), the flax array
    being ``state_dict[key].permute(order)``.  ``num_batches_tracked`` has
    no leaf; a state_dict entry the map does not cover raises."""
    kernel, names = _FAMILIES[family]
    leaf_names: dict[str, list[str]] = {}
    for flax_name, port_name in names.items():
        leaf_names.setdefault(port_name, []).append(flax_name)
    leaves = []
    for key, value in model.state_dict().items():
        *mods, name = key.split(".")
        if name == "num_batches_tracked":
            continue
        if name in _STAT_LEAVES:
            leaves.append((("batch_stats", *mods, _STAT_LEAVES[name]), key, None))
            continue
        if name not in leaf_names:
            raise KeyError(f"unmapped state_dict entry {key}")
        # "weight" is a kernel (2-d or 4-d) or a norm's scale (1-d).
        leaf = "kernel" if "kernel" in leaf_names[name] and value.dim() >= 2 else next(
            n for n in leaf_names[name] if n != "kernel")
        path = ("params", *mods, leaf)
        order = _kernel_order(kernel, path[1:], value.dim()) if leaf == "kernel" else None
        leaves.append((path, key, order))
    return sorted(leaves, key=lambda leaf: leaf[0])


def _flax_shape(value: torch.Tensor, order) -> tuple:
    return tuple(value.shape) if order is None else tuple(value.shape[i] for i in order)


def load_checkpoint_npz(model: torch.nn.Module, path: str, family: str) -> torch.nn.Module:
    """Load the JAX package's ``.npz`` checkpoint (``save_checkpoint_npz``)
    into ``model`` (``family``: "hrnet", "swin", "rtmpose", "centernet",
    "rtmdet" or "yolox").  A leaf count or a leaf shape that differs from
    the model's raises."""
    leaves = flax_leaves(model, family)
    sd = model.state_dict()
    with np.load(path, allow_pickle=False) as f:
        flat = {k: f[k] for k in f.files}
    if set(flat) != {f"p{i}" for i in range(len(leaves))}:
        raise ValueError(f"checkpoint {path}: {len(flat)} leaves, the {family} model has "
                         f"{len(leaves)}")
    tree: dict = {}
    for i, (fpath, key, order) in enumerate(leaves):
        arr, want = flat[f"p{i}"], _flax_shape(sd[key], order)
        if arr.shape != want:
            raise ValueError(f"checkpoint shape mismatch at p{i} ({'/'.join(fpath)}): "
                             f"{arr.shape} vs {want}")
        node = tree
        for part in fpath[:-1]:
            node = node.setdefault(part, {})
        node[fpath[-1]] = arr
    return _LOADERS[family](model, tree)


def save_checkpoint_npz(model: torch.nn.Module, path: str, family: str) -> None:
    """Write ``model``'s weights as the JAX package's ``save_checkpoint_npz``
    does (float32 leaves ``p{i}`` in ``jax.tree.flatten`` order): the inverse
    of `load_checkpoint_npz`."""
    sd = model.state_dict()
    arrays = {}
    for i, (_, key, order) in enumerate(flax_leaves(model, family)):
        w = sd[key].detach().to("cpu", torch.float32)
        arrays[f"p{i}"] = (w if order is None else w.permute(order)).contiguous().numpy()
    np.savez(path, **arrays)
