"""Carry weights into the port's ``state_dict``: from a flax variables tree
(HRNet, Swin, RTMPose and the detectors CenterNet, RTMDet, YOLOX), from the
JAX package's ``.npz`` checkpoints, and from MMPose/MMDet ``.pth``
checkpoints (HRNet, RTMPose, Swin, YOLOX, RTMDet; the ``load_torch_*``
functions at the end).

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

import re

import numpy as np
import torch

from .hrnet import HRNET_W32
from .rtmdet import RTMDET_M
from .rtmpose import _P5, RTMPOSE_T
from .swin import SWIN_B
from .yolox import _DARKNET_P5, YOLOX_TINY

__all__ = ["hrnet_state_dict_from_flax", "load_hrnet_from_flax", "swin_state_dict_from_flax",
           "load_swin_from_flax", "rtmpose_state_dict_from_flax", "load_rtmpose_from_flax",
           "centernet_state_dict_from_flax", "load_centernet_from_flax",
           "rtmdet_state_dict_from_flax", "load_rtmdet_from_flax", "yolox_state_dict_from_flax",
           "load_yolox_from_flax", "flax_leaves", "load_checkpoint_npz", "save_checkpoint_npz",
           "torch_state_dict_to_flat", "load_torch_hrnet", "load_torch_rtmpose", "load_torch_swin",
           "load_torch_yolox", "load_torch_rtmdet", "TORCH_LOADERS"]

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


# ---------------------------------------------------------------------------
# MMPose / MMDet ``.pth`` checkpoints.
#
# Each family has a name map of (MMPose/MMDet name, flax path, transform)
# triples: the JAX package's tables for RTMPose, Swin, YOLOX and RTMDet, and
# for HRNet a table written out from MMPose's module structure (the JAX
# package pairs HRNet's tensors by construction order; the table gives the
# same pairs by name).  The flax path then names the port's ``state_dict``
# key and axis order through `flax_leaves`, so nothing depends on the order
# in which a checkpoint or a model lists its tensors.  Strict, as the JAX
# package: a missing key, a tensor the map does not name, or a shape other
# than the model's raises ``ValueError`` and nothing is loaded.

# HRNet's wrapper prefixes (mmengine's ``backbone.`` / ``keypoint_head.`` /
# ``head.``, DataParallel's ``module.``), stripped wherever they lead a name.
_HRNET_WRAPPERS = ("module", "backbone", "keypoint_head", "head")
# Bookkeeping a real checkpoint carries with no model counterpart (the
# normalization constants live in the port's preprocessing).
_DROP_PREFIXES = ("data_preprocessor.",)


def torch_state_dict_to_flat(path: str) -> dict[str, np.ndarray]:
    """A torch checkpoint (``.pth``) as ``{name: ndarray}``, read on the CPU:
    the ``state_dict`` entry where the file has one, entries that are not
    tensors skipped."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    state = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    return {k: v.detach().cpu().numpy() for k, v in state.items() if hasattr(v, "numpy")}


def _conv_w(a: np.ndarray) -> np.ndarray:
    return np.transpose(a, (2, 3, 1, 0))  # OIHW -> HWIO (groups included)


def _linear_w(a: np.ndarray) -> np.ndarray:
    return a.T  # torch (out, in) -> flax (in, out)


def _deconv_w(a: np.ndarray) -> np.ndarray:
    return np.transpose(a, (2, 3, 0, 1))  # torch ConvTranspose (I, O, kh, kw) -> HWIO


def _natural(key: str):
    """'stage10' -> ('stage', 10, '') so that numbers sort as numbers."""
    return tuple(int(p) if p.isdigit() else p for p in re.split(r"(\d+)", key))


def _bn(table: list, tprefix: str, fpath: tuple) -> None:
    table.append((f"{tprefix}.weight", ("params", *fpath, "scale"), None))
    table.append((f"{tprefix}.bias", ("params", *fpath, "bias"), None))
    table.append((f"{tprefix}.running_mean", ("batch_stats", *fpath, "mean"), None))
    table.append((f"{tprefix}.running_var", ("batch_stats", *fpath, "var"), None))


def _convmodule(table: list, tprefix: str, fprefix: tuple) -> None:
    """mmcv's ConvModule: ``conv`` (no bias) and ``bn``."""
    table.append((f"{tprefix}.conv.weight", ("params", *fprefix, "conv", "kernel"), _conv_w))
    _bn(table, f"{tprefix}.bn", (*fprefix, "bn"))


def _depth(n: int, deepen: float) -> int:
    return max(int(round(n * deepen)), 1)


def _hrnet_key_table(cfg: dict | None = None) -> list:
    """(MMPose name, flax path, transform) triples of the HRNet layout, the
    wrapper prefixes stripped: the stem, ``layer1``'s Bottlenecks, each new
    branch's ``transition``, each ``stage``'s HRModules (``branches`` of
    four BasicBlocks, then the ``fuse_layers``) and the ``final_layer``."""
    cfg = cfg or HRNET_W32
    modules, stem = cfg["modules"], cfg["stem"]
    table: list = []

    def convbn(tconv: str, tbn: str, fpath: tuple) -> None:
        table.append((f"{tconv}.weight", ("params", *fpath, "Conv_0", "kernel"), _conv_w))
        _bn(table, tbn, (*fpath, "BatchNorm_0"))

    convbn("conv1", "bn1", ("ConvBN_0",))
    convbn("conv2", "bn2", ("ConvBN_1",))
    for i in range(4):
        t, f = f"layer1.{i}", (f"Bottleneck_{i}",)
        for k in range(3):
            convbn(f"{t}.conv{k + 1}", f"{t}.bn{k + 1}", (*f, f"ConvBN_{k}"))
        if i == 0 and stem != 256:
            convbn(f"{t}.downsample.0", f"{t}.downsample.1", (*f, "ConvBN_3"))
    convbn("transition1.0.0", "transition1.0.1", ("ConvBN_2",))
    # Each new branch: transition{s}.{branch}.0 = (conv, BN, ReLU).
    for s, name in ((1, "ConvBN_3"), (2, "ConvBN_4"), (3, "ConvBN_5")):
        t = f"transition{s}.{s}.0"
        convbn(f"{t}.0", f"{t}.1", (name,))
    final_ms = bool(cfg.get("final_multiscale", False))
    h = 0
    for stage, n_br in ((2, 2), (3, 3), (4, 4)):
        n_mod = modules[stage - 1]
        for m in range(n_mod):
            t, f = f"stage{stage}.{m}", (f"HRModule_{h}",)
            h += 1
            for b in range(n_br):
                for k in range(4):
                    tb, fb = f"{t}.branches.{b}.{k}", (*f, f"BasicBlock_{b * 4 + k}")
                    convbn(f"{tb}.conv1", f"{tb}.bn1", (*fb, "ConvBN_0"))
                    convbn(f"{tb}.conv2", f"{tb}.bn2", (*fb, "ConvBN_1"))
            # Output branch i from input j: one 1x1 ConvBN (j > i), a chain
            # of i - j stride-2 ConvBNs (j < i); the last module of stage 4
            # fuses into branch 0 only.
            n_out = n_br if final_ms or not (stage == 4 and m == n_mod - 1) else 1
            count = 0
            for i in range(n_out):
                for j in range(n_br):
                    tf = f"{t}.fuse_layers.{i}.{j}"
                    chain = [tf] if j > i else [f"{tf}.{k}" for k in range(i - j)]
                    for tc in chain:
                        convbn(f"{tc}.0", f"{tc}.1", (*f, "FuseLayer_0", f"ConvBN_{count}"))
                        count += 1
    table.append(("final_layer.weight", ("params", "head", "kernel"), _conv_w))
    table.append(("final_layer.bias", ("params", "head", "bias"), None))
    return table


def _cspnext_layer(table: list, tprefix: str, fprefix: tuple, num_blocks: int,
                   attention: bool) -> None:
    """mmdet's CSPLayer of CSPNeXt blocks (a depthwise-separable conv2)."""
    for conv in ("main_conv", "short_conv", "final_conv"):
        _convmodule(table, f"{tprefix}.{conv}", (*fprefix, conv))
    for b in range(num_blocks):
        t, f = f"{tprefix}.blocks.{b}", (*fprefix, f"blocks_{b}")
        _convmodule(table, f"{t}.conv1", (*f, "conv1"))
        _convmodule(table, f"{t}.conv2.depthwise_conv", (*f, "conv2", "depthwise_conv"))
        _convmodule(table, f"{t}.conv2.pointwise_conv", (*f, "conv2", "pointwise_conv"))
    if attention:
        table.append((f"{tprefix}.attention.fc.weight",
                      ("params", *fprefix, "attention", "fc", "kernel"), _conv_w))
        table.append((f"{tprefix}.attention.fc.bias",
                      ("params", *fprefix, "attention", "fc", "bias"), None))


def _csp_stages(table: list, stages, deepen: float, csp) -> None:
    """A CSP backbone's stages: ``backbone.stage{s}.0`` (the stride-2 conv),
    the SPP bottleneck where the stage has one, then the CSP layer
    (``csp(tprefix, fprefix, num_blocks)``)."""
    for s, (_ch, nb, _add_id, use_spp) in enumerate(stages, start=1):
        t, f = f"backbone.stage{s}", ("backbone",)
        _convmodule(table, f"{t}.0", (*f, f"stage{s}_down"))
        if use_spp:
            for conv in ("conv1", "conv2"):
                _convmodule(table, f"{t}.1.{conv}", (*f, f"stage{s}_spp", conv))
        csp(f"{t}.{2 if use_spp else 1}", (*f, f"stage{s}_csp"), _depth(nb, deepen))


def _cspnext_backbone(table: list, deepen: float) -> None:
    """CSPNeXt (RTMPose's and RTMDet's backbone): three stem convs, then the
    P5 stages with channel attention in their CSP layers."""
    for i in range(3):
        _convmodule(table, f"backbone.stem.{i}", ("backbone", f"stem_{i}"))
    _csp_stages(table, _P5, deepen,
                lambda t, f, n: _cspnext_layer(table, t, f, n, attention=True))


def _rtmpose_key_table(cfg: dict | None = None) -> list:
    """(MMPose name, flax path, transform) triples of the RTMPose layout: the
    CSPNeXt backbone (``backbone.stage{s}.0`` <-> ``backbone/stage{s}_down``)
    and the RTMCC head's fields one to one."""
    cfg = cfg or RTMPOSE_T
    table: list = []
    _cspnext_backbone(table, cfg["deepen"])
    table.append(("head.final_layer.weight", ("params", "final_layer", "kernel"), _conv_w))
    table.append(("head.final_layer.bias", ("params", "final_layer", "bias"), None))
    table.append(("head.mlp.0.g", ("params", "mlp_ln", "g"), None))
    table.append(("head.mlp.1.weight", ("params", "mlp_fc", "kernel"), _linear_w))
    table.append(("head.gau.ln.g", ("params", "gau", "ln", "g"), None))
    table.append(("head.gau.uv.weight", ("params", "gau", "uv", "kernel"), _linear_w))
    table.append(("head.gau.gamma", ("params", "gau", "gamma"), None))
    table.append(("head.gau.beta", ("params", "gau", "beta"), None))
    table.append(("head.gau.o.weight", ("params", "gau", "o", "kernel"), _linear_w))
    table.append(("head.gau.res_scale.scale", ("params", "gau", "res_scale"), None))
    table.append(("head.cls_x.weight", ("params", "cls_x", "kernel"), _linear_w))
    table.append(("head.cls_y.weight", ("params", "cls_y", "kernel"), _linear_w))
    return table


def _swin_key_table(cfg: dict | None = None) -> list:
    """(MMPose name, flax path, transform) triples of the Swin layout:
    patch_embed, each block (norm1, the window MSA's bias table, qkv and
    proj, norm2, the FFN), each stage's patch merging, the out_indices norm
    (``norm{last stage}``) and the HeatmapHead (deconv, BN, final 1x1)."""
    cfg = cfg or SWIN_B
    table: list = []

    def ln(tprefix: str, fpath: tuple) -> None:
        table.append((f"{tprefix}.weight", ("params", *fpath, "scale"), None))
        table.append((f"{tprefix}.bias", ("params", *fpath, "bias"), None))

    def linear(tprefix: str, fpath: tuple, bias: bool = True) -> None:
        table.append((f"{tprefix}.weight", ("params", *fpath, "kernel"), _linear_w))
        if bias:
            table.append((f"{tprefix}.bias", ("params", *fpath, "bias"), None))

    b = "backbone"
    table.append((f"{b}.patch_embed.projection.weight",
                  ("params", b, "patch_embed_projection", "kernel"), _conv_w))
    table.append((f"{b}.patch_embed.projection.bias",
                  ("params", b, "patch_embed_projection", "bias"), None))
    ln(f"{b}.patch_embed.norm", (b, "patch_embed_norm"))
    for i, depth in enumerate(cfg["depths"]):
        for j in range(depth):
            t, f = f"{b}.stages.{i}.blocks.{j}", (b, f"stage_{i}_block_{j}")
            ln(f"{t}.norm1", (*f, "norm1"))
            table.append((f"{t}.attn.w_msa.relative_position_bias_table",
                          ("params", *f, "attn", "bias_table"), None))
            linear(f"{t}.attn.w_msa.qkv", (*f, "attn", "qkv"))
            linear(f"{t}.attn.w_msa.proj", (*f, "attn", "proj"))
            ln(f"{t}.norm2", (*f, "norm2"))
            linear(f"{t}.ffn.layers.0.0", (*f, "ffn_fc1"))
            linear(f"{t}.ffn.layers.1", (*f, "ffn_fc2"))
        if i < len(cfg["depths"]) - 1:
            t, f = f"{b}.stages.{i}.downsample", (b, f"downsample_{i}")
            ln(f"{t}.norm", (*f, "norm"))
            linear(f"{t}.reduction", (*f, "reduction"), bias=False)
    ln(f"{b}.norm{len(cfg['depths']) - 1}", (b, "out_norm"))
    for d in range(len(cfg["deconv"])):
        table.append((f"head.deconv_layers.{3 * d}.weight", ("params", f"deconv_{d}", "kernel"),
                      _deconv_w))
        _bn(table, f"head.deconv_layers.{3 * d + 1}", (f"deconv_bn_{d}",))
    table.append(("head.final_layer.weight", ("params", "final_layer", "kernel"), _conv_w))
    table.append(("head.final_layer.bias", ("params", "final_layer", "bias"), None))
    return table


def _pafpn(table: list, csp, n_blocks: int) -> None:
    """The PAFPN neck of YOLOX and RTMDet: two reduce convs, top-down CSP
    layers, downsample convs and bottom-up CSP layers (``csp``), and three
    out convs."""
    for i in range(2):
        _convmodule(table, f"neck.reduce_layers.{i}", ("neck", f"reduce_{i}"))
        csp(f"neck.top_down_blocks.{i}", ("neck", f"top_down_{i}"), n_blocks)
        _convmodule(table, f"neck.downsamples.{i}", ("neck", f"downsample_{i}"))
        csp(f"neck.bottom_up_blocks.{i}", ("neck", f"bottom_up_{i}"), n_blocks)
    for i in range(3):
        _convmodule(table, f"neck.out_convs.{i}", ("neck", f"out_{i}"))


def _yolox_key_table(cfg: dict | None = None) -> list:
    """(MMDet name, flax path, transform) triples of the YOLOX layout: the
    CSPDarknet backbone (Focus stem), the YOLOXPAFPN neck and the decoupled
    head's per-level convs."""
    cfg = cfg or YOLOX_TINY
    table: list = []

    def conv2d(tprefix: str, fprefix: tuple) -> None:
        table.append((f"{tprefix}.weight", ("params", *fprefix, "kernel"), _conv_w))
        table.append((f"{tprefix}.bias", ("params", *fprefix, "bias"), None))

    def csplayer(tprefix: str, fprefix: tuple, num_blocks: int) -> None:
        for conv in ("main_conv", "short_conv", "final_conv"):
            _convmodule(table, f"{tprefix}.{conv}", (*fprefix, conv))
        for b in range(num_blocks):
            bb = (*fprefix, f"blocks_{b}")
            _convmodule(table, f"{tprefix}.blocks.{b}.conv1", (*bb, "conv1"))
            _convmodule(table, f"{tprefix}.blocks.{b}.conv2", (*bb, "conv2"))

    _convmodule(table, "backbone.stem.conv", ("backbone", "stem_conv"))
    _csp_stages(table, _DARKNET_P5, cfg["deepen"], csplayer)
    _pafpn(table, csplayer, _depth(3, cfg["deepen"]))
    for lvl in range(3):
        for i in range(2):
            _convmodule(table, f"bbox_head.multi_level_cls_convs.{lvl}.{i}",
                        ("head", f"cls_convs_{lvl}_{i}"))
            _convmodule(table, f"bbox_head.multi_level_reg_convs.{lvl}.{i}",
                        ("head", f"reg_convs_{lvl}_{i}"))
        for what in ("cls", "reg", "obj"):
            conv2d(f"bbox_head.multi_level_conv_{what}.{lvl}", ("head", f"conv_{what}_{lvl}"))
    return table


def _rtmdet_key_table(cfg: dict | None = None) -> tuple[list, dict]:
    """(MMDet name, flax path, transform) triples of the RTMDet layout, and
    the share_conv duplicates: ``{level > 0 head conv name: its level-0
    name}``.  mmdet's RTMDetSepBNHead (``share_conv=True``) shares those
    convs across levels, so the state dict carries identical copies; the
    port, like the JAX package, has one kernel per conv and a BatchNorm per
    level."""
    cfg = cfg or RTMDET_M
    table: list = []

    _cspnext_backbone(table, cfg["deepen"])
    # The neck's CSP layers have no channel attention.
    _pafpn(table, lambda t, f, n: _cspnext_layer(table, t, f, n, attention=False),
           cfg.get("num_csp_blocks", 2))
    stacked = cfg.get("stacked_convs", 2)
    shared: dict[str, str] = {}
    for i in range(stacked):
        for branch in ("cls", "reg"):
            src = f"bbox_head.{branch}_convs.0.{i}.conv.weight"
            table.append((src, ("params", "head", f"{branch}_conv_{i}", "kernel"), _conv_w))
            for lvl in (1, 2):
                shared[f"bbox_head.{branch}_convs.{lvl}.{i}.conv.weight"] = src
    for lvl in range(3):
        for i in range(stacked):
            for branch in ("cls", "reg"):
                _bn(table, f"bbox_head.{branch}_convs.{lvl}.{i}.bn",
                    ("head", f"{branch}_bn_{lvl}_{i}"))
        for what in ("cls", "reg"):
            table.append((f"bbox_head.rtm_{what}.{lvl}.weight",
                          ("params", "head", f"rtm_{what}_{lvl}", "kernel"), _conv_w))
            table.append((f"bbox_head.rtm_{what}.{lvl}.bias",
                          ("params", "head", f"rtm_{what}_{lvl}", "bias"), None))
    return table, shared


def _load_torch(model: torch.nn.Module, family: str, state: dict, table: list, what: str,
                ignore: tuple = ()) -> torch.nn.Module:
    """Fill ``model`` from ``state`` ({MMPose/MMDet name: ndarray}) through
    the name map ``table``, strictly: every name of the map present, every
    tensor of ``state`` named by it (``num_batches_tracked`` and names
    ending in ``ignore`` aside), every shape the model's, every leaf of the
    model filled.  Raises ``ValueError`` before anything is loaded."""
    names = {tkey for tkey, _, _ in table}
    missing = [tkey for tkey, _, _ in table if tkey not in state]
    if missing:
        raise ValueError(f"{what} checkpoint missing {len(missing)} expected keys, e.g. "
                         f"{missing[:5]}: is it a {what} checkpoint of the configured size?")
    skip = ("num_batches_tracked",) + ignore
    leftovers = sorted((k for k in state if k not in names and not k.endswith(skip)),
                       key=_natural)
    if leftovers:
        raise ValueError(f"{what} checkpoint has {len(leftovers)} unexpected tensors, e.g. "
                         f"{leftovers[:5]}: an unsupported {what} variant?  Refusing to load "
                         f"partially.")
    leaves = {fpath: (key, order) for fpath, key, order in flax_leaves(model, family)}
    want = model.state_dict()
    sd: dict[str, torch.Tensor] = {}
    for tkey, fpath, tf in table:
        if fpath not in leaves:
            raise ValueError(f"{tkey} maps to {'/'.join(fpath)}, which the {what} model lacks")
        key, order = leaves[fpath]
        arr = np.asarray(tf(state[tkey]) if tf else state[tkey], np.float32)
        shape = _flax_shape(want[key], order)
        if arr.shape != shape:
            raise ValueError(f"shape mismatch at {tkey} -> {'/'.join(fpath)}: checkpoint "
                             f"{arr.shape} vs model {shape}")
        if order is not None:
            arr = arr.transpose(np.argsort(order))
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
    unfilled = sorted("/".join(p) for p in set(leaves) - {fpath for _, fpath, _ in table})
    if unfilled:
        raise ValueError(f"the {what} name map fills {len(leaves) - len(unfilled)} of the "
                         f"model's {len(leaves)} leaves; not {unfilled[:5]}")
    for key, value in want.items():
        if key.endswith("num_batches_tracked"):
            sd[key] = torch.zeros_like(value, device="cpu")
    return _load_strict(model, sd)


def _unwrap(path: str, drop: tuple = ()) -> dict[str, np.ndarray]:
    """The checkpoint's tensors, ``module.`` removed from the front of each
    name and names starting with ``drop`` left out."""
    return {k.removeprefix("module."): v for k, v in torch_state_dict_to_flat(path).items()
            if not k.startswith(drop)}


def load_torch_hrnet(model: torch.nn.Module, path: str, cfg: dict | None = None):
    """Load an MMPose HRNet heatmap checkpoint into the port's `HRNet`.

    ``cfg``: the HRNet cfg of the model (default: the model's own, else
    HRNET_W32).  Names may carry the wrapper prefixes ``module.`` /
    ``backbone.`` / ``keypoint_head.`` / ``head.`` in any combination;
    ``data_preprocessor.`` buffers are dropped; the order of the names does
    not matter."""
    cfg = cfg or getattr(model, "cfg", None) or HRNET_W32
    state: dict[str, np.ndarray] = {}
    for name, arr in torch_state_dict_to_flat(path).items():
        if name.startswith(_DROP_PREFIXES):
            continue
        parts = name.split(".")
        while parts and parts[0] in _HRNET_WRAPPERS:
            parts = parts[1:]
        key = ".".join(parts)
        if key in state:
            raise ValueError(f"HRNet checkpoint names {key!r} twice (with and without a "
                             f"wrapper prefix)")
        state[key] = arr
    return _load_torch(model, "hrnet", state, _hrnet_key_table(cfg), "HRNet")


def load_torch_rtmpose(model: torch.nn.Module, path: str, cfg: dict | None = None):
    """Load an MMPose RTMPose (CSPNeXt + RTMCC head) checkpoint into the
    port's `RTMPose`; ``cfg``: its widen/deepen/embed cfg (default: the
    model's own, else RTMPOSE_T)."""
    cfg = cfg or getattr(model, "cfg", None) or RTMPOSE_T
    return _load_torch(model, "rtmpose", _unwrap(path), _rtmpose_key_table(cfg), "RTMPose")


def load_torch_swin(model: torch.nn.Module, path: str, cfg: dict | None = None):
    """Load an MMPose Swin heatmap checkpoint into the port's `SwinPose`;
    ``cfg``: its Swin cfg (default: the model's own, else SWIN_B).  The
    ``relative_position_index`` buffers are recomputed by the model, never
    read."""
    cfg = cfg or getattr(model, "cfg", None) or SWIN_B
    return _load_torch(model, "swin", _unwrap(path), _swin_key_table(cfg), "Swin",
                       ignore=("relative_position_index",))


def load_torch_yolox(model: torch.nn.Module, path: str, cfg: dict | None = None):
    """Load an MMDet YOLOX checkpoint into the port's `YOLOX`; ``cfg``: its
    widen/deepen cfg (default YOLOX_TINY); ``data_preprocessor.`` buffers
    are dropped."""
    cfg = cfg or YOLOX_TINY
    return _load_torch(model, "yolox", _unwrap(path, _DROP_PREFIXES), _yolox_key_table(cfg),
                       "YOLOX")


def load_torch_rtmdet(model: torch.nn.Module, path: str, cfg: dict | None = None):
    """Load an MMDet RTMDet checkpoint into the port's `RTMDet`; ``cfg``:
    its widen/deepen/neck cfg (default RTMDET_M).  The head's share_conv
    copies must equal their level-0 source bit for bit (one kernel each in
    the model); ``data_preprocessor.`` buffers are dropped."""
    cfg = cfg or RTMDET_M
    state = _unwrap(path, _DROP_PREFIXES)
    table, shared = _rtmdet_key_table(cfg)
    for dup, src in shared.items():
        if dup in state and src in state and not np.array_equal(state[dup], state[src]):
            raise ValueError(f"share_conv violation: {dup} differs from {src}; this checkpoint "
                             f"was not trained with RTMDetSepBNHead's share_conv=True")
    return _load_torch(model, "rtmdet", {k: v for k, v in state.items() if k not in shared},
                       table, "RTMDet")


TORCH_LOADERS = {"hrnet": load_torch_hrnet, "rtmpose": load_torch_rtmpose,
                 "swin": load_torch_swin, "yolox": load_torch_yolox, "rtmdet": load_torch_rtmdet}
