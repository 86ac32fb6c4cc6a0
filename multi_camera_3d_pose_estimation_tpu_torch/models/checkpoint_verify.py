"""The checkpoint import drill: the port's model against an independent
MMPose-named model, stage by stage, on the same ``.pth``.

A conversion slip that the converter and the port's own tests share would
pass every end-to-end self-check and still load real checkpoints wrong.
So the drill loads the same state dict into two implementations and
compares their forwards at each stage:

1. the port's model, filled through `models.convert`'s strict name map (a
   missing or leftover key or a shape mismatch aborts);
2. the MMPose mirror (`models.mirrors`), registered in MMPose's order and
   loaded with torch's own ``load_state_dict``.

A shared misreading of, e.g., Swin's relative-position bias shows as a
divergence at the first block that uses it: the report names the stage,
not just "outputs differ".  Both models run in float32 with TF32 off on
``device`` (the card by default; ``device="cpu"`` on a machine without
one); the port's Swin takes its plain attention path, since its kernels
compute in bf16.

CLI: ``python -m multi_camera_3d_pose_estimation_tpu_torch convert
ckpt.pth --model coco_swin-b --verify`` (`cli.convert`).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from . import convert as cv
from .hrnet import HRNET_W32
from .registry import new_model
from .rtmpose import RTMPOSE_T
from .swin import SWIN_B

__all__ = ["verify_checkpoint", "format_report"]

# Forward agreement: both sides compute in float32 with different op orders,
# so they agree to about 1e-4 relative (the parity tests' threshold).
_REL_TOL = 2e-3
# What a mirror may lack or carry beyond the checkpoint: bookkeeping and the
# recomputable Swin position index.
_RECOMPUTABLE = ("num_batches_tracked", "relative_position_index")


def _stage_points(family: str, cfg: dict) -> list[tuple[str, str | None, str]]:
    """(label, the port model's module name or None for its output, the
    mirror's module name) triples: the JAX drill's cut points."""
    if family == "hrnet":
        pts = [("stage1(layer1)", "Bottleneck_3", "layer1")]
        h = 0
        for s, n_mod in enumerate(cfg["modules"][1:], start=2):
            h += n_mod
            pts.append((f"stage{s}", f"HRModule_{h - 1}", f"stage{s}"))
        pts.append(("head", None, "final_layer"))
        return pts
    if family == "rtmpose":
        pts = [(f"backbone.stage{s}", f"backbone.stage{s}_csp", f"backbone.stage{s}")
               for s in (1, 2, 3, 4)]
        pts.append(("head.gau", "gau", "head.gau"))
        return pts
    if family == "swin":
        pts = [(f"stage{i}.block{depth - 1}", f"backbone.stage_{i}_block_{depth - 1}",
                f"backbone.stages.{i}.blocks.{depth - 1}") for i, depth in enumerate(cfg["depths"])]
        pts.append(("backbone.out", "backbone", "backbone"))
        return pts
    raise ValueError(f"unknown family '{family}'")


def _as_numpy(t) -> np.ndarray:
    return t.detach().to("cpu", torch.float64).numpy()


def _compare(label: str, ours, theirs) -> dict:
    """Largest divergence at one cut point (tensors or lists of them),
    relative to the mirror's largest magnitude.  The layouts may differ:
    NHWC against NCHW (the port's Swin), (B, H, W, C) against (B, L, C)."""
    ours = ours if isinstance(ours, (tuple, list)) else (ours,)
    theirs = theirs if isinstance(theirs, (tuple, list)) else (theirs,)
    max_abs = scale = 0.0
    for o, t in zip(ours, theirs):
        o, t = _as_numpy(o), _as_numpy(t)
        if o.shape != t.shape and t.ndim == 4 and t.transpose(0, 2, 3, 1).shape == o.shape:
            t = t.transpose(0, 2, 3, 1)
        elif o.shape != t.shape and o.size == t.size:
            t = t.reshape(o.shape)
        if o.shape != t.shape:
            return {"stage": label, "max_abs": float("inf"), "rel": float("inf"),
                    "note": f"shape {o.shape} vs {t.shape}", "ok": False}
        max_abs = max(max_abs, float(np.max(np.abs(o - t))))
        scale = max(scale, float(np.max(np.abs(t))))
    rel = max_abs / max(scale, 1e-12)
    return {"stage": label, "max_abs": max_abs, "rel": rel, "ok": bool(rel <= _REL_TOL)}


def _mirror(family: str, cfg: dict, num_joints: int, input_size):
    """The MMPose mirror of ``family`` and the prefixes its names drop."""
    if family == "hrnet":
        from .mirrors.hrnet import MMPoseHRNet

        return MMPoseHRNet(cfg, num_joints=num_joints), ("backbone.", "keypoint_head.", "head.")
    if family == "rtmpose":
        from .mirrors.rtmpose import MMPoseRTMPose

        return MMPoseRTMPose(cfg, input_size=input_size, num_joints=num_joints), ()
    from .mirrors.swin import MMPoseSwin

    return MMPoseSwin(cfg, num_joints=num_joints), ()


def _mirror_state(path: str, family: str, strip: tuple) -> dict[str, torch.Tensor]:
    """The checkpoint's tensors under the mirror's names (HRNet: the
    wrapper prefixes removed and ``data_preprocessor.`` dropped)."""
    out = {}
    for k, v in cv.torch_state_dict_to_flat(path).items():
        if family == "hrnet":
            if k.startswith(cv._DROP_PREFIXES):
                continue
            for p in ("module.",) + strip:
                k = k.removeprefix(p)
        out[k] = torch.from_numpy(np.asarray(v))
    return out


def _forward_with_hooks(model, x, points: list, which: int) -> tuple[Any, dict]:
    """``model(x)`` with a forward hook at each cut point's module (entry
    ``which`` of the point): (the output, {label: the module's output})."""
    captured: dict[str, Any] = {}
    named = dict(model.named_modules())
    hooks = []
    for point in points:
        label, name = point[0], point[which]
        if name is not None and name in named:
            hooks.append(named[name].register_forward_hook(
                lambda _m, _i, o, label=label: captured.__setitem__(label, o)))
    try:
        with torch.no_grad():
            out = model(x)
    finally:
        for h in hooks:
            h.remove()
    return out, captured


def verify_checkpoint(path: str, family: str, cfg: dict | None = None, num_joints: int = 17,
                      input_size: tuple[int, int] = (192, 256), seed: int = 0,
                      device="cuda") -> dict:
    """Load ``path`` into the port's model and into the MMPose mirror, and
    compare their forwards stage by stage on ``device``.

    Returns a report: ``converted`` (the strict load succeeded), ``error``
    (its message, or the mirror's load mismatch), ``n_values`` (the values
    loaded), ``stages`` (per cut point the largest absolute and relative
    divergence and ``ok``), ``ok`` (loaded and every stage within
    tolerance).  ``input_size`` is (W, H) as in the registry."""
    defaults = {"hrnet": HRNET_W32, "rtmpose": RTMPOSE_T, "swin": SWIN_B}
    if family not in defaults:
        raise ValueError(f"unknown family '{family}' (expected hrnet|rtmpose|swin)")
    cfg = cfg or defaults[family]
    model = new_model(family, cfg, device, input_size, num_joints, torch.float32)
    mirror, strip = _mirror(family, cfg, num_joints, input_size)
    report: dict[str, Any] = {"family": family, "path": path, "converted": False, "stages": [],
                              "ok": False}
    try:
        cv.TORCH_LOADERS[family](model, path, cfg)
    except ValueError as e:
        report["error"] = str(e)
        return report
    report["converted"] = True
    sd = model.state_dict()
    report["n_values"] = sum(sd[key].numel() for _, key, _ in cv.flax_leaves(model, family))

    # The mirror gets the same tensors through torch's own load.
    missing, unexpected = mirror.load_state_dict(_mirror_state(path, family, strip),
                                                 strict=False)
    bad_missing = [m for m in missing if not m.endswith(_RECOMPUTABLE)]
    bad_unexpected = [u for u in unexpected if not u.endswith(_RECOMPUTABLE)]
    if bad_missing or bad_unexpected:
        report["error"] = (f"mirror load mismatch: missing={bad_missing[:5]} "
                           f"unexpected={bad_unexpected[:5]}")
        return report
    mirror.to(device).eval()

    in_w, in_h = input_size
    x_np = np.random.default_rng(seed).uniform(size=(2, in_h, in_w, 3)).astype(np.float32)
    x = torch.from_numpy(x_np).to(device)
    nchw = x.permute(0, 3, 1, 2)
    points = _stage_points(family, cfg)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        t_out, theirs = _forward_with_hooks(mirror, nchw, points, 2)
        out, ours = _forward_with_hooks(model, x if family == "swin" else nchw, points, 1)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    for label, name, _ in points:
        o = out if name is None else ours.get(label)
        t = theirs.get(label)
        if o is None or t is None:
            report["stages"].append({"stage": label, "max_abs": float("nan"),
                                     "note": "cut point not found", "ok": False})
            continue
        report["stages"].append(_compare(label, o, t))
    if family == "rtmpose":
        final = max(_compare("out.x", out[0], t_out[0])["rel"],
                    _compare("out.y", out[1], t_out[1])["rel"])
        report["stages"].append({"stage": "outputs", "rel": final, "max_abs": float("nan"),
                                 "ok": bool(final <= _REL_TOL)})
    else:
        report["stages"].append(_compare("outputs", out, t_out))
    report["ok"] = all(s.get("ok") for s in report["stages"])
    return report


def format_report(report: dict) -> str:
    """The report as the JAX drill prints it: one line per stage."""
    lines = [f"checkpoint: {report.get('path')}  family: {report['family']}"]
    if not report["converted"]:
        lines.append(f"CONVERSION REFUSED: {report.get('error')}")
        return "\n".join(lines)
    if report.get("error"):
        lines.append(f"MIRROR LOAD FAILED: {report['error']}")
        return "\n".join(lines)
    lines.append(f"converted values: {report.get('n_values', '?')}")
    lines.append(f"{'stage':24s} {'max|Δ|':>12s} {'rel':>10s}  ok")
    for s in report["stages"]:
        lines.append(f"{s['stage']:24s} {s.get('max_abs', float('nan')):12.3e} "
                     f"{s.get('rel', float('nan')):10.2e}  "
                     f"{'PASS' if s.get('ok') else 'FAIL'} {s.get('note', '')}")
    lines.append("VERIFY: " + ("PASS" if report["ok"] else "FAIL"))
    return "\n".join(lines)
