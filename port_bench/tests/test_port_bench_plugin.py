"""A configuration of a new model family, with a person detector ahead of
the pose model and a judge of its own, added as new files and entries
alone: in a copy of the test-sized benchmark, a family module that needs
``weight_kind``, a detector family that overrides a shared rule and
calibrates what it drew, a pipeline module whose judge replays through the
reference models it is given, a traffic mix, a limits file and a
``workloads`` entry, and nothing else; then ``run_cell`` on the CPU
through ``build_estimate_pipeline`` to a verdict.

The toy proves the wiring, not a model: its pose family is the HRNet
reference with the normalization buffers a real MMPose checkpoint carries
(which the program's loader drops), its detector family takes the port's
own MMDet-named RTMDet mirror for its names and shapes (SiLU ConvModules
with BatchNorm; ``share_conv`` binds the head's convs across levels), and
its judge counts the frames that came back and replays the detector."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile

import pytest
import torch

from port_bench.catalog import Catalog
from port_bench.harness import CALIBRATION_FRAMES, Cell, run_cell
from port_bench.reference import build_model
from port_bench.weights import draw_state_dict

from conftest import ROOT, tiny_root

SEED = 2 ** 32 + 17

TOY_POSE = '''
import torch

from port_bench.reference.hrnet import HRNetRef

HEAD_KEY = "head.final_layer.weight"


class MODEL(HRNetRef):
    def __init__(self, cfg):
        super().__init__(cfg)
        self.data_preprocessor = torch.nn.Module()
        self.data_preprocessor.register_buffer("mean", torch.zeros(3))
        self.data_preprocessor.register_buffer("std", torch.ones(3))


def weight_kind(key, module, param):
    if key.startswith("data_preprocessor."):
        return ("uniform", (0.5, 1.5))
    return None
'''

TOY_DETECTOR = '''
import torch

from multi_camera_3d_pose_estimation_tpu_torch.models.mirrors.rtmdet import MMDetRTMDet
from multi_camera_3d_pose_estimation_tpu_torch.models.registry import DETECTOR_REGISTRY

HEAD_KEY = None
REG_BIAS = (2.5, 3.5)


class MODEL(MMDetRTMDet):
    def __init__(self, cfg):
        super().__init__(DETECTOR_REGISTRY[cfg["registry_name"]]["cfg"])


def weight_kind(key, module, param):
    if key.startswith("bbox_head.rtm_reg.") and key.endswith(".bias"):
        return ("uniform", REG_BIAS)  # a conv's bias, which a shared rule covers
    return None


def network_input(frames_u8):
    return frames_u8.permute(0, 3, 1, 2).float() / 255.0


@torch.no_grad()
def calibrate(model, state, frames_u8, cfg):
    norms = {m: n for n, m in model.named_modules() if isinstance(m, torch.nn.BatchNorm2d)}

    def set_statistics(mod, args):
        ms = args[0].double().square().mean()
        mod.running_var.copy_(state[norms[mod] + ".running_var"] * ms)
        mod.running_mean.copy_(state[norms[mod] + ".running_mean"] * ms.sqrt())

    hooks = [m.register_forward_pre_hook(set_statistics) for m in norms]
    try:
        model(network_input(frames_u8[:2]))
    finally:
        for hook in hooks:
            hook.remove()
    for m, n in norms.items():
        state[n + ".running_var"].copy_(m.running_var)
        state[n + ".running_mean"].copy_(m.running_mean)
'''

TOY_PIPELINE = '''
import numpy as np
import torch

from port_bench.bounds import model_flops_per_crop
from port_bench.reference.topdown import crop, crop_geometry

NAMES = ("frames_gap", "replay_gap")
MEANS = ()


def calibration_crops(models, frames_u8, cfg):
    T, C, H, W, _ = frames_u8.shape
    frames = frames_u8.reshape(T * C, H, W, 3)
    boxes = torch.tensor([0.0, 0.0, float(W), float(H)]).expand(T * C, 4)
    origin, scale = crop_geometry(boxes, cfg["input_size"], cfg["bbox_padding"])
    return crop(frames.float() / 255.0, origin, scale, cfg["input_size"])


@torch.no_grad()
def run_block(models, frames_u8, cfg, rig, rounding):
    T, C, H, W, _ = frames_u8.shape
    x = frames_u8.reshape(T * C, H, W, 3).permute(0, 3, 1, 2).float() / 255.0
    _, scores = models["detector"](x)
    return {"frames": T, "x": x, "top1_score": scores.amax(-1)}


@torch.no_grad()
def judge(outputs, n_blocks, refs, rig, cfg, device, models):
    gap = float(abs(outputs[0].shape[0] - n_blocks * refs[0]["frames"]))
    replay = max(float((models["detector"](r["x"])[1].amax(-1) - r["top1_score"]).abs().max())
                 for r in refs)
    numbers = {"frames_gap": gap, "replay_gap": replay}
    return {"numbers": numbers,
            "per_block": {n: np.full(n_blocks, v) for n, v in numbers.items()}}


def program_kwargs(cfg, checkpoints):
    det = cfg["detector"]
    return {"detector_model": det["registry_name"], "detector_checkpoint": checkpoints["detector"],
            "detector_bbox_thr": det["bbox_thr"], "detector_select": "top1"}


def flops_per_crop(meta_models, cfg, traffic):
    in_w, in_h = cfg["input_size"]
    pose = model_flops_per_crop(
        lambda: meta_models["pose"](torch.empty((1, 3, in_h, in_w), device="meta")))
    frame = model_flops_per_crop(lambda: meta_models["detector"](
        torch.empty((1, 3, traffic["height"], traffic["width"]), device="meta")))
    return pose + frame  # one crop a frame: the top-1 box
'''


def _add_toy(root: str) -> None:
    """The toy's files and entries, added to the copy at ``root``."""
    bench = os.path.join(root, "port_bench")

    def write(rel: str, text: str) -> None:
        with open(os.path.join(bench, rel), "w") as f:
            f.write(text)

    write("reference/toy_pose.py", TOY_POSE)
    write("reference/toy_rtmdet.py", TOY_DETECTOR)
    write("reference/pipelines/toy_detect.py", TOY_PIPELINE)
    with open(os.path.join(bench, "configs", "tiny_hrnet.json")) as f:
        cfg = json.load(f)
    cfg.update(name="toy_detect", family="toy_pose", pipeline="toy_detect",
               detector={"family": "toy_rtmdet", "registry_name": "test_rtmdet_micro",
                         "bbox_thr": 0.3})
    write("configs/toy_detect.json", json.dumps(cfg))
    with open(os.path.join(bench, "traffic", "tiny.json")) as f:
        traffic = json.load(f)
    traffic.update(height=64, width=64)  # strides 8-32 of the detector's levels
    write("traffic/tiny_square.json", json.dumps(traffic))
    write("limits/toy_detect_cell.json", json.dumps({"frames_gap": {"limit": 0.0},
                                                     "replay_gap": {"limit": 0.0}}))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "toy_detect", "source": "port_bench/tests",
                            "file": "port_bench/configs/toy_detect.json", "reduced": [],
                            "why": "test"})
    spec["workloads"].append({"name": "toy_detect_cell", "config": "toy_detect",
                              "traffic": "tiny_square", "chips": 1, "why": "test"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)


def _files(top: str) -> dict:
    """{path: (size, mtime)} of the files under ``top``, bytecode aside."""
    out = {}
    for dirpath, dirs, files in os.walk(top):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for name in files:
            path = os.path.join(dirpath, name)
            st = os.stat(path)
            out[path] = (st.st_size, st.st_mtime_ns)
    return out


@pytest.fixture
def toy_catalog(tmp_path, monkeypatch):
    """The copy with the toy added, the temporary directory inside it, and
    one CPU thread."""
    root = tiny_root(tmp_path / "root")
    _add_toy(root)
    tmp = os.path.join(root, "tmp")
    os.makedirs(tmp)
    monkeypatch.setattr(tempfile, "tempdir", tmp)
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield Catalog(root)
    finally:
        torch.set_num_threads(saved)


def test_a_family_that_needs_weight_kind_is_refused_without_it(toy_catalog):
    cfg = toy_catalog.config("toy_detect")
    meta = build_model(cfg, "meta", root=toy_catalog.root)
    with pytest.raises(ValueError, match="weight_kind"):
        draw_state_dict(meta, SEED, "cpu")
    state = draw_state_dict(meta, SEED, "cpu", 0, toy_catalog.family("toy_pose").weight_kind)
    assert set(state) == set(meta.state_dict())
    assert ((state["data_preprocessor.std"] >= 0.5) & (state["data_preprocessor.std"] < 1.5)).all()


def _calibrated_detector(cat: Catalog, frames_u8: torch.Tensor) -> dict:
    """The toy detector's state as the harness makes it: stream 2 of the
    toy family's distributions, then its ``calibrate`` on ``frames_u8``."""
    cfg = cat.config("toy_detect")["detector"]
    family = cat.family("toy_rtmdet")
    state = draw_state_dict(build_model(cfg, "meta", root=cat.root), SEED, "cpu", 2,
                            family.weight_kind)
    model = build_model(cfg, "cpu", root=cat.root)
    model.load_state_dict(state, strict=True)
    family.calibrate(model, state, frames_u8, cfg)
    return state


def _head_norm_rms(cat: Catalog, state: dict, frames_u8: torch.Tensor) -> list:
    """The RMS of the output of each BatchNorm of the toy detector's head."""
    cfg = cat.config("toy_detect")["detector"]
    model = build_model(cfg, "cpu", root=cat.root)
    model.load_state_dict(state, strict=True)
    rms = []
    hooks = [m.register_forward_hook(lambda m, a, out: rms.append(float(out.square().mean().sqrt())))
             for n, m in model.named_modules() if n.startswith("bbox_head.") and n.endswith(".bn")]
    with torch.no_grad():
        model(cat.family("toy_rtmdet").network_input(frames_u8[:2]))
    for hook in hooks:
        hook.remove()
    return rms


def _first_frames(cell: Cell) -> torch.Tensor:
    """The frames a family's ``calibrate`` gets: every camera of the first
    block's first `CALIBRATION_FRAMES` time steps."""
    first = torch.from_numpy(cell.host[0][:CALIBRATION_FRAMES])
    return first.reshape(-1, *first.shape[2:])


def test_cell_draws_the_detector_from_its_own_stream_and_calibrates_it(toy_catalog):
    cell = Cell(toy_catalog, "toy_detect_cell", SEED, "cpu")
    assert set(cell.states) == {"pose", "detector"}
    det_cfg = cell.cfg["detector"]
    meta = build_model(det_cfg, "meta", root=toy_catalog.root)
    family = toy_catalog.family("toy_rtmdet")
    drawn = draw_state_dict(meta, SEED, "cpu", 2, family.weight_kind)
    want = _calibrated_detector(toy_catalog, _first_frames(cell))
    assert set(cell.states["detector"]) == set(want)
    assert all(torch.equal(cell.states["detector"][k], want[k]) for k in want)
    # Calibrated: every BatchNorm's statistics and nothing else moved.
    moved = {k for k in want if not torch.equal(want[k], drawn[k])}
    assert moved == {k for k in want if k.endswith(("running_mean", "running_var"))}
    # The family's weight_kind comes first, also for a name that a shared
    # rule covers (a bias, N(0, 0.02²) by the shared rules).
    bias = want["bbox_head.rtm_reg.0.bias"]
    assert ((bias >= 2.5) & (bias < 3.5)).all()
    other = draw_state_dict(meta, SEED, "cpu", 0, family.weight_kind)
    assert not torch.equal(want["bbox_head.rtm_cls.0.weight"], other["bbox_head.rtm_cls.0.weight"])
    # share_conv: the head's level convs are one tensor, drawn once.
    assert torch.equal(want["bbox_head.cls_convs.1.0.conv.weight"],
                       want["bbox_head.cls_convs.0.0.conv.weight"])
    # The pose weights: stream 0 of the toy family's names, the head scaled.
    family = toy_catalog.family("toy_pose")
    pose = draw_state_dict(build_model(cell.cfg, "meta", root=toy_catalog.root), SEED, "cpu", 0,
                           family.weight_kind)
    head = (family.HEAD_KEY, family.HEAD_KEY.removesuffix("weight") + "bias")
    assert set(cell.states["pose"]) == set(pose)
    for k, v in pose.items():
        assert torch.equal(cell.states["pose"][k], v.mul_(cell.head_scale) if k in head else v)
    # A detector's operations, spread over the crops, add to the pose model's.
    alone = Cell(toy_catalog, "tiny_hrnet_cell", SEED, "cpu")
    assert cell.pipe.flops_per_crop(cell.meta, cell.cfg, cell.traffic) > \
        alone.pipe.flops_per_crop(alone.meta, alone.cfg, alone.traffic)


def test_calibrate_holds_the_toy_detectors_activations_at_unit_scale(toy_catalog):
    cell = Cell(toy_catalog, "toy_detect_cell", SEED, "cpu")
    frames = _first_frames(cell)
    meta = build_model(cell.cfg["detector"], "meta", root=toy_catalog.root)
    drawn = draw_state_dict(meta, SEED, "cpu", 2, toy_catalog.family("toy_rtmdet").weight_kind)
    # Drawn alone, each SiLU layer shrinks the scale: the head's BatchNorms
    # put out 0.065-0.090 RMS (the shifts' N(0, 0.05²) carry it); calibrated,
    # 0.98-1.06.
    assert max(_head_norm_rms(toy_catalog, drawn, frames)) < 0.1
    assert all(0.5 <= v <= 2.0 for v in _head_norm_rms(toy_catalog, cell.states["detector"],
                                                        frames))


def test_two_processes_draw_and_calibrate_the_same_bits(toy_catalog):
    code = f"""
import hashlib, sys
import torch
sys.path.insert(0, {ROOT!r})
torch.set_num_threads(1)
from port_bench.catalog import Catalog
from port_bench.harness import Cell
cell = Cell(Catalog({toy_catalog.root!r}), "toy_detect_cell", {SEED}, "cpu")
h = hashlib.sha256()
for role in sorted(cell.states):
    for k in sorted(cell.states[role]):
        h.update(f"{{role}}.{{k}}".encode())
        h.update(cell.states[role][k].contiguous().numpy().tobytes())
print(h.hexdigest())
"""
    digests = [subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              cwd=toy_catalog.root, check=True, timeout=300
                              ).stdout.split()[-1] for _ in range(2)]
    cell = Cell(toy_catalog, "toy_detect_cell", SEED, "cpu")
    h = hashlib.sha256()
    for role in sorted(cell.states):
        for k in sorted(cell.states[role]):
            h.update(f"{role}.{k}".encode())
            h.update(cell.states[role][k].contiguous().numpy().tobytes())
    assert digests == [h.hexdigest()] * 2


def test_run_cell_with_a_detector_reaches_a_verdict_through_new_files_alone(toy_catalog,
                                                                            monkeypatch):
    from multi_camera_3d_pose_estimation_tpu_torch.cli import estimate
    from multi_camera_3d_pose_estimation_tpu_torch.models.registry import build_detector

    root = toy_catalog.root
    built, saved = [], {}

    def spy_detector(name, checkpoint=None, **kw):
        detector = build_detector(name, checkpoint=checkpoint, **kw)
        built.append((name, checkpoint, kw, detector))
        return detector

    real_save = torch.save

    def spy_save(obj, path, *args, **kw):
        saved[os.path.abspath(path)] = {
            "state_dict": {k: v.clone() for k, v in obj["state_dict"].items()}}
        return real_save(obj, path, *args, **kw)

    monkeypatch.setattr(estimate, "build_detector", spy_detector)
    monkeypatch.setattr(torch, "save", spy_save)
    before = _files(os.path.join(ROOT, "port_bench")), os.stat(
        os.path.join(ROOT, "BENCHMARK.json")).st_mtime_ns
    result = run_cell(toy_catalog, "toy_detect_cell", SEED, 3.0, trace=False, device="cpu",
                      log=lambda msg: None)
    assert result["correct"] is True and result["failed"] == 0
    assert result["checks"] == {"frames_gap": {"value": 0.0, "limit": 0.0},
                                "replay_gap": {"value": 0.0, "limit": 0.0}}

    # The program ran RTMDet from the detector's own checkpoint, top-1: the
    # calibrated state, as the harness wrote it.
    (name, ckpt, kw, detector), = built
    assert name == "test_rtmdet_micro" and kw["select"] == "top1" and kw["bbox_thr"] == 0.3
    assert os.path.basename(ckpt) == "detector.pth" and detector.model is not None
    state = _calibrated_detector(toy_catalog, _first_frames(
        Cell(toy_catalog, "toy_detect_cell", SEED, "cpu")))
    written = saved[os.path.abspath(ckpt)]["state_dict"]
    assert set(written) == set(state) and all(torch.equal(written[k], state[k]) for k in state)
    path = os.path.join(root, "tmp", "want.pth")
    real_save({"state_dict": state}, path)
    want = build_detector(name, checkpoint=path, **kw).model.state_dict()
    got = detector.model.state_dict()
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)

    # Nothing was written outside the temporary root, and the project is gone.
    assert saved and all(p.startswith(os.path.abspath(root) + os.sep) for p in saved)
    assert os.listdir(os.path.join(root, "tmp")) == ["want.pth"]
    assert (_files(os.path.join(ROOT, "port_bench")), os.stat(
        os.path.join(ROOT, "BENCHMARK.json")).st_mtime_ns) == before
    shutil.rmtree(os.path.join(root, "tmp"))
