"""The RTMDet reference family (``reference/rtmdet.py``) at RTMDet-m's
published widths, on the CPU, on the first two frames (two cameras, 64x48,
resized to 640x480 and padded to 640x640 by the test pipeline) of the
test-sized traffic:

- the drawn state alone collapses: the activations fall until the
  BatchNorms' shifts carry them, and the input no longer reaches the
  scores; ``calibrate`` lifts that: the scores spread and the top-1 boxes
  are tens of pixels;
- the drawn, calibrated state loads strictly into the port's RTMDet-m
  through ``build_detector``, and the port in float32 returns the
  reference's candidate scores and head outputs within float32 rounding.
  The head outputs are compared before the decode: the port turns the
  regression into distances as ``relu(reg) · stride``, where MMDet's
  RTMDet-m (``exp_on_reg``) takes ``exp(reg) · stride``.
"""

import json
import os

import pytest
import torch

from port_bench.catalog import find_family
from port_bench.reference import build_model
from port_bench.traffic import make_blocks
from port_bench.weights import draw_state_dict

from conftest import DATA, ROOT

SEED = 2 ** 31 + 7
# RTMDet-m's detector configuration, as MMDet's rtmdet_m config sets it (the
# port's registry entry "rtmdet_m").
RTMDET_M = {"family": "rtmdet", "registry_name": "rtmdet_m", "widen": 0.75, "deepen": 0.67,
            "neck_out": 192, "num_csp_blocks": 2, "num_classes": 1}


@pytest.fixture(scope="module")
def drawn():
    """(family module, frames (2, 48, 64, 3) uint8, the drawn state)."""
    family = find_family(ROOT, "rtmdet")
    with open(os.path.join(DATA, "port_bench", "traffic", "tiny.json")) as f:
        traffic = json.load(f)
    block = torch.from_numpy(make_blocks(traffic, SEED, "cpu")[0])
    frames = block[0]  # the first time step's two cameras
    meta = build_model(RTMDET_M, "meta", root=ROOT)
    return family, frames, draw_state_dict(meta, SEED, "cpu", 2, family.weight_kind)


def _model(state: dict) -> torch.nn.Module:
    model = build_model(RTMDET_M, "cpu", root=ROOT)
    model.load_state_dict(state, strict=True)
    return model


@torch.no_grad()
def test_calibrate_lifts_the_collapse_of_the_drawn_state(drawn):
    family, frames, state = drawn
    x, scale = family.preprocess(frames)
    assert x.shape == (2, 3, 640, 640) and scale == (10.0, 10.0)
    _, scores = _model(state)(x)
    # Collapsed: the two frames' 8,400 scores each agree to 1.2e-5 (read on
    # four seeds: at most 1.8e-5; calibrated, they differ by 0.5 or more):
    # the input does not reach the head.  Their spread is 0.0151 (0.002-
    # 0.015 on four seeds; calibrated 0.09-0.11).  (Their range reads 0.013-
    # 0.042 at 640x640, so "all within 0.02" does not hold here.)
    assert float((scores[0] - scores[1]).abs().max()) < 1e-3
    assert float(scores.std()) < 0.02

    state = {k: v.clone() for k, v in state.items()}
    family.calibrate(_model(state), state, frames, RTMDET_M)
    boxes, scores = _model(state)(x)
    # Calibrated: the spread over both frames' candidates reads 0.109 (0.09-
    # 0.11 on four seeds), and the top-1 boxes are 92.6 and 59.8 px on the
    # root of their area in the network input (25-161 px on four seeds):
    # boxes a pose model can crop, not sub-pixel ones, and not the frame.
    assert float(scores.std()) >= 0.05
    top = boxes[torch.arange(2), scores.argmax(-1)]
    side = ((top[:, 2] - top[:, 0]).clamp(min=0) * (top[:, 3] - top[:, 1]).clamp(min=0)).sqrt()
    assert 16.0 <= float(side.median()) <= 320.0

    # Every BatchNorm's statistics moved, by a factor shared by its
    # channels: the draw's spread across channels stays.
    for key, drawn_var in drawn[2].items():
        if key.endswith("running_var"):
            ratio = state[key].double() / drawn_var.double()
            assert float(ratio.std() / ratio.mean()) < 1e-6, key
            assert not torch.equal(state[key], drawn_var), key


def test_drawn_state_loads_into_the_port_and_agrees_in_float32(drawn, tmp_path):
    from multi_camera_3d_pose_estimation_tpu_torch.models.registry import build_detector

    family, frames, state = drawn
    state = {k: v.clone() for k, v in state.items()}
    family.calibrate(_model(state), state, frames, RTMDET_M)
    path = str(tmp_path / "detector.pth")
    torch.save({"state_dict": state}, path)
    port = build_detector("rtmdet_m", checkpoint=path, device="cpu", dtype=torch.float32).model
    reference = _model(state)
    x, _ = family.preprocess(frames)
    with torch.no_grad():
        out = port(x)
        _, scores = reference(x)
        levels = reference.levels(x)
    # float32 rounding through ~70 layers: the gaps read 9.2e-6 in the
    # scores and 5.6e-5 / 1.4e-5 in the logits / regressions against
    # largest values of 13.6 / 2.6 (under 1e-5 of them); the limits leave
    # five to ten times that.  One BatchNorm's statistics permuted across
    # its channels moves them by 5-58% of their largest value.
    assert out["scores_all"].shape == scores.shape
    assert float((out["scores_all"] - scores).abs().max()) < 1e-4
    for (cls, reg), (ref_cls, ref_reg) in zip(out["raw"], levels):
        for got, want in ((cls, ref_cls), (reg, ref_reg)):
            want = want.permute(0, 2, 3, 1)
            assert got.shape == want.shape
            assert float((got - want).abs().max()) < 5e-5 * float(want.abs().max())


def test_the_family_exports_what_a_detector_pipeline_needs():
    family = find_family(ROOT, "rtmdet")
    meta = build_model(RTMDET_M, "meta", root=ROOT)
    # 27.37 M tensors' values, 24.71 M of them distinct (the head's shared
    # convs are named at each of three levels): MMDet's 24.71 M for RTMDet-m.
    state = meta.state_dict()
    assert sum(v.numel() for v in state.values()) == 27_366_343
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        boxes, scores = meta(torch.empty((1, 3, 640, 640), device="meta"))
    # 2 per multiply-add: 38.94 G multiply-adds, MMDet's 39.27 GFLOPs.
    assert counter.get_total_flops() == 77_878_149_120
    assert boxes.shape == (1, 8400, 4) and scores.shape == (1, 8400)
    # A 1280x720 frame: halved to 640x360, padded below; RGB in, BGR out.
    frames = torch.tensor([10, 20, 200], dtype=torch.uint8).expand(1, 720, 1280, 3)
    x, scale = family.preprocess(frames)
    assert scale == (0.5, 0.5)
    mean, std = torch.tensor(family.MEAN_BGR), torch.tensor(family.STD_BGR)
    assert torch.allclose(x[0, :, 359, 639], (torch.tensor([200.0, 20.0, 10.0]) - mean) / std)
    assert torch.allclose(x[0, :, 360, 0], (114.0 - mean) / std)
    assert torch.equal(family.to_frame(torch.tensor([[10.0, -4.0, 700.0, 200.0]]), scale,
                                       (720, 1280)),
                       torch.tensor([[20.0, 0.0, 1280.0, 400.0]]))
