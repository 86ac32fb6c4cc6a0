"""The plain reference held against the port's CPU path, both in float32, on
the same seeded MMPose-format state dict: the crop, HRNet and Swin (with
shifted, padded windows), the decode and the triangulation.  The port is
imported here only, never by the reference."""

import json
import os

import numpy as np
import pytest
import torch

from port_bench.reference import build_model
from port_bench.reference.topdown import crop, crop_geometry, decode_maps
from port_bench.reference.triangulate import dlt_gap, triangulate_top2
from port_bench.rig import make_rig
from port_bench.weights import calibrate_head, draw_state_dict

from conftest import DATA, ROOT

SWIN_PADDED = {"family": "swin", "num_joints": 17, "input_size": [192, 256], "embed": 48,
               "depths": [2, 2, 4, 2], "heads": [2, 4, 8, 16], "window": 7, "mlp_ratio": 2,
               "deconv": [64, 64, 64]}


def _data_cfg(name):
    with open(os.path.join(DATA, "port_bench", "configs", f"{name}.json")) as f:
        return json.load(f)


def _port_model(registry_name, state, tmp_path):
    from multi_camera_3d_pose_estimation_tpu_torch.models.registry import build_estimator

    path = str(tmp_path / "weights.pth")
    torch.save({"state_dict": state}, path)
    return build_estimator(registry_name, checkpoint=path, device="cpu",
                           dtype=torch.float32).model


def _crops(seed, n, hw):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, 3) + tuple(hw), generator=g)


@pytest.mark.parametrize("cfg,registry_name", [
    (_data_cfg("tiny_hrnet"), "test_tiny"),
    (_data_cfg("tiny_swin"), "test_swin_128"),
    (SWIN_PADDED, "test_swin_192x256"),
], ids=["hrnet_tiny", "swin_tiny", "swin_padded_shifted"])
def test_model_matches_the_port_in_float32(cfg, registry_name, tmp_path):
    ref = build_model(cfg)
    state = draw_state_dict(ref, seed=3, device="cpu")
    ref.load_state_dict(state, strict=True)
    port = _port_model(registry_name, state, tmp_path)
    in_w, in_h = cfg["input_size"]
    x = _crops(5, 2, (in_h, in_w))
    with torch.no_grad():
        want = ref(x)
        if cfg["family"] == "swin":
            got = port(x.permute(0, 2, 3, 1).contiguous())
        else:
            got = port(x)
    assert got.shape == want.shape
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 2e-5 * scale


@pytest.mark.parametrize("name", ["hrnet_w32_coco_256x192", "swin_b_coco_256x192"])
def test_state_dict_names_are_the_ports_mmpose_names(name):
    from multi_camera_3d_pose_estimation_tpu_torch.models import convert

    with open(os.path.join(ROOT, "port_bench", "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    ours = {k for k in build_model(cfg, "meta").state_dict()
            if not k.endswith("num_batches_tracked")}
    if cfg["family"] == "hrnet":
        theirs = {"backbone." + k if not k.startswith("final_layer") else "head." + k
                  for k, _, _ in convert._hrnet_key_table(
                      {"widths": tuple(cfg["widths"]), "modules": tuple(cfg["modules"]),
                       "stem": cfg["stem"]})}
    else:
        arch = {k: tuple(cfg[k]) if isinstance(cfg[k], list) else cfg[k]
                for k in ("embed", "depths", "heads", "window", "mlp_ratio", "deconv")}
        theirs = {k for k, _, _ in convert._swin_key_table(arch)}
    assert ours == theirs


def test_crop_matches_the_port():
    from multi_camera_3d_pose_estimation_tpu_torch.models.topdown import preprocess_crops

    g = torch.Generator().manual_seed(1)
    frames = torch.rand((3, 48, 64, 3), generator=g)
    boxes = torch.tensor([[0.0, 0.0, 64.0, 48.0], [5.0, 7.0, 40.0, 30.0],
                          [-3.0, 2.0, 70.0, 50.0]])
    origin, scale = crop_geometry(boxes, (32, 64), 1.25)
    want = crop(frames, origin, scale, (32, 64))
    got, got_scale, got_offset = preprocess_crops(frames, boxes, (32, 64), 1.25)
    assert torch.allclose(got.permute(0, 3, 1, 2), want, atol=1e-5)
    assert torch.allclose(got_scale.double(), scale, rtol=1e-6)
    assert torch.allclose(got_offset.double(), origin, rtol=1e-6, atol=1e-4)


def test_decode_matches_the_port():
    from multi_camera_3d_pose_estimation_tpu_torch.ops.heatmap_decode import \
        heatmap_argmax_decode
    from multi_camera_3d_pose_estimation_tpu_torch.ops.moments import heatmap_moments

    g = torch.Generator().manual_seed(2)
    maps = torch.randn((4, 17, 16, 12), generator=g) * 0.3
    maps[0, 0] = 0.0  # an empty map: no mass over the threshold
    maps[1, 1, 3, 4:6] = 2.0  # a tie: the first occurrence wins
    xy, score, mom = decode_maps(maps, 0.01)
    pxy, pscore = heatmap_argmax_decode(maps)
    pmom = heatmap_moments(maps, 0.01)
    assert torch.equal(xy, pxy.double())
    assert torch.equal(score, pscore.double())
    assert torch.allclose(mom, pmom.double(), rtol=1e-4, atol=1e-4)
    assert torch.equal(mom[0, 0], torch.zeros(6, dtype=torch.float64))


def _rig_points(n, seed=0):
    rig = make_rig({"cameras": 3, "radius_m": 3.0, "height_m": 1.6, "target_m": 1.0,
                    "arc_deg": 90.0, "hfov_deg": 70.0,
                    "dist": [-0.12, 0.03, 0.0005, -0.0004, 0.0]}, 640, 480)
    rng = np.random.default_rng(seed)
    world = rng.uniform([-0.5, -0.5, 0.2], [0.5, 0.5, 1.8], (n, 3))
    pix = []
    for c in range(3):
        cam = world @ rig["R"][c].T + rig["T"][c]
        x, y = cam[:, 0] / cam[:, 2], cam[:, 1] / cam[:, 2]
        k1, k2, p1, p2, k3 = rig["dist"][c]
        r2 = x * x + y * y
        radial = 1 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
        xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        K = rig["K"][c]
        pix.append(np.stack([K[0, 0] * xd + K[0, 2], K[1, 1] * yd + K[1, 2]], -1))
    return rig, world, np.stack(pix, 1)  # (n, C, 2)


def test_triangulation_recovers_points_and_matches_the_port():
    from multi_camera_3d_pose_estimation_tpu_torch.ops.triangulation import \
        triangulate_top2 as port_top2

    rig, world, pix = _rig_points(50)
    rig_t = {k: torch.as_tensor(rig[k]) for k in ("K", "R", "T", "dist")}
    conf = torch.rand((50, 3), generator=torch.Generator().manual_seed(4), dtype=torch.float64)
    xy = torch.as_tensor(pix)
    ours = triangulate_top2(xy, conf, rig_t)
    assert torch.allclose(ours, torch.as_tensor(world), atol=1e-6)
    theirs = port_top2(xy.float(), conf.float(), rig_t["K"].float(), rig_t["dist"].float(),
                       rig_t["R"].float(), rig_t["T"].float())
    assert torch.allclose(theirs.double(), ours, atol=2e-3)
    gap = dlt_gap(xy, conf, theirs.double(), rig_t)
    assert gap.max() < 1e-9
    moved = theirs.double() + torch.tensor([0.05, 0.0, 0.0], dtype=torch.float64)
    assert dlt_gap(xy, conf, moved, rig_t).min() > 1e-7


def test_dlt_gap_nan_rules():
    rig, world, pix = _rig_points(4)
    rig_t = {k: torch.as_tensor(rig[k]) for k in ("K", "R", "T", "dist")}
    xy = torch.as_tensor(pix).clone()
    conf = torch.ones((4, 3), dtype=torch.float64)
    conf[0, :2] = 0.0
    xy[0, 2] = torch.nan  # joint 0: one of its best two views gated
    xyz = triangulate_top2(xy, conf, rig_t)
    assert torch.isnan(xyz[0]).all() and torch.isfinite(xyz[1:]).all()
    assert dlt_gap(xy, conf, xyz, rig_t)[0] == 0.0
    swapped = xyz.clone()
    swapped[1] = torch.nan
    assert dlt_gap(xy, conf, swapped, rig_t)[1] == float("inf")


def test_weights_are_drawn_from_the_seed_and_the_head_is_scaled():
    cfg = _data_cfg("tiny_hrnet")
    model = build_model(cfg)
    a = draw_state_dict(model, seed=2 ** 40 + 1, device="cpu")
    b = draw_state_dict(model, seed=2 ** 40 + 1, device="cpu")
    c = draw_state_dict(model, seed=2 ** 40 + 2, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["head.final_layer.weight"], c["head.final_layer.weight"])
    model.load_state_dict(a, strict=True)
    crops = _crops(1, 8, (64, 32))
    calibrate_head(model, crops, a, 0.35, "head.final_layer.weight")
    model.load_state_dict(a, strict=True)
    with torch.no_grad():
        peaks = model(crops).flatten(2).amax(-1)
    assert peaks.median().item() == pytest.approx(0.35, rel=1e-4)
