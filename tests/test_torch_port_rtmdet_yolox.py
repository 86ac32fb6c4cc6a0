"""The port's RTMDet and YOLOX against the JAX package's flax modules.

The registry's test sizes, ``test_rtmdet_micro`` (CSPNeXt widen 0.125, one
CSP block in the neck, 32-channel head) and ``test_yolox_micro`` (widen
0.125: floor widths), on 64x96 frames (three levels of 8x12, 4x6 and 2x3
cells); one random flax tree each, carried across by the converters.

Tolerances:

- f32 against the flax module: boxes within 2e-3 px (as
  ``tests/test_torch_parity.py`` holds the JAX package's RTMDet against its
  torch mirror), scores and every raw head output at 1e-4 relative to the
  largest value;
- bf16 against the bf16 flax module: raw head outputs at 5e-2 of their
  largest value (bf16 roundings in other places compound through ~50 convs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_camera_3d_pose_estimation_tpu.models.rtmdet import RTMDet as JRTMDet
from multi_camera_3d_pose_estimation_tpu.models.yolox import YOLOX as JYOLOX
from multi_camera_3d_pose_estimation_tpu_torch.models import registry
from multi_camera_3d_pose_estimation_tpu_torch.models.convert import (
    load_rtmdet_from_flax, load_yolox_from_flax, rtmdet_state_dict_from_flax,
    yolox_state_dict_from_flax)
from multi_camera_3d_pose_estimation_tpu_torch.models.rtmdet import RTMDet
from multi_camera_3d_pose_estimation_tpu_torch.models.yolox import YOLOX

from tests._torch_port_util import random_variables

SHAPE = (2, 64, 96, 3)
FAMILIES = {
    "rtmdet": (JRTMDet, RTMDet, load_rtmdet_from_flax,
               registry.DETECTOR_REGISTRY["test_rtmdet_micro"]["cfg"]),
    "yolox": (JYOLOX, YOLOX, load_yolox_from_flax,
              registry.DETECTOR_REGISTRY["test_yolox_micro"]["cfg"]),
}


def _rel(out, ref):
    out = out.float().numpy() if torch.is_tensor(out) else np.asarray(out)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    jcls, tcls, load, cfg = FAMILIES[request.param]
    v = random_variables(jcls(**cfg, dtype=jnp.float32), SHAPE, seed=len(request.param))
    x = np.random.default_rng(9).uniform(0, 1, SHAPE).astype(np.float32)
    return request.param, jcls, tcls, load, cfg, v, x


def _port(family, dtype):
    _, _, tcls, load, cfg, v, _ = family
    return load(tcls(**cfg, dtype=dtype, device="cpu"), v).eval()


def test_detector_matches_flax_f32(family):
    name, jcls, _, _, cfg, v, x = family
    ref = jax.jit(jcls(**cfg, dtype=jnp.float32).apply)(v, jnp.asarray(x))
    with torch.no_grad():
        out = _port(family, torch.float32)(torch.from_numpy(x).permute(0, 3, 1, 2))
    n = 8 * 12 + 4 * 6 + 2 * 3
    assert out["boxes_all"].shape == (2, n, 4) and out["scores_all"].shape == (2, n)
    np.testing.assert_allclose(out["boxes_all"].numpy(), np.asarray(ref["boxes_all"]), rtol=0,
                               atol=2e-3)
    assert _rel(out["scores_all"], ref["scores_all"]) <= 1e-4
    for lvl, (o_lvl, r_lvl) in enumerate(zip(out["raw"], ref["raw"])):
        for o, r in zip(o_lvl, r_lvl):
            assert o.shape == r.shape and _rel(o, r) <= 1e-4, (name, lvl)


def test_detector_bf16_matches_flax_bf16(family):
    name, jcls, _, _, cfg, v, x = family
    ref = jax.jit(jcls(**cfg).apply)(v, jnp.asarray(x))
    with torch.no_grad():
        out = _port(family, torch.bfloat16)(torch.from_numpy(x).permute(0, 3, 1, 2))
    for o_lvl, r_lvl in zip(out["raw"], ref["raw"]):
        for o, r in zip(o_lvl, r_lvl):
            assert o.dtype == torch.float32
            assert _rel(o, r) <= 5e-2, name


def test_rtmdet_head_shares_convs_across_levels():
    """One ``cls_conv_i`` / ``reg_conv_i`` per stack index, three BatchNorms."""
    cfg = FAMILIES["rtmdet"][3]
    sd = rtmdet_state_dict_from_flax(random_variables(JRTMDet(**cfg), SHAPE, seed=0))
    convs = sorted(k for k in sd if k.startswith("head.") and "_conv_" in k)
    assert convs == ["head.cls_conv_0.weight", "head.cls_conv_1.weight",
                     "head.reg_conv_0.weight", "head.reg_conv_1.weight"]
    assert sum(k.startswith("head.cls_bn_") and k.endswith(".weight") for k in sd) == 6
    assert sd["head.rtm_reg_2.bias"].shape == (4,)


def test_converters_are_strict(family):
    name, jcls, _, _, cfg, v, _ = family
    to_sd = rtmdet_state_dict_from_flax if name == "rtmdet" else yolox_state_dict_from_flax
    bad = jax.tree_util.tree_map(lambda a: a, v)
    bad["params"]["head"]["res_scale"] = np.ones(4, np.float32)
    with pytest.raises(KeyError, match="unmapped"):
        to_sd(bad)
    short = jax.tree_util.tree_map(lambda a: a, v)
    del short["batch_stats"]["neck"]
    with pytest.raises(KeyError, match="missing"):
        load = FAMILIES[name][2]
        load(FAMILIES[name][1](**cfg, device="cpu"), short)


@pytest.mark.parametrize("name", ["rtmdet_m", "rtmdet_tiny", "test_rtmdet_micro", "yolox_tiny",
                                  "yolox_s", "test_yolox_micro", "centernet_w16"])
def test_registry_detectors_draw_usable_boxes(name):
    """Each registry detector with its seeded random weights: the top box of
    a random frame is finite and of positive size inside the frame (the reg
    biases of `init_rtmdet_` / `init_yolox_` / `init_centernet_`)."""
    det = registry.build_detector(name, device="cpu", seed=0, bbox_thr=0.0)
    frames = np.random.default_rng(1).integers(0, 256, (2, 64, 96, 3), dtype=np.uint8)
    boxes = det.detect(frames)
    assert torch.isfinite(boxes).all()
    assert (boxes[:, 2] > boxes[:, 0]).all() and (boxes[:, 3] > boxes[:, 1]).all()
    assert (boxes >= 0).all() and (boxes[:, [0, 2]] <= 96).all() and (boxes[:, [1, 3]] <= 64).all()
