"""The port reads and writes the JAX package's ``.npz`` checkpoints.

For each of the six families (HRNet ``test_tiny``, Swin ``test_swin_128``,
RTMPose at ``tests/test_torch_port_cspnext.py``'s small config, and the
detectors ``test_rtmdet_micro``, ``test_yolox_micro``,
``test_centernet_w8``): seeded flax variables are written by JAX's
``save_checkpoint_npz``; the model the port builds from that file has
exactly ``*_state_dict_from_flax(variables)``; the port's writer gives a
file that JAX's ``_load_checkpoint`` reads back to the same leaves (and the
same bytes).  Everything is exact: the weights are float32 on both sides.
"""

import jax
import numpy as np
import pytest
import torch

from multi_camera_3d_pose_estimation_tpu.models import detector as jdet
from multi_camera_3d_pose_estimation_tpu.models import registry as jreg
from multi_camera_3d_pose_estimation_tpu.models.hrnet import HRNet as JHRNet
from multi_camera_3d_pose_estimation_tpu.models.rtmdet import RTMDet as JRTMDet
from multi_camera_3d_pose_estimation_tpu.models.rtmpose import RTMPose as JRTMPose
from multi_camera_3d_pose_estimation_tpu.models.swin import SwinPose as JSwinPose
from multi_camera_3d_pose_estimation_tpu.models.yolox import YOLOX as JYOLOX
from multi_camera_3d_pose_estimation_tpu_torch.models import convert, registry

from tests._torch_port_util import random_variables

RTMPOSE_CFG, RTMPOSE_INPUT = {"widen": 0.125, "deepen": 0.167, "embed": 32}, (64, 96)
DET = {name: jreg.DETECTOR_REGISTRY[name] for name in
       ("test_rtmdet_micro", "test_yolox_micro", "test_centernet_w8")}


def _jax_model(name):
    """(flax module, input shape, port family, checkpoint -> the port's model)."""
    if name in ("test_tiny", "test_swin_128"):
        spec = jreg.MODEL_REGISTRY[name]
        w, h = spec["input_size"]
        cls = JHRNet if spec["family"] == "hrnet" else JSwinPose
        return (cls(num_joints=17, cfg=spec["cfg"]), (1, h, w, 3), spec["family"],
                lambda ckpt: registry.build_estimator(name, checkpoint=ckpt, device="cpu").model)
    if name == "rtmpose":
        w, h = RTMPOSE_INPUT
        return (JRTMPose(cfg=RTMPOSE_CFG, input_size=RTMPOSE_INPUT), (1, h, w, 3), "rtmpose",
                lambda ckpt: registry.build_model("rtmpose", RTMPOSE_CFG, "cpu",
                                                  input_size=RTMPOSE_INPUT, checkpoint=ckpt))
    cfg = DET[name].get("cfg")
    if name == "test_rtmdet_micro":
        module, family = JRTMDet(**cfg), "rtmdet"
    elif name == "test_yolox_micro":
        module, family = JYOLOX(**cfg), "yolox"
    else:
        module, family = jdet.CenterNetDetector(width=DET[name]["width"]), "centernet"
    return (module, (1, 64, 96, 3), family,
            lambda ckpt: registry.build_detector(name, checkpoint=ckpt, device="cpu").model)


NAMES = ["test_tiny", "test_swin_128", "rtmpose", "test_rtmdet_micro", "test_yolox_micro",
         "test_centernet_w8"]
FROM_FLAX = {"hrnet": convert.hrnet_state_dict_from_flax,
             "swin": convert.swin_state_dict_from_flax,
             "rtmpose": convert.rtmpose_state_dict_from_flax,
             "rtmdet": convert.rtmdet_state_dict_from_flax,
             "yolox": convert.yolox_state_dict_from_flax,
             "centernet": convert.centernet_state_dict_from_flax}


@pytest.fixture(scope="module", params=NAMES)
def checkpoint(request, tmp_path_factory):
    module, shape, family, build = _jax_model(request.param)
    variables = random_variables(module, shape, seed=NAMES.index(request.param))
    path = str(tmp_path_factory.mktemp(request.param) / "jax.npz")
    jreg.save_checkpoint_npz(variables, path)
    return variables, path, family, build


def test_reader_gives_the_converted_state_dict(checkpoint):
    variables, path, family, build = checkpoint
    want = FROM_FLAX[family](variables)
    got = build(path).state_dict()
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype and torch.equal(got[key], value), key
    n_leaves = len(jax.tree.leaves(variables))
    assert len(convert.flax_leaves(build(path), family)) == n_leaves


def test_writer_round_trips_through_jax(checkpoint, tmp_path):
    variables, path, family, build = checkpoint
    out = str(tmp_path / "port.npz")
    convert.save_checkpoint_npz(build(path), out, family)
    restored = jreg._load_checkpoint(variables, out, family)
    a, b = jax.tree.leaves(variables), jax.tree.leaves(restored)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.asarray(y).dtype == np.float32
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert jax.tree.structure(restored) == jax.tree.structure(variables)
    with open(path, "rb") as f, open(out, "rb") as g:
        assert f.read() == g.read()


def test_leaf_order_sorts_keys_as_strings():
    """``jax.tree.flatten`` sorts dict keys as strings at every level:
    ``stage_10`` before ``stage_2``, ``batch_stats`` before ``params``."""
    model = registry.build_estimator("test_tiny", device="cpu").model
    paths = [leaf[0] for leaf in convert.flax_leaves(model, "hrnet")]
    assert paths == sorted(paths) and paths[0][0] == "batch_stats" and paths[-1][0] == "params"
    flat = jax.tree_util.tree_flatten_with_path(
        {"params": {"stage_10": {"a": 0}, "stage_2": {"b": 1}}, "batch_stats": {"c": 2}})[0]
    assert [tuple(k.key for k in p) for p, _ in flat] == sorted(
        [("params", "stage_10", "a"), ("params", "stage_2", "b"), ("batch_stats", "c")])


def _rewrite(path, out, edit):
    with np.load(path) as f:
        flat = {k: f[k] for k in f.files}
    edit(flat)
    np.savez(out, **flat)
    return out


def test_bad_checkpoints_raise(tmp_path):
    module, shape, family, build = _jax_model("test_tiny")
    variables = random_variables(module, shape, seed=0)
    path = str(tmp_path / "ok.npz")
    jreg.save_checkpoint_npz(variables, path)
    n = len(jax.tree.leaves(variables))
    short = _rewrite(path, str(tmp_path / "short.npz"), lambda f: f.pop(f"p{n - 1}"))
    with pytest.raises(ValueError, match="leaves"):
        build(short)
    extra = _rewrite(path, str(tmp_path / "extra.npz"),
                     lambda f: f.update({f"p{n}": np.zeros(1, np.float32)}))
    with pytest.raises(ValueError, match="leaves"):
        build(extra)
    wrong = _rewrite(path, str(tmp_path / "shape.npz"),
                     lambda f: f.update(p3=np.zeros(f["p3"].shape[:-1] + (5,), np.float32)))
    with pytest.raises(ValueError, match="shape mismatch"):
        build(wrong)
    for suffix in (".pth", ".pt"):  # torch files go to the MMPose name map, which is strict
        torch_file = tmp_path / f"model{suffix}"
        torch.save({"state_dict": {"aux_head.fc.weight": torch.zeros(8, 8)}}, str(torch_file))
        with pytest.raises(ValueError, match="missing"):
            build(str(torch_file))
    orbax = tmp_path / "orbax_dir"
    orbax.mkdir()
    with pytest.raises(NotImplementedError):
        build(str(orbax))
    with pytest.raises(FileNotFoundError):
        build(str(tmp_path / "missing.npz"))
    model = build(path)
    model.register_parameter("stray", torch.nn.Parameter(torch.zeros(2)))
    with pytest.raises(KeyError, match="unmapped"):
        convert.flax_leaves(model, family)
    full_frame = registry.build_detector("full_frame", checkpoint="ignored.npz", device="cpu")
    assert full_frame.model is None
