"""The port reads MMPose/MMDet ``.pth`` checkpoints as the JAX package does.

For each family with a converter (HRNet, Swin and RTMPose at
``tests/test_torch_parity.py``'s small configurations, YOLOX and RTMDet at
``test_yolox_micro``'s and ``test_rtmdet_micro``'s), a random checkpoint
written by the JAX package's MMPose/MMDet mirror goes through JAX's
``load_torch_*`` and through the port's:

- the port's ``state_dict`` is exactly the JAX variables converted by
  ``*_state_dict_from_flax`` (float32 on both sides: bit for bit), and the
  float32 forwards agree within 1e-4 (the boxes at atol 2e-3, as in
  ``tests/test_torch_parity.py``);
- shuffled key order, the wrapper prefixes and ``data_preprocessor.``
  buffers give both packages the same weights as the clean file;
- both packages refuse the same malformed files (an unknown tensor, a
  missing key, a leftover key, a wider model) with ``ValueError``, and the
  port's model keeps its weights;
- the ``convert`` CLI's ``--out`` file equals the JAX CLI's array for
  array, a failed drill exits 1 in both, an unknown model raises in both;
- the user's path: ``estimate_pose_from_video`` with ``.pth`` checkpoints
  for HRNet (``test_tiny``) and RTMDet (``test_rtmdet_micro``), both in
  float32, against the JAX CLI at ``tests/test_torch_port_cli.py``'s
  tolerances.

The JAX side's variables come from ``jax.eval_shape`` (`zero_variables`,
`fast_flax_init`): its loaders overwrite every leaf, and an unjitted flax
``init`` would take about 20 s per model.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multi_camera_3d_pose_estimation_tpu.cli import convert as j_convert_cli
from multi_camera_3d_pose_estimation_tpu.models import convert as jcv
from multi_camera_3d_pose_estimation_tpu.models.hrnet import HRNet as JHRNet
from multi_camera_3d_pose_estimation_tpu.models.rtmdet import RTMDet as JRTMDet
from multi_camera_3d_pose_estimation_tpu.models.rtmpose import RTMPose as JRTMPose
from multi_camera_3d_pose_estimation_tpu.models.swin import SwinPose as JSwinPose
from multi_camera_3d_pose_estimation_tpu.models.yolox import YOLOX as JYOLOX
from multi_camera_3d_pose_estimation_tpu_torch import __main__ as port_main
from multi_camera_3d_pose_estimation_tpu_torch.models import convert, registry
from multi_camera_3d_pose_estimation_tpu_torch.models.rtmdet import RTMDet
from multi_camera_3d_pose_estimation_tpu_torch.models.yolox import YOLOX

from tests._torch_port_util import SMALL_PTH, fast_flax_init, write_pth, zero_variables

FAMILIES = list(SMALL_PTH)
FROM_FLAX = {"hrnet": convert.hrnet_state_dict_from_flax,
             "swin": convert.swin_state_dict_from_flax,
             "rtmpose": convert.rtmpose_state_dict_from_flax,
             "rtmdet": convert.rtmdet_state_dict_from_flax,
             "yolox": convert.yolox_state_dict_from_flax}


def _jax_model(family, cfg):
    if family == "hrnet":
        return JHRNet(num_joints=17, cfg=cfg, dtype=jnp.float32)
    if family == "swin":
        return JSwinPose(num_joints=17, cfg=cfg, dtype=jnp.float32)
    if family == "rtmpose":
        return JRTMPose(num_joints=17, input_size=(32, 64), cfg=cfg, dtype=jnp.float32)
    return (JYOLOX if family == "yolox" else JRTMDet)(**cfg, dtype=jnp.float32)


def _port_model(family, cfg):
    if family in ("hrnet", "swin", "rtmpose"):
        return registry.new_model(family, cfg, "cpu", (32, 64), 17, torch.float32)
    return (YOLOX if family == "yolox" else RTMDet)(**cfg, dtype=torch.float32, device="cpu")


@functools.cache
def _zeros(family):
    """The JAX model's zero variables, traced once per family (the loaders
    return new trees and leave this one as it is)."""
    cfg, shape = SMALL_PTH[family]
    return zero_variables(_jax_model(family, cfg), shape)


def _jax_load(family, path):
    return getattr(jcv, f"load_torch_{family}")(_zeros(family), path, SMALL_PTH[family][0])


def _port_load(family, path):
    cfg = SMALL_PTH[family][0]
    return convert.TORCH_LOADERS[family](_port_model(family, cfg), path, cfg)


def _assert_same_weights(family, variables, model):
    want = FROM_FLAX[family](jax.tree.map(np.asarray, variables))
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if not key.endswith("num_batches_tracked"):
            assert got[key].dtype == torch.float32 and torch.equal(got[key], value), key


@pytest.fixture(scope="module", params=FAMILIES)
def loaded(request, tmp_path_factory):
    family = request.param
    cfg = SMALL_PTH[family][0]
    path = write_pth(tmp_path_factory.mktemp(family) / "m.pth", family, cfg,
                     seed=FAMILIES.index(family))
    return family, _jax_load(family, path), _port_load(family, path)


def test_loads_the_jax_weights(loaded):
    family, variables, model = loaded
    _assert_same_weights(family, variables, model)


def test_forward_matches_jax(loaded):
    family, variables, model = loaded
    cfg, shape = SMALL_PTH[family]
    x = np.random.default_rng(5).uniform(size=(2,) + shape[1:]).astype(np.float32)
    ref = jax.jit(_jax_model(family, cfg).apply)(variables, jnp.asarray(x))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        out = model(xt if family == "swin" else xt.permute(0, 3, 1, 2))
    if family in ("yolox", "rtmdet"):
        assert out["boxes_all"].shape == (2, 126, 4)
        np.testing.assert_allclose(out["scores_all"].numpy(), np.asarray(ref["scores_all"]),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(out["boxes_all"].numpy(), np.asarray(ref["boxes_all"]),
                                   rtol=1e-4, atol=2e-3)
    elif family == "rtmpose":
        for o, r in zip(out, ref):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4)
    else:
        assert out.shape == (2, 17, 16, 8)
        np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-4)


def _messy(family):
    """The state dict rebuilt in shuffled order, with the wrapper prefixes
    and (HRNet and the detectors) ``data_preprocessor.`` buffers that a
    re-saved or mmengine checkpoint carries."""
    def edit(state):
        keys = list(state)
        np.random.default_rng(1).shuffle(keys)
        out = {}
        for k in keys:
            if family == "hrnet":
                prefix = ("module.keypoint_head." if k.startswith("final_layer")
                          else "module.backbone." if k.startswith("stage") else "backbone.")
            else:
                prefix = "module."
            out[prefix + k] = state[k]
        if family in ("hrnet", "yolox", "rtmdet"):
            out["data_preprocessor.mean"] = torch.zeros(3)
            out["data_preprocessor.std"] = torch.ones(3)
        return out
    return edit


@pytest.mark.parametrize("family", FAMILIES)
def test_key_order_and_prefixes_change_nothing(family, tmp_path):
    cfg = SMALL_PTH[family][0]
    clean = write_pth(tmp_path / "clean.pth", family, cfg, seed=3)
    messy = write_pth(tmp_path / "messy.pth", family, cfg, seed=3, edit=_messy(family))
    want = _port_load(family, clean).state_dict()
    got = _port_load(family, messy).state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    _assert_same_weights(family, _jax_load(family, messy), _port_load(family, messy))


def _widen(family, cfg):
    if family == "hrnet":
        return {**cfg, "widths": (12, 24, 48, 96)}
    if family == "swin":
        return {**cfg, "embed": 32}
    return {**cfg, "widen": 0.25}


def _malformed(kind):
    def edit(state):
        state = dict(state)
        convs = [k for k, v in state.items() if k.endswith(".weight") and v.dim() >= 2]
        if kind == "unknown":
            state["aux_head.fc.weight"] = torch.zeros(8, 8)
        elif kind == "missing":
            del state[convs[3]]
        else:  # leftover: an extra tensor inside a known module
            state[convs[0].removesuffix("weight") + "extra.weight"] = torch.zeros(4, 4, 1, 1)
        return state
    return edit


@pytest.mark.parametrize("kind", ["unknown", "missing", "leftover", "wider"])
@pytest.mark.parametrize("family", FAMILIES)
def test_both_refuse_the_same_files(family, kind, tmp_path):
    cfg = SMALL_PTH[family][0]
    if kind == "wider":
        path = write_pth(tmp_path / "bad.pth", family, _widen(family, cfg))
    else:
        path = write_pth(tmp_path / "bad.pth", family, cfg, edit=_malformed(kind))
    with pytest.raises(ValueError):
        _jax_load(family, path)
    model = _port_model(family, cfg)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match="mismatch" if kind == "wider" else
                       "missing" if kind == "missing" else "unexpected"):
        convert.TORCH_LOADERS[family](model, path, cfg)
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


@pytest.mark.parametrize("name,family,suffix", [("test_tiny", "hrnet", ".pth"),
                                                ("test_swin_128", "swin", ".pt")])
def test_build_estimator_reads_pth(name, family, suffix, tmp_path):
    """``build_estimator(checkpoint=*.pth / *.pt)`` goes to the family's
    loader, in the model's compute dtype as any checkpoint."""
    cfg = registry.MODEL_REGISTRY[name]["cfg"]
    path = write_pth(tmp_path / f"m{suffix}", family, cfg, seed=2)
    est = registry.build_estimator(name, checkpoint=path, device="cpu")
    want = convert.TORCH_LOADERS[family](_port_model(family, cfg), path, cfg).state_dict()
    got = est.model.state_dict()
    assert est.model.dtype == torch.bfloat16
    assert all(torch.equal(got[k], want[k]) for k in want)


# The convert CLI.
CLI_MODELS = [("test_tiny", "hrnet"), ("test_swin_128", "swin"), ("coco_rtmpose-t", "rtmpose")]


@pytest.mark.parametrize("name,family", CLI_MODELS)
def test_convert_out_equals_the_jax_cli(name, family, tmp_path, monkeypatch, capsys):
    spec = registry.MODEL_REGISTRY[name]
    w, h = spec["input_size"]
    pth = write_pth(tmp_path / "m.pth", family, spec["cfg"], seed=4, input_size=(w, h))
    fast_flax_init(monkeypatch, JHRNet, JSwinPose, JRTMPose)
    j_convert_cli.main([pth, "--model", name, "--out", str(tmp_path / "jax.npz")])
    port_main.main(["convert", pth, "--model", name, "--out", str(tmp_path / "port.npz"),
                    "--device", "cpu"])
    assert "written to" in capsys.readouterr().out
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k])
    # The file loads back through the builder.
    est = registry.build_estimator(name, checkpoint=str(tmp_path / "port.npz"), device="cpu")
    want = convert.TORCH_LOADERS[family](
        registry.new_model(family, spec["cfg"], "cpu", (w, h), 17, torch.float32),
        pth).state_dict()
    assert all(torch.equal(est.model.state_dict()[k], want[k]) for k in want)


def test_convert_exit_codes_follow_the_jax_cli(tmp_path, monkeypatch, capsys):
    """A drill that fails exits 1 in both CLIs; one that passes, 0 (no
    ``--out``: nothing written); an unknown model raises in both."""
    cfg = registry.MODEL_REGISTRY["test_swin_128"]["cfg"]

    def drift(state):
        k = next(k for k in state if k.endswith("qkv.weight"))
        state[k] = torch.zeros(state[k].shape[0] * 2, state[k].shape[1])
        return state

    bad = write_pth(tmp_path / "bad.pth", "swin", cfg, seed=5, edit=drift)
    fast_flax_init(monkeypatch, JSwinPose)
    for run in (lambda a: j_convert_cli.main(a),
                lambda a: port_main.main(["convert", *a, "--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            run([bad, "--model", "test_swin_128", "--verify"])
        assert e.value.code == 1
        assert "CONVERSION REFUSED" in capsys.readouterr().out
        with pytest.raises(KeyError):
            run([bad, "--model", "no_such_model"])
    good = write_pth(tmp_path / "good.pth", "swin", cfg, seed=5)
    port_main.main(["convert", good, "--model", "test_swin_128", "--verify", "--device", "cpu"])
    assert "VERIFY: PASS" in capsys.readouterr().out
    assert not list(tmp_path.glob("*.npz"))


def test_estimate_from_pth_matches_jax(tmp_path, monkeypatch):
    """The user's path: both estimate CLIs on the same HRNet and RTMDet
    ``.pth`` files, estimator and detector in float32 (the detector's dtype
    through each package's ``build_detector(dtype=)``)."""
    pytest.importorskip("cv2")
    import multi_camera_3d_pose_estimation_tpu.cli.estimate as j_cli
    import multi_camera_3d_pose_estimation_tpu_torch.cli.estimate as p_cli
    from multi_camera_3d_pose_estimation_tpu.models import registry as jreg

    from tests.test_torch_port_cli import KEYS, N_FRAMES, _hold_end_to_end, _write_cameras, W, H
    import cv2

    _write_cameras(tmp_path, 2)
    rng = np.random.default_rng(0)
    paths = []
    for c in range(2):
        p = str(tmp_path / f"cam{c}_synced.mp4")
        vw = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"mp4v"), 15.0, (W, H))
        for _ in range(N_FRAMES):
            vw.write(rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
        vw.release()
        paths.append(p)
    pose = write_pth(tmp_path / "hrnet.pth", "hrnet", registry.MODEL_REGISTRY["test_tiny"]["cfg"],
                     seed=6)
    det = write_pth(tmp_path / "rtmdet.pth", "rtmdet",
                    registry.DETECTOR_REGISTRY["test_rtmdet_micro"]["cfg"], seed=7)
    fast_flax_init(monkeypatch, JHRNet, JRTMDet)
    monkeypatch.setattr(j_cli, "build_detector",
                        lambda *a, **k: jreg.build_detector(*a, dtype=jnp.float32, **k))
    monkeypatch.setattr(p_cli, "build_detector",
                        lambda *a, **k: registry.build_detector(*a, dtype=torch.float32, **k))
    out = {}
    for side, fn, kw in (("jax", j_cli.estimate_pose_from_video, {"dtype": jnp.float32}),
                         ("port", p_cli.estimate_pose_from_video, {"dtype": torch.float32})):
        extra = {"device": "cpu"} if side == "port" else {}
        out[side] = fn(paths, project_dir=str(tmp_path), pose_estimation_model="test_tiny",
                       checkpoint=pose, detector_model="test_rtmdet_micro",
                       detector_checkpoint=det, detector_bbox_thr=0.0, block_size=3,
                       estimator_kwargs=kw, save_dir=str(tmp_path / side), **extra)
    _hold_end_to_end(out["jax"], out["port"], min_share=0.5)
    for key, arr in zip(KEYS, out["port"]):
        np.testing.assert_array_equal(np.load(tmp_path / "port" / f"{key}.npy"), arr)
