"""The port's CenterNet, candidate decodes and consistent box selection
against the JAX package.

Tolerances:

- CenterNet (``test_centernet_w8``) in f32 against the flax module at 1e-4
  relative to each map's largest value, at 64x96 and at 72x88, where the
  stride-2 convs meet odd maps (72 -> 36 -> 18 -> 9 -> 5 rows) and XLA's
  SAME padding is (1, 1) instead of (0, 1); bf16 against bf16 at 5e-2;
- `decode_top1` / `decode_topk`: the same candidates chosen (boxes identify
  them: every candidate's box is distinct) with values at 1e-6 relative,
  on hand-made ties (equal scores, a plateau on the centre map, fewer peaks
  than k, where the -inf slots come in index order with score 0);
- `select_consistent_boxes`: the selected boxes and scores bit for bit
  equal to JAX's, on the teleporting-distractor scene of
  ``tests/test_detector_e2e.py`` (also through the top-1 selector), on a
  scene with duplicated candidates (ties: the first wins), and on a scene
  with a 4-frame window and NaN anchors where the nanmedian's even counts
  decide picks: a lower median (``torch.nanmedian``'s) picks other boxes;
- `SinglePersonDetector.detect` (f32 models) against JAX's: boxes within
  2e-3 px.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from multi_camera_3d_pose_estimation_tpu.models import detector as jdet
from multi_camera_3d_pose_estimation_tpu_torch.models import detector as tdet
from multi_camera_3d_pose_estimation_tpu_torch.models import registry
from multi_camera_3d_pose_estimation_tpu_torch.models.convert import (
    centernet_state_dict_from_flax, load_centernet_from_flax)

from tests._torch_port_util import random_variables
from tests.conftest import project_np


def _rel(out, ref):
    out = out.float().numpy() if torch.is_tensor(out) else np.asarray(out)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


@pytest.mark.parametrize("n,k,s", [(256, 3, 2), (9, 3, 2), (72, 3, 2), (5, 3, 2), (18, 3, 1),
                                   (7, 5, 3), (4, 1, 2)])
def test_same_pads_match_xla(n, k, s):
    assert tdet.same_pads(n, k, s) == tuple(lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0])


@pytest.fixture(scope="module")
def centernet():
    jm = jdet.CenterNetDetector(width=8, dtype=jnp.float32)
    return jm, random_variables(jm, (1, 64, 96, 3), seed=3)


@pytest.mark.parametrize("hw", [(64, 96), (72, 88)])
def test_centernet_matches_flax_f32(centernet, hw):
    jm, v = centernet
    x = np.random.default_rng(hw[0]).uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    ref = jax.jit(jm.apply)(v, jnp.asarray(x))
    port = load_centernet_from_flax(tdet.CenterNetDetector(8, torch.float32, "cpu"), v)
    with torch.no_grad():
        out = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert out["center"].shape == ref["center"].shape == ((2, 4, 6) if hw[0] == 64 else (2, 5, 6))
    for key in ("center", "wh", "offset"):
        assert out[key].dtype == torch.float32 and out[key].shape == ref[key].shape
        assert _rel(out[key], ref[key]) <= 1e-4, key


def test_centernet_bf16_matches_flax_bf16(centernet):
    _, v = centernet
    x = np.random.default_rng(1).uniform(0, 1, (2, 72, 88, 3)).astype(np.float32)
    ref = jax.jit(jdet.CenterNetDetector(width=8).apply)(v, jnp.asarray(x))
    port = load_centernet_from_flax(tdet.CenterNetDetector(8, device="cpu"), v)
    with torch.no_grad():
        out = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    for key in ("center", "wh", "offset"):
        assert _rel(out[key], ref[key]) <= 5e-2, key


def test_centernet_converter_is_strict(centernet):
    _, v = centernet
    sd = centernet_state_dict_from_flax(v)
    assert sd["_ConvBNReLU_8.Conv_0.weight"].shape == (32, 64, 3, 3)
    assert sd["Conv_1.bias"].shape == (2,)
    bad = jax.tree_util.tree_map(lambda a: a, v)
    bad["params"]["Conv_2"]["gamma"] = np.ones(2, np.float32)
    with pytest.raises(KeyError, match="unmapped"):
        centernet_state_dict_from_flax(bad)


def _centernet_maps():
    """Head maps (3, 6, 7): ties between two cells, a plateau, a single peak
    (fewer peaks than k), every cell's box distinct."""
    rng = np.random.default_rng(4)
    center = rng.normal(size=(3, 6, 7)).astype(np.float32)
    center[0, 1, 1] = center[0, 4, 5] = 5.0  # tied maxima: the first wins
    center[1, 2:4, 2:4] = 3.0  # a 2x2 plateau: four tied peaks
    ii, jj = np.mgrid[0:6, 0:7]
    center[2] = -(np.abs(ii - 3) + np.abs(jj - 3))  # one peak at (3, 3): the other k - 1
    # slots are -inf, in index order
    wh = rng.uniform(5, 40, (3, 6, 7, 2)).astype(np.float32)
    off = rng.uniform(-0.5, 0.5, (3, 6, 7, 2)).astype(np.float32)
    return {"center": center, "wh": wh, "offset": off}


def _flat_candidates():
    rng = np.random.default_rng(5)
    scores = rng.uniform(0, 1, (3, 50)).astype(np.float32)
    scores[0, [7, 20, 33]] = 1.5  # three tied best
    scores[1] = np.round(scores[1] * 4) / 4  # many ties
    boxes = rng.uniform(0, 200, (3, 50, 4)).astype(np.float32)
    return {"boxes_all": boxes, "scores_all": scores}


@pytest.mark.parametrize("maps", ["centernet", "flat"])
def test_decode_top1_matches_jax(maps):
    out = _centernet_maps() if maps == "centernet" else _flat_candidates()
    jb, js = jdet.decode_top1({k: jnp.asarray(v) for k, v in out.items()})
    tb, ts = tdet.decode_top1(_t(out))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)
    if maps == "flat":
        np.testing.assert_array_equal(tb[0].numpy(), out["boxes_all"][0, 7])  # first of the ties


@pytest.mark.parametrize("maps", ["centernet", "flat"])
@pytest.mark.parametrize("k", [1, 4, 9])
def test_decode_topk_matches_jax(maps, k):
    out = _centernet_maps() if maps == "centernet" else _flat_candidates()
    jb, js = jdet.decode_topk({key: jnp.asarray(v) for key, v in out.items()}, k=k)
    tb, ts = tdet.decode_topk(_t(out), k=k)
    assert tb.shape == (3, k, 4) and ts.shape == (3, k)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)
    if maps == "centernet" and k > 1:
        assert (ts[2, 1:] == 0).all()  # sigmoid(-inf) slots past the only peak


def _rig():
    """The `camera_pair` rig of tests/conftest.py (numpy float64 and a
    stacked f32 dict)."""
    th = np.deg2rad(25.0)
    cams = [(np.array([[920.0, 0, 640], [0, 910, 360], [0, 0, 1]]), np.eye(3), np.zeros(3),
             np.array([-0.21, 0.05, 0.0008, -0.0011, 0.01])),
            (np.array([[880.0, 0, 620], [0, 885, 380], [0, 0, 1]]),
             np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]]),
             np.array([-120.0, 5.0, 40.0]), np.array([0.12, -0.03, -0.0006, 0.0009, 0.002]))]
    stack = {key: np.stack([c[i] for c in cams]).astype(np.float32)
             for i, key in enumerate(("K", "R", "T", "dist"))}
    return cams, stack


def _teleport_scene():
    """tests/test_detector_e2e.py's scene: a smooth subject and a teleporting
    distractor that out-scores it on ~30% of frames, plus junk candidates."""
    cams, cam = _rig()
    rng = np.random.default_rng(5)
    T, C, k = 40, 2, 4
    t = np.linspace(0, 2 * np.pi, T)
    subject = np.stack([20 * np.sin(t), 10 * np.cos(t), 330 + 15 * np.sin(0.5 * t)], axis=-1)
    distractor = rng.uniform([-40, -40, 280], [40, 40, 420], size=(T, 3))
    centers = np.zeros((T, C, k, 2), np.float32)
    scores = np.full((T, C, k), 0.05, np.float32)
    wrong = rng.uniform(size=T) < 0.3
    for c, (K, R, Tc, d) in enumerate(cams):
        centers[:, c, 0] = project_np(subject, K, R, Tc, d)
        centers[:, c, 1] = project_np(distractor, K, R, Tc, d)
        scores[:, c, 0] = np.where(wrong, 0.60, 0.85)
        scores[:, c, 1] = np.where(wrong, 0.80, 0.55)
        centers[:, c, 2:] += rng.uniform(0, 1280, size=(T, k - 2, 2))
    order = np.argsort(-scores, axis=-1)
    centers = np.take_along_axis(centers, order[..., None], axis=2)
    scores = np.take_along_axis(scores, order, axis=2)
    boxes = np.concatenate([centers - 60.0, centers + 60.0], axis=-1)
    subj_c = np.stack([project_np(subject, *c) for c in cams], axis=1)
    return boxes, scores, cam, subj_c


def _select_both(boxes, scores, cam, **kw):
    jsel = jax.jit(functools.partial(jdet.select_consistent_boxes, **kw))
    jb, js = jsel(jnp.asarray(boxes), jnp.asarray(scores), cam)
    tb, ts = tdet.select_consistent_boxes(torch.from_numpy(boxes), torch.from_numpy(scores),
                                          _t(cam), **kw)
    return (np.asarray(jb), np.asarray(js)), (tb.numpy(), ts.numpy())


def test_select_consistent_rejects_teleporting_distractor():
    boxes, scores, cam, subj_c = _teleport_scene()
    (jb, js), (tb, ts) = _select_both(boxes, scores, cam, det_thr=0.3, frame_wh=(1280, 720))
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(ts, js)
    hits = np.linalg.norm((tb[..., :2] + tb[..., 2:]) / 2 - subj_c, axis=-1) < 1.0
    # The top-1 selector on the same candidates (one frame-camera per row).
    T, C, k = scores.shape
    flat = {"boxes_all": boxes.reshape(T * C, k, 4), "scores_all": scores.reshape(T * C, k)}
    j1, _ = jdet.decode_top1({key: jnp.asarray(v) for key, v in flat.items()})
    t1, _ = tdet.decode_top1(_t(flat))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1))
    top1_hits = np.linalg.norm((t1[:, :2] + t1[:, 2:]).numpy().reshape(T, C, 2) / 2 - subj_c,
                               axis=-1) < 1.0
    print("consistent hits", hits.mean(), "top-1 hits", top1_hits.mean())
    assert hits.mean() >= 0.95 and top1_hits.mean() <= 0.75


def test_select_consistent_ties_pick_the_first():
    """Duplicated candidates (YOLOX's neighbouring anchors): equal utility,
    the lower index wins on both sides."""
    boxes, scores, cam, _ = _teleport_scene()
    boxes[:, :, 1], scores[:, :, 1] = boxes[:, :, 0], scores[:, :, 0]
    (jb, js), (tb, ts) = _select_both(boxes, scores, cam, det_thr=0.3, frame_wh=(1280, 720),
                                      window=5)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(ts, js)


def _median_scene(seed=1, T=12, k=3):
    """A jumpy subject (its candidates scattered by 15 units), a 4-frame
    window, and frames where no view passes ``det_thr`` (NaN anchors): the
    windows' counts are even and odd."""
    cams, cam = _rig()
    rng = np.random.default_rng(seed)
    subj = rng.uniform([-40, -40, 280], [40, 40, 420], (T, 3))
    cents = np.zeros((T, 2, k, 2))
    scores = rng.uniform(0.35, 0.9, (T, 2, k)).astype(np.float32)
    for c, cm in enumerate(cams):
        for j in range(k):
            cents[:, c, j] = project_np(subj + rng.normal(0, 15, (T, 3)), *cm)
    nan_frames = rng.uniform(size=T) < 0.3
    scores[nan_frames] = 0.1
    scores[nan_frames, 0, 0] = 0.31
    scores[nan_frames, 1, 0] = 0.2
    order = np.argsort(-scores, -1, kind="stable")
    scores = np.take_along_axis(scores, order, -1)
    cents = np.take_along_axis(cents, order[..., None], 2)
    half = rng.uniform(20, 60, (T, 2, k, 1))
    return np.concatenate([cents - half, cents + half], -1).astype(np.float32), scores, cam


def _lower_nanmedian(x):
    vals = torch.sort(torch.where(torch.isnan(x), torch.full_like(x, float("inf")), x), 1).values
    n = (~torch.isnan(x)).sum(1, keepdim=True)
    med = torch.gather(vals, 1, torch.clamp((n - 1) // 2, min=0))[:, 0]
    return torch.where(n[:, 0] > 0, med, torch.full_like(med, float("nan")))


def test_select_consistent_even_window_needs_the_midpoint(monkeypatch):
    boxes, scores, cam = _median_scene()
    kw = dict(det_thr=0.3, frame_wh=(1280, 720), window=4)
    (jb, js), (tb, ts) = _select_both(boxes, scores, cam, **kw)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(ts, js)
    monkeypatch.setattr(tdet, "nanmedian_dim1", _lower_nanmedian)
    lower = tdet.select_consistent_boxes(torch.from_numpy(boxes), torch.from_numpy(scores),
                                         _t(cam), **kw)[0].numpy()
    assert (np.abs(lower - jb).max(-1) > 0).sum() >= 3  # the scene tells the medians apart


def test_nanmedian_matches_jnp():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(6, 8, 3)).astype(np.float32)
    x[0, :3] = np.nan  # 5 left: odd
    x[1, :2] = np.nan  # 6 left: even, the mean of the middle pair
    x[2] = np.nan  # none: NaN
    x[3, ::2, 1] = np.nan
    ref = np.asarray(jnp.nanmedian(jnp.asarray(x), axis=1))
    out = tdet.nanmedian_dim1(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(out, ref)
    assert np.isnan(out[2]).all() and not np.isnan(np.delete(out, 2, 0)).any()


def test_single_person_detector_detect_matches_jax(centernet):
    jm, v = centernet
    frames = np.random.default_rng(8).integers(0, 256, (3, 72, 88, 3), dtype=np.uint8)
    ref = jdet.SinglePersonDetector(jm, v, bbox_thr=0.2).detect(frames)
    port = tdet.SinglePersonDetector(
        load_centernet_from_flax(tdet.CenterNetDetector(8, torch.float32, "cpu"), v),
        bbox_thr=0.2, device="cpu")
    out = port.detect(frames)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=2e-3)
    full = tdet.SinglePersonDetector(device="cpu").detect(frames)
    np.testing.assert_array_equal(full.numpy(), np.tile([0, 0, 88, 72], (3, 1)))
    with pytest.raises(ValueError, match="select"):
        tdet.SinglePersonDetector(select="best", device="cpu")


def test_build_detector_registry():
    assert len(registry.DETECTOR_REGISTRY) == 10
    assert registry.build_detector("full_frame", device="cpu").model is None
    with pytest.raises(KeyError):
        registry.build_detector("nope", device="cpu")
    det = registry.build_detector("test_centernet_w8", device="cpu", seed=2, select="consistent")
    assert det.select == "consistent" and det.topk == 4
    frames = np.random.default_rng(0).integers(0, 256, (2, 64, 96, 3), dtype=np.uint8)
    boxes = det.detect(frames)
    # The random size head's bias: boxes of about 48 px, inside the frame.
    w, h = boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1]
    assert (w > 10).all() and (h > 10).all() and (boxes[:, 2] <= 96).all()
