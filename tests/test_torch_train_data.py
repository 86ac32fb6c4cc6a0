"""The port's training data path and synthetic scenes against the JAX package's.

- `make_crop_batch` with a given flip mask (the one ``jax.random.bernoulli``
  draws for the JAX side's key) for heatmap and SimCC targets, in f32: the
  crops at the crop resample's 1e-5 (`tests/test_torch_port_topdown.py`)
  through the ImageNet normalisation's 1/std (at most 4.5), the weights
  equal, the targets within 1e-5 (the keypoints move by the crop affine's
  f32 rounding, ~1e-5 px).
- `KeypointBatcher` over a `write_coco_dataset` folder: without flips the
  same batches as the JAX batcher with the same seed, at the same
  tolerances; with flips, seeded.
- The synthetic scenes, projections, renders and the COCO dataset files:
  bit for bit the JAX package's for the same seed.
"""

import filecmp
import json
import os

import jax
import numpy as np
import pytest
import torch

from multi_camera_3d_pose_estimation_tpu.training import data as jd
from multi_camera_3d_pose_estimation_tpu.training import synthetic as js
from multi_camera_3d_pose_estimation_tpu_torch.training import data as td
from multi_camera_3d_pose_estimation_tpu_torch.training import synthetic as ts

CROP_TOL = 1e-5 / 0.225  # the resample's tolerance through the normalisation


def _inputs(seed=0, B=6):
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(B, 100, 90, 3)).astype(np.float32)
    x0 = rng.uniform(0, 40, (B, 2))
    boxes = np.concatenate([x0, x0 + rng.uniform(20, 50, (B, 2))], -1).astype(np.float32)
    kps = (x0[:, None] + rng.uniform(0, 40, (B, 17, 2))).astype(np.float32)
    vis = rng.integers(0, 3, (B, 17)).astype(np.float32)
    return images, boxes, kps, vis


def _compare(out, ref):
    assert set(out) == set(ref)
    for k, r in ref.items():
        r = np.asarray(r)
        o = out[k].numpy()
        assert o.shape == r.shape and o.dtype == r.dtype == np.float32, k
        if k in ("weights", "w"):
            np.testing.assert_array_equal(o, r)
        else:
            np.testing.assert_allclose(o, r, rtol=0, atol=CROP_TOL if k == "images" else 1e-5,
                                       err_msg=k)


@pytest.mark.parametrize("target", ["heatmap", "simcc"])
@pytest.mark.parametrize("seed", [0, 1])
def test_make_crop_batch_matches_jax(target, seed):
    images, boxes, kps, vis = _inputs(seed)
    key = jax.random.PRNGKey(seed)
    ref = jd.make_crop_batch(images, boxes, kps, vis, input_size=(32, 64), target=target,
                             flip_key=key)
    mask = torch.tensor(np.asarray(jax.random.bernoulli(key, 0.5, (len(images),))))
    assert 0 < int(mask.sum()) < len(images)
    out = td.make_crop_batch(images, boxes, kps, vis, input_size=(32, 64), target=target,
                             flip_mask=mask, device="cpu")
    _compare(out, ref)


def test_make_crop_batch_uint8_is_the_float_batch():
    images, boxes, kps, vis = _inputs(2)
    u8 = (images * 255).astype(np.uint8)
    a = td.make_crop_batch(u8, boxes, kps, vis, input_size=(32, 64), device="cpu")
    b = td.make_crop_batch(u8.astype(np.float32) / 255.0, boxes, kps, vis, input_size=(32, 64),
                           device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    ann, imgs = ts.write_coco_dataset(root, n_images=8, width=96, height=96, seed=3)
    return ann, imgs


def test_batcher_matches_jax_without_flips(coco):
    records = td.parse_coco_keypoints(*coco)
    assert len(records) == 8
    kw = dict(batch_size=4, input_size=(32, 64), image_size=(96, 96), seed=5, augment=False)
    jb = jd.KeypointBatcher(jd.parse_coco_keypoints(*coco), **kw)
    tb = td.KeypointBatcher(records, device="cpu", **kw)
    try:
        for ref, out in zip((next(iter(jb)), next(iter(jb))), (next(iter(tb)), next(iter(tb)))):
            _compare(out, ref)
    finally:
        jb.close()
        tb.close()
    assert not tb._thread.is_alive()


def test_batcher_flips_are_seeded(coco):
    records = td.parse_coco_keypoints(*coco)
    kw = dict(batch_size=4, input_size=(32, 64), image_size=(96, 96), seed=1, target="simcc",
              device="cpu")
    runs = []
    for _ in range(2):
        b = td.KeypointBatcher(records, **kw)
        it = iter(b)
        runs.append([next(it) for _ in range(3)])
        b.close()
    for x, y in zip(*runs):
        assert all(torch.equal(x[k], y[k]) for k in x)
    assert runs[0][0]["images"].shape == (4, 64, 32, 3) and runs[0][0]["lx"].shape == (4, 17, 64)


def test_batcher_raises_the_producers_error(tmp_path):
    rec = {"image_path": str(tmp_path / "missing.png"), "bbox": np.zeros(4, np.float32),
           "keypoints": np.zeros((17, 2), np.float32), "visibility": np.ones(17, np.float32)}
    b = td.KeypointBatcher([rec], batch_size=1, input_size=(32, 64), device="cpu")
    try:
        with pytest.raises(FileNotFoundError):
            next(iter(b))
    finally:
        b.close()
    with pytest.raises(ValueError, match="fewer than a batch"):
        td.KeypointBatcher([rec], batch_size=2, device="cpu")


@pytest.mark.parametrize("hard,distortion", [(False, None), (True, True)])
def test_synthetic_scene_is_the_jax_scene(hard, distortion):
    j = js.SyntheticSceneConfig(n_cams=3, seed=7, hard=hard, distortion=distortion)
    t = ts.SyntheticSceneConfig(n_cams=3, seed=7, hard=hard, distortion=distortion)
    for a, b in zip(j.cams, t.cams):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(j.trajectory(5), t.trajectory(5))
    traj = j.trajectory(3)  # both scenes draw from their rng in step
    np.testing.assert_array_equal(traj, t.trajectory(3))
    for i in range(3):
        for x, y in zip(j.render_views(traj[i]), t.render_views(traj[i])):
            np.testing.assert_array_equal(x, y)
    pts = j.sample_pose()
    np.testing.assert_array_equal(pts, t.sample_pose())
    views = zip(j.render_training_view(pts, j.cams[1]), t.render_training_view(pts, t.cams[1]))
    for x, y in views:
        np.testing.assert_array_equal(x, y)
    K, R, T, d = t.cams[2]
    np.testing.assert_array_equal(js.project_oracle(traj, K, R, T, d),
                                  ts.project_oracle(traj, K, R, T, d))


def test_write_coco_dataset_is_the_jax_dataset(tmp_path):
    ja, jdir = js.write_coco_dataset(tmp_path / "jax", n_images=3, width=64, height=80, seed=2)
    ta, tdir = ts.write_coco_dataset(tmp_path / "port", n_images=3, width=64, height=80, seed=2)
    with open(ja) as f, open(ta) as g:
        assert json.load(f) == json.load(g)
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir)) and len(names) == 3
    assert all(filecmp.cmp(os.path.join(jdir, n), os.path.join(tdir, n), shallow=False)
               for n in names)
    for a, b in zip(jd.parse_coco_keypoints(ja, jdir), td.parse_coco_keypoints(ta, tdir)):
        for k in ("bbox", "keypoints", "visibility"):
            np.testing.assert_array_equal(a[k], b[k])
