"""The port's train CLI against the JAX package's, on a generated COCO folder.

``python -m multi_camera_3d_pose_estimation_tpu_torch train --device cpu``
and the JAX package's CLI resume from one TrainState file written by JAX
(test_tiny's variables, step 0) and take 3 steps in float32 without
augmentation on batches of 8 (the batcher's order comes from the seed).

- The logged losses: the first (the same weights on the same batch) within
  1e-4 relative; the second within 1e-2 and the third within 3e-2.  The
  later ones cannot be held closer in float32.  Train-mode BatchNorm over
  the small maps of stage 4 gives gradients with a rounding error of about
  1e-3 of a leaf's largest element, and Adam's first steps move every
  weight by about ±lr whatever its gradient's size, so rounding decides the
  direction of many steps.  Measured at this size: the two CLIs part by
  4.3e-4 at step 2 and 4.9e-3 at step 3; the port in float32 against itself
  in float64, over ten seeds, by up to 2.9e-3 and 6.7e-3 (at batch 2, where
  stage 4 normalises over 4 values, by up to 7.2e-3 and 6.4e-2).  A doubled
  or halved learning rate moves steps 2 and 3 by 4.1e-2 and 9.3e-2, or
  4.2e-2 and 5.2e-2.  The composed steps are held at 1e-4 in float64 by
  ``tests/test_torch_train_loop.py``.
- What the losses cannot show is held exactly: the batches each CLI fed its
  steps (at the tolerances of ``tests/test_torch_train_data.py``), the
  optimizer the port's CLI built against the JAX CLI's (optax's clip 1.0 ->
  AdamW, weight decay 1e-4, at the parsed learning rate), and the step and
  update counts in both TrainState files.
- The port's ``.npz`` loads in both packages' ``build_estimator
  (checkpoint=)``, which predict the same keypoints, and JAX's loads in the
  port.
"""

import contextlib
import io
import re

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multi_camera_3d_pose_estimation_tpu.cli import train as jcli
from multi_camera_3d_pose_estimation_tpu.models.hrnet import HRNet as JHRNet
from multi_camera_3d_pose_estimation_tpu.models.registry import build_estimator as j_build
from multi_camera_3d_pose_estimation_tpu.training.loop import TrainState as JTrainState
from multi_camera_3d_pose_estimation_tpu_torch import __main__ as port_main
from multi_camera_3d_pose_estimation_tpu_torch.cli import train as tcli
from multi_camera_3d_pose_estimation_tpu_torch.models.registry import MODEL_REGISTRY
from multi_camera_3d_pose_estimation_tpu_torch.models.registry import build_estimator as t_build
from multi_camera_3d_pose_estimation_tpu_torch.training import ClipAdamW
from multi_camera_3d_pose_estimation_tpu_torch.training.synthetic import write_coco_dataset

from tests._torch_port_util import random_variables

LOSS = re.compile(r"^step (\d+): loss ([0-9.eE+-]+)", re.M)
LOSS_RTOL = {1: 1e-4, 2: 1e-2, 3: 3e-2}
CROP_TOL = 1e-5 / 0.225  # the crop resample's tolerance through the normalisation


def _losses(text):
    return {int(s): float(v) for s, v in LOSS.findall(text)}


def _spy(batcher_cls, fed):
    """``batcher_cls`` that records every batch its iterator hands out."""

    class Spy(batcher_cls):
        def __iter__(self):
            for batch in super().__iter__():
                fed.append(batch)
                yield batch

    return Spy


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs, 3 steps each from one JAX TrainState: their output, the
    batches they fed, and the trainer the port's CLI built."""
    root = tmp_path_factory.mktemp("train_cli")
    ann, imgs = write_coco_dataset(root, n_images=24, width=96, height=96, seed=1)
    jm = JHRNet(num_joints=17, cfg=MODEL_REGISTRY["test_tiny"]["cfg"], dtype=jnp.float32)
    v = random_variables(jm, (1, 64, 32, 3), seed=2, jitter=False)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(5e-4, weight_decay=1e-4))
    init = str(root / "init.npz")
    JTrainState(v["params"], v["batch_stats"], tx.init(v["params"]), 0).save(init)
    common = ["--annotations", ann, "--images", imgs, "--model", "test_tiny", "--steps", "3",
              "--batch_size", "8", "--log_every", "1", "--checkpoint_every", "0",
              "--no_augment", "--dtype", "float32", "--image_size", "96", "96",
              "--resume", init]
    fed = {"jax": [], "port": []}
    trainers = []
    build = tcli.build_trainer
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcli, "KeypointBatcher", _spy(jcli.KeypointBatcher, fed["jax"]))
        mp.setattr(tcli, "KeypointBatcher", _spy(tcli.KeypointBatcher, fed["port"]))
        mp.setattr(tcli, "build_trainer", lambda *a, **k: trainers.append(build(*a, **k))
                   or trainers[-1])
        for side, run in (("jax", lambda: jcli.main(common + ["--out", str(root / "jax.npz")])),
                          ("port", lambda: port_main.main(["train", *common, "--out",
                                                           str(root / "port.npz"),
                                                           "--device", "cpu"]))):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                run()
            out[side] = buf.getvalue()
    return {"root": root, "out": out, "fed": fed, "trainer": trainers[0]}


def test_train_cli_matches_jax(runs):
    root, out = runs["root"], runs["out"]
    assert "resumed at step 0" in out["port"] and "saved inference checkpoint" in out["port"]
    ref, got = _losses(out["jax"]), _losses(out["port"])
    assert sorted(got) == sorted(ref) == [1, 2, 3]
    print("relative gaps", {k: abs(got[k] - ref[k]) / abs(ref[k]) for k in ref})
    for step, rtol in LOSS_RTOL.items():
        np.testing.assert_allclose(got[step], ref[step], rtol=rtol, err_msg=f"step {step}")
    for side in ("jax", "port"):  # the step and Adam's update count in the TrainState file
        with np.load(str(root / f"{side}.npz.train_state.npz")) as f:
            counts = [int(f[k]) for k in f.files if f[k].ndim == 0]
        assert counts == [3, 3], (side, counts)

    # The checkpoint in both packages' estimators: the same keypoints.
    frames = np.random.default_rng(0).uniform(0, 1, (2, 96, 96, 3)).astype(np.float32)
    boxes = np.array([[10, 5, 80, 90], [0, 0, 96, 96]], np.float32)
    est_j = j_build("test_tiny", checkpoint=str(root / "port.npz"))
    est_t = t_build("test_tiny", checkpoint=str(root / "port.npz"), device="cpu")
    kj = np.asarray(est_j.predict_batch(jnp.asarray(frames), jnp.asarray(boxes))["keypoints"])
    kt = est_t.predict_batch(torch.from_numpy(frames), torch.from_numpy(boxes))["keypoints"]
    assert kt.shape == kj.shape == (2, 17, 3)
    same = np.abs(kt[..., :2].float().numpy() - kj[..., :2]).max(-1) < 1e-2
    assert same.mean() >= 0.9  # bf16 models on both sides: a few peaks may tie differently
    t_build("test_tiny", checkpoint=str(root / "jax.npz"), device="cpu")  # and JAX's in the port


def test_train_cli_feeds_the_jax_clis_batches(runs):
    jax_fed, port_fed = runs["fed"]["jax"], runs["fed"]["port"]
    assert len(jax_fed) == len(port_fed) == 3
    for step, (ref, got) in enumerate(zip(jax_fed, port_fed), 1):
        assert set(got) == set(ref) == {"images", "targets", "weights"}
        for k, r in ref.items():
            r, o = np.asarray(r), got[k].numpy()
            assert o.shape == r.shape and o.dtype == r.dtype == np.float32, (step, k)
            if k == "weights":
                np.testing.assert_array_equal(o, r, err_msg=f"step {step}")
            else:
                np.testing.assert_allclose(o, r, rtol=0, atol=CROP_TOL if k == "images" else 1e-5,
                                           err_msg=f"step {step} {k}")


def test_train_cli_optimizer_is_the_jax_clis(runs):
    """The port CLI's optimizer is the JAX CLI's, its make_train_step default
    (clip 1.0 -> AdamW, weight decay 1e-4) at the parsed learning rate; the
    updates of that optimizer are held against optax's by
    ``tests/test_torch_train_loop.py``."""
    lr = jcli.build_parser().parse_args(["--annotations", "a", "--images", "i"]).learning_rate
    tx = runs["trainer"].init_fn().tx
    assert (type(tx), tx.learning_rate, tx.weight_decay, tx.grad_clip) == (ClipAdamW, lr, 1e-4, 1.0)
