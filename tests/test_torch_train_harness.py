"""The port's train -> deploy accuracy harness on the CPU.

- The JAX package's smallest budget (``tests/test_accuracy_harness.py``:
  2 frames, 10 detector steps, 10 pose steps) through the whole harness:
  the metrics that test asserts are finite, for the heatmap family (its
  default HRNet and the Swin entry) and for SimCC.
- The resume drill of ``test_pose_trainer_checkpoint_resume``: 4 steps, then
  a second call with a budget of 8 resumes from the file at step 4, and a
  third call at 8 trains nothing, returns no loss and the same weights; the
  resumed run ends on the same weights as an uninterrupted one.
"""

import numpy as np
import pytest
import torch

from multi_camera_3d_pose_estimation_tpu_torch.training import harness
from multi_camera_3d_pose_estimation_tpu_torch.training.synthetic import SyntheticSceneConfig


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: these steps are small, and a thread per core
    oversubscribes the CPU when the test files run in parallel."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("family,model", [("heatmap", None), ("heatmap", "test_swin_128"),
                                          ("simcc", None)])
def test_accuracy_harness_smoke(family, model):
    m = harness.run_accuracy_harness(n_frames=2, det_steps=10, pose_steps=10, pose_family=family,
                                     pose_model_name=model, device="cpu")
    for key in ("mpjpe_3d", "px_err_2d", "det_tight_frac", "pose_loss"):
        assert key in m and np.isfinite(m[key]), (key, m)
    assert m["pose_family"] == family
    assert ("px_err_flip_shift" in m) == (family == "heatmap")


def test_accuracy_harness_nview_and_sgd():
    m = harness.run_accuracy_harness(n_frames=4, det_steps=2, pose_steps=2, n_cams=3,
                                     pose_model_name="test_tiny", sgd_refine=True,
                                     sgd_kwargs=dict(max_iter=5, patience=30, batch_size=4),
                                     sgd_variants={"smooth": {"lambda_smooth": 1e-3}},
                                     device="cpu")
    for key in ("mpjpe_3d_nview", "mpjpe_3d_sgd", "mpjpe_3d_sgd_smooth"):
        assert key in m and np.isfinite(m[key]), (key, m)


def _weights(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def test_pose_trainer_checkpoint_resume(tmp_path):
    ckpt = str(tmp_path / "pose.npz")
    kw = dict(batch=2, model_name="test_tiny", checkpoint_path=ckpt, checkpoint_every=2,
              device="cpu")
    harness.train_synthetic_pose(SyntheticSceneConfig(n_cams=2, seed=3), steps=4, **kw)
    assert int(np.load(ckpt)["step"]) == 4
    scene = SyntheticSceneConfig(n_cams=2, seed=3)
    scene.rng = np.random.default_rng(11)  # the batches after step 4
    m8, _, loss8 = harness.train_synthetic_pose(scene, steps=8, **kw)
    assert int(np.load(ckpt)["step"]) == 8 and loss8 is not None
    m8b, _, loss = harness.train_synthetic_pose(SyntheticSceneConfig(n_cams=2, seed=3), steps=8,
                                                **kw)
    assert loss is None
    w8, w8b = _weights(m8), _weights(m8b)
    assert all(torch.equal(w8[k], w8b[k]) for k in w8)

    # Uninterrupted: the same batches (seed 3 for four steps, then seed 11).
    scene = SyntheticSceneConfig(n_cams=2, seed=3)
    batches = []
    real = harness._sample_person_crops

    def spy(scene_, batch, size, device):
        if len(batches) == 4:
            scene_.rng = np.random.default_rng(11)
        batches.append(None)
        return real(scene_, batch, size, device)

    harness._sample_person_crops = spy
    try:
        straight, _, _ = harness.train_synthetic_pose(scene, steps=8, batch=2,
                                                      model_name="test_tiny", device="cpu")
    finally:
        harness._sample_person_crops = real
    ws = _weights(straight)
    for k in w8:
        torch.testing.assert_close(ws[k], w8[k], rtol=1e-6, atol=1e-6)
