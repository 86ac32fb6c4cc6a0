"""The port's crop resample and box fitting against the JAX package.

`crop_frames` must reproduce ``jax.image.scale_and_translate(method="linear")``
including its antialiasing when it downscales.  Held at 1e-5 in f32: the
weights come from the same f32 formula, the two contractions run in
another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_camera_3d_pose_estimation_tpu.models import topdown as jtd
from multi_camera_3d_pose_estimation_tpu_torch.models import topdown as ttd

BOXES = np.array([
    [0.0, 0.0, 80.0, 96.0],  # whole frame, downscales (antialiased)
    [8.0, 4.0, 72.0, 92.0],  # downscales
    [30.0, 40.0, 42.0, 52.0],  # small box: upscales
    [-20.0, 60.0, 50.0, 130.0],  # crosses the image edge
    [70.0, -10.0, 95.0, 20.0],  # crosses two edges
], np.float32)


def test_center_scale_matches_jax():
    c_ref, s_ref = (np.asarray(a) for a in jtd.center_scale_from_bbox(jnp.asarray(BOXES), 0.75))
    c, s = ttd.center_scale_from_bbox(torch.from_numpy(BOXES), 0.75)
    np.testing.assert_allclose(c.numpy(), c_ref, rtol=1e-6)
    np.testing.assert_allclose(s.numpy(), s_ref, rtol=1e-6)


@pytest.mark.parametrize("out_hw", [(64, 32), (40, 56)])
def test_crop_frames_matches_scale_and_translate(out_hw):
    frames = np.random.default_rng(0).uniform(0, 1, (len(BOXES), 96, 80, 3)).astype(np.float32)
    center, size = jtd.center_scale_from_bbox(jnp.asarray(BOXES), out_hw[1] / out_hw[0])
    crop = jax.jit(jtd.crop_frames, static_argnums=3)
    ref = [np.asarray(a) for a in crop(jnp.asarray(frames), center, size, out_hw)]
    out = ttd.crop_frames(torch.from_numpy(frames), torch.from_numpy(np.array(center)),
                          torch.from_numpy(np.array(size)), out_hw)
    for o, r in zip(out, ref):
        assert o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), r, rtol=1e-5, atol=1e-5)
    # The downscaled whole-frame crop is antialiased: bilinear sampling
    # without the widened kernel would differ from it by far more.
    plain = torch.nn.functional.interpolate(torch.from_numpy(frames[:1]).permute(0, 3, 1, 2),
                                            size=out_hw, mode="bilinear", align_corners=False)
    assert np.abs(plain.permute(0, 2, 3, 1).numpy() - ref[0][:1]).max() > 1e-2


def test_preprocess_crops_matches_jax_bf16():
    """The pipeline's bf16 pixel path: one bf16 rounding (2^-8) apart at most
    per contraction, then normalized by std ~0.22 -> 4e-2 absolute."""
    frames = np.random.default_rng(1).uniform(0, 1, (len(BOXES), 96, 80, 3)).astype(np.float32)
    ref = jtd.preprocess_crops(jnp.asarray(frames, jnp.bfloat16), jnp.asarray(BOXES), (32, 64))
    out = ttd.preprocess_crops(torch.from_numpy(frames).to(torch.bfloat16),
                               torch.from_numpy(BOXES), (32, 64))
    assert out[0].dtype == torch.bfloat16 and out[0].shape == (len(BOXES), 64, 32, 3)
    np.testing.assert_allclose(out[0].float().numpy(), np.asarray(ref[0].astype(jnp.float32)),
                               rtol=0, atol=4e-2)
    for o, r in zip(out[1:], ref[1:]):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6)
