"""The port's stage-1 Bottleneck (plain version of the CUDA kernel) against JAX.

- f32: one folded block against the flax ``Bottleneck`` at 2e-4, as the
  JAX package's own kernel test holds its Pallas block (folding BN changes
  the order of the f32 arithmetic).
- bf16: the 4-block chain against ``fused_stage1_chain(..., interpret=True)``
  at 8e-3 relative to the output's largest value (the bf16 tolerance the
  JAX side accepts for this kernel, PROFILE.md): both compute bf16 products
  with f32 sums and cast at the same points, so they differ only where a
  sum in another order rounds to the neighbouring bf16 value (2^-8).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_camera_3d_pose_estimation_tpu.models.hrnet import Bottleneck as JBottleneck
from multi_camera_3d_pose_estimation_tpu.ops.pallas import bottleneck as jbn
from multi_camera_3d_pose_estimation_tpu_torch.models.convert import load_hrnet_from_flax
from multi_camera_3d_pose_estimation_tpu_torch.models.hrnet import Bottleneck
from multi_camera_3d_pose_estimation_tpu_torch.ops import bottleneck as tbn

from tests._torch_port_util import random_variables


def _blocks(cins, dtype, seed=0):
    """flax Bottleneck variables for each cin, and the port's modules loaded from them."""
    out = []
    for i, cin in enumerate(cins):
        v = random_variables(JBottleneck(64, dtype=dtype), (1, 8, 8, cin), seed + i)
        block = load_hrnet_from_flax(Bottleneck(cin, 64, dtype=torch.float32), v)
        out.append((v, block))
    return out


@pytest.mark.parametrize("cin", [64, 256])
def test_plain_block_matches_flax_f32(cin):
    (v, block), = _blocks([cin], jnp.float32, seed=cin)
    x = np.random.default_rng(2).normal(size=(3, 16, 12, cin)).astype(np.float32)
    ref = np.asarray(JBottleneck(64, dtype=jnp.float32).apply(v, x))
    p = tbn.prepare_block(tbn.fold_bottleneck_params(block), torch.float32, "cpu")
    assert ("wd" in p) == (cin != 256)
    out = tbn.fused_bottleneck_block(torch.from_numpy(x), p)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-4, atol=2e-4)
    # The port's own module path agrees too.
    mod = block(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(mod.detach().numpy(), ref, rtol=2e-4, atol=2e-4)


def test_plain_chain_matches_pallas_interpret_bf16():
    blocks = _blocks([64, 256, 256, 256], jnp.bfloat16, seed=7)
    x = np.random.default_rng(3).uniform(0, 1, (2, 16, 12, 64)).astype(np.float32)
    folded = [jbn.fold_bottleneck_params(v["params"], v["batch_stats"]) for v, _ in blocks]
    ref = np.asarray(jbn.fused_stage1_chain(jnp.asarray(x, jnp.bfloat16), folded,
                                            interpret=True).astype(jnp.float32))
    prepared = [tbn.prepare_block(tbn.fold_bottleneck_params(b), torch.bfloat16, "cpu")
                for _, b in blocks]
    xt = torch.from_numpy(x).to(torch.bfloat16)
    out = tbn.fused_stage1_chain(xt, prepared)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 16, 12, 256)
    out = out.float().numpy()
    assert np.abs(out - ref).max() <= 8e-3 * np.abs(ref).max()
    # The folded weights agree with the JAX folding to f32 rounding.
    np.testing.assert_allclose(tbn.fold_bottleneck_params(blocks[0][1])["W2"].numpy(),
                               folded[0]["W2"], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tbn.stage1_chain_plain(xt, prepared).float().numpy(), out)


@pytest.mark.parametrize("cin", [16, 64])
def test_plain_concatenated_downsample_matches_separate_sums_f32(cin):
    """Block 0's expand and downsample as one product over K = 64 + cin (the
    kernel's order) against the Pallas kernel's ``(y2 @ W3 + b3) + (x @ Wd
    + bd)``: only the order of the f32 sums differs, within 1e-5 of the
    largest output."""
    (_, block), = _blocks([cin], jnp.float32, seed=cin + 1)
    p = tbn.prepare_block(tbn.fold_bottleneck_params(block), torch.float32, "cpu")
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(2, 9, 7, cin)).astype(np.float32))
    new = tbn.bottleneck_block_plain(x, p)
    xf = x.reshape(-1, cin)
    y1 = torch.relu(xf @ p["w1"].t() + p["b1"]).view(2, 9, 7, 64)
    pad = torch.nn.functional.pad(y1, (0, 0, 1, 1, 1, 1))
    cat = torch.cat([pad[:, kh:kh + 9, kw:kw + 7] for kh in range(3) for kw in range(3)], -1)
    y2 = torch.relu(cat.reshape(-1, 576) @ p["w2"].t() + p["b2"])
    old = torch.relu((y2 @ p["w3"].t() + p["b3"]) + (xf @ p["wd"].t() + p["bd"]))
    ref = old.view(2, 9, 7, -1)
    assert (new - ref).abs().max() <= 1e-5 * ref.abs().max()


def test_chain_rejects_misplaced_downsample():
    blocks = _blocks([256], jnp.float32)
    p = tbn.prepare_block(tbn.fold_bottleneck_params(blocks[0][1]), torch.float32, "cpu")
    with pytest.raises(ValueError, match="downsample"):
        tbn.fused_stage1_chain(torch.zeros(1, 4, 4, 256), [p])


def test_block_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        tbn.fused_bottleneck_block(torch.zeros(1, 4, 4, 64, device="meta"), {})
