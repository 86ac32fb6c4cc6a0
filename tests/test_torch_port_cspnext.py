"""The port's CSPNeXt blocks, RTMPose and SimCC decode against the JAX package.

Weights: one random flax variables tree (`random_variables`, non-trivial
BatchNorm statistics, GAU γ of order one) carried across by
`rtmpose_state_dict_from_flax`; inputs drawn from a seed with numpy.

Tolerances:

- f32, every block and the whole model against its flax module at 1e-4
  relative to the output's largest value (the same arithmetic, sums in
  another order);
- bf16 RTMPose against the bf16 flax module at 5e-2 of the logits' largest
  value (a few bf16 roundings in other places compound through ~60 convs,
  as `test_torch_port_pipeline.py` holds HRNet);
- `simcc_decode`: argmax positions exactly, values at 1e-6 relative (the
  refinement's f32 weighted sums in another order: a few ulps of a bin
  index up to 40), on hand-made ties (the first maximum wins).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_camera_3d_pose_estimation_tpu.models import rtmpose as jr
from multi_camera_3d_pose_estimation_tpu.ops.simcc import simcc_decode as j_simcc_decode
from multi_camera_3d_pose_estimation_tpu_torch.models import registry
from multi_camera_3d_pose_estimation_tpu_torch.models import rtmpose as tr
from multi_camera_3d_pose_estimation_tpu_torch.models.convert import (
    load_rtmpose_from_flax, rtmpose_state_dict_from_flax)
from multi_camera_3d_pose_estimation_tpu_torch.ops import simcc_decode

from tests._torch_port_util import random_variables

CFG = {"widen": 0.125, "deepen": 0.167, "embed": 32}
INPUT = (64, 96)  # (w, h)
F32 = jnp.float32


def _rel(out, ref):
    out = out.detach().float().numpy() if torch.is_tensor(out) else np.asarray(out)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


class _Wrap(torch.nn.Module):
    """Holds a port block under the flax block's variable root."""

    def __init__(self, block):
        super().__init__()
        self.block = block


# (flax module, port module, input channels): every building block, each with
# its own tree under a root named "block".
BLOCKS = {
    "conv3x3_s2": (lambda: jr.ConvModule(12, 3, 2, dtype=F32),
                   lambda: tr.ConvModule(8, 12, 3, 2, dtype=torch.float32), 8),
    "depthwise": (lambda: jr.ConvModule(8, 5, groups=8, dtype=F32),
                  lambda: tr.ConvModule(8, 8, 5, groups=8, dtype=torch.float32), 8),
    "no_act": (lambda: jr.ConvModule(6, 1, act=False, dtype=F32),
               lambda: tr.ConvModule(8, 6, 1, act=False, dtype=torch.float32), 8),
    "dwsep": (lambda: jr.DepthwiseSeparableConv(12, dtype=F32),
              lambda: tr.DepthwiseSeparableConv(8, 12, dtype=torch.float32), 8),
    "attention": (lambda: jr.ChannelAttention(dtype=F32),
                  lambda: tr.ChannelAttention(8), 8),
    "cspnext_block": (lambda: jr.CSPNeXtBlock(8, dtype=F32),
                      lambda: tr.CSPNeXtBlock(8, 8, dtype=torch.float32), 8),
    "csp_layer": (lambda: jr.CSPLayer(16, 2, dtype=F32),
                  lambda: tr.CSPLayer(8, 16, 2, dtype=torch.float32), 8),
    "csp_layer_plain": (lambda: jr.CSPLayer(16, 1, add_identity=False, use_attention=False,
                                            dtype=F32),
                        lambda: tr.CSPLayer(12, 16, 1, False, False, dtype=torch.float32), 12),
    "spp": (lambda: jr.SPPBottleneck(16, dtype=F32),
            lambda: tr.SPPBottleneck(8, 16, dtype=torch.float32), 8),
}


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_matches_flax_f32(kind):
    jmake, tmake, cin = BLOCKS[kind]
    jm = jmake()
    x = np.random.default_rng(len(kind)).normal(size=(2, 11, 13, cin)).astype(np.float32)
    v = random_variables(jm, x.shape, seed=len(kind))
    ref = jax.jit(jm.apply)(v, jnp.asarray(x))
    tree = {c: {"block": t} for c, t in v.items()}
    port = load_rtmpose_from_flax(_Wrap(tmake()), tree).block
    with torch.no_grad():
        out = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert out.shape == ref.shape
    assert _rel(out, ref) <= 1e-4


def test_scalenorm_and_gau_match_flax_f32():
    x = np.random.default_rng(3).normal(size=(3, 17, 32)).astype(np.float32)
    for jm, tm in ((jr.ScaleNorm(dtype=F32), tr.ScaleNorm(torch.float32)),
                   (jr.GAU(32, dtype=F32), tr.GAU(32, dtype=torch.float32))):
        v = random_variables(jm, x.shape, seed=5)
        ref = jax.jit(jm.apply)(v, jnp.asarray(x))
        port = load_rtmpose_from_flax(_Wrap(tm), {c: {"block": t} for c, t in v.items()}).block
        with torch.no_grad():
            out = port(torch.from_numpy(x))
        assert _rel(out, ref) <= 1e-4, type(tm).__name__


@pytest.fixture(scope="module")
def rtmpose():
    jm = jr.RTMPose(cfg=CFG, input_size=INPUT, dtype=F32)
    x = np.random.default_rng(7).normal(size=(3, INPUT[1], INPUT[0], 3)).astype(np.float32)
    v = random_variables(jm, x.shape, seed=2)
    return jm, v, x


def _port_rtmpose(v, dtype):
    model = tr.RTMPose(cfg=CFG, input_size=INPUT, dtype=dtype, device="cpu")
    return load_rtmpose_from_flax(model, v).eval()


def test_cspnext_backbone_matches_flax_f32(rtmpose):
    _, v, x = rtmpose
    jm = jr.CSPNeXt(CFG["widen"], CFG["deepen"], dtype=F32)
    ref = jax.jit(jm.apply)({c: t["backbone"] for c, t in v.items()}, jnp.asarray(x))
    with torch.no_grad():
        out = _port_rtmpose(v, torch.float32).backbone(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert out.shape == (3, 128, 3, 2)
    assert _rel(out.permute(0, 2, 3, 1), ref) <= 1e-4


def test_rtmpose_matches_flax_f32(rtmpose):
    jm, v, x = rtmpose
    ref = jax.jit(jm.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        out = _port_rtmpose(v, torch.float32)(torch.from_numpy(x).permute(0, 3, 1, 2))
    for o, r, n in zip(out, ref, (128, 192)):
        assert o.dtype == torch.float32 and o.shape == r.shape == (3, 17, n)
        assert _rel(o, r) <= 1e-4


def test_rtmpose_bf16_matches_flax_bf16(rtmpose):
    _, v, x = rtmpose
    ref = jax.jit(jr.RTMPose(cfg=CFG, input_size=INPUT).apply)(v, jnp.asarray(x))
    with torch.no_grad():
        out = _port_rtmpose(v, torch.bfloat16)(torch.from_numpy(x).permute(0, 3, 1, 2))
    for o, r in zip(out, ref):
        assert o.dtype == torch.float32
        print("bf16 logits error / scale:", _rel(o, r))
        assert _rel(o, r) <= 5e-2


def test_rtmpose_converter_is_strict(rtmpose):
    _, v, _ = rtmpose
    sd = rtmpose_state_dict_from_flax(v)
    assert sd["gau.gamma"].shape == (2, 128) and sd["mlp_ln.g"].shape == (1,)
    assert sd["backbone.stage1_csp.blocks_0.conv2.depthwise_conv.conv.weight"].shape == (8, 1, 5, 5)
    unknown = jax.tree_util.tree_map(lambda a: a, v)
    unknown["params"]["gau"]["delta"] = np.zeros((2, 128), np.float32)
    with pytest.raises(KeyError, match="unmapped"):
        rtmpose_state_dict_from_flax(unknown)
    missing = jax.tree_util.tree_map(lambda a: a, v)
    del missing["params"]["gau"]["res_scale"]
    with pytest.raises(KeyError, match="missing"):
        _port_rtmpose(missing, torch.float32)


def _ties():
    """Logits (4, 17, 40) with hand-made ties: equal maxima on both axes
    (the first wins), a flat row, and one peak at the last bin."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(4, 17, 40)).astype(np.float32)
    x[0, 0, [3, 30]] = 9.0
    x[0, 1] = 0.0
    x[1, 2, [0, 39]] = 7.0
    x[2, 3, 39] = 12.0
    return x


@pytest.mark.parametrize("refine", [(False, 0), (True, 2), (True, 5)])
def test_simcc_decode_matches_jax(refine):
    sx, sy = _ties(), _ties()[:, :, ::-1].copy() * 1.5
    ref_xy, ref_s = j_simcc_decode(jnp.asarray(sx), jnp.asarray(sy), 2.0, *refine)
    xy, s = simcc_decode(torch.from_numpy(sx), torch.from_numpy(sy), 2.0, *refine)
    if not refine[0]:  # positions are argmax bins / 2: exact
        np.testing.assert_array_equal(xy.numpy(), np.asarray(ref_xy))
        assert xy[0, 0, 0] == 1.5 and xy[0, 1, 0] == 0.0  # first of the tied maxima
    np.testing.assert_allclose(xy.numpy(), np.asarray(ref_xy), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(ref_s), rtol=1e-6, atol=1e-7)


def test_rtmpose_names_build():
    for name, n_bins in (("coco_rtmpose-t", (384, 512)), ("coco_rtmpose-m", (512, 512))):
        est = registry.build_estimator(name, device="cpu", seed=1)
        assert est.family == "rtmpose" and est.decode == "simcc"
        assert (est.model.cls_x.out_features, est.model.cls_y.out_features) == n_bins
