"""Train-mode BatchNorm of the port against flax's ``nn.BatchNorm(momentum=0.9)``.

flax in train mode normalises by the batch's statistics, taken in f32 as
E[x] and E[x²] − E[x]² (clamped at 0), and moves the running statistics to
0.9·running + 0.1·batch with the biased variance.  ``F.batch_norm`` keeps
the Bessel-corrected variance; the single-layer test shows that the
tolerance below tells the two apart.

- One BatchNorm layer: output at 1e-5, statistics at 1e-6 relative.
- Two values per channel near 4096, where E[x²] − E[x]² in f32 is far from
  the two-pass variance and, each mean being one addition, independent of
  the reduction order: the port matches flax, the two-pass variance does not
  (the control).
- Whole models in train mode (``model.apply(..., train=True,
  mutable=["batch_stats"])`` against ``model.train()``), in f64 activations
  from the same f32 variables, so that summation order through tens of
  layers stays far below the tolerances: the outputs at 1e-5 and every
  updated running statistic within 1e-6 of its leaf's scale; a Bessel
  correction (a factor 1 + 1/(N·H·W - 1), at least 1e-3 here) falls
  outside it.
- Eval mode gives the same bits as the inference formula the port used
  before train mode existed.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multi_camera_3d_pose_estimation_tpu.models.detector import CenterNetDetector as JCenterNet
from multi_camera_3d_pose_estimation_tpu.models.hrnet import HRNet as JHRNet
from multi_camera_3d_pose_estimation_tpu.models.rtmpose import RTMPose as JRTMPose
from multi_camera_3d_pose_estimation_tpu.models.swin import SwinPose as JSwinPose
from multi_camera_3d_pose_estimation_tpu_torch.models import convert
from multi_camera_3d_pose_estimation_tpu_torch.models.batchnorm import BatchNorm, batch_norm
from multi_camera_3d_pose_estimation_tpu_torch.models.detector import CenterNetDetector
from multi_camera_3d_pose_estimation_tpu_torch.models.hrnet import HRNet
from multi_camera_3d_pose_estimation_tpu_torch.models.registry import MODEL_REGISTRY
from multi_camera_3d_pose_estimation_tpu_torch.models.rtmpose import RTMPose
from multi_camera_3d_pose_estimation_tpu_torch.models.swin import SwinPose

from tests._torch_port_util import random_variables

F32, F64 = jnp.float32, jnp.float64
T64 = torch.float64


class _FlaxBN(nn.Module):
    @nn.compact
    def __call__(self, x, train):
        return nn.BatchNorm(use_running_average=not train, momentum=0.9, dtype=F32)(x)


def _single_layer(x_nhwc):
    """flax's one-layer train step and the port's on the same variables."""
    C = x_nhwc.shape[-1]
    rng = np.random.default_rng(3)
    v = {"params": {"BatchNorm_0": {"scale": 1 + 0.2 * rng.normal(size=C).astype(np.float32),
                                    "bias": 0.1 * rng.normal(size=C).astype(np.float32)}},
         "batch_stats": {"BatchNorm_0": {"mean": 0.1 * rng.normal(size=C).astype(np.float32),
                                         "var": 1 + rng.uniform(size=C).astype(np.float32)}}}
    ref, upd = _FlaxBN().apply(v, jnp.asarray(x_nhwc), True, mutable=["batch_stats"])
    bn = BatchNorm(C)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(v["params"]["BatchNorm_0"]["scale"]))
        bn.bias.copy_(torch.from_numpy(v["params"]["BatchNorm_0"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(v["batch_stats"]["BatchNorm_0"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(v["batch_stats"]["BatchNorm_0"]["var"]))
    return v, np.asarray(ref), upd["batch_stats"]["BatchNorm_0"], bn


@pytest.mark.parametrize("shape", [(2, 3, 3, 8), (4, 16, 12, 32)])
def test_batch_norm_train_step_matches_flax(shape):
    """A 2x3x3 batch (Bessel's factor 18/17) and a larger one."""
    x = (2.0 + np.random.default_rng(0).normal(size=shape)).astype(np.float32)
    v, ref, upd, bn = _single_layer(x)
    bn.train()
    out = batch_norm(torch.from_numpy(x).permute(0, 3, 1, 2), bn, torch.float32)
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), ref, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(upd["mean"]), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(upd["var"]), rtol=1e-6)
    # The control: torch's own batch norm keeps the corrected variance.
    old = v["batch_stats"]["BatchNorm_0"]
    rm, rv = torch.from_numpy(old["mean"].copy()), torch.from_numpy(old["var"].copy())
    F.batch_norm(torch.from_numpy(x).permute(0, 3, 1, 2), rm, rv, training=True, momentum=0.1)
    assert np.abs(rv.numpy() - np.asarray(upd["var"])).max() > 1e-6 * np.asarray(upd["var"]).max()


def test_batch_norm_fast_variance_matches_flax():
    """Two values per channel near 4096: each mean is one addition, so the
    result does not depend on the reduction order, and E[x²] − E[x]² in f32
    (clamped at 0) is far from the two-pass variance."""
    x = (4096.0 + np.random.default_rng(2).uniform(0, 1, (2, 1, 1, 64))).astype(np.float32)
    v, ref, upd, bn = _single_layer(x)
    bn.train()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    out = batch_norm(xt, bn, torch.float32)
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), ref, rtol=1e-5,
                               atol=1e-5)
    want = np.asarray(upd["var"])
    np.testing.assert_allclose(bn.running_var.numpy(), want, rtol=1e-6)
    two_pass = xt.var((0, 2, 3), unbiased=False)
    moved = 0.9 * torch.from_numpy(v["batch_stats"]["BatchNorm_0"]["var"]) + 0.1 * two_pass
    assert np.abs(moved.numpy() - want).max() > 1e-2 * want.max()


def test_batch_norm_eval_is_the_inference_formula_bit_for_bit():
    x = np.random.default_rng(1).normal(size=(2, 8, 5, 7)).astype(np.float32)
    _, _, _, bn = _single_layer(np.moveaxis(x, 1, -1))
    y = torch.from_numpy(x).to(torch.bfloat16)
    mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    before = ((y.float() - bn.running_mean[:, None, None]) * mul[:, None, None]
              + bn.bias[:, None, None]).to(torch.bfloat16)
    assert not bn.training  # built in eval mode, as flax's train=False default
    assert torch.equal(batch_norm(y, bn, torch.bfloat16), before)
    rm = bn.running_mean.clone()
    batch_norm(y, bn, torch.bfloat16)
    assert torch.equal(bn.running_mean, rm)


SWIN = MODEL_REGISTRY["test_swin_128"]["cfg"]
RTM = {"widen": 0.125, "deepen": 0.167, "embed": 32}
HR_TINY = MODEL_REGISTRY["test_tiny"]["cfg"]

CASES = {  # name: (flax module, port module, family, input (B, H, W, 3), NHWC input)
    "hrnet_test_tiny": (lambda: JHRNet(num_joints=17, cfg=HR_TINY, dtype=F64),
                        lambda: HRNet(17, HR_TINY, T64, "cpu"), "hrnet",
                        (2, 64, 32, 3), False),
    "swin_test_swin_128": (lambda: JSwinPose(num_joints=17, cfg=SWIN, dtype=F64),
                           lambda: SwinPose(17, SWIN, T64, "cpu"), "swin",
                           (2, 64, 64, 3), True),
    "rtmpose_small": (lambda: JRTMPose(num_joints=17, input_size=(64, 96), cfg=RTM, dtype=F64),
                      lambda: RTMPose(17, (64, 96), cfg=RTM, dtype=T64, device="cpu"), "rtmpose",
                      (2, 96, 64, 3), False),
    "centernet_test_w8": (lambda: JCenterNet(width=8, dtype=F64),
                          lambda: CenterNetDetector(8, T64, "cpu"), "centernet",
                          (2, 64, 96, 3), False),
}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.mark.parametrize("name", list(CASES))
def test_model_train_mode_matches_flax(name):
    jmake, tmake, family, shape, nhwc = CASES[name]
    jm = jmake()
    v = random_variables(jm, shape, seed=5)
    x = np.random.default_rng(6).normal(size=shape)
    ref, upd = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(v, x)
    port = convert._LOADERS[family](tmake(), v).train()
    xt = torch.from_numpy(x)
    out = port(xt if nhwc else xt.permute(0, 3, 1, 2))
    if isinstance(out, dict):  # CenterNet's head maps, the same layouts on both sides
        pairs = [(out[k], ref[k]) for k in ("center", "wh", "offset")]
    elif isinstance(out, tuple):  # RTMPose's SimCC logits
        pairs = list(zip(out, ref))
    else:  # heatmaps: NCHW against flax's NHWC
        pairs = [(out, np.moveaxis(np.asarray(ref), -1, 1))]
    for o, r in pairs:
        r = np.asarray(r)
        scale = max(np.abs(r).max(), 1.0)
        np.testing.assert_allclose(o.detach().double().numpy(), r, rtol=1e-5, atol=1e-5 * scale)
    sd = port.state_dict()
    stats = dict(_flat(upd["batch_stats"]))
    assert len(stats) == sum(k.endswith(("running_mean", "running_var")) for k in sd) > 0
    for path, want in stats.items():
        key = ".".join(path[:-1] + ({"mean": "running_mean", "var": "running_var"}[path[-1]],))
        got = sd[key].numpy()
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
        assert err <= 1e-6, (key, err)
        # The update moved the statistic (the seeded ones are not the batch's).
        assert not np.allclose(got, dict(_flat(v["batch_stats"]))[path])
