"""The port's HRNet, loaded through the flax converter, against flax HRNet in f32.

Held at 1e-4 (the converters' tolerance): both run the same convs and
BatchNorm arithmetic in f32 and differ in summation order only.  With the
kernel rule (`runs_kernels`) patched to hold in f32, stage 1 runs BN-folded
through the stage-1 kernel's plain chain, which reorders its f32
arithmetic; the same 1e-4 holds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_camera_3d_pose_estimation_tpu.models.hrnet import HRNet as JHRNet
from multi_camera_3d_pose_estimation_tpu_torch.models.convert import (hrnet_state_dict_from_flax,
                                                                     load_hrnet_from_flax)
from multi_camera_3d_pose_estimation_tpu_torch.models import hrnet as port_hrnet
from multi_camera_3d_pose_estimation_tpu_torch.models.hrnet import HRNet

from tests._torch_port_util import random_variables

TINY = {"widths": (8, 16, 32, 64), "modules": (1, 1, 1, 1), "stem": 16}


@pytest.fixture(scope="module")
def tiny():
    model = JHRNet(num_joints=17, cfg=TINY, dtype=jnp.float32)
    v = random_variables(model, (1, 64, 32, 3), seed=1)
    x = np.random.default_rng(4).normal(size=(2, 64, 32, 3)).astype(np.float32)
    ref = np.moveaxis(np.asarray(jax.jit(model.apply)(v, x)), -1, 1)  # (B, K, h, w)
    return v, x, ref


def _port(v):
    return load_hrnet_from_flax(HRNet(17, TINY, dtype=torch.float32, device="cpu"), v).eval()


@pytest.mark.parametrize("stage1", ["modules", "plain_chain"])
def test_hrnet_matches_flax_f32(tiny, stage1, monkeypatch):
    v, x, ref = tiny
    model = _port(v)
    if stage1 == "plain_chain":
        monkeypatch.setattr(port_hrnet, "runs_kernels", lambda *a, **k: True)
    with torch.no_grad():
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert out.dtype == torch.float32 and out.shape == ref.shape == (2, 17, 16, 8)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_hrnet_w32_state_dict_covers_flax_tree():
    """At W32 widths the converter's keys and shapes are exactly the model's
    (checked on the abstract flax tree; no weights are drawn)."""
    from multi_camera_3d_pose_estimation_tpu_torch.models.hrnet import HRNET_W32

    shapes = jax.eval_shape(lambda: JHRNet(num_joints=17, cfg=HRNET_W32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 256, 192, 3))))
    v = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = hrnet_state_dict_from_flax(v)
    want = HRNet(17, HRNET_W32, device="meta").state_dict()
    assert set(sd) == set(want)
    assert all(tuple(sd[k].shape) == tuple(want[k].shape) for k in sd)


def test_converter_is_strict(tiny):
    v = tiny[0]
    missing = jax.tree_util.tree_map(lambda a: a, v)
    del missing["params"]["HRModule_0"]["BasicBlock_1"]
    with pytest.raises(KeyError, match="missing"):
        _port(missing)
    extra = jax.tree_util.tree_map(lambda a: a, v)
    extra["params"]["ConvBN_9"] = extra["params"]["ConvBN_5"]
    extra["batch_stats"]["ConvBN_9"] = extra["batch_stats"]["ConvBN_5"]
    with pytest.raises(KeyError, match="leftover"):
        _port(extra)
    unknown = jax.tree_util.tree_map(lambda a: a, v)
    unknown["params"]["head"]["gain"] = np.ones(17, np.float32)
    with pytest.raises(KeyError, match="unmapped"):
        hrnet_state_dict_from_flax(unknown)
