"""The kernel wrappers refuse autograd instead of detaching silently.

The kernels run through ``ctypes`` and have no backward: an output would
carry no ``grad_fn``, and the gradient upstream of it would be lost.  Each
public wrapper raises a ``RuntimeError`` naming its kernel when autograd is
on and an input requires grad.  The check comes before the device dispatch,
so it holds on the CPU, where the wrappers run the plain versions; under
``torch.no_grad()`` (or with no input that requires grad) they run.
"""

import re

import numpy as np
import pytest
import torch

from multi_camera_3d_pose_estimation_tpu_torch.models.hrnet import HRNet
from multi_camera_3d_pose_estimation_tpu_torch.models.swin import SwinPose
from multi_camera_3d_pose_estimation_tpu_torch.ops import bn_epilogue as be
from multi_camera_3d_pose_estimation_tpu_torch.ops import bottleneck as bn
from multi_camera_3d_pose_estimation_tpu_torch.ops import crop_resample as cr
from multi_camera_3d_pose_estimation_tpu_torch.ops import fused_decode as fd
from multi_camera_3d_pose_estimation_tpu_torch.ops import swin_block as sb
from multi_camera_3d_pose_estimation_tpu_torch.ops import window_attention as wa
from multi_camera_3d_pose_estimation_tpu_torch.ops.swin_geometry import window_roll_perm

TINY = {"widths": (8, 16, 32, 64), "modules": (1, 1, 1, 1), "stem": 16}


def _block_params():
    return HRNet(17, TINY, torch.float32, "cpu").stage1_blocks()[0]


def _calls():
    """name -> (kernel words in the message, fn(grad_input) -> output)."""
    g = torch.Generator().manual_seed(0)
    p = _block_params()
    x = torch.randn(1, 4, 4, 16, generator=g)
    maps = torch.rand(3, 8 * 6, generator=g)
    qkv = torch.randn(2, 4, 3 * 8, generator=g)
    bias = torch.randn(2, 4, 4, generator=g)
    a = torch.randn(8, 16, generator=g)
    w = torch.randn(12, 16, generator=g)
    b = torch.randn(12, generator=g)
    rows = torch.as_tensor(window_roll_perm(2, 4, 2, 0, 0).astype(np.int32))
    frames = torch.rand(2, 12, 10, 3, generator=g)
    boxes = torch.tensor([[0.0, 0.0, 10.0, 12.0], [2.0, 3.0, 7.0, 9.0]])
    ymap = torch.randn(2, 8, 3, 2, generator=g).to(torch.bfloat16)
    res = torch.randn(2, 8, 6, 4, generator=g).to(torch.bfloat16)
    mean, mul, beta = (torch.randn(8, generator=g) for _ in range(3))
    return {
        "bottleneck": ("bottleneck kernel", lambda r: bn.fused_bottleneck_block(r(x), p)),
        "bottleneck_weights": ("bottleneck kernel", lambda r: bn.fused_bottleneck_block(
            x, {**p, "w1": r(p["w1"])})),
        "bn_epilogue": ("BatchNorm epilogue kernel", lambda r: be.bn_epilogue(
            r(ymap), mean, mul, beta, residual=res, upsample=1, relu=True)),
        "bn_epilogue_residual": ("BatchNorm epilogue kernel", lambda r: be.bn_epilogue(
            ymap, mean, mul, beta, residual=r(res), upsample=1, relu=True)),
        "crop": ("crop kernel", lambda r: cr.crop_resample(r(frames), boxes, (8, 16))),
        "crop_boxes": ("crop kernel", lambda r: cr.crop_resample(frames, r(boxes), (8, 16))),
        "decode": ("heatmap decode kernel", lambda r: fd.heatmap_decode_raw(r(maps), 6)),
        "fused_decode": ("heatmap decode kernel",
                         lambda r: fd.fused_heatmap_decode(r(maps).view(3, 8, 6))),
        "swin_gemm": ("swin_gemm kernel", lambda r: sb.swin_gemm("qkv", r(a), w, b)),
        "swin_gemm_weight": ("swin_gemm kernel", lambda r: sb.swin_gemm("qkv", a, r(w), b)),
        "window_attention": ("window attention kernel",
                             lambda r: wa.window_attention(r(qkv), bias, None, 2)),
        "window_attention_bias": ("window attention kernel",
                                  lambda r: wa.fused_window_attention(qkv, r(bias), None, 2)),
        "window_attention_rows": ("window attention kernel (row mode)",
                                  lambda r: wa.window_attention_rows(r(qkv).reshape(8, 24),
                                                                     bias, None, 2, rows, 8)),
    }


CALLS = list(_calls())


@pytest.mark.parametrize("name", CALLS)
def test_wrapper_refuses_an_input_that_requires_grad(name):
    words, call = _calls()[name]
    with pytest.raises(RuntimeError, match=re.escape(words)):
        call(lambda t: t.detach().clone().requires_grad_(True))


@pytest.mark.parametrize("name", CALLS)
def test_wrapper_runs_without_autograd(name):
    _, call = _calls()[name]
    with torch.no_grad():
        out = call(lambda t: t.detach().clone().requires_grad_(True))
    assert all(torch.isfinite(o).all() for o in (out if isinstance(out, tuple) else (out,)))
    call(lambda t: t)  # nothing requires grad


def test_kernel_paths_refuse_training(monkeypatch):
    """A model never hands autograd to a kernel: under autograd (eval mode,
    the weights requiring grad) and in train mode, bf16 HRNet and Swin take
    their plain paths (`runs_kernels`), no kernel wrapper is called and the
    gradient reaches the stem; the wrappers themselves refuse (above)."""
    called = []

    def refuse(name):
        def fn(*a, **k):
            called.append(name)
            raise AssertionError(f"{name} called under autograd")
        return fn

    monkeypatch.setattr(bn, "fused_bottleneck_block", refuse("bottleneck"))
    monkeypatch.setattr(sb, "fused_swin_block", refuse("swin block"))
    monkeypatch.setattr(be, "bn_epilogue", refuse("epilogue"))
    cfg = {"embed": 24, "depths": (1, 1), "heads": (2, 4), "window": 4, "mlp_ratio": 2,
           "deconv": (16,)}
    hr = HRNet(17, TINY, torch.bfloat16, "cpu")
    swin = SwinPose(17, cfg, torch.bfloat16, "cpu")
    for train in (False, True):
        for model, x, stem in ((hr, torch.randn(2, 3, 64, 32), hr.ConvBN_0.Conv_0),
                               (swin, torch.randn(2, 64, 64, 3),
                                swin.backbone.patch_embed_projection)):
            model.train(train)
            model.zero_grad()
            model(x).sum().backward()
            assert stem.weight.grad is not None and torch.isfinite(stem.weight.grad).all()
    assert called == []
