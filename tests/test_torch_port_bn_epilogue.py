"""The ConvBN epilogue (`ops.bn_epilogue`, `models.batchnorm.batch_norm_act`).

On the CPU: the wrapper's plain form equals `batch_norm`, the bf16 cast, the
residual add (after ``F.interpolate`` at factors 2, 4 and 8 in FuseLayer's
mode) and the ReLU bit for bit, at HRNet-W32's channel widths; the routing
gives every eval-mode bf16 call to the wrapper, views and mixed layouts
included (laid out densely first), and leaves train mode,
`calibrating_batch_norm`, `synced_batch_norm`, inputs that require grad, f32
and f64 inputs and f64 statistics to the plain form, and on the CPU no counter
moves; the wrapper refuses a residual of another shape; the per-channel
vectors are computed once and again after the module changes; HRNet's
BasicBlock and FuseLayer keep their sum's order and roundings.

Marked ``cuda`` (skipped without a card): the kernel against the plain form
bit for bit (up to the sign of a zero from the ReLU) on every ConvBN shape of
an HRNet-W32 forward in both dense layouts, at channel counts that are not a
multiple of 8, on a misaligned view, on views and mixed layouts, with a
residual and upsampled, each through `batch_norm_act`; a whole
HRNet-W32 forward and a whole Swin-B forward with the kernel routed against
the same forward forced plain; 279 launches per HRNet-W32 forward and no
plain call.  On a machine with a card:

    python -m pytest tests/test_torch_port_bn_epilogue.py -p no:cacheprovider --noconftest
"""

import pytest
import torch
import torch.nn.functional as F

from multi_camera_3d_pose_estimation_tpu_torch.models import batchnorm as bnm
from multi_camera_3d_pose_estimation_tpu_torch.models.batchnorm import (
    BatchNorm, batch_norm, batch_norm_act, calibrating_batch_norm, synced_batch_norm)
from multi_camera_3d_pose_estimation_tpu_torch.models.hrnet import (HRNET_W32, BasicBlock,
                                                                    FuseLayer, HRNet, conv2d)
from multi_camera_3d_pose_estimation_tpu_torch.ops import bn_epilogue as be

W32_WIDTHS = HRNET_W32["widths"]
BF16 = torch.bfloat16


def _bn(C, seed=0, device="cpu"):
    """An eval-mode BatchNorm with statistics and affine far from identity."""
    g = torch.Generator().manual_seed(seed)
    bn = BatchNorm(C)
    with torch.no_grad():
        bn.running_mean.copy_(0.5 * torch.randn(C, generator=g))
        bn.running_var.copy_(0.25 + 2 * torch.rand(C, generator=g))
        bn.weight.copy_(0.5 + torch.rand(C, generator=g))
        bn.bias.copy_(0.3 * torch.randn(C, generator=g))
    return bn.to(device)


def _map(shape, seed, device="cpu", channels_last=True):
    g = torch.Generator().manual_seed(seed)
    x = (2 * torch.randn(shape, generator=g)).to(BF16).to(device)
    return x.contiguous(memory_format=torch.channels_last if channels_last else
                        torch.contiguous_format)


def _composed(y, bn, residual=None, upsample=0, relu=False):
    """`batch_norm` → bf16, F.interpolate, residual + , ReLU: the chain the
    kernel replaces, as the models wrote it."""
    out = batch_norm(y, bn, BF16)
    if upsample:
        out = F.interpolate(out, scale_factor=2 ** upsample, mode="nearest")
    if residual is not None:
        out = residual + out
    return torch.relu(out) if relu else out


def _vectors(bn):
    return bn.running_mean, torch.rsqrt(bn.running_var + bn.eps) * bn.weight, bn.bias


# (C, H, W of the output, upsample, residual, relu): W32's widths at the
# benchmark crop's branch sizes, the BasicBlock's residual, FuseLayer's
# factors 2, 4 and 8.
CPU_CASES = ([(C, 16, 12, 0, False, r) for C in W32_WIDTHS for r in (False, True)]
             + [(C, 16, 12, 0, True, True) for C in W32_WIDTHS]
             + [(C, 16, 16, s, True, r) for C in W32_WIDTHS[:3] for s in (1, 2, 3)
                for r in (False, True)])


@pytest.mark.parametrize("C,H,W,upsample,res,relu", CPU_CASES)
def test_plain_form_is_the_composed_chain(C, H, W, upsample, res, relu):
    bn = _bn(C, seed=C)
    y = _map((2, C, H >> upsample, W >> upsample), seed=1)
    r = _map((2, C, H, W), seed=2) if res else None
    want = _composed(y, bn, r, upsample, relu)
    with torch.no_grad():
        got = be.bn_epilogue(y, *_vectors(bn), residual=r, upsample=upsample, relu=relu)
        routed = batch_norm_act(y, bn, BF16, relu=relu, residual=r, upsample=upsample)
    assert got.dtype == BF16 and got.shape == (2, C, H, W)
    assert torch.equal(got, want) and torch.equal(routed, want)


def _takes(y, bn, dtype, residual):
    """Whether the routing gives the call to the wrapper (on the card, the
    kernel)."""
    return bnm.runs_kernels(bn, dtype, y, residual) and bnm._eval_vectors(bn) is not None


def test_routing_takes_eval_bf16_dense_maps():
    y_cl, y_nchw = _map((2, 32, 8, 6), 0), _map((2, 32, 8, 6), 0, channels_last=False)
    assert be.dense(y_cl)[0] == "channels_last" and be.dense(y_nchw)[0] == "nchw"
    bn = _bn(32)
    with torch.no_grad():
        assert _takes(y_cl, bn, BF16, None)
        assert _takes(y_nchw, bn, BF16, None)
        assert _takes(y_cl, bn, BF16, _map((2, 32, 8, 6), 1))
        assert _takes(_map((2, 32, 4, 3), 0), bn, BF16, _map((2, 32, 16, 12), 1))
    assert not _takes(y_cl, bn, BF16, None)  # autograd follows γ and β


def _odd_layout(case, y, r):
    """``y`` and its residual ``r`` (both channels-last) laid out as ``case``."""
    if case == "strided":
        return torch.cat([y, y], -1)[..., ::2], r
    if case == "channel_slice":
        return torch.cat([y, y], 1)[:, 3:3 + y.shape[1]], r
    if case == "permuted":
        return y.transpose(2, 3).contiguous().transpose(2, 3), r
    if case == "mixed_layouts":
        return y, r.contiguous()
    return y.contiguous(), r  # "nchw_map"


ODD_LAYOUTS = ["strided", "channel_slice", "permuted", "mixed_layouts", "nchw_map"]


@pytest.mark.parametrize("case", ODD_LAYOUTS)
def test_routing_takes_views_and_mixed_layouts(case):
    bn = _bn(32)
    y, r = _odd_layout(case, _map((2, 32, 8, 6), 0), _map((2, 32, 8, 6), 1))
    with torch.no_grad():
        assert _takes(y, bn, BF16, r)
        got = batch_norm_act(y, bn, BF16, residual=r, relu=True)
    assert torch.equal(got, _composed(y, bn, r, relu=True))


@pytest.mark.parametrize("case", ["train", "calibrating", "synced", "requires_grad",
                                  "residual_requires_grad", "f32", "f64", "f32_out",
                                  "f64_stats"])
def test_routing_leaves_to_the_plain_form(case):
    y, bn, dtype, r = _map((2, 32, 8, 6), 0), _bn(32), BF16, None
    if case == "train":
        bn.train()
    elif case == "requires_grad":
        y = y.detach().requires_grad_(True)
    elif case == "residual_requires_grad":
        r = _map((2, 32, 8, 6), 1).requires_grad_(True)
    elif case in ("f32", "f64"):
        y = y.to(torch.float32 if case == "f32" else torch.float64)
    elif case == "f32_out":
        dtype = torch.float32
    elif case == "f64_stats":
        bn = bn.double()
    ctx = {"calibrating": calibrating_batch_norm(),
           "synced": synced_batch_norm(lambda t: t, 1.0)}.get(case, torch.enable_grad())
    launches, plain = be.bn_epilogue.launches, be.bn_epilogue.plain
    with ctx:
        assert not _takes(y, bn, dtype, r)
        out = batch_norm_act(y, bn, dtype, residual=r, relu=True)
    assert out.shape == y.shape and out.dtype == dtype
    assert (be.bn_epilogue.launches, be.bn_epilogue.plain) == (launches, plain)


def test_routing_refuses_a_residual_of_another_shape():
    y, r = _map((2, 32, 8, 6), 0), _map((2, 32, 8, 6), 1)
    with torch.no_grad():
        with pytest.raises(ValueError, match="residual of the output's shape"):
            batch_norm_act(y, _bn(32), BF16, residual=r, upsample=1)
        with pytest.raises(ValueError, match="residual of the output's shape"):
            batch_norm_act(y, _bn(32), BF16, residual=_map((2, 16, 8, 6), 1))


@pytest.mark.parametrize("case", ["not_4d", "upsample_range"])
def test_wrapper_refuses_what_it_cannot_index(case):
    bn = _bn(16)
    y = _map((2, 16, 4, 6), 0)
    y, upsample = (y[0], 0) if case == "not_4d" else (y, 16)
    with torch.no_grad(), pytest.raises(ValueError, match="N, C, H, W"):
        be.bn_epilogue(y, *_vectors(bn), upsample=upsample)


@pytest.mark.parametrize("case", ODD_LAYOUTS)
def test_dense_lays_out_what_the_kernel_cannot_index(case):
    y0, r0 = _map((2, 16, 4, 6), 0), _map((2, 16, 4, 6), 1)
    y, r = _odd_layout(case, y0, r0)
    lay, yd, rd = be.dense(y, r)
    fmt = torch.channels_last if lay == "channels_last" else torch.contiguous_format
    assert lay == ("nchw" if case == "mixed_layouts" else "channels_last")
    assert yd.is_contiguous(memory_format=fmt) and rd.is_contiguous(memory_format=fmt)
    assert torch.equal(yd, y) and torch.equal(rd, r)
    if case == "nchw_map":  # a dense map in the residual's layout stays where it is
        assert be.dense(y0, r0)[1] is y0 and be.dense(y)[1] is y


def test_wrapper_refuses_other_devices_and_autograd():
    y, bn = _map((1, 8, 2, 2), 0), _bn(8)
    with torch.no_grad(), pytest.raises(ValueError, match="unsupported device"):
        be.bn_epilogue(y.to("meta"), *(t.to("meta") for t in _vectors(bn)))
    with pytest.raises(RuntimeError, match="bn_epilogue"):
        be.bn_epilogue(y, *_vectors(bn))  # γ requires grad


def test_eval_vectors_are_cached_and_follow_the_module():
    bn = _bn(16)
    first = bnm._eval_vectors(bn)
    assert bnm._eval_vectors(bn) is first
    mean, mul, bias = first
    assert torch.equal(mul, torch.rsqrt(bn.running_var + bn.eps) * bn.weight)
    assert torch.equal(mean, bn.running_mean) and torch.equal(bias, bn.bias)
    with torch.no_grad():
        bn.running_var.mul_(2.0)
    assert not torch.equal(bnm._eval_vectors(bn)[1], mul)
    assert torch.equal(bnm._eval_vectors(bn)[1],
                       torch.rsqrt(bn.running_var + bn.eps) * bn.weight)
    bn.load_state_dict(_bn(16, seed=5).state_dict())
    assert torch.equal(bnm._eval_vectors(bn)[2], _bn(16, seed=5).bias)
    with torch.no_grad():
        bn.weight.fill_(3.0)
    assert torch.equal(bnm._eval_vectors(bn)[1], torch.rsqrt(bn.running_var + bn.eps) * 3.0)


def test_eval_vectors_of_inference_tensors_are_computed_at_every_call():
    with torch.inference_mode():
        bn = _bn(16)  # parameters and buffers made in inference mode keep no version
        first = bnm._eval_vectors(bn)
        bn.running_var.mul_(2.0)
        assert torch.equal(bnm._eval_vectors(bn)[1],
                           torch.rsqrt(bn.running_var + bn.eps) * bn.weight)
        assert not torch.equal(bnm._eval_vectors(bn)[1], first[1])
        y = _map((2, 16, 4, 6), 0)
        assert torch.equal(batch_norm_act(y, bn, BF16, relu=True), _composed(y, bn, relu=True))


def _randomize_bn_(model, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                C = m.num_features
                m.running_mean.copy_(0.2 * torch.randn(C, generator=g))
                m.running_var.copy_(0.5 + torch.rand(C, generator=g))
                m.weight.copy_(0.5 + torch.rand(C, generator=g))
                m.bias.copy_(0.2 * torch.randn(C, generator=g))
    return model


def _convbn_old(cb, x):
    y = batch_norm(conv2d(x, cb.Conv_0.weight.to(cb.dtype), cb.Conv_0.stride,
                          cb.Conv_0.padding), cb.BatchNorm_0, cb.dtype)
    return torch.relu(y) if cb.act else y


def _fuse_old(fl, xs):
    """FuseLayer's forward as it was written before the epilogue routing."""
    outs = []
    for i in range(fl.n_out):
        acc = None
        for j, names in enumerate(fl.paths[i]):
            y = xs[j]
            for name in names:
                y = _convbn_old(getattr(fl, name), y)
            if j > i:
                y = F.interpolate(y, scale_factor=2 ** (j - i), mode="nearest")
            acc = y if acc is None else acc + y
        outs.append(torch.relu(acc))
    return outs


@pytest.mark.parametrize("n,out_branches", [(2, None), (3, None), (4, None), (4, 1)])
def test_fuse_layer_keeps_its_order_and_roundings(n, out_branches):
    widths = (8, 16, 24, 32)[:n]
    torch.manual_seed(n)
    fl = _randomize_bn_(FuseLayer(widths, out_branches), seed=n).to(
        memory_format=torch.channels_last)
    xs = [_map((2, w, 32 >> k, 24 >> k), seed=k) for k, w in enumerate(widths)]
    with torch.no_grad():
        got, want = fl(xs), _fuse_old(fl, xs)
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))


def test_basic_block_keeps_its_roundings():
    torch.manual_seed(0)
    blk = _randomize_bn_(BasicBlock(16), seed=1).to(memory_format=torch.channels_last)
    x = _map((2, 16, 12, 8), 0)
    with torch.no_grad():
        want = torch.relu(_convbn_old(blk.ConvBN_1, _convbn_old(blk.ConvBN_0, x)) + x)
        assert torch.equal(blk(x), want)


# ---- on the card --------------------------------------------------------

cuda = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same_up_to_zero_sign(a, b):
    return torch.equal(a, b) and torch.equal(a.isnan(), b.isnan())


def _w32_shapes():
    """(C, H, W of the output, upsample, residual, relu) of every distinct
    ConvBN epilogue of an HRNet-W32 forward at 256x192."""
    shapes = {(64, 128, 96, 0, False, True), (64, 64, 48, 0, False, True)}  # the stem
    sizes = [(64, 48), (32, 24), (16, 12), (8, 6)]
    for b, C in enumerate(W32_WIDTHS):
        H, W = sizes[b]
        shapes |= {(C, H, W, 0, False, True), (C, H, W, 0, True, True)}  # BasicBlock, transition
        shapes.add((C, H, W, 0, False, False))  # a FuseLayer row's first, or a chain's last
        for j in range(b + 1, 4):  # upsampled terms into branch b
            shapes |= {(C, H, W, j - b, True, False), (C, H, W, j - b, True, True)}
        shapes |= {(C, H, W, 0, True, False)}  # a downsampled term mid-row
    return sorted(shapes)


@cuda
@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("C,H,W,upsample,res,relu", _w32_shapes())
def test_kernel_matches_plain_on_w32_shapes(card, C, H, W, upsample, res, relu, channels_last):
    N = 8
    bn = _bn(C, seed=C + upsample, device=card)
    y = _map((N, C, H >> upsample, W >> upsample), 1, card, channels_last)
    r = _map((N, C, H, W), 2, card, channels_last) if res else None
    with torch.inference_mode():
        n = be.bn_epilogue.launches
        got = batch_norm_act(y, bn, BF16, relu=relu, residual=r, upsample=upsample)
        assert be.bn_epilogue.launches == n + 1
        want = be.bn_epilogue_plain(y, *_vectors(bn), BF16, r, upsample, relu)
    assert got.is_contiguous(memory_format=torch.channels_last if channels_last else
                             torch.contiguous_format)
    assert _same_up_to_zero_sign(got, want)


@cuda
@pytest.mark.parametrize("C", [17, 24, 12, 3])
@pytest.mark.parametrize("upsample,res", [(0, False), (0, True), (1, True), (2, True)])
@pytest.mark.parametrize("channels_last", [True, False])
def test_kernel_matches_plain_at_odd_channel_counts(card, C, upsample, res, channels_last):
    bn = _bn(C, seed=C, device=card)
    y = _map((3, C, 7 << (2 - upsample), 5 << (2 - upsample)), 1, card, channels_last)
    r = _map((3, C, 28, 20), 2, card, channels_last) if res else None
    with torch.inference_mode():
        n = be.bn_epilogue.launches
        got = batch_norm_act(y, bn, BF16, relu=True, residual=r, upsample=upsample)
        assert be.bn_epilogue.launches == n + 1
        want = be.bn_epilogue_plain(y, *_vectors(bn), BF16, r, upsample, True)
    assert _same_up_to_zero_sign(got, want)


@cuda
@pytest.mark.parametrize("channels_last", [True, False])
def test_kernel_matches_plain_on_a_misaligned_view(card, channels_last):
    N, C, H, W = 4, 32, 16, 12
    bn = _bn(C, device=card)
    flat = (2 * torch.randn(N * C * H * W + 1, device=card)).to(BF16)[1:]
    shape = (N, H, W, C) if channels_last else (N, C, H, W)
    y = flat.view(shape)
    y = y.permute(0, 3, 1, 2) if channels_last else y
    r = _map((N, C, H, W), 3, card, channels_last)
    assert y.data_ptr() % 16 != 0 and be.dense(y, r)[1] is y  # no copy: the kernel reads it
    with torch.inference_mode():
        n = be.bn_epilogue.launches
        got = batch_norm_act(y, bn, BF16, relu=True, residual=r)
        assert be.bn_epilogue.launches == n + 1
        want = be.bn_epilogue_plain(y, *_vectors(bn), BF16, r, 0, True)
    assert _same_up_to_zero_sign(got, want)


@cuda
@pytest.mark.parametrize("case", ODD_LAYOUTS)
@pytest.mark.parametrize("upsample", [0, 1])
def test_kernel_takes_views_and_mixed_layouts(card, case, upsample):
    bn = _bn(32, device=card)
    y, r = _odd_layout(case, _map((4, 32, 16 >> upsample, 12 >> upsample), 1, card),
                       _map((4, 32, 16, 12), 2, card))
    with torch.inference_mode():
        n, plain = be.bn_epilogue.launches, be.bn_epilogue.plain
        got = batch_norm_act(y, bn, BF16, relu=True, residual=r, upsample=upsample)
        assert (be.bn_epilogue.launches, be.bn_epilogue.plain) == (n + 1, plain)
        want = be.bn_epilogue_plain(y, *_vectors(bn), BF16, r, upsample, True)
    assert _same_up_to_zero_sign(got, want)


@cuda
def test_kernel_refuses_what_it_cannot_compute(card):
    bn = _bn(8, device=card)
    with torch.inference_mode():
        with pytest.raises(TypeError, match="bf16"):
            be.bn_epilogue(torch.randn(1, 8, 4, 4, device=card), *_vectors(bn))
        with pytest.raises(ValueError, match="at most 4096 channels"):
            batch_norm_act(_map((1, 4104, 2, 2), 0, card), _bn(4104, device=card), BF16)
        with pytest.raises(ValueError, match="on the map's device"):
            batch_norm_act(_map((1, 8, 4, 4), 0, card), _bn(8), BF16)


def _forced_plain(monkeypatch):
    """The routed calls compute the plain form in place of the kernel."""
    def plain(y, mean, mul, bias, residual, upsample, relu, lay):
        return be.bn_epilogue_plain(y, mean, mul, bias, BF16, residual, upsample, relu)
    monkeypatch.setattr(be, "_launch", plain)


@cuda
def test_hrnet_w32_forward_matches_plain(card, monkeypatch):
    from multi_camera_3d_pose_estimation_tpu_torch.models.registry import init_hrnet_

    model = HRNet(17, HRNET_W32, BF16, card)
    _randomize_bn_(init_hrnet_(model, torch.Generator().manual_seed(0)), seed=1)
    x = torch.randn(16, 3, 256, 192, generator=torch.Generator().manual_seed(2)).to(card)
    with torch.inference_mode():
        launches, plain = be.bn_epilogue.launches, be.bn_epilogue.plain
        got = model(x)
        assert be.bn_epilogue.launches - launches == 279
        assert be.bn_epilogue.plain == plain
        _forced_plain(monkeypatch)
        want = model(x)
    assert torch.equal(got, want)


@cuda
def test_swin_b_head_matches_plain(card, monkeypatch):
    from multi_camera_3d_pose_estimation_tpu_torch.models.registry import init_swin_
    from multi_camera_3d_pose_estimation_tpu_torch.models.swin import SWIN_B, SwinPose

    model = SwinPose(17, SWIN_B, BF16, card)
    _randomize_bn_(init_swin_(model, torch.Generator().manual_seed(0)), seed=1)
    x = torch.randn(8, 256, 192, 3, generator=torch.Generator().manual_seed(2)).to(card)
    with torch.inference_mode():
        launches, plain = be.bn_epilogue.launches, be.bn_epilogue.plain
        got = model(x)
        assert be.bn_epilogue.launches - launches == len(SWIN_B["deconv"])
        assert be.bn_epilogue.plain == plain
        _forced_plain(monkeypatch)
        want = model(x)
    assert torch.equal(got, want)
