"""HRNet stage-1 Bottleneck with BatchNorm folded, as a CUDA kernel.

Counterpart of the JAX package's ``ops/pallas/bottleneck.py``.  Each
Bottleneck, with inference BatchNorm folded into its convs
(W' = W·scale, b' = β − μ·scale), is

    y1  = bf16(relu(x @ W1 + b1))                 1x1 reduce  (cin -> 64)
    y2  = bf16(relu(im2col3x3(y1) @ W2 + b2))     3x3 SAME, K = 576
    out = bf16(relu((y2 @ W3 + b3) + x))          identity blocks
    out = bf16(relu([y2 | x] @ [W3 | Wd] + (b3 + bd)))   block 0 (downsample)

with bf16 operands, f32 accumulation and the Pallas kernel's bf16 cast
points.  Block 0's expand and downsample are one product over K = 64 + cin
(the kernel sums them in one accumulator), which is the Pallas kernel's
``(y2 @ W3 + b3) + (x @ Wd + bd)`` with the f32 sums in another order.
``csrc/bottleneck.cu`` computes one such block per launch
(`fused_bottleneck_block`, `wgmma` products fed by TMA rings);
`fused_stage1_chain` is that kernel launched four times.
`bottleneck_block_plain` repeats the kernel's arithmetic in plain PyTorch:
the wrapper runs it for a CPU tensor, and only there.

Layout: activations are NHWC, (B, H, W, C) contiguous; an NCHW tensor in
``torch.channels_last`` is that layout without a copy (`make_fused_stage1`).
Weights are kept in the kernel's layout, output channel first:
``w1`` (mid, cin), ``w2`` (mid, 9·mid) with column (3·kh + kw)·mid + c,
``w3`` (cout, mid), ``wd`` (cout, cin); biases f32.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _native

__all__ = [
    "fold_convbn",
    "fold_bottleneck_params",
    "prepare_block",
    "bottleneck_block_plain",
    "fused_bottleneck_block",
    "fused_stage1_chain",
    "stage1_chain_plain",
    "make_fused_stage1",
]

MID = 64  # the kernel's Bottleneck width (HRNet stage 1)
COUT = 256  # the kernel's output width (HRNet stage 1): four 64-channel chunks
MAX_W = 191  # rows of y1 lookahead the kernel's ring holds: (W + 64) // 64 <= 3


def fold_convbn(convbn, eps: float = 1e-5):
    """Fold a ConvBN module's inference BatchNorm into its conv.

    Returns (W (kh, kw, cin, cout) f32, b (cout,) f32) with
    ``conv(x, W) + b == bn(conv(x, W_orig))``.
    """
    conv, bn = convbn.Conv_0, convbn.BatchNorm_0
    W = conv.weight.detach().float().permute(2, 3, 1, 0)
    scale = bn.weight.detach().float() / torch.sqrt(bn.running_var.detach().float() + eps)
    return W * scale, bn.bias.detach().float() - bn.running_mean.detach().float() * scale


def fold_bottleneck_params(block) -> dict:
    """Fold one Bottleneck module's ConvBN_0..2 (+ the downsample ConvBN_3,
    when the block has one) into ``{W1, b1, W2, b2, W3, b3[, Wd, bd]}``."""
    out = {}
    for i, name in enumerate(("1", "2", "3")):
        out[f"W{name}"], out[f"b{name}"] = fold_convbn(getattr(block, f"ConvBN_{i}"))
    if hasattr(block, "ConvBN_3"):
        out["Wd"], out["bd"] = fold_convbn(block.ConvBN_3)
    return out


def prepare_block(folded: dict, dtype: torch.dtype, device) -> dict:
    """Folded weights -> the kernel's layout, weights in ``dtype``."""
    def w(key):
        W = folded[key]  # (kh, kw, cin, cout)
        return W.permute(3, 0, 1, 2).reshape(W.shape[3], -1).to(device, dtype).contiguous()

    def b(key):
        return folded[key].to(device, torch.float32).contiguous()

    out = {"w1": w("W1"), "b1": b("b1"), "w2": w("W2"), "b2": b("b2"),
           "w3": w("W3"), "b3": b("b3")}
    if "Wd" in folded:
        out["wd"], out["bd"] = w("Wd"), b("bd")
    return out


def bottleneck_block_plain(x: torch.Tensor, p: dict) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: x (B, H, W, cin) -> (B, H, W, cout).

    Products of ``x.dtype`` values accumulate in f32; the results are cast
    back to ``x.dtype`` where the kernel casts them.
    """
    dt = x.dtype
    B, H, W, cin = x.shape
    xf = x.reshape(-1, cin).float()
    y1 = torch.relu(xf @ p["w1"].float().t() + p["b1"]).to(dt)
    mid = y1.shape[-1]
    pad = F.pad(y1.view(B, H, W, mid), (0, 0, 1, 1, 1, 1))  # SAME zero pad of y1
    cat = torch.cat([pad[:, kh:kh + H, kw:kw + W] for kh in range(3) for kw in range(3)],
                    dim=-1).reshape(-1, 9 * mid)
    y2 = torch.relu(cat.float() @ p["w2"].float().t() + p["b2"]).to(dt)
    if "wd" in p:  # expand and downsample as one product, as the kernel sums them
        w = torch.cat([p["w3"], p["wd"]], dim=1).float()
        out = torch.cat([y2.float(), xf], dim=-1) @ w.t() + (p["b3"] + p["bd"])
    else:
        out = (y2.float() @ p["w3"].float().t() + p["b3"]) + xf
    return torch.relu(out).to(dt).view(B, H, W, -1)


_LAUNCH_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _launch(x: torch.Tensor, p: dict) -> torch.Tensor:
    B, H, W, cin = x.shape
    mid, cout = p["w1"].shape[0], p["w3"].shape[0]
    has_down = "wd" in p
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the bottleneck kernel takes bf16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the bottleneck kernel takes a contiguous NHWC tensor")
    if mid != MID or cin % 16 or cin > COUT or cout != COUT:
        raise ValueError(f"the bottleneck kernel needs mid == {MID}, cin % 16 == 0, "
                         f"cin <= {COUT} and cout == {COUT}; got mid {mid}, cin {cin}, "
                         f"cout {cout}")
    if W > MAX_W:
        raise ValueError(f"the bottleneck kernel takes W <= {MAX_W}, got {W}")
    if not has_down and cin != cout:
        raise ValueError(f"identity residual needs cin == cout, got {cin} vs {cout}")
    for key, t in p.items():
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"weight {key} must be contiguous and 16-byte aligned on {x.device}")
    if x.data_ptr() % 16:
        raise ValueError("the bottleneck kernel takes a 16-byte aligned x (its TMA loads)")
    lib = _native.library("bottleneck")
    fn = lib.mc3d_bottleneck_block
    fn.argtypes = _LAUNCH_ARGTYPES
    fn.restype = ctypes.c_int
    out = torch.empty((B, H, W, cout), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), out.data_ptr(),
                p["w1"].data_ptr(), p["b1"].data_ptr(), p["w2"].data_ptr(), p["b2"].data_ptr(),
                p["w3"].data_ptr(), p["b3"].data_ptr(),
                p["wd"].data_ptr() if has_down else None,
                p["bd"].data_ptr() if has_down else None,
                B, H, W, cin, cout, int(has_down), stream)
    _native.check(rc, "mc3d_bottleneck_block")
    fused_bottleneck_block.launches += 1
    return out


def fused_bottleneck_block(x: torch.Tensor, p: dict) -> torch.Tensor:
    """One folded Bottleneck, x (B, H, W, cin) -> (B, H, W, cout).

    ``p``: `prepare_block` output.  A CUDA tensor launches the kernel (or
    raises); a CPU tensor runs `bottleneck_block_plain`.  Refuses autograd
    (`_native.refuse_autograd`).
    """
    _native.refuse_autograd("bottleneck kernel (fused_bottleneck_block)", x, *p.values())
    if x.device.type == "cuda":
        return _launch(x, p)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return bottleneck_block_plain(x, p)


fused_bottleneck_block.launches = 0


def _check_chain(blocks):
    if "wd" not in blocks[0] or any("wd" in p for p in blocks[1:]):
        raise ValueError("the chain expects the downsample in block 0 only")


def fused_stage1_chain(x: torch.Tensor, blocks: list[dict]) -> torch.Tensor:
    """Whole stage 1: block 0 (with downsample) then identity blocks,
    x (B, H, W, cin) -> (B, H, W, cout), one kernel launch per block."""
    _check_chain(blocks)
    for p in blocks:
        x = fused_bottleneck_block(x, p)
    return x


def stage1_chain_plain(x: torch.Tensor, blocks: list[dict]) -> torch.Tensor:
    """`fused_stage1_chain` in plain PyTorch on any device."""
    _check_chain(blocks)
    for p in blocks:
        x = bottleneck_block_plain(x, p)
    return x


def make_fused_stage1(model, n_blocks: int = 4):
    """Build ``fn(x) -> x`` running an HRNet's stage 1 through the kernel.

    ``model``: the port's `HRNet`.  BN is folded once, into weights of the
    model's compute dtype on its device.  ``fn`` takes and returns NCHW
    tensors; in ``torch.channels_last`` the kernel reads and writes them
    without a copy.  A block structure other than downsample-then-identity
    runs block by block.
    """
    device = next(model.parameters()).device
    blocks = [prepare_block(fold_bottleneck_params(getattr(model, f"Bottleneck_{i}")),
                            model.dtype, device) for i in range(n_blocks)]
    chain_ok = "wd" in blocks[0] and not any("wd" in p for p in blocks[1:])

    def fn(x):
        nhwc = x.permute(0, 2, 3, 1).contiguous()
        if chain_ok:
            nhwc = fused_stage1_chain(nhwc, blocks)
        else:
            for p in blocks:
                nhwc = fused_bottleneck_block(nhwc, p)
        return nhwc.permute(0, 3, 1, 2)

    fn.blocks = blocks
    return fn
