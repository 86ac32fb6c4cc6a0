"""Swin window attention core, as a CUDA kernel.

Counterpart of the JAX package's ``ops/pallas/window_attention.py``
(``fused_window_attention`` and ``packed_window_attention``) and of the
attention step inside ``ops/pallas/swin_block.py::fused_swin_block``.  From
the fused qkv projection of each window it computes, per head,

    s   = f32(q · kᵀ) · d^-½ + bias[h] + mask[w mod nW]
    p   = dtype(softmax_f32(s))
    ctx = dtype(f32(p · v))

with qkv (Bw, n, 3C) (q | k | v along the last axis, C = heads·d), bias
(heads, n, n) f32 and an additive (nW, n, n) f32 mask or None; window w
takes mask ``w mod nW`` (the partition order is (B, h-windows, w-windows)).
Returns ctx (Bw, n, C).

`window_attention_rows` is the same attention on the fixed-order stage
layout (``ops/pallas/swin_block.py::fused_swin_block_fixed`` and
``fused_swin_stage_fixed``): qkv (B·P, 3C) holds each crop's tokens in
shift-0 window order, padded to P rows, and window w of crop c = w / nW
reads and writes token k at row ``c·P + rows[(w mod nW)·n + k]``, where
``rows`` (nW·n int32) is the block's `swin_geometry.window_roll_perm`.
The Pallas kernels' full (P, P) table (bias, −100 across wrap regions,
−1e5 across windows) is exactly this per-window attention; each crop's
P − nW·n alignment rows attend only to themselves there, so their ctx is
their own v.  The kernel does the gather and scatter in its own loads and
stores.

``csrc/window_attention.cu`` computes each window on its own: the TPU
kernels' block-diagonal packing of several windows per matrix-unit pass (−1e5 off
the diagonal, ``wb``) is a workaround for the TPU's matrix unit and is not
carried over; ``wb`` is accepted and ignored.  `window_attention_plain`
repeats the kernel's arithmetic in plain PyTorch, and
`window_attention_rows_plain` adds the gather and scatter: the wrappers run
them for a CPU tensor, and only there.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _native
from .swin_geometry import regions_to_mask

__all__ = [
    "window_attention",
    "window_attention_plain",
    "window_attention_rows",
    "window_attention_rows_plain",
    "fused_window_attention",
    "packed_window_attention",
]

HEAD_DIM = 32  # the kernel's head width (Swin-T, -B and -L)
MAX_TOKENS = 64  # windows up to 8x8


def _check_shapes(qkv, bias, mask, heads):
    return _check_tables(*qkv.shape, bias, mask, heads)


def _check_tables(Bw, n, C3, bias, mask, heads):
    C = C3 // 3
    if C3 % 3 or C % heads:
        raise ValueError(f"qkv width {C3} is not 3·heads·d for heads={heads}")
    if tuple(bias.shape) != (heads, n, n):
        raise ValueError(f"bias must be {(heads, n, n)}, got {tuple(bias.shape)}")
    if mask is not None:
        if mask.dim() != 3 or tuple(mask.shape[1:]) != (n, n):
            raise ValueError(f"mask must be (nW, {n}, {n}), got {tuple(mask.shape)}")
        if Bw % mask.shape[0]:
            raise ValueError(f"Bw={Bw} not a multiple of nW={mask.shape[0]}")
    return Bw, n, C


def window_attention_plain(qkv: torch.Tensor, bias: torch.Tensor, mask, heads: int
                           ) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, in ``qkv.dtype``."""
    Bw, n, C = _check_shapes(qkv, bias, mask, heads)
    d = C // heads
    dt = qkv.dtype
    q, k, v = qkv.reshape(Bw, n, 3, heads, d).permute(2, 0, 3, 1, 4).unbind(0)  # (Bw, h, n, d)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (d ** -0.5)
    s = s + bias.float()[None]
    if mask is not None:
        nW = mask.shape[0]
        s = (s.reshape(Bw // nW, nW, heads, n, n) + mask.float()[None, :, None]).reshape(
            Bw, heads, n, n)
    p = torch.softmax(s, dim=-1).to(dt)
    ctx = torch.matmul(p.float(), v.float()).to(dt)  # (Bw, h, n, d)
    return ctx.transpose(1, 2).reshape(Bw, n, C)


def _check_rows(qkv, bias, mask, heads, rows, P):
    """(B, nW, n, C) of a fixed-order qkv (B·P, 3C) and its row table."""
    if qkv.dim() != 2 or rows.dim() != 1:
        raise ValueError(f"qkv must be (B·P, 3C) and rows (nW·n,), got {tuple(qkv.shape)} "
                         f"and {tuple(rows.shape)}")
    M, C3 = qkv.shape
    n = bias.shape[-1]
    nW = rows.numel() // n
    if M % P or rows.numel() % n or rows.numel() > P:
        raise ValueError(f"{M} rows are not crops of P={P} rows holding {rows.numel()} "
                         f"window tokens of n={n}")
    if mask is not None and mask.shape[0] != nW:
        raise ValueError(f"mask has {mask.shape[0]} windows, the row table {nW}")
    _check_tables(M // P * nW, n, C3, bias, mask, heads)
    return M // P, nW, n, C3 // 3


def _gather_index(rows, P, B):
    """(B·nW·n,) long: the fixed-order row of each shifted-window token."""
    base = torch.arange(B, device=rows.device) * P
    return (base[:, None] + rows.long()[None, :]).reshape(-1)


def window_attention_rows_plain(qkv: torch.Tensor, bias: torch.Tensor, mask, heads: int,
                                rows: torch.Tensor, P: int) -> torch.Tensor:
    """The row-mode kernel's arithmetic in plain PyTorch: gather the
    windows, `window_attention_plain`, scatter ctx back; each crop's
    alignment rows (P − nW·n) take their own v."""
    B, nW, n, C = _check_rows(qkv, bias, mask, heads, rows, P)
    idx = _gather_index(rows, P, B)
    ctx = window_attention_plain(qkv[idx].view(B * nW, n, 3 * C), bias, mask, heads)
    out = torch.empty((B * P, C), dtype=qkv.dtype, device=qkv.device)
    out.view(B, P, C)[:, nW * n:] = qkv.view(B, P, 3 * C)[:, nW * n:, 2 * C:]
    out[idx] = ctx.reshape(-1, C)
    return out


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _launch(qkv, bias, mask, heads, rows=None, P=0):
    if rows is None:
        Bw, n, C = _check_shapes(qkv, bias, mask, heads)
        nW = mask.shape[0] if mask is not None else 1
        out_shape = (Bw, n, C)
    else:
        B, nW, n, C = _check_rows(qkv, bias, mask, heads, rows, P)
        Bw = B * nW
        out_shape = (B * P, C)
        if rows.dtype != torch.int32:
            raise TypeError(f"rows must be int32, got {rows.dtype}")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"the window attention kernel takes bf16 qkv, got {qkv.dtype}")
    if C // heads != HEAD_DIM:
        raise ValueError(f"the window attention kernel needs head dim {HEAD_DIM}, "
                         f"got {C // heads}")
    if n > MAX_TOKENS:
        raise ValueError(f"the window attention kernel takes windows up to 8x8, got n={n}")
    for name, t in (("qkv", qkv), ("bias", bias), ("mask", mask), ("rows", rows)):
        if t is None:
            continue
        if t.device != qkv.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned on {qkv.device}")
        if name in ("bias", "mask") and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    fn = _native.library("window_attention").mc3d_window_attention
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    out = torch.empty(out_shape, dtype=qkv.dtype, device=qkv.device)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        rc = fn(qkv.data_ptr(), bias.data_ptr(), ptr(mask), ptr(rows), out.data_ptr(),
                Bw, n, heads, C, nW, P, stream)
    _native.check(rc, "mc3d_window_attention")
    return out


def window_attention(qkv: torch.Tensor, bias: torch.Tensor, mask, heads: int) -> torch.Tensor:
    """Attention context (Bw, n, C) of qkv (Bw, n, 3C).  A CUDA tensor
    launches the kernel (or raises); a CPU tensor runs
    `window_attention_plain`."""
    if qkv.device.type == "cuda":
        out = _launch(qkv, bias, mask, heads)
        window_attention.launches += 1
        return out
    if qkv.device.type != "cpu":
        raise ValueError(f"unsupported device {qkv.device}")
    return window_attention_plain(qkv, bias, mask, heads)


window_attention.launches = 0


def window_attention_rows(qkv: torch.Tensor, bias: torch.Tensor, mask, heads: int,
                          rows: torch.Tensor, P: int) -> torch.Tensor:
    """Attention context (B·P, C) of fixed-order qkv (B·P, 3C), windows
    read through the row table ``rows`` (nW·n int32, a permutation of
    range(nW·n) such as `swin_geometry.window_roll_perm`: rows inside a
    crop of P); mask (nW, n, n) f32 or None.  A CUDA tensor launches the
    kernel in row mode (or raises; a table entry out of range stops the
    kernel with a device-side assert); a CPU tensor runs
    `window_attention_rows_plain`."""
    if qkv.device.type == "cuda":
        out = _launch(qkv, bias, mask, heads, rows, P)
        window_attention_rows.launches += 1
        return out
    if qkv.device.type != "cpu":
        raise ValueError(f"unsupported device {qkv.device}")
    return window_attention_rows_plain(qkv, bias, mask, heads, rows, P)


window_attention_rows.launches = 0


def fused_window_attention(qkv: torch.Tensor, bias: torch.Tensor, mask, heads: int
                           ) -> torch.Tensor:
    """``fused_window_attention(qkv, bias, mask, heads)`` of the JAX package:
    mask (nW, n, n) f32 or None."""
    return window_attention(qkv, bias, mask, heads)


def packed_window_attention(qkv: torch.Tensor, bias: torch.Tensor, regions, heads: int,
                            wb: int | None = None) -> torch.Tensor:
    """``packed_window_attention(qkv, bias, regions, heads, wb)`` of the JAX
    package: ``regions`` (nW, n) integer region ids (host numpy) or None
    become the −100 additive mask here; ``wb`` is ignored (the kernel runs
    one window at a time)."""
    del wb
    mask = None
    if regions is not None:
        mask = torch.as_tensor(regions_to_mask(np.asarray(regions)), device=qkv.device)
    return window_attention(qkv, bias, mask, heads)
