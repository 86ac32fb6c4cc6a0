"""One whole SwinBlock as CUDA kernels: four token products and the window
attention.

Counterpart of the JAX package's ``ops/pallas/swin_block.py::fused_swin_block``
(one Pallas program set per block).  On Hopper a block's six weight
matrices (24·C² bytes in bf16, 25 MB at Swin-B stage 3) do not fit in a
CTA's 227 KB of shared memory, so the block is five launches: three modes
of ``csrc/swin_gemm.cu`` around ``csrc/window_attention.cu``.  On the
window-order tokens xw (B·nW·n, C), with the Pallas kernel's cast points
(``_block_body``):

    qkv = bf16(bf16(LN1(xw)·valid @ Wqkv) + bf16(bqkv))          swin_gemm, LN prologue
    ctx = window attention (rel-pos bias, −100 shift mask)         window_attention
    x2  = xw + bf16(bf16(ctx @ Wproj) + bf16(bproj))               swin_gemm, residual
    h   = bf16(gelu_erf(f32(LN2(x2) @ Wfc1) + bfc1))               swin_gemm, LN prologue
    out = x2 + bf16(bf16(h @ Wfc2) + bf16(bfc2))  [· valid]        swin_gemm, residual

LN: f32 statistics, var = E[x²] − E[x]², eps 1e-5; an LN mode's call
launches a row kernel that normalises each row once into a scratch
operand, then the product (``swin_gemm.launches`` counts the product's
launch, ``swin_gemm.ln_launches`` the row kernel's).
``valid`` is 1 on real tokens and 0 on window padding: pad tokens enter
qkv as exact zeros (mmcv pads the LN1 output), and with
``emit_partitioned`` they leave as exact zeros, so the next block's
`window_roll_perm` gather sees a freshly zero-padded map.  In float32
every cast is the identity.

`swin_gemm` and `window_attention` launch their kernels for a CUDA tensor
(or raise) and run their plain versions for a CPU tensor; `swin_block_plain`
runs the plain versions on any device.  The TPU kernel's VMEM feasibility
gate (``feasible_wb``) and its window packing (``wb``/``wa``) have no
counterpart: ``wb`` and ``wa`` are accepted and ignored.

The fixed-order stage layout (``fused_swin_block_fixed``,
``fused_swin_stage_fixed``) keeps a stage's tokens in shift-0 window order,
(B·P, C) with each crop padded to P rows (`swin_geometry.fixed_partition`),
for every block of the stage.  Its block is the same five launches: the
products take their rows in any order, and the attention reads a shifted
block's windows through its row table (`window_attention_rows`).  Validity
is by original position, the same for every shift; as in the Pallas kernel
(``zero_pad_out=False``) nothing is zeroed on output, so map-padding and
alignment rows carry values from block to block that never reach a real
token (LN1's output is masked by ``valid``).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _native
from .swin_geometry import (device_table, fixed_rows, fixed_valid, padded_dims, shift_mask,
                            valid_mask, window_partition, window_reverse, window_roll_perm)
from .window_attention import (window_attention, window_attention_plain, window_attention_rows,
                               window_attention_rows_plain)

__all__ = [
    "swin_gemm",
    "swin_gemm_plain",
    "fused_swin_block",
    "swin_block_plain",
    "fused_swin_block_fixed",
    "swin_block_fixed_plain",
    "fused_swin_stage_fixed",
    "swin_stage_fixed_plain",
    "prepare_swin_block",
    "block_tables",
    "fixed_tables",
]

MODES = {"qkv": 0, "resid": 1, "gelu": 2}
EPS = 1e-5


def _layer_norm_rows(a: torch.Tensor, ln) -> torch.Tensor:
    """f32 LayerNorm with the Pallas kernel's statistics (no variance clamp)."""
    af = a.float()
    mu = af.mean(-1, keepdim=True)
    var = (af * af).mean(-1, keepdim=True) - mu * mu
    return (af - mu) * torch.rsqrt(var + EPS) * ln[0] + ln[1]


def _row_valid(valid: torch.Tensor, M: int) -> torch.Tensor:
    return valid.repeat(M // valid.numel())[:, None]


def swin_gemm_plain(mode: str, a: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    res=None, ln=None, valid=None) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, in ``a.dtype``.

    ``mode``: "qkv" (LN prologue), "resid" (residual epilogue) or "gelu" (LN
    prologue, f32 bias + erf-GELU epilogue).  ``ln`` = (gamma, beta) f32,
    ``valid`` a (period,) f32 row pattern (row r takes ``valid[r % period]``).
    """
    dt = a.dtype
    af = a.float()
    if ln is not None:
        y = _layer_norm_rows(a, ln)
        if valid is not None:
            y = y * _row_valid(valid, a.shape[0])
        af = y.to(dt).float()
    acc = af @ w.float().t()
    if mode == "qkv":
        return acc.to(dt) + b.to(dt)
    if mode == "resid":
        out = res + (acc.to(dt) + b.to(dt))
        return out * _row_valid(valid, a.shape[0]).to(dt) if valid is not None else out
    if mode == "gelu":
        h = acc + b
        return (0.5 * h * (1.0 + torch.erf(h * 2.0 ** -0.5))).to(dt)
    raise ValueError(f"unknown mode {mode!r}")


_GEMM_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                  + [ctypes.c_float, ctypes.c_void_p])


def _launch_gemm(mode, a, w, b, res, ln, valid):
    M, K = a.shape
    N = w.shape[0]
    if a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"the swin_gemm kernel takes bf16 tokens and weights, got "
                        f"{a.dtype} and {w.dtype}")
    if w.shape[1] != K or N % 8 or K % 32:
        raise ValueError(f"the swin_gemm kernel needs W (N, K) with N % 8 == 0 and K % 32 == 0; "
                         f"got tokens {tuple(a.shape)}, W {tuple(w.shape)}")
    tensors = {"a": a, "w": w, "b": b, "res": res, "valid": valid}
    if ln is not None:
        tensors.update(ln_w=ln[0], ln_b=ln[1])
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != a.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned on {a.device}")
        want = torch.bfloat16 if name in ("a", "w", "res") else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
    if res is not None and tuple(res.shape) != (M, N):
        raise ValueError(f"res must be {(M, N)}, got {tuple(res.shape)}")
    if valid is not None and M % valid.numel():
        raise ValueError(f"{M} rows are not a multiple of the valid period {valid.numel()}")
    fn = _native.library("swin_gemm").mc3d_swin_gemm
    fn.argtypes = _GEMM_ARGTYPES
    fn.restype = ctypes.c_int
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    # LN modes: the kernel's operand bf16(LN(a)·valid), normalised once per row.
    a_ln = torch.empty_like(a) if ln is not None else None

    def ptr(t):
        return t.data_ptr() if t is not None else None

    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(MODES[mode], a.data_ptr(), w.data_ptr(), b.data_ptr(), ptr(res),
                ptr(ln[0]) if ln is not None else None, ptr(ln[1]) if ln is not None else None,
                ptr(valid), ptr(a_ln), out.data_ptr(), M, N, K,
                valid.numel() if valid is not None else 0, EPS, stream)
    _native.check(rc, "mc3d_swin_gemm")
    swin_gemm.launches += 1
    if ln is not None:
        swin_gemm.ln_launches += 1
    return out


def swin_gemm(mode: str, a: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              res=None, ln=None, valid=None) -> torch.Tensor:
    """One token product (M, K) @ W (N, K)ᵀ -> (M, N) with its prologue and
    epilogue (see `swin_gemm_plain`).  A CUDA tensor launches the kernel (or
    raises); a CPU tensor runs `swin_gemm_plain`.  Refuses autograd
    (`_native.refuse_autograd`)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    _native.refuse_autograd("swin_gemm kernel", a, w, b, res, *(ln or ()), valid)
    if a.device.type == "cuda":
        return _launch_gemm(mode, a, w, b, res, ln, valid)
    if a.device.type != "cpu":
        raise ValueError(f"unsupported device {a.device}")
    return swin_gemm_plain(mode, a, w, b, res, ln, valid)


swin_gemm.launches = 0
swin_gemm.ln_launches = 0


def prepare_swin_block(block, dtype: torch.dtype) -> dict:
    """A port `models.swin.SwinBlock`'s weights in the kernels' layout:
    weights (out, in) in ``dtype``, biases and LN affines f32, the gathered
    relative-position bias (heads, n, n) f32."""
    bias = block.attn.relative_bias().detach().contiguous()

    def lin(m):
        return (m.weight.detach().to(dtype).contiguous(), m.bias.detach().float().contiguous())

    def norm(m):
        return (m.weight.detach().float().contiguous(), m.bias.detach().float().contiguous())

    wqkv, bqkv = lin(block.attn.qkv)
    wproj, bproj = lin(block.attn.proj)
    wfc1, bfc1 = lin(block.ffn_fc1)
    wfc2, bfc2 = lin(block.ffn_fc2)
    return {"norm1": norm(block.norm1), "wqkv": wqkv, "bqkv": bqkv, "bias": bias,
            "wproj": wproj, "bproj": bproj, "norm2": norm(block.norm2),
            "wfc1": wfc1, "bfc1": bfc1, "wfc2": wfc2, "bfc2": bfc2}


def block_tables(H: int, W: int, win: int, shift: int, device):
    """(valid (nW·n,) f32 or None when unpadded, shift mask (nW, n, n) f32
    or None when unshifted) of one block's window layout, on ``device``."""
    Hp, Wp = padded_dims(H, W, win)
    valid = None
    if Hp != H or Wp != W:
        valid = device_table(valid_mask, H, W, Hp, Wp, win, shift, device=device,
                             dtype=torch.float32).reshape(-1)
    mask = None
    if shift:
        mask = device_table(shift_mask, Hp, Wp, win, shift, device=device, dtype=torch.float32)
    return valid, mask


def _block(x, p, heads, window, shift, mlp_ratio, pre_partitioned, emit_partitioned,
           gemm, attn):
    if pre_partitioned is not None:
        B, H, W = pre_partitioned
        C = x.shape[-1]
    else:
        B, H, W, C = x.shape
    win, n = window, window * window
    Hp, Wp = padded_dims(H, W, win)
    Bw = B * (Hp // win) * (Wp // win)
    if p["wfc1"].shape != (mlp_ratio * C, C):
        raise ValueError(f"fc1 weight {tuple(p['wfc1'].shape)} is not ({mlp_ratio * C}, {C})")
    if pre_partitioned is not None:
        if tuple(x.shape) != (Bw * n, C):
            raise ValueError(f"pre-partitioned tokens must be {(Bw * n, C)}, "
                             f"got {tuple(x.shape)}")
        xw = x
    else:
        xw = window_partition(x, win, shift).contiguous()
    valid, mask = block_tables(H, W, win, shift, x.device)
    qkv = gemm("qkv", xw, p["wqkv"], p["bqkv"], ln=p["norm1"], valid=valid)
    ctx = attn(qkv.view(Bw, n, 3 * C), p["bias"], mask, heads)
    x2 = gemm("resid", ctx.view(Bw * n, C), p["wproj"], p["bproj"], res=xw)
    hid = gemm("gelu", x2, p["wfc1"], p["bfc1"], ln=p["norm2"])
    out = gemm("resid", hid, p["wfc2"], p["bfc2"], res=x2,
               valid=valid if emit_partitioned else None)
    if emit_partitioned:
        return out
    return window_reverse(out, B, H, W, win, shift)


def fused_swin_block(x: torch.Tensor, p: dict, *, heads: int, window: int, shift: int,
                     mlp_ratio: int, wb: int | None = None, wa: int | None = None,
                     pre_partitioned: tuple[int, int, int] | None = None,
                     emit_partitioned: bool = False) -> torch.Tensor:
    """Whole SwinBlock (LN1 -> window attention -> +x -> LN2 -> MLP -> +).

    x: (B, H, W, C) block input, or, with ``pre_partitioned=(B, H, W)``, the
    (B·nW·n, C) window-order tokens of this block's layout
    (`swin_geometry.window_partition`).  p: `prepare_swin_block`.
    Returns (B, H, W, C), or (B·nW·n, C) with ``emit_partitioned`` (pad
    tokens zeroed).  ``wb``/``wa`` (TPU window packing) are ignored.
    """
    del wb, wa
    return _block(x, p, heads, window, shift, mlp_ratio, pre_partitioned, emit_partitioned,
                  swin_gemm, window_attention)


def swin_block_plain(x: torch.Tensor, p: dict, *, heads: int, window: int, shift: int,
                     mlp_ratio: int, pre_partitioned: tuple[int, int, int] | None = None,
                     emit_partitioned: bool = False) -> torch.Tensor:
    """`fused_swin_block` through the plain versions, on any device."""
    return _block(x, p, heads, window, shift, mlp_ratio, pre_partitioned, emit_partitioned,
                  swin_gemm_plain, window_attention_plain)


def fixed_tables(H: int, W: int, win: int, shift: int, device):
    """(valid (P,) f32, row table (nW·n,) int32, shift mask (nW, n, n) f32
    or None when unshifted) of one fixed-order block, on ``device``."""
    Hp, Wp = padded_dims(H, W, win)
    valid = device_table(fixed_valid, H, W, win, device=device, dtype=torch.float32)
    rows = device_table(window_roll_perm, H, W, win, 0, shift, device=device, dtype=torch.int32)
    mask = None
    if shift:
        mask = device_table(shift_mask, Hp, Wp, win, shift, device=device, dtype=torch.float32)
    return valid, rows, mask


def _block_fixed(x, p, heads, window, shift, mlp_ratio, geom, gemm, attn):
    B, H, W = geom
    C = x.shape[-1]
    P = fixed_rows(H, W, window)
    if tuple(x.shape) != (B * P, C):
        raise ValueError(f"fixed-order tokens must be {(B * P, C)}, got {tuple(x.shape)}")
    if p["wfc1"].shape != (mlp_ratio * C, C):
        raise ValueError(f"fc1 weight {tuple(p['wfc1'].shape)} is not ({mlp_ratio * C}, {C})")
    valid, rows, mask = fixed_tables(H, W, window, shift, x.device)
    qkv = gemm("qkv", x, p["wqkv"], p["bqkv"], ln=p["norm1"], valid=valid)
    ctx = attn(qkv, p["bias"], mask, heads, rows, P)
    x2 = gemm("resid", ctx, p["wproj"], p["bproj"], res=x)
    hid = gemm("gelu", x2, p["wfc1"], p["bfc1"], ln=p["norm2"])
    return gemm("resid", hid, p["wfc2"], p["bfc2"], res=x2)


def fused_swin_block_fixed(x: torch.Tensor, p: dict, *, heads: int, window: int, shift: int,
                           mlp_ratio: int, geom: tuple[int, int, int], cp: int = 1
                           ) -> torch.Tensor:
    """Whole SwinBlock on fixed-order tokens x (B·P, C)
    (`swin_geometry.fixed_partition` of a (B, H, W, C) map, ``geom`` =
    (B, H, W)); returns the same layout, so the blocks of a stage chain
    with no layout op between them.  p: `prepare_swin_block`.  Five
    launches: `swin_gemm` ("qkv" with the period-P valid pattern),
    `window_attention_rows`, "resid", "gelu", "resid" (nothing zeroed).
    ``cp`` (crops per TPU program) is accepted and ignored."""
    del cp
    return _block_fixed(x, p, heads, window, shift, mlp_ratio, geom, swin_gemm,
                        window_attention_rows)


def swin_block_fixed_plain(x: torch.Tensor, p: dict, *, heads: int, window: int, shift: int,
                           mlp_ratio: int, geom: tuple[int, int, int], cp: int = 1
                           ) -> torch.Tensor:
    """`fused_swin_block_fixed` through the plain versions, on any device."""
    del cp
    return _block_fixed(x, p, heads, window, shift, mlp_ratio, geom, swin_gemm_plain,
                        window_attention_rows_plain)


def _stage_fixed(x, plist, heads, window, shifts, mlp_ratio, geom, block):
    if len(shifts) != len(plist):
        raise ValueError("shifts and plist must align")
    for p, shift in zip(plist, shifts):
        x = block(x, p, heads=heads, window=window, shift=shift, mlp_ratio=mlp_ratio, geom=geom)
    return x


def fused_swin_stage_fixed(x: torch.Tensor, plist: list, *, heads: int, window: int,
                           shifts: list, mlp_ratio: int, geom: tuple[int, int, int],
                           cp: int = 1, group: int | None = None) -> torch.Tensor:
    """A whole fixed-order stage: ``len(plist)`` `fused_swin_block_fixed`
    on the same (B·P, C) tensor, ``shifts[j]`` for block j, no layout op
    between blocks.

    ``cp`` and ``group`` (and the JAX package's ``MC3D_SWIN_CP`` and
    ``MC3D_SWIN_GROUP``) are accepted and ignored: with ``feasible_fixed``,
    ``feasible_chain_group`` and ``_lanes`` they size TPU programs against a
    VMEM budget that must hold a (heads, cp·P, cp·P) table and G blocks'
    weights.  The Hopper block builds no table and is five launches that
    take any row count, so it needs no feasibility gate, no crop packing
    and no group size."""
    del cp, group
    return _stage_fixed(x, plist, heads, window, shifts, mlp_ratio, geom, fused_swin_block_fixed)


def swin_stage_fixed_plain(x: torch.Tensor, plist: list, *, heads: int, window: int,
                           shifts: list, mlp_ratio: int, geom: tuple[int, int, int]
                           ) -> torch.Tensor:
    """`fused_swin_stage_fixed` through the plain versions, on any device."""
    return _stage_fixed(x, plist, heads, window, shifts, mlp_ratio, geom, swin_block_fixed_plain)
