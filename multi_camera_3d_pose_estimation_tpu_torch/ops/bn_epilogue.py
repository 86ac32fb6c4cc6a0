"""The eval-mode BatchNorm epilogue of a conv, as one CUDA kernel.

A ConvBN's epilogue in the compute dtype bf16: flax's eval-mode BatchNorm in
f32 (``(f32(y) - mean) * mul + bias`` with ``mul = rsqrt(var + eps) * γ``),
the cast back to bf16, then optionally a residual added in bf16 (the
BasicBlock's shortcut, or the running sum of a FuseLayer row, with the conv
output first upsampled by nearest neighbour at the factor ``2**upsample``),
then optionally the ReLU.  `bn_epilogue_plain` is that chain in plain
PyTorch, one pass over the map per step: the form every model of the port
takes in train mode, under `calibrating_batch_norm`, under autograd and on
the CPU.

The kernel (``csrc/bn_epilogue.cu``) makes one pass: it reads the conv's
bf16 output once (in the upsample mode it walks the high-resolution output
and reads the low-resolution value), reads the residual once and writes
bf16 once, with the same f32 roundings and casts, so its output equals the
plain form's bit for bit (the ReLU may give +0 where the plain form gives
-0).  It runs in the two dense layouts, channels-last and NCHW-contiguous,
with ``y``, the residual and the output in the same one (`dense` copies a
view or a mixed pair into one first).

`bn_epilogue` launches the kernel for a CUDA tensor (or raises) and runs
the plain form for a CPU tensor: `models.batchnorm.batch_norm_act` calls
it for every eval-mode bf16 BatchNorm outside calibration, a data-parallel
step and autograd.  ``bn_epilogue.launches`` counts the kernel's launches;
``bn_epilogue.plain`` counts the eval-mode bf16 BatchNorm calls on a CUDA
map that `batch_norm_act` left to the plain form (calibration, a
data-parallel step, autograd, statistics not in f32): 0 on every
inference path.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from .. import _native

__all__ = ["MAX_CHANNELS", "bn_epilogue", "bn_epilogue_plain", "dense"]

MAX_CHANNELS = 4096  # the kernel's per-channel vectors fill at most 48 KB of shared memory

_fn = None  # the launcher, its ctypes signature bound once


def bn_epilogue_plain(y, mean, mul, bias, dtype, residual=None, upsample: int = 0,
                      relu: bool = False):
    """The epilogue in plain PyTorch: ``y`` (N, C, H, W) in f32 (f64 for an
    f64 ``y``) minus ``mean``, times ``mul``, plus ``bias`` (each (C,)), cast
    to ``dtype``; upsampled by ``2**upsample`` (nearest); ``residual +``
    that; ReLU.  Differentiable."""
    yf = y.to(torch.promote_types(y.dtype, torch.float32))
    out = ((yf - mean[:, None, None]) * mul[:, None, None] + bias[:, None, None]).to(dtype)
    if upsample:
        out = F.interpolate(out, scale_factor=2 ** upsample, mode="nearest")
    if residual is not None:
        out = residual + out
    return torch.relu(out) if relu else out


def dense(y: torch.Tensor, residual=None):
    """(layout, y, residual) for the kernel: ``"channels_last"`` or
    ``"nchw"``, the dense layout of the residual where there is one, else of
    ``y`` (channels-last where it has neither), with ``y`` and the residual
    copied into it where they are not in it (a view, a slice, the other
    layout)."""
    ref = y if residual is None else residual
    if ref.is_contiguous(memory_format=torch.channels_last) or not ref.is_contiguous():
        name, fmt = "channels_last", torch.channels_last
    else:
        name, fmt = "nchw", torch.contiguous_format
    return (name, y.contiguous(memory_format=fmt),
            None if residual is None else residual.contiguous(memory_format=fmt))


def _launcher():
    global _fn
    if _fn is None:
        fn = _native.library("bn_epilogue").mc3d_bn_epilogue
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _launch(y, mean, mul, bias, residual, upsample: int, relu: bool, lay: str):
    """One launch on checked inputs: ``lay`` is `dense`'s layout of ``y``
    and the residual; ``mean``, ``mul``, ``bias`` contiguous f32 on ``y``'s
    device."""
    N, C, H, W = y.shape
    Ho, Wo = H << upsample, W << upsample
    cl = lay == "channels_last"
    fmt = torch.channels_last if cl else torch.contiguous_format
    out = torch.empty((N, C, Ho, Wo), dtype=torch.bfloat16, device=y.device, memory_format=fmt)
    r_ptr = 0 if residual is None else residual.data_ptr()
    vec = (C % 8 == 0 if cl else upsample == 0 and (Ho * Wo) % 8 == 0) and all(
        p % 16 == 0 for p in (y.data_ptr(), r_ptr, out.data_ptr()))
    dev = y.get_device()
    # The raw stream, without a Stream object or a device switch where the
    # map is on the current device: ~280 launches a W32 forward.
    with contextlib.nullcontext() if dev == torch.cuda.current_device() else \
            torch.cuda.device(dev):
        rc = _launcher()(y.data_ptr(), r_ptr, out.data_ptr(), mean.data_ptr(), mul.data_ptr(),
                         bias.data_ptr(), N, C, Ho, Wo, upsample, int(cl), int(vec),
                         int(relu), torch._C._cuda_getCurrentRawStream(dev))
    _native.check(rc, "mc3d_bn_epilogue")
    bn_epilogue.launches += 1
    return out


def bn_epilogue(y, mean, mul, bias, *, residual=None, upsample: int = 0, relu: bool = False):
    """The epilogue of ``y`` (N, C, H, W): bf16 (N, C, H << upsample,
    W << upsample), as `bn_epilogue_plain` with ``dtype`` bf16; the residual
    of that shape.

    A CUDA tensor launches the kernel: a bf16 ``y`` and residual, f32
    vectors (C,) on its device, C at most `MAX_CHANNELS`, else it raises; a
    map or residual in no dense layout the two share is first copied into
    one (`dense`).  A CPU tensor runs `bn_epilogue_plain`.  Refuses
    autograd (`_native.refuse_autograd`).
    """
    _native.refuse_autograd("BatchNorm epilogue kernel (bn_epilogue)", y, mean, mul, bias,
                            residual)
    if y.dim() != 4 or not 0 <= upsample < 16:
        raise ValueError(f"the BatchNorm epilogue takes y (N, C, H, W) and an upsample "
                         f"exponent in [0, 16), got {tuple(y.shape)} and {upsample}")
    N, C, H, W = y.shape
    if residual is not None and residual.shape != (N, C, H << upsample, W << upsample):
        raise ValueError(f"the BatchNorm epilogue takes a residual of the output's shape "
                         f"{(N, C, H << upsample, W << upsample)}, got {tuple(residual.shape)}")
    if y.device.type == "cpu":
        return bn_epilogue_plain(y, mean, mul, bias, torch.bfloat16, residual, upsample, relu)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    if y.dtype != torch.bfloat16 or (residual is not None and residual.dtype != torch.bfloat16):
        raise TypeError("the BatchNorm epilogue kernel takes a bf16 map and residual")
    if C > MAX_CHANNELS:
        raise ValueError(f"the BatchNorm epilogue kernel takes at most {MAX_CHANNELS} channels, "
                         f"got {C}")
    dev = y.device
    if any(t.shape != (C,) or t.dtype != torch.float32 or t.device != dev
           for t in (mean, mul, bias)) or (residual is not None and residual.device != dev):
        raise ValueError(f"the BatchNorm epilogue kernel takes f32 vectors ({C},) and a "
                         f"residual on the map's device {dev}")
    lay, y, residual = dense(y, residual)
    return _launch(y, mean.contiguous(), mul.contiguous(), bias.contiguous(), residual,
                   upsample, relu, lay)


bn_epilogue.launches = 0
bn_epilogue.plain = 0
