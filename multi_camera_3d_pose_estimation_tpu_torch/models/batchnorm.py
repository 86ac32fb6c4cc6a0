"""The BatchNorm of every model of the port, in train and in eval mode.

flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` in a bf16 module, which
every JAX model of the package uses:

- eval mode (flax ``use_running_average=True``): in f32 (f64 for f64
  activations), minus the running
  mean, times rsqrt(running var + eps)·γ, plus β, cast back to the compute
  dtype;
- train mode (``use_running_average=False``): the same with the statistics
  of the batch, taken in f32 over (N, H, W) as E[x] and E[x²] − E[x]²
  clamped at 0 (flax ``_compute_stats`` with ``use_fast_variance``); the
  running statistics then move to ``0.9·running + 0.1·batch``, the
  variance uncorrected.  ``F.batch_norm`` differs in both: it computes the
  variance in two passes and keeps the Bessel-corrected one.

A `BatchNorm` starts in eval mode, as the flax modules default to
``train=False``: a model takes batch statistics only after ``model.train()``.

`batch_norm_act` adds the rest of a ConvBN's epilogue (a nearest upsample,
a residual sum, the ReLU).  Where `runs_kernels` holds it is
`ops.bn_epilogue.bn_epilogue`: on the card one launch of the epilogue
kernel, with the same bits; train mode, calibration, a data-parallel step,
autograd, f32 and f64 take the plain form.

`runs_kernels` is the one rule that picks every kernel of the port's
models: the epilogue here, HRNet's stage-1 Bottleneck chain and the whole
SwinBlock (`models.hrnet`, `models.swin`).

In a data-parallel train step (`synced_batch_norm`) the batch is the global
one: the JAX package's step is a global-view program that XLA shards, so
its batch means are over every device's rows (flax's ``axis_name`` matters
only under ``pmap``).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn

from ..ops import bn_epilogue as _bne

__all__ = ["BatchNorm", "batch_norm", "batch_norm_act", "calibrating_batch_norm",
           "synced_batch_norm", "runs_kernels", "cached_by_tensors", "MOMENTUM"]

MOMENTUM = 0.9  # flax's: running = MOMENTUM·running + (1 − MOMENTUM)·batch

_CALIBRATING = False
_SYNC = None  # (reduce, share) within `synced_batch_norm`


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d``'s parameters and buffers (so state_dicts and the
    flax map are unchanged), built in eval mode; applied by `batch_norm`."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps)
        self.eval()


@contextlib.contextmanager
def calibrating_batch_norm():
    """Within it, every `batch_norm` call first sets its BatchNorm's
    statistics from its input: mean 0 and, for every channel, the mean
    square of the input over all channels (the scale calibration of random
    weights, `models.registry`)."""
    global _CALIBRATING
    _CALIBRATING = True
    try:
        yield
    finally:
        _CALIBRATING = False


@contextlib.contextmanager
def synced_batch_norm(reduce, share: float):
    """Within it, train-mode `batch_norm` takes the statistics of a
    data-parallel step's global batch: each call weights its per-channel
    E[x] and E[x²] by ``share`` (this rank's share of the global batch),
    packs them into one tensor and ``reduce`` (an all-reduce sum over the
    ranks whose backward sums the gradient over the ranks too,
    `parallel.mesh.all_reduce_sum`) returns the global means on every rank;
    the running statistics then move the same on every rank."""
    global _SYNC
    _SYNC = (reduce, share)
    try:
        yield
    finally:
        _SYNC = None


def batch_norm(y: torch.Tensor, bn: nn.BatchNorm2d, dtype: torch.dtype) -> torch.Tensor:
    """flax's BatchNorm over NCHW ``y``, cast to ``dtype``: the running
    statistics in eval mode, the batch's (and the running update, without
    autograd) when ``bn.training``, over the global batch inside
    `synced_batch_norm`.  Inside `calibrating_batch_norm`, it first takes
    its statistics from this batch.  `batch_norm_act` without its
    epilogue's extras."""
    return batch_norm_act(y, bn, dtype)


def batch_norm_act(y: torch.Tensor, bn: nn.BatchNorm2d, dtype: torch.dtype, *,
                   relu: bool = False, residual: torch.Tensor | None = None,
                   upsample: int = 0) -> torch.Tensor:
    """`batch_norm`, then the rest of a ConvBN's epilogue in ``dtype``: the
    result upsampled by ``2**upsample`` (nearest, `F.interpolate`),
    ``residual +`` it (of the upsampled shape), and the ReLU
    (`ops.bn_epilogue.bn_epilogue_plain`).

    Where the call is the epilogue kernel's function (`runs_kernels` of
    ``bn``, ``y`` and ``residual``, and f32 statistics) it is
    `ops.bn_epilogue.bn_epilogue` with the BatchNorm's cached vectors: on
    the card one launch, in whatever layout the maps come (it raises
    rather than fall back), bit for bit the plain form.  Every other call
    takes the plain form; ``bn_epilogue.plain`` counts the eval-mode bf16
    ones on the card.
    """
    vectors = _eval_vectors(bn) if runs_kernels(bn, dtype, y, residual) else None
    if vectors is not None:
        return _bne.bn_epilogue(y, *vectors, residual=residual, upsample=upsample, relu=relu)
    if y.is_cuda and not bn.training and y.dtype == dtype == torch.bfloat16:
        _bne.bn_epilogue.plain += 1
    if _CALIBRATING:
        bn.running_mean.zero_()
        bn.running_var.fill_(y.float().square().mean().item())
    yf = y.to(torch.promote_types(y.dtype, torch.float32))  # f32, or f64 for f64 inputs
    if bn.training:
        mean, mean_sq = yf.mean((0, 2, 3)), yf.square().mean((0, 2, 3))
        if _SYNC is not None:
            reduce, share = _SYNC
            mean, mean_sq = reduce(torch.stack([mean, mean_sq]) * share).unbind(0)
        var = torch.clamp(mean_sq - mean.square(), min=0.0)
        with torch.no_grad():
            bn.running_mean.copy_(MOMENTUM * bn.running_mean + (1 - MOMENTUM) * mean)
            bn.running_var.copy_(MOMENTUM * bn.running_var + (1 - MOMENTUM) * var)
    else:
        mean, var = bn.running_mean, bn.running_var
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return _bne.bn_epilogue_plain(yf, mean, mul, bn.bias, dtype, residual, upsample, relu)


def runs_kernels(module: nn.Module, dtype: torch.dtype, x: torch.Tensor,
                 residual: torch.Tensor | None = None) -> bool:
    """Whether a call of ``module`` on ``x`` (and ``residual``) is the
    kernels' function, the rule that picks every kernel of the port's
    models: eval mode, outside `calibrating_batch_norm` and
    `synced_batch_norm`; the compute ``dtype``, ``x`` and ``residual``
    bf16; no input or parameter of ``module`` that autograd follows.
    Where it holds, the model calls the kernel's op, which launches the
    kernel for a CUDA tensor and runs its plain form for a CPU one; every
    other call takes the plain model path.  Cheap checks first: a W32
    forward makes 280 of these calls."""
    if (module.training or _CALIBRATING or _SYNC is not None or dtype != torch.bfloat16
            or x.dtype != torch.bfloat16
            or (residual is not None and residual.dtype != torch.bfloat16)):
        return False
    if not torch.is_grad_enabled():
        return True
    return not (x.requires_grad or (residual is not None and residual.requires_grad)
                or any(p.requires_grad for p in module.parameters()))


def _eval_vectors(bn: nn.BatchNorm2d):
    """(mean, mul, bias) of an eval-mode BatchNorm for the kernel, None where
    its statistics are not all f32; computed with the plain form's ops
    (``rsqrt(var + eps) * γ``), cached by `cached_by_tensors`."""
    params = (bn._buffers["running_mean"], bn._buffers["running_var"],
              bn._parameters["weight"], bn._parameters["bias"])
    if any(t.dtype != torch.float32 for t in params):
        return None
    return cached_by_tensors(bn, "_epilogue_vectors", params, lambda: _vectors(bn, params),
                             extra=(bn.eps,))


def cached_by_tensors(owner: nn.Module, name: str, tensors, make, extra=()):
    """``make()``, cached on ``owner`` under ``name`` and made again only
    after one of ``tensors`` was replaced (its storage moved: moved,
    reloaded) or written in place (its version counter moved), or ``extra``
    changed.  Inference tensors keep no version counter: where one of
    ``tensors`` is one, ``make()`` runs at every call.  The kernels' folded
    weights and BatchNorm vectors are kept this way."""
    try:
        key = (*extra, *((t.data_ptr(), t._version) for t in tensors))
    except RuntimeError:  # an inference tensor's _version
        return make()
    cached = owner.__dict__.get(name)
    if cached is None or cached[0] != key:
        cached = (key, make())
        owner.__dict__[name] = cached
    return cached[1]


def _vectors(bn, params):
    """(mean, rsqrt(var + eps)·γ, β), contiguous, outside autograd."""
    mean, var, weight, bias = params
    with torch.no_grad():
        mul = torch.rsqrt(var + bn.eps) * weight
    return mean.contiguous(), mul.contiguous(), bias.detach().contiguous()
