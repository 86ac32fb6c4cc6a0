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

In a data-parallel train step (`synced_batch_norm`) the batch is the global
one: the JAX package's step is a global-view program that XLA shards, so
its batch means are over every device's rows (flax's ``axis_name`` matters
only under ``pmap``).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn

__all__ = ["BatchNorm", "batch_norm", "calibrating_batch_norm", "synced_batch_norm",
           "MOMENTUM"]

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
    its statistics from this batch."""
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
    return ((yf - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]).to(dtype)
