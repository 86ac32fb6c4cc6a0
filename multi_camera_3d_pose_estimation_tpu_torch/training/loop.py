"""Train steps for the 2D models, and their state in the JAX package's files.

Counterpart of the JAX package's ``training/loop.py``.  One factory covers
the three families: the loss closure receives (the model's outputs, the
batch) and returns a scalar.  A step runs the model in train mode
(BatchNorm on batch statistics, its running statistics moving as a side
effect, `models.batchnorm`), takes the gradients with autograd and applies
the optimizer to the model's parameters in place.

The optimizer is optax's chain, in its order and arithmetic:
``clip_by_global_norm(clip)`` → ``scale_by_adam(b1, b2, eps)`` →
``add_decayed_weights(weight_decay)`` → ``scale(−lr(count))``, where a
schedule's first update uses lr(0) (`ClipAdamW`, the JAX package's
default; `adam` its no-clip, no-decay choice).  The clip scales by min(1, clip/‖g‖):
optax's ``where(‖g‖ < clip, g, g/‖g‖·clip)`` up to the rounding of one
product.

`TrainState.save` / `TrainState.load` write and read the JAX package's
``TrainState`` file: ``step``, then ``l{i}``, the i-th leaf of
``jax.tree.flatten((params, batch_stats, opt_state))``.  The leaves' flax
paths come from the model's own ``state_dict`` (`models.convert.flax_leaves`),
so a run started on either side resumes on the other.

With a mesh the step is data-parallel with the JAX package's global-batch
semantics (its step is a global-view program that XLA shards): each rank
runs its rows of the batch, BatchNorm takes the global batch's statistics,
and the loss is the user's loss over the global batch, so the step equals
the one-device step on that batch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..models.batchnorm import synced_batch_norm
from ..models.convert import flax_leaves
from ..models.detector import CenterNetDetector
from ..models.hrnet import HRNet
from ..models.registry import MODEL_REGISTRY, build_model, resolve_model_name
from ..models.rtmdet import RTMDet
from ..models.rtmpose import RTMPose
from ..models.swin import SwinPose
from ..models.yolox import YOLOX
from ..parallel.mesh import (all_reduce_sum, all_reduce_sum_flat, broadcast_from_first,
                             check_mesh, gather_rows, is_first_rank, local_rows, mesh_barrier)

__all__ = ["TrainState", "make_train_step", "ClipAdamW", "AdamState", "adam",
           "warmup_cosine_decay_schedule", "model_family", "apply_model", "build_train_model"]

Schedule = Callable[[int], float]

_FAMILY_OF = ((SwinPose, "swin"), (HRNet, "hrnet"), (RTMPose, "rtmpose"),
              (CenterNetDetector, "centernet"), (RTMDet, "rtmdet"), (YOLOX, "yolox"))


def model_family(model: torch.nn.Module) -> str:
    """The `models.convert` family name of one of the port's models."""
    for cls, family in _FAMILY_OF:
        if isinstance(model, cls):
            return family
    raise TypeError(f"not a model of the port: {type(model).__name__}")


def apply_model(model: torch.nn.Module, images: torch.Tensor):
    """The model on (B, H, W, 3) images: `SwinPose` takes them NHWC, the
    others as the NCHW view of the same memory (channels_last)."""
    return model(images if isinstance(model, SwinPose) else images.permute(0, 3, 1, 2))


def build_train_model(model_name: str, dtype=torch.float32, seed: int = 0, device="cuda"):
    """A registry model set up for training: HRNet, Swin or RTMPose in
    ``dtype``, random weights from ``torch.Generator`` seed ``seed``.  Train
    mode and autograd take every model's plain path (Swin's plain attention,
    as the JAX package trains it: `models.batchnorm.runs_kernels`).  Returns
    (model, spec)."""
    spec = MODEL_REGISTRY[resolve_model_name(model_name)]
    model = build_model(spec["family"], spec["cfg"], device, seed=seed,
                        input_size=spec["input_size"], dtype=dtype)
    return model, spec


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    """optax's ``warmup_cosine_decay_schedule`` as a function of the update
    count: linear from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then cosine down to ``end_value`` at ``decay_steps``
    (warm-up included)."""
    span = decay_steps - warmup_steps
    if span <= 0:
        raise ValueError(f"decay_steps ({decay_steps}) must exceed warmup_steps ({warmup_steps})")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(float(count - warmup_steps), float(span))
        cosine = 0.5 * (1 + math.cos(math.pi * c / span))
        return peak_value * ((1 - alpha) * cosine ** exponent + alpha)

    return schedule


@dataclass
class AdamState:
    """Adam's moments, one per parameter in ``model.parameters()`` order,
    and the update count (optax keeps it twice with a schedule, equal)."""

    count: int
    mu: list
    nu: list


class ClipAdamW:
    """clip_by_global_norm → scale_by_adam (optax's b1, b2, eps) →
    add_decayed_weights → scale(−lr), in optax's order.  ``learning_rate``:
    a float or a schedule of the count; ``grad_clip`` or ``weight_decay``
    None leaves that step out."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, learning_rate: float | Schedule, weight_decay: float | None = 1e-4,
                 grad_clip: float | None = 1.0):
        self.learning_rate = learning_rate
        self.weight_decay, self.grad_clip = weight_decay, grad_clip

    @property
    def has_schedule(self) -> bool:
        return callable(self.learning_rate)

    def init(self, params: list) -> AdamState:
        return AdamState(0, [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update(self, grads: list, state: AdamState, params: list) -> AdamState:
        """Apply one update to ``params`` in place; returns the new state."""
        b1, b2 = self.B1, self.B2
        grads = list(grads)
        if self.grad_clip is not None:
            g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            factor = torch.where(g_norm < self.grad_clip, torch.ones_like(g_norm),
                                 self.grad_clip / g_norm)
            grads = torch._foreach_mul(grads, factor)
        mu = torch._foreach_mul(state.mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
        nu = torch._foreach_mul(state.nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
        count = state.count + 1
        denom = torch._foreach_div(nu, 1 - b2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.EPS)
        upd = torch._foreach_div(mu, 1 - b1 ** count)
        torch._foreach_div_(upd, denom)
        if self.weight_decay is not None:
            torch._foreach_add_(upd, torch._foreach_mul(params, self.weight_decay))
        lr = self.learning_rate(state.count) if self.has_schedule else self.learning_rate
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(params, upd)
        return AdamState(count, mu, nu)


def adam(learning_rate: float | Schedule) -> ClipAdamW:
    """``optax.adam(learning_rate)`` (no clip, no weight decay)."""
    return ClipAdamW(learning_rate, None, None)


@dataclass
class TrainState:
    """A model under training: the model (its parameters and BatchNorm
    statistics), its `models.convert` family, the optimizer and its state,
    the number of steps taken, and the mesh of a data-parallel step (None
    on one device)."""

    model: torch.nn.Module
    family: str
    tx: ClipAdamW
    opt_state: AdamState
    step: int
    mesh: object = None

    def _layout(self):
        """(params, batch_stats) leaves in flax order: (state_dict key, axis
        order) each; and the parameters' positions in ``model.parameters()``."""
        leaves = flax_leaves(self.model, self.family)
        params = [(key, order) for path, key, order in leaves if path[0] == "params"]
        stats = [(key, order) for path, key, order in leaves if path[0] == "batch_stats"]
        index = {name: i for i, (name, _) in enumerate(self.model.named_parameters())}
        return params, stats, index

    def save(self, path: str) -> None:
        """Write the JAX package's TrainState ``.npz``; on a mesh every rank
        calls it, the first writes and the others wait for it."""
        if self.mesh is None or is_first_rank(self.mesh):
            self._write(path)
        if self.mesh is not None:
            mesh_barrier(self.mesh)

    def _write(self, path: str) -> None:
        params, stats, index = self._layout()
        sd = self.model.state_dict()

        def flax(t, order):
            t = t.detach().cpu()
            return (t if order is None else t.permute(order)).contiguous().numpy()

        leaves = [flax(sd[k], o) for k, o in params + stats]
        count = np.asarray(self.opt_state.count, np.int32)
        leaves.append(count)
        for moments in (self.opt_state.mu, self.opt_state.nu):
            leaves += [flax(moments[index[k]], o) for k, o in params]
        if self.tx.has_schedule:
            leaves.append(count)
        np.savez(path, step=self.step, **{f"l{i}": v for i, v in enumerate(leaves)})

    @classmethod
    def load(cls, path: str, template: "TrainState") -> "TrainState":
        """Read a TrainState ``.npz`` (the JAX package's or `save`'s) into
        ``template``'s model, in place; returns the loaded state.  A leaf
        count or shape that differs from the template's raises.  On a mesh
        every rank calls it: the first reads the file and the others take
        its values."""
        mesh = template.mesh
        if mesh is None:
            return cls._read(path, template)
        state = cls._read(path, template) if is_first_rank(mesh) else template
        model = template.model
        head = torch.tensor([state.opt_state.count, state.step],
                            device=next(model.parameters()).device)
        broadcast_from_first([*model.state_dict().values(), *state.opt_state.mu,
                              *state.opt_state.nu, head], mesh)
        return cls(model, template.family, template.tx,
                   AdamState(int(head[0]), state.opt_state.mu, state.opt_state.nu),
                   int(head[1]), mesh)

    @classmethod
    def _read(cls, path: str, template: "TrainState") -> "TrainState":
        params, stats, index = template._layout()
        n_opt = 1 + 2 * len(params) + int(template.tx.has_schedule)
        with np.load(path, allow_pickle=False) as f:
            flat = {k: f[k] for k in f.files}
        n = len(params) + len(stats) + n_opt
        if set(flat) != {"step"} | {f"l{i}" for i in range(n)}:
            raise ValueError(f"train state {path}: {len(flat) - 1} leaves, the model and "
                             f"optimizer have {n}")
        model = template.model
        sd = model.state_dict()
        named = dict(model.named_parameters())
        leaf = iter(range(n))

        def port(key, order, like):
            i = next(leaf)
            arr = torch.from_numpy(np.asarray(flat[f"l{i}"]))
            if order is not None:
                arr = arr.permute(*np.argsort(order).tolist())
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(f"train state {path}: l{i} ({key}) has shape "
                                 f"{tuple(arr.shape)}, the model {tuple(like.shape)}")
            return arr.to(like.device, like.dtype)

        with torch.no_grad():
            for key, order in params + stats:
                sd[key].copy_(port(key, order, sd[key]))
            count = int(flat[f"l{next(leaf)}"])
            mu, nu = list(template.opt_state.mu), list(template.opt_state.nu)
            for moments in (mu, nu):
                for key, order in params:
                    moments[index[key]] = port(key, order, named[key]).clone()
        return cls(model, template.family, template.tx, AdamState(count, mu, nu),
                   int(flat["step"]), template.mesh)


def _gather_outputs(outputs, mesh):
    """The model's outputs (a tensor, or a tuple or dict of them) gathered
    over the ranks, differentiably (`parallel.mesh.gather_rows`)."""
    if isinstance(outputs, torch.Tensor):
        return gather_rows(outputs, mesh)
    if isinstance(outputs, dict):
        return {k: _gather_outputs(v, mesh) for k, v in outputs.items()}
    return type(outputs)(_gather_outputs(v, mesh) for v in outputs)


def _global_loss(model: torch.nn.Module, loss_fn: Callable, batch: dict, mesh):
    """``loss_fn`` over the global batch, this rank running its rows of the
    images: BatchNorm takes the global batch's statistics and the outputs
    are gathered, differentiably, so every rank computes the one-device
    loss (the user's loss normalises over the global batch, e.g. by the
    sum of all visibility weights)."""
    images = local_rows(batch["images"], mesh)
    share = images.shape[0] / batch["images"].shape[0]
    with synced_batch_norm(lambda x: all_reduce_sum(x, mesh), share):
        outputs = apply_model(model, images)
    return loss_fn(_gather_outputs(outputs, mesh), batch)


def _mean_over_ranks(grads: list, mesh) -> list:
    """The gradients averaged over the ranks, one all-reduce per dtype, each
    in its own layout (the clip's norms sum in memory order).

    Every rank differentiated the same global loss, and the backward of the
    outputs' gather and of the statistics' all-reduce each sum over the
    ranks: a rank's gradient is (mesh size) x the share of dL/dθ that its
    rows carry.  Their average is exactly the one-device dL/dθ.  A sum
    would be (mesh size) x too large, and plain DDP (the average of each
    rank's gradient of its own rows' loss) differentiates another loss
    wherever the loss's weights differ between the ranks.
    """
    out = all_reduce_sum_flat(grads, mesh)
    torch._foreach_div_(out, float(mesh.size()))
    return out


def make_train_step(model: torch.nn.Module, loss_fn: Callable, tx: ClipAdamW | None = None,
                    learning_rate: float = 5e-4, grad_clip: float = 1.0, mesh=None):
    """Build ``(init_fn, step_fn)`` for one of the port's models.

    - ``loss_fn(outputs, batch) -> scalar``, ``outputs`` the model's return
      for ``batch["images"]`` (B, H, W, 3) (`apply_model`).
    - ``tx``: the optimizer; None is `ClipAdamW` (``learning_rate``, weight
      decay 1e-4, ``grad_clip``), the JAX package's default.
    - ``init_fn() -> TrainState`` at step 0 with the model's current weights
      (on a mesh, the first rank's, on every rank).
    - ``step_fn(state, batch) -> (state, loss)``: one step; the model's
      parameters and statistics change in place, ``loss`` stays on the
      device (no synchronisation).
    - ``mesh``: a mesh of `parallel.make_mesh` for a data-parallel step.
      Every rank is given the global ``batch`` (its leading axis a multiple
      of the mesh size) and runs its rows of the images; BatchNorm's
      statistics, the loss and the gradients are the global batch's, so the
      step equals the one-device step, and every rank applies the same
      update.
    """
    tx = tx if tx is not None else ClipAdamW(learning_rate, grad_clip=grad_clip)
    family = model_family(model)
    params = list(model.parameters())
    check_mesh(mesh, params[0].device)

    def init_fn() -> TrainState:
        if mesh is not None:
            with torch.no_grad():
                broadcast_from_first(list(model.state_dict().values()), mesh)
        return TrainState(model, family, tx, tx.init(params), 0, mesh)

    def step_fn(state: TrainState, batch: dict):
        model.train()
        with torch.enable_grad():
            if mesh is None:
                loss = loss_fn(apply_model(model, batch["images"]), batch)
            else:
                loss = _global_loss(model, loss_fn, batch, mesh)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        if mesh is not None:
            grads = _mean_over_ranks(grads, mesh)
        opt_state = tx.update(grads, state.opt_state, params)
        return TrainState(model, family, tx, opt_state, state.step + 1, mesh), loss.detach()

    return init_fn, step_fn
