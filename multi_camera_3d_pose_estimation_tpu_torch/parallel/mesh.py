"""Rank meshes over ``torch.distributed``, and the collectives of the mesh paths.

Counterpart of the JAX package's ``parallel/mesh.py`` in SPMD form: one
process per device (launched by ``torchrun``, or started by
`init_distributed`), each a rank of the default process group.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over ranks 0..n-1 in row-major
order, with JAX's axis names.

The JAX package writes its mesh programs in global view and XLA shards them.
Here every rank is given the same global inputs and returns the same global
outputs: it computes its own block of the leading axis (`local_rows`), and
the collectives are explicit, on local tensors (`gather_rows`,
`all_reduce_sum`).  A leading axis the mesh size does not divide raises, as
``jax.jit`` does with ``in_shardings`` on such an axis.  The collectives run
over each of the mesh's dimension groups in turn, innermost first, so a 2-D
mesh orders rows clips-major, as JAX's ``P(("clips", "data"))`` does.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "make_mesh",
    "make_clip_mesh",
    "init_distributed",
    "data_sharding",
    "replicated",
    "local_rows",
    "gather_rows",
    "all_reduce_sum",
    "all_reduce_sum_flat",
    "mesh_barrier",
    "broadcast_from_first",
    "is_first_rank",
    "check_mesh",
]

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _backend(device) -> str:
    kind = torch.device(device).type
    if kind not in _BACKENDS:
        raise ValueError(f"no process-group backend for device type '{kind}'")
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: a CUDA mesh needs a card "
                           "(pass device='cpu' for a gloo group on the CPU)")
    return _BACKENDS[kind]


def init_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, local_device_ids=None,
                     device="cuda") -> None:
    """Start this process's rank of the default process group.

    Call once per process before building a mesh.  ``coordinator_address``
    ("host:port", rank 0's), ``num_processes`` and ``process_id`` as in
    JAX; with none of them, the group reads ``torchrun``'s environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  The
    backend is NCCL for ``device="cuda"`` and gloo for ``"cpu"``.  On CUDA
    the process's card is ``local_device_ids`` (one id: the port runs one
    process per card), else ``LOCAL_RANK``, else rank modulo the card count.
    """
    backend = _backend(device)
    explicit = (coordinator_address, num_processes, process_id)
    if any(v is not None for v in explicit) and any(v is None for v in explicit):
        raise ValueError("give coordinator_address, num_processes and process_id together "
                         "(or none of them, under torchrun)")
    if coordinator_address is None:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes), rank=int(process_id))
    if backend == "nccl":
        if local_device_ids is not None:
            ids = [int(i) for i in np.atleast_1d(local_device_ids)]
            if len(ids) != 1:
                raise ValueError(f"one card per process, got local_device_ids={ids}")
            index = ids[0]
        elif "LOCAL_RANK" in os.environ:
            index = int(os.environ["LOCAL_RANK"])
        else:
            index = dist.get_rank() % torch.cuda.device_count()
        torch.cuda.set_device(index)


def _world(n_devices: int | None, device) -> int:
    """The ranks of the default group; with none started and ``n_devices``
    None or 1, a one-rank group on a local store (a single card needs no
    launcher)."""
    if dist.is_initialized():
        if _BACKENDS.get(torch.device(device).type) != dist.get_backend():
            raise ValueError(f"the process group runs {dist.get_backend()}, "
                             f"not the backend of device '{device}'")
        return dist.get_world_size()
    if n_devices not in (None, 1):
        return 1
    dist.init_process_group(_backend(device), store=dist.HashStore(), world_size=1, rank=0)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device).index or 0)
    return 1


def make_mesh(n_devices: int | None = None, axis: str = "data", device="cuda"):
    """1-D mesh over ranks 0..``n_devices``-1 (default: every rank).  Every
    rank calls it.  ``device``: the ranks' device type (``"cuda"``: NCCL)."""
    world = _world(n_devices, device)
    n = world if n_devices is None else int(n_devices)
    if world < n:
        raise ValueError(f"need {n} devices, have {world} (start one rank per device with "
                         f"torchrun or init_distributed)")
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(torch.device(device).type, torch.arange(n), mesh_dim_names=(axis,))


def make_clip_mesh(n_outer: int | None = None, n_inner: int | None = None,
                   axes: tuple[str, str] = ("clips", "data"), device="cuda"):
    """2-D mesh: ``clips`` outer (across nodes), ``data`` inner, ranks
    node-major.  Defaults: outer = the number of nodes (the world over
    ``torchrun``'s ``LOCAL_WORLD_SIZE``; one node without it), inner = the
    ranks per node.  Ranks left out of the mesh are warned about, as JAX
    warns about idle chips."""
    world = _world(None, device)
    if n_outer is None:
        n_outer = max(world // int(os.environ.get("LOCAL_WORLD_SIZE", world)), 1)
    if n_inner is None:
        n_inner = world // n_outer
    n = n_outer * n_inner
    if n > world:
        raise ValueError(f"mesh {n_outer}x{n_inner} needs {n} devices, have {world}")
    if n < world:
        warnings.warn(f"make_clip_mesh {n_outer}x{n_inner} uses only {n} of {world} devices; "
                      f"{world - n} chips will sit idle", stacklevel=2)
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(torch.device(device).type, torch.arange(n).reshape(n_outer, n_inner),
                      mesh_dim_names=tuple(axes))


def data_sharding(mesh, ndim: int, axis=None) -> tuple:
    """DTensor placements that shard the leading axis over ``axis`` (default:
    every mesh axis, clips-major on a 2-D mesh) and replicate the rest
    (``ndim``, the array's rank, is JAX's argument and changes nothing)."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    axis = names if axis is None else ((axis,) if isinstance(axis, str) else tuple(axis))
    return tuple(Shard(0) if name in axis else Replicate() for name in names)


def replicated(mesh) -> tuple:
    """DTensor placements that replicate over every mesh axis."""
    from torch.distributed.tensor import Replicate

    return (Replicate(),) * mesh.ndim


def check_mesh(mesh, device) -> None:
    """Raise ``TypeError`` unless ``mesh`` is None or a mesh (a
    ``DeviceMesh``) of ``device``'s type."""
    from torch.distributed.device_mesh import DeviceMesh

    kind = torch.device(device).type
    if mesh is not None and not (isinstance(mesh, DeviceMesh) and mesh.device_type == kind):
        raise TypeError(f"mesh must be a {kind} DeviceMesh of parallel.make_mesh, not {mesh!r}")


def _position(mesh) -> int:
    """This rank's block of the leading axis: its row-major mesh index."""
    ranks = mesh.mesh.flatten().tolist()
    if ranks != list(range(len(ranks))):
        raise ValueError(f"the mesh paths need ranks 0..n-1 in row-major order, got {ranks}")
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    return int(np.ravel_multi_index(tuple(coord), tuple(mesh.shape)))


def local_rows(x, mesh):
    """This rank's contiguous block of the leading axis of ``x`` (a tensor or
    an array), clips-major then data on a 2-D mesh."""
    n, size = x.shape[0], mesh.size()
    if n % size:
        raise ValueError(f"the leading axis has {n} rows, which the mesh's {size} devices do "
                         f"not divide (dimension 0 should be divisible by {size})")
    rows = n // size
    i = _position(mesh)
    return x[i * rows:(i + 1) * rows]


def _dim_groups(mesh):
    """The process groups of this rank's mesh dimensions, innermost first."""
    return [mesh.get_group(d) for d in reversed(range(mesh.ndim))]


def _row_major(x: torch.Tensor):
    """``x`` permuted into its memory order, and the permutation back, where
    its leading axis is outermost in memory (a channels_last map, a
    transposed view); else ``x`` made contiguous.  The collectives keep a
    tensor's layout so, and the ops after them (a convolution's backward, a
    loss's sum) run as on one device, to the bit."""
    order = sorted(range(x.dim()), key=lambda d: (-x.stride(d), d))
    if x.dim() and order[0] == 0 and x.permute(order).is_contiguous():
        return x.permute(order), [order.index(d) for d in range(x.dim())]
    return x.contiguous(), list(range(x.dim()))


def _gather(x: torch.Tensor, mesh) -> torch.Tensor:
    x, back = _row_major(x)
    for group in _dim_groups(mesh):
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        x = torch.cat(parts)
    return x.permute(back)


def _all_reduce(x: torch.Tensor, mesh) -> torch.Tensor:
    x, back = _row_major(x)
    x = x.clone(memory_format=torch.contiguous_format)
    for group in _dim_groups(mesh):
        dist.all_reduce(x, group=group)
    return x.permute(back)


class _GatherRows(torch.autograd.Function):
    """`gather_rows`; backward: the rank's rows of the all-reduced gradient."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _gather(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return local_rows(_all_reduce(grad, ctx.mesh), ctx.mesh), None


class _AllReduceSum(torch.autograd.Function):
    """`all_reduce_sum`; backward: the all-reduced gradient."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_reduce(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.mesh), None


def gather_rows(x_local: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's `local_rows` block concatenated back to the global
    leading axis, on every rank.  Differentiable: the backward sums the
    gradient over the ranks and keeps this rank's rows (a reduce-scatter)."""
    return _GatherRows.apply(x_local, mesh)


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over the mesh's ranks, on every rank (a new tensor).
    Differentiable: the backward sums the gradient over the ranks."""
    return _AllReduceSum.apply(x, mesh)


def all_reduce_sum_flat(tensors: list, mesh) -> list:
    """Each of ``tensors`` summed over the mesh's ranks, through one
    all-reduce per dtype of them all flattened together; returns views of
    the sums with the given tensors' shapes and layouts (not
    differentiable)."""
    out = list(tensors)
    for dtype in dict.fromkeys(t.dtype for t in tensors):  # the same order on every rank
        idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
        views = [_row_major(tensors[i]) for i in idx]
        flat = _all_reduce(torch.cat([v.reshape(-1) for v, _ in views]), mesh)
        for i, (v, back), part in zip(idx, views, torch.split(flat, [v.numel() for v, _ in views])):
            out[i] = part.view(v.shape).permute(back)
    return out


def is_first_rank(mesh) -> bool:
    """Whether this rank is the mesh's first (the one that writes files)."""
    return mesh.get_coordinate() is not None and _position(mesh) == 0


def mesh_barrier(mesh) -> None:
    """Wait until every rank of the mesh has arrived."""
    for group in _dim_groups(mesh):
        dist.barrier(group=group)


def broadcast_from_first(tensors, mesh) -> None:
    """Overwrite ``tensors`` in place, on every rank, with the mesh's first
    rank's values (innermost dimension first, so the first rank's values
    reach every row before they go down the columns)."""
    for group in _dim_groups(mesh):
        src = dist.get_global_rank(group, 0)
        for t in tensors:
            # A collective sends a tensor's storage as it lies: a permuted
            # view goes through a contiguous copy.
            buf = t if t.is_contiguous() else t.contiguous()
            dist.broadcast(buf, src=src, group=group)
            if buf is not t:
                t.copy_(buf)
