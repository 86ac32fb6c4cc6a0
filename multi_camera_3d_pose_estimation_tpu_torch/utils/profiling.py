"""Tracing / profiling utilities (counterpart of the JAX package's
``utils/profiling.py``).

The reference's instrumentation is ad hoc: ``time.time()`` deltas around
the detector/pose forwards (mmpose_pose_estimation.py:235-256) and per-cost
cumulative wall-time percentages inside the SGD loop
(``print_compute_times``, pose_refinement.py:998-1067).  Here:

- `StepTimer`: wall time per named stage with a context manager, the card
  synchronized at the end of each stage; `report()` prints the
  reference-style percentage breakdown in the JAX package's format;
- `trace`: a ``torch.profiler`` window over CPU and CUDA activity that
  writes a Chrome/TensorBoard trace (``*.pt.trace.json``) under
  ``log_dir`` (the TensorBoard package is not needed);
- `profile_refinement_costs`: each refinement cost timed alone on one
  window of a `refine.PoseRefiner`, the reference's per-cost breakdown for
  tuning the λ weights (the production loop stays as it is).
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from collections import defaultdict

import numpy as np
import torch

__all__ = ["StepTimer", "trace", "profile_refinement_costs"]


def _sync_cuda() -> None:
    """Wait for the card's queued work, where CUDA is in use."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimer:
    """Accumulate wall time per named stage.  ``synchronize=True`` waits for
    the card's queued work at the end of each stage, so that a stage's time
    includes the work it launched (``block_jax`` is the JAX package's name
    for it, and wins when given)."""

    def __init__(self, synchronize: bool = True, block_jax: bool | None = None):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.synchronize = bool(synchronize if block_jax is None else block_jax)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.synchronize:
                _sync_cuda()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        total = sum(self.totals.values()) or 1e-12
        lines = []
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            lines.append(
                f"{name}: {t:.3f}s ({100 * t / total:.1f}%), "
                f"{self.counts[name]} calls, {t / self.counts[name] * 1e3:.2f} ms/call"
            )
        out = "\n".join(lines)
        print(out)
        return out


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile CPU (and, where available, CUDA) activity in the block and
    write its Chrome trace to ``<log_dir>/<host>.<pid>.<ms>.pt.trace.json``
    (open it in TensorBoard's profile tab, Perfetto or chrome://tracing).
    Yields the ``torch.profiler.profile`` (its ``events()`` and
    ``key_averages()``); the trace's path is its ``trace_path`` once the
    block has ended."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        _sync_cuda()
        prof.stop()
        path = os.path.join(log_dir, f"{socket.gethostname()}.{os.getpid()}."
                                     f"{int(time.time() * 1e3)}.pt.trace.json")
        prof.export_chrome_trace(path)
        prof.trace_path = path


def profile_refinement_costs(refiner, window: int | None = None, n_iters: int = 20):
    """Time each refinement cost alone on the first ``window`` frames of
    ``refiner`` (a `refine.PoseRefiner`; all of them by default), in its
    dtype on its device, each call synchronized before the clock is read.

    Returns {cost_name: seconds per evaluation}: ``likelihood_cost``,
    ``smoothness_cost`` and, when the refiner has body lengths,
    ``body_length_cost``; prints a reference-style percentage line
    (pose_refinement.py:1060-1067).
    """
    from ..refine.costs import body_length_cost, likelihood_cost, nan_mean, precompute_cov_inverse
    from ..utils.skeleton import body_length_edges

    def t(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype or refiner.dtype, device=refiner.device)

    g = t(refiner.gaussians)
    B = window or g.shape[0]
    g = g[:B]
    means = g[..., :2]
    cov_inv = precompute_cov_inverse(g)
    traj = t(refiner.initial_trajectory[:B])
    Ks, Rs, Ts, ds = (t(np.stack([refiner.cam_params[i][k] for i in refiner.camera_ids]))
                      for k in range(4))

    fns = {
        "likelihood_cost": lambda x: likelihood_cost(x, means, cov_inv, Ks, Rs, Ts, ds),
        "smoothness_cost": lambda x: nan_mean(
            torch.sum((x[2:] - 2 * x[1:-1] + x[:-2]) ** 2, dim=(-2, -1))),
    }
    if refiner.body_lengths:
        e_s, e_e, e_t = body_length_edges(refiner.body_lengths)
        e_s, e_e = t(e_s, torch.long), t(e_e, torch.long)
        e_t = t(e_t)
        fns["body_length_cost"] = lambda x: body_length_cost(x, e_s, e_e, e_t)

    times = {}
    with torch.no_grad():
        for name, fn in fns.items():
            fn(traj)  # warm-up
            _sync_cuda()
            t0 = time.perf_counter()
            for _ in range(n_iters):
                fn(traj)
                _sync_cuda()
            times[name] = (time.perf_counter() - t0) / n_iters
    total = sum(times.values())
    print(
        "Proportional cost times: "
        + ", ".join(f"{k}: {100 * v / total:.2f}%" for k, v in times.items())
    )
    return times
