"""Environment health check:
``python -m multi_camera_3d_pose_estimation_tpu_torch doctor``.

The port's counterpart of the JAX package's ``cli/doctor.py``, with its
flags, report rows and exit rule.  In order:

1. imports and versions: ``torch`` and ``numpy`` required, ``cv2`` and
   ``yaml`` optional;
2. the media runtime (`native.load_mediadec`: libav decode, audio, remux),
   required as in the JAX package;
3. a 4-rank gloo group on the CPU (four processes) doing one
   `parallel.mesh.all_reduce_sum`: the setup the mesh paths' CPU runs rely
   on (the JAX package checks its virtual 4-device CPU mesh here);
4. the device, probed in a killable subprocess with ``--probe_timeout``:
   ``torch.cuda.is_available()``, the card's name and count, then
   `_native.build_all` and a load of each kernel library.  Advisory (a
   machine without a card is a supported configuration for the CPU path)
   unless ``--require_device`` is given.

Exit code 0 when every required row is ok, else 1.  The report never
imports `viz` (matplotlib).
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time

_OK = "ok"
_FAIL = "FAIL"
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _check_imports(report):
    required = ("torch", "numpy")
    optional = ("cv2", "yaml")
    good = True
    for name in required + optional:
        try:
            mod = __import__(name)
            ver = getattr(mod, "__version__", "?")
            report.append((f"import {name}", _OK, ver))
        except Exception as e:
            report.append((f"import {name}", _FAIL, str(e)[:60]))
            if name in required:
                good = False
    return good


def _check_native(report):
    try:
        from ..native import library_path, load_mediadec

        lib = load_mediadec()
    except Exception as e:
        report.append(("native mediadec", _FAIL, str(e)[:60]))
        return False
    if lib is None:
        report.append(("native mediadec", _FAIL,
                       "libmediadec.so unavailable (build or libav missing)"))
        return False
    report.append(("native mediadec", _OK,
                   f"demux/decode/audio/remux loaded ({library_path().name})"))
    return True


# A device probe in a child process: what an unconstrained process sees.
_PROBE = """
import torch
if not torch.cuda.is_available():
    raise SystemExit("torch.cuda.is_available() is False")
print("cuda", torch.cuda.device_count(), torch.cuda.get_device_name(0), sep="|", flush=True)
from multi_camera_3d_pose_estimation_tpu_torch import _native
_native.build_all()
for name in _native.SOURCES:
    _native.library(name)
print(",".join(_native.SOURCES), flush=True)
"""


def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_REPO, env.get("PYTHONPATH")) if p)
    return env


def _tail(r) -> str:
    lines = (r.stderr or r.stdout or "").strip().splitlines()
    return lines[-1][:70] if lines else f"exit code {r.returncode}"


def _probe_device(report, timeout_s: float):
    """The device row and the kernel-library row; True when both are ok."""
    try:  # the child is killed at the timeout
        r = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True,
                           timeout=timeout_s, env=_child_env())
    except subprocess.TimeoutExpired:
        report.append(("device backend", _FAIL,
                       f"no answer after {timeout_s:.0f}s: CUDA hung or card unavailable"))
        return False
    lines = r.stdout.strip().splitlines()
    if not lines or not lines[0].startswith("cuda|"):
        report.append(("device backend", _FAIL, _tail(r)))
        return False
    _, n, name = lines[0].split("|", 2)
    report.append(("device backend", _OK, f"cuda × {n} ({name})"))
    if r.returncode != 0 or len(lines) < 2:
        report.append(("kernel libraries", _FAIL, _tail(r)))
        return False
    report.append(("kernel libraries", _OK, f"built and loaded: {lines[1]}"))
    return True


# One rank of the CPU group: JAX is never imported; one thread each.
_RANK = """
import sys
import torch
torch.set_num_threads(1)
from multi_camera_3d_pose_estimation_tpu_torch.parallel import mesh as m
addr, world, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
m.init_distributed(addr, world, rank, device="cpu")
mesh = m.make_mesh(world, device="cpu")
x = torch.arange(4.0, dtype=torch.float64) + 4 * rank
y = m.all_reduce_sum(x, mesh)
want = sum(torch.arange(4.0, dtype=torch.float64) + 4 * r for r in range(world))
if not torch.equal(y, want):
    raise SystemExit(f"all_reduce_sum gave {y.tolist()}, not {want.tolist()}")
torch.distributed.destroy_process_group()
print("mesh-ok", flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _check_cpu_mesh(report, n_ranks: int = 4, timeout_s: float = 120.0):
    """Required: a gloo group of ``n_ranks`` processes sums a tensor over
    `parallel.mesh.all_reduce_sum`.  Every rank is killed at the timeout."""
    row = f"{n_ranks}-rank gloo CPU mesh"
    addr = f"127.0.0.1:{_free_port()}"
    env = _child_env()
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, addr, str(n_ranks), str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(n_ranks)]
    deadline = time.monotonic() + timeout_s
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 0.1)))
            except subprocess.TimeoutExpired:
                report.append((row, _FAIL, f"timed out after {timeout_s:.0f}s"))
                return False
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(p, o) for p, o in zip(procs, outs) if p.returncode != 0 or "mesh-ok" not in o[0]]
    if bad:
        p, (out, err) = bad[0]
        lines = (err or out).strip().splitlines()
        report.append((row, _FAIL, lines[-1][:70] if lines else f"exit code {p.returncode}"))
        return False
    report.append((row, _OK, "all_reduce_sum over the ranks"))
    return True


def main(argv=None):
    p = argparse.ArgumentParser(prog="doctor", description="environment health check")
    p.add_argument("--probe_timeout", type=float, default=60.0,
                   help="seconds before declaring the device probe failed (the kernels' "
                        "first build is part of it)")
    p.add_argument("--no_device", action="store_true",
                   help="skip the device probe (fast, CPU only)")
    p.add_argument("--require_device", action="store_true",
                   help="fail (exit 1) if the device probe fails")
    args = p.parse_args(argv)

    report: list[tuple[str, str, str]] = []
    good = _check_imports(report)
    good &= _check_native(report)
    good &= _check_cpu_mesh(report)
    if not args.no_device:
        dev_ok = _probe_device(report, args.probe_timeout)
        if args.require_device:
            good &= dev_ok

    width = max(len(name) for name, _, _ in report)
    for name, status, detail in report:
        print(f"{name:<{width}}  {status:<4}  {detail}")
    print("doctor:", "healthy" if good else "PROBLEMS FOUND")
    raise SystemExit(0 if good else 1)


if __name__ == "__main__":
    main()
