"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, loaded with ``ctypes``.  Libraries go to the package's
``build/`` directory (listed in ``.gitignore``) or, where this process
cannot write there (a read-only install), to a per-user cache
(`build_dir`), named by a hash of the source so an edited kernel is
rebuilt.  Nothing is built on import: a kernel is built at its first
launch, or all at once, in parallel, by `build_all`.
There is no fallback: a missing ``nvcc`` or a failed build raises.

A kernel called through ``ctypes`` is invisible to autograd: its output
would carry no ``grad_fn`` and the gradient upstream of it would be lost
without a word.  So every kernel wrapper first calls `refuse_autograd`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["SOURCES", "build_all", "build_dir", "library", "check", "refuse_autograd"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
SOURCES = ("bn_epilogue", "bottleneck", "crop_resample", "fused_decode", "swin_gemm",
           "window_attention")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def writable(path: Path) -> bool:
    """Whether this process can create files in ``path``: the directory, or
    the nearest one above it that exists, is writable."""
    while not path.exists() and path.parent != path:
        path = path.parent
    return os.access(path, os.W_OK)


def build_dir(own: Path = BUILD) -> Path:
    """Where a native library is built: ``own`` (a git-ignored ``build/``
    of the package) when this process can write there, else a per-user
    cache, ``$XDG_CACHE_HOME`` (or ``~/.cache``) ``/mc3d-pose-tpu-torch/
    <version>/build``, as the JAX package builds its media library in a
    read-only install.  The libraries' names carry their sources' digest,
    so either place holds one library per source."""
    if writable(own):
        return own
    from . import __version__

    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return Path(base) / "mc3d-pose-tpu-torch" / __version__ / "build"


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return build_dir() / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start the nvcc process for ``name`` (None if already built)."""
    out = _target(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> dict[str, str]:
    """Compile every kernel source at once (one nvcc each, in parallel).

    Returns ``{name: nvcc output}`` (register and shared-memory use from
    ``-Xptxas -v``; empty for a library that was already built).
    """
    started = {name: _start(name) for name in SOURCES}
    return {name: _finish(name, started[name]) for name in SOURCES}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(_target(name)))
        _libs[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def refuse_autograd(kernel: str, *tensors) -> None:
    """Raise ``RuntimeError`` naming ``kernel`` when autograd is on and an
    input requires grad: the kernels have no backward.  Checked on every
    device, before the dispatch (the CPU runs the kernel's plain version in
    its place)."""
    if torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(f"{kernel}: the kernel has no backward, and an input requires "
                           f"grad; call it under torch.no_grad() or torch.inference_mode(), "
                           f"or train through the plain path")
