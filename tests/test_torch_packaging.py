"""The port as an installed package: what its wheel ships and where it builds.

- The package-data globs of ``pyproject.toml`` match every source the port
  builds from at run time: the kernels (``csrc/*.cu``, `_native`) and the
  media runtime (``native/mediadec.cpp`` and its ``Makefile``, `native`).
- In a read-only install (the package directory not writable: the check
  `_native.writable` is patched, the tree is not chmodded) the kernels'
  libraries and the media runtime go to a per-user cache,
  ``$XDG_CACHE_HOME`` or ``~/.cache``, under ``mc3d-pose-tpu-torch/<version>``,
  as the JAX package's ``native.build`` does; the media runtime really
  builds there (g++ and libav are needed: skipped without them).
- ``native.build(force=True)`` compiles again over a library that exists,
  as the JAX package's ``build(force=)`` does.
"""

import fnmatch
import os
import shutil
import subprocess
import tomllib
from pathlib import Path

import pytest

import multi_camera_3d_pose_estimation_tpu_torch as port
from multi_camera_3d_pose_estimation_tpu_torch import _native
from multi_camera_3d_pose_estimation_tpu_torch import native as pnative

REPO = Path(__file__).resolve().parent.parent
PKG = "multi_camera_3d_pose_estimation_tpu_torch"


@pytest.mark.parametrize("path", ["native/mediadec.cpp", "native/Makefile", "csrc/bottleneck.cu",
                                  "csrc/fused_decode.cu", "csrc/swin_gemm.cu",
                                  "csrc/window_attention.cu"])
def test_port_sources_ship_as_package_data(path):
    with open(REPO / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    assert (REPO / PKG / path).is_file()
    # setuptools matches a package's globs against paths relative to that package.
    shipped = [(pkg, g) for pkg, globs in data.items() for g in globs
               if pkg.startswith(PKG)]
    assert any(fnmatch.fnmatch(str(Path(PKG.replace(".", "/")) / path),
                               str(Path(pkg.replace(".", "/")) / g)) for pkg, g in shipped), \
        f"{path} is not in the port's package-data {shipped}"


def test_every_kernel_source_is_shipped():
    """The parametrised list above names every source `_native` builds."""
    assert sorted(f"csrc/{s}.cu" for s in _native.SOURCES) == sorted(
        f"csrc/{p.name}" for p in (REPO / PKG / "csrc").glob("*.cu"))


@pytest.mark.parametrize("cache", ["xdg", "home"])
def test_read_only_install_builds_in_the_user_cache(monkeypatch, tmp_path, cache):
    if cache == "xdg":
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
        base = tmp_path / "xdg"
    else:
        monkeypatch.delenv("XDG_CACHE_HOME", raising=False)
        monkeypatch.setenv("HOME", str(tmp_path / "home"))
        base = tmp_path / "home" / ".cache"
    want = base / "mc3d-pose-tpu-torch" / port.__version__ / "build"
    assert _native.build_dir() == _native.BUILD  # the checkout is writable
    monkeypatch.setattr(_native, "writable", lambda path: False)
    assert _native.build_dir() == want
    for name in _native.SOURCES:
        target = _native._target(name)
        assert target.parent == want and target.name.startswith(f"lib{name}-")
    assert pnative.library_path().parent == want
    assert pnative.library_path().name.startswith("libmediadec-")


def test_media_runtime_builds_in_the_user_cache(monkeypatch, tmp_path):
    if shutil.which("make") is None or shutil.which("g++") is None:
        pytest.skip("needs make and g++")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    monkeypatch.setattr(_native, "writable", lambda path: False)
    before = sorted(os.listdir(_native.BUILD)) if _native.BUILD.exists() else []
    if not pnative.build():
        pytest.skip("the libav development files are missing")
    out = pnative.library_path()
    assert out.is_file() and out.is_relative_to(tmp_path)
    assert (sorted(os.listdir(_native.BUILD)) if _native.BUILD.exists() else []) == before
    assert not any(p.suffix == ".tmp" for p in out.parent.iterdir())


def test_native_build_force_rebuilds(monkeypatch, tmp_path):
    """``build()`` leaves a library that is there alone; ``build(force=True)``
    runs ``make`` again and replaces it."""
    monkeypatch.setattr(pnative, "BUILD", tmp_path / "build")
    calls = []

    def fake_make(cmd, **kw):
        out = Path(next(a for a in cmd if a.startswith("OUT="))[4:])
        out.write_text(f"build {len(calls)}")
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(pnative.subprocess, "run", fake_make)
    assert pnative.build() and len(calls) == 1
    assert pnative.build() and len(calls) == 1  # there already: not built again
    assert pnative.build(force=True) and len(calls) == 2
    assert pnative.library_path().read_text() == "build 1"
