"""ctypes bindings of the port's media runtime (``native/mediadec.cpp``).

Host code, not a kernel: libav demux/decode with a background prefetch
thread, the multi-camera block assembler (``mda_*``), container audio
decode and an audio remux, the same C ABI as the JAX package's
``native/``.  The library is built with ``make`` (g++ and the libav
development files) at the first `load_mediadec`, into the package's
git-ignored ``build/`` or, where this process cannot write there (a
read-only install), a per-user cache (`_native.build_dir`), named by a
hash of the source and flags so that an edited source is rebuilt.
Nothing is built on import.  Without the toolchain or libav,
`load_mediadec` returns None and the callers fall back: `io.frames` to
cv2, `sync.audio` to PCM ``.wav`` files.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

from .._native import build_dir

__all__ = ["build", "load_mediadec", "library_path", "remux_with_audio"]

_DIR = Path(__file__).resolve().parent
BUILD = _DIR.parent / "build"
_CXXFLAGS = "-O3 -fPIC -shared -std=c++17"
_lib = None
_tried = False


def library_path() -> Path:
    """Where the library of the current source is (or will be) built."""
    src = (_DIR / "mediadec.cpp").read_bytes() + (_DIR / "Makefile").read_bytes()
    digest = hashlib.sha256(src + _CXXFLAGS.encode()).hexdigest()[:12]
    return build_dir(BUILD) / f"libmediadec-{digest}.so"


def build(force: bool = False) -> bool:
    """Compile the library into `library_path` unless it is there (or
    again, when ``force``); returns whether it is there afterwards.  A
    failed compile (no g++, no libav, an unwritable directory) returns
    False.  The sources are read where they are installed: ``make`` writes
    the library only."""
    out = library_path()
    if out.exists() and not force:
        return True
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(["make", "-C", str(_DIR), f"OUT={tmp}", f"CXXFLAGS={_CXXFLAGS}", str(tmp)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    except (OSError, subprocess.CalledProcessError):
        if tmp.exists():
            tmp.unlink()
        return False
    return True


def _bind(lib) -> None:
    """The C signatures of every entry point."""
    c_int_p = ctypes.POINTER(ctypes.c_int)
    c_ubyte_p = ctypes.POINTER(ctypes.c_ubyte)
    info = [ctypes.c_void_p, c_int_p, c_int_p, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_longlong)]
    lib.md_open.restype = ctypes.c_void_p
    lib.md_open.argtypes = [ctypes.c_char_p]
    lib.md_info.argtypes = info
    lib.md_read_frames.restype = ctypes.c_int
    lib.md_read_frames.argtypes = [ctypes.c_void_p, c_ubyte_p, ctypes.c_int]
    lib.md_start_prefetch.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.md_next_frames.restype = ctypes.c_int
    lib.md_next_frames.argtypes = [ctypes.c_void_p, c_ubyte_p, ctypes.c_int]
    lib.md_close.argtypes = [ctypes.c_void_p]
    lib.md_read_audio.restype = ctypes.c_longlong
    lib.md_read_audio.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                  ctypes.c_longlong, c_int_p]
    lib.mda_open.restype = ctypes.c_void_p
    lib.mda_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int]
    lib.mda_info.argtypes = info
    lib.mda_next_block.restype = ctypes.c_int
    lib.mda_next_block.argtypes = [ctypes.c_void_p, c_ubyte_p, ctypes.c_int]
    lib.mda_close.argtypes = [ctypes.c_void_p]
    lib.md_remux_with_audio.restype = ctypes.c_int
    lib.md_remux_with_audio.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                        ctypes.POINTER(ctypes.c_float), ctypes.c_longlong,
                                        ctypes.c_int]


def load_mediadec():
    """The loaded library, built first if needed; None when it cannot be
    built or loaded (tried once per process)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not build():
        return None
    try:
        lib = ctypes.CDLL(str(library_path()))
    except OSError:
        return None
    _bind(lib)
    _lib = lib
    return lib


def remux_with_audio(video_in: str, out_path: str, samples, sample_rate: int) -> None:
    """Write ``out_path``: the video stream of ``video_in`` (stream-copied)
    and a mono pcm_s16le track of ``samples`` (float in [-1, 1]).  Makes
    audio-bearing ``.mov``/``.mp4`` files for the audio-sync path.  Raises
    ``RuntimeError`` when the library is unavailable or the mux fails."""
    import numpy as np

    lib = load_mediadec()
    if lib is None:
        raise RuntimeError("native mediadec library unavailable")
    arr = np.ascontiguousarray(np.asarray(samples, np.float32))
    rc = lib.md_remux_with_audio(str(video_in).encode(), str(out_path).encode(),
                                 arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                 ctypes.c_longlong(arr.size), int(sample_rate))
    if rc != 0:
        raise RuntimeError(f"md_remux_with_audio failed with code {rc}")
