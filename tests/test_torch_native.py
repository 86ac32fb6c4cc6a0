"""The port's media runtime (``native/``: libav decode, the block assembler,
container audio, the remux) against the JAX package's, bit for bit.

Videos are ``tests/test_media.py``'s mp4v files (each frame's red channel
encodes its index) and random-content ones; audio-bearing ``.mov`` files
are written by the port's `remux_with_audio` on
``test_media.py::test_audio_sync_end_to_end_in_container``'s layout.  Both
packages decode with their own copy of ``mediadec.cpp``: the port's is
built into its ``build/`` directory, the JAX package's into its own.
"""

import os
import threading

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from multi_camera_3d_pose_estimation_tpu import native as jnative  # noqa: E402
from multi_camera_3d_pose_estimation_tpu.io import frames as jframes  # noqa: E402
from multi_camera_3d_pose_estimation_tpu.sync import audio as jaudio  # noqa: E402
from multi_camera_3d_pose_estimation_tpu.sync import videos as jvideos  # noqa: E402
from multi_camera_3d_pose_estimation_tpu_torch import native as pnative  # noqa: E402
from multi_camera_3d_pose_estimation_tpu_torch.io import frames as pframes  # noqa: E402
from multi_camera_3d_pose_estimation_tpu_torch.sync import audio as paudio  # noqa: E402
from multi_camera_3d_pose_estimation_tpu_torch.sync import videos as pvideos  # noqa: E402

from tests.test_media import write_test_video  # noqa: E402

PKG = os.path.dirname(pnative.__file__)


@pytest.fixture(scope="module")
def libs():
    p, j = pnative.load_mediadec(), jnative.load_mediadec()
    if p is None or j is None:
        pytest.skip("libav or the C++ toolchain is missing: no native decoder to hold")
    return p, j


@pytest.fixture(scope="module")
def clips(tmp_path_factory, libs):
    """Two cameras: an 11-frame index ramp and a 9-frame random clip (the
    shorter camera ends the blocks)."""
    d = tmp_path_factory.mktemp("clips")
    ramp = write_test_video(d / "ramp.mp4", n_frames=11)
    rng = np.random.default_rng(0)
    noise = str(d / "noise.mp4")
    vw = cv2.VideoWriter(noise, cv2.VideoWriter_fourcc(*"mp4v"), 15.0, (64, 48))
    for _ in range(9):
        vw.write(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
    vw.release()
    return [ramp, noise]


def test_library_is_built_into_the_port_build_dir(libs):
    path = pnative.library_path()
    assert path.parent.name == "build" and path.parent.parent.name == os.path.basename(
        os.path.dirname(PKG))
    assert path.name.startswith("libmediadec-") and path.exists()
    assert not any(n.endswith(".so") for n in os.listdir(PKG))  # nothing in the package dir
    assert pnative.load_mediadec() is libs[0]  # loaded once


def test_missing_toolchain_gives_none_and_remux_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(pnative, "_lib", None)
    monkeypatch.setattr(pnative, "_tried", False)
    monkeypatch.setattr(pnative, "BUILD", tmp_path / "build")  # nothing built there yet
    monkeypatch.setenv("PATH", str(tmp_path))  # no make, no g++
    assert pnative.load_mediadec() is None
    assert pnative.load_mediadec() is None and pnative._tried  # tried once
    assert not (tmp_path / "build").exists() or not os.listdir(tmp_path / "build")
    with pytest.raises(RuntimeError, match="native mediadec library unavailable"):
        pnative.remux_with_audio("a.mp4", str(tmp_path / "b.mov"), np.zeros(8), 8000)


@pytest.mark.parametrize("bgr", [False, True])
@pytest.mark.parametrize("prefetch", [16, 0])
def test_video_reader_matches_jax_libav(clips, bgr, prefetch):
    for path in clips:
        with jframes.VideoReader(path, prefetch=prefetch, bgr=bgr) as j, \
                pframes.VideoReader(path, prefetch=prefetch, bgr=bgr) as p:
            assert p._handle and j._handle and p._cap is None  # both on libav
            assert (p.width, p.height, p.fps, p.n_frames) == (j.width, j.height, j.fps,
                                                              j.n_frames)
            for n in (4, 1, 5, 4, 3):
                a, b = j.read_block(n), p.read_block(n)
                assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
            assert b.shape[0] == 0
    with pframes.VideoReader(clips[0], bgr=bgr) as p:  # the red ramp: frame i holds 10 i
        red = p.read_block(11)[..., 2 if bgr else 0].mean(axis=(1, 2))
    assert np.all(np.abs(red - 10 * np.arange(11)) < 12)


def test_video_reader_falls_back_to_cv2(clips, monkeypatch):
    monkeypatch.setattr(pframes, "load_mediadec", lambda: None)
    monkeypatch.setattr(jframes, "load_mediadec", lambda: None)
    with jframes.VideoReader(clips[1]) as j, pframes.VideoReader(clips[1]) as p:
        assert p._handle is None and p._cap is not None
        np.testing.assert_array_equal(j.read_block(9), p.read_block(9))


def _blocks(pipe):
    try:
        return [(np.array(b), n) for b, n in pipe]
    finally:
        pipe.close()


@pytest.mark.parametrize("block", [4, 16])
def test_assembler_blocks_match_jax(clips, block):
    """``mda_*`` blocks, the padded tail and the shorter camera's end
    included, equal to JAX's ``native_assembler=True`` and to the port's
    per-camera readers."""
    j = jframes.BatchedFramePipeline(clips, block_size=block, stage_to_device=False)
    p = pframes.BatchedFramePipeline(clips, block_size=block, stage_to_device=False)
    r = pframes.BatchedFramePipeline(clips, block_size=block, stage_to_device=False,
                                     native_assembler=False)
    assert j._asm is not None and p._asm is not None and p.readers == [] and r._asm is None
    a, b, c = _blocks(j), _blocks(p), _blocks(r)
    want = [block] * (9 // block) + ([9 % block] if 9 % block else [])
    assert [n for _, n in a] == [n for _, n in b] == [n for _, n in c] == want
    for (ba, _), (bb, _), (bc, _) in zip(a, b, c):
        assert bb.shape == (block, 2, 48, 64, 3)
        np.testing.assert_array_equal(ba, bb)
        np.testing.assert_array_equal(bc, bb)
    tail, n = b[-1]
    assert not tail[n:].any() and tail[:n].any()


def test_assembler_blocks_through_stage_blocks(clips):
    """The pinned-ring stager's CPU path consumes the assembler's blocks."""
    p = pframes.BatchedFramePipeline(clips, block_size=4, device="cpu")
    want = _blocks(jframes.BatchedFramePipeline(clips, block_size=4, stage_to_device=False))
    got = _blocks(p)
    assert [n for _, n in got] == [n for _, n in want]
    for (g, _), (w, _) in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert p._asm is None and not p._thread.is_alive()


@pytest.mark.parametrize("consumed", [0, 1])
def test_assembler_close_while_decoding(tmp_path, libs, consumed):
    """close() with the producer inside ``mda_next_block`` or blocked on a
    full queue (and, with 0 consumed, before any block was read): the
    thread exits, the handle is freed after it, a waiting consumer ends."""
    paths = [write_test_video(tmp_path / f"long{c}.mp4", n_frames=40) for c in range(2)]
    p = pframes.BatchedFramePipeline(paths, block_size=2, queue_depth=1, stage_to_device=False)
    it = iter(p)
    for _ in range(consumed):
        block, n = next(it)
        assert n == 2 and block[:, 0, ..., 0].mean() < 30  # frames 0-1 of the ramp
    p.close()
    assert not p._thread.is_alive() and p._asm is None
    assert list(it) == []  # the end marker reaches the consumer
    p.close()  # twice is harmless


def test_short_stream_closed_unread(clips):
    """Every block and the end marker already queued, nothing read: close()
    must not block on the full queue."""
    p = pframes.BatchedFramePipeline(clips, block_size=16, queue_depth=1, stage_to_device=False)
    p._thread.join(timeout=10)
    done = threading.Event()
    threading.Thread(target=lambda: (p.close(), done.set()), daemon=True).start()
    assert done.wait(15) and p._asm is None


def _audio_mov(tmp_path, remux, name, n_frames, fps, peak_at, sr=16000):
    """``test_media.py::write_audio_bearing_video``'s fixture, muxed by
    ``remux``."""
    silent = write_test_video(tmp_path / f"_{name}_noaudio.mp4", n_frames=n_frames, fps=fps)
    t = np.arange(int(sr * n_frames / fps)) / sr
    y = 0.05 * np.sin(2 * np.pi * 330 * t)
    y[int(peak_at * sr)] = 0.9
    out = str(tmp_path / f"{name}.mov")
    remux(silent, out, y, sr)
    return out


def test_container_audio_and_sync_match_jax(tmp_path, libs):
    """Audio-bearing ``.mov`` files from the port's remux: the same bytes as
    the JAX remux's, the same samples decoded by both packages, the loudest
    point, and `compute_sync_frame_indices` with camera 1's clap 6 frames
    later ([15, 21] at 15 fps)."""
    fps = 15.0
    movs = {}
    for side, remux in (("port", pnative.remux_with_audio), ("jax", jnative.remux_with_audio)):
        d = tmp_path / side
        d.mkdir()
        movs[side] = [_audio_mov(d, remux, f"cam{c}", 60, fps, peak)
                      for c, peak in enumerate((1.0, 1.4))]
    for a, b in zip(movs["port"], movs["jax"]):
        assert open(a, "rb").read() == open(b, "rb").read()
    for path in movs["port"]:
        (yp, srp), (yj, srj) = paudio.decode_audio(path), jaudio.decode_audio(path)
        assert srp == srj == 16000 and yp.dtype == yj.dtype == np.float32
        assert yp.shape == yj.shape == (64000,)
        np.testing.assert_array_equal(yp, yj)
        cut = paudio.decode_audio(path, max_seconds=1.2)[0]
        np.testing.assert_array_equal(cut, jaudio.decode_audio(path, max_seconds=1.2)[0])
        assert paudio.get_loudest_point(path) == jaudio.get_loudest_point(path)
    pi, pf = pvideos.compute_sync_frame_indices(movs["port"])
    ji, jf = jvideos.compute_sync_frame_indices(movs["port"])
    assert pi == ji == [15, 21] and pf == jf
    assert abs(paudio.get_loudest_point(movs["port"][1]) - 1.4) < 1e-3
    frames, outs = pvideos.synchronize_videos(movs["port"], save_as_files=True)
    jframes_, jouts = jvideos.synchronize_videos(movs["jax"], save_as_files=True)
    assert len(frames) == len(jframes_) > 10
    for fp, fj in zip(frames, jframes_):
        assert all(np.array_equal(a, b) for a, b in zip(fp, fj))
    for i in (0, 5, 9):  # frame i of the synced pair comes from source frames 15 + i, 21 + i
        assert abs(int(frames[i][0][:, :, 2].mean()) - 10 * (15 + i) % 250) < 12
        assert abs(int(frames[i][1][:, :, 2].mean()) - 10 * (21 + i) % 250) < 12
    assert [os.path.basename(p) for p in outs] == [os.path.basename(p) for p in jouts]


def test_remux_failure_raises(tmp_path, libs):
    with pytest.raises(RuntimeError, match="md_remux_with_audio failed"):
        pnative.remux_with_audio(str(tmp_path / "missing.mp4"), str(tmp_path / "x.mov"),
                                 np.zeros(16), 8000)

