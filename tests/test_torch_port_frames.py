"""The port's frame IO against the JAX package's, bit for bit.

Videos are mp4v files written with OpenCV (as ``tests/test_media.py``
writes them), two cameras of 10 random frames, read in blocks of 4 so that
the last block holds 2 frames and is zero-padded.  The port decodes as it
runs by default (its own libav library where it builds, else OpenCV); the
JAX reader is held both on its OpenCV path (its libav decoder switched off)
and as it runs by default.  ``tests/test_torch_native.py`` holds the two
libav paths against each other.
"""

import os
import threading

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from multi_camera_3d_pose_estimation_tpu.io import frames as jframes  # noqa: E402
from multi_camera_3d_pose_estimation_tpu_torch.io import frames as pframes  # noqa: E402

N_FRAMES, BLOCK = 10, 4


def _write_video(path, rng, n=N_FRAMES, w=64, h=48):
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 15.0, (w, h))
    assert vw.isOpened()
    for _ in range(n):
        vw.write(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    vw.release()
    return str(path)


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    d = tmp_path_factory.mktemp("videos")
    rng = np.random.default_rng(0)
    return [_write_video(d / f"cam{c}.mp4", rng) for c in range(2)]


@pytest.fixture(params=["cv2", "default"])
def jax_decoder(request, monkeypatch):
    if request.param == "cv2":
        monkeypatch.setattr(jframes, "load_mediadec", lambda: None)
    return request.param


@pytest.mark.parametrize("bgr", [False, True])
def test_video_reader_matches_jax(videos, jax_decoder, bgr):
    with jframes.VideoReader(videos[0], bgr=bgr) as j, pframes.VideoReader(videos[0], bgr=bgr) as p:
        assert (p.width, p.height, p.n_frames) == (j.width, j.height, j.n_frames) == (64, 48, 10)
        assert p.fps == pytest.approx(j.fps)
        for n in (3, 3, 3, 3, 3):
            a, b = j.read_block(n), p.read_block(n)
            assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        assert b.shape == (0, 48, 64, 3)
    with jframes.VideoReader(videos[1]) as j, pframes.VideoReader(videos[1]) as p:
        fj, fp = list(j), list(p)
        assert len(fj) == len(fp) == N_FRAMES
        assert all(np.array_equal(a, b) for a, b in zip(fj, fp))


def test_frame_generator_matches_jax(videos, jax_decoder):
    a = list(jframes.frame_generator(videos))
    b = list(pframes.load_frames(video_paths=videos))
    assert len(a) == len(b) == N_FRAMES
    for fa, fb in zip(a, b):
        assert len(fa) == len(fb) == 2
        assert all(np.array_equal(x, y) for x, y in zip(fa, fb))
    with pytest.raises(ValueError):
        pframes.load_frames()


def test_batched_blocks_match_jax(videos, jax_decoder):
    """Host blocks (stage_to_device=False), the padded tail included."""
    j = jframes.BatchedFramePipeline(videos, block_size=BLOCK, stage_to_device=False,
                                     native_assembler=False)
    p = pframes.BatchedFramePipeline(videos, block_size=BLOCK, stage_to_device=False)
    try:
        a, b = list(j), list(p)
    finally:
        j.close()
        p.close()
    assert [n for _, n in a] == [n for _, n in b] == [4, 4, 2]
    for (ba, _), (bb, _) in zip(a, b):
        assert bb.shape == (BLOCK, 2, 48, 64, 3) and bb.dtype == np.uint8
        np.testing.assert_array_equal(ba, bb)
    assert not b[-1][0][2:].any() and b[-1][0][:2].any()  # zero padding after the 2 valid frames


def test_close_in_the_middle_of_a_stream(videos):
    """The producer is blocked on a full queue; close() drains it and the
    thread exits."""
    p = pframes.BatchedFramePipeline(videos, block_size=1, queue_depth=1, stage_to_device=False)
    it = iter(p)
    block, n = next(it)
    assert n == 1 and block.shape == (1, 2, 48, 64, 3)
    threads = threading.active_count()
    p.close()
    p._thread.join(timeout=10)
    assert not p._thread.is_alive()
    assert all(r._cap is None for r in p.readers)
    assert threading.active_count() <= threads


def test_stage_blocks_on_the_cpu(videos):
    rng = np.random.default_rng(1)
    host = [(rng.integers(0, 256, (3, 2, 8, 6, 3), dtype=np.uint8), n) for n in (3, 3, 1)]
    out = list(pframes.stage_blocks(iter(host), "cpu"))
    assert [n for _, n in out] == [3, 3, 1]
    for (h, _), (t, _) in zip(host, out):
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu" and not t.is_pinned()
        np.testing.assert_array_equal(t.numpy(), h)
    p = pframes.BatchedFramePipeline(videos, block_size=BLOCK, device="cpu")
    try:
        staged = list(p)
    finally:
        p.close()
    assert [n for _, n in staged] == [4, 4, 2]
    assert all(isinstance(t, torch.Tensor) and t.shape == (BLOCK, 2, 48, 64, 3) for t, _ in staged)


def test_stage_blocks_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    block = np.zeros((1, 1, 2, 2, 3), np.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(pframes.stage_blocks(iter([(block, 1)]), "cuda"))


def test_image_frames_and_keypoint_dump_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    folder = tmp_path / "imgs"
    folder.mkdir()
    for i in (0, 2, 10, 1):
        cv2.imwrite(str(folder / f"frame{i}.jpg"), rng.integers(0, 256, (8, 6, 3), dtype=np.uint8))
    for bgr in (True, False):
        a = list(jframes.load_frames(frames_folder=str(folder), bgr=bgr))
        b = list(pframes.load_frames(frames_folder=str(folder), bgr=bgr))
        assert len(a) == len(b) == 4
        assert all(np.array_equal(x[0], y[0]) for x, y in zip(a, b))
    kp = rng.normal(size=(3, 17, 3))
    jframes.write_keypoints_to_disk(str(tmp_path / "j.txt"), kp)
    pframes.write_keypoints_to_disk(str(tmp_path / "p.txt"), kp)
    assert (tmp_path / "j.txt").read_bytes() == (tmp_path / "p.txt").read_bytes()
    assert os.path.getsize(tmp_path / "p.txt") > 0
