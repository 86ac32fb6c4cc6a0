"""The port's front end against the JAX package's, on the CPU: configure,
capture, audio sync and the record_and_estimate command.

Both packages run on the same inputs made from numpy seeds; the port with
``device="cpu"``, the JAX side in float64 where it calibrates
(``tests/conftest.py`` turns on ``jax_enable_x64``).

- `configure_cameras` with existing intrinsics and ``manual_measurements``
  (and a checkerboard display YAML): every file of both projects bit for
  bit.  With ``capture_source`` / ``stereo_capture_source`` images warped
  by cv2 (two cameras, six board poses seen by both): ``camera_names.pkl``
  and the origin camera's ``.dat`` bit for bit; the calibrated files line
  for line the same layout, K at 1e-8 and the stereo R, T at 1e-7 relative
  (measured 1.4e-9 and 1.3e-8: the solvers' own spread in float64 along
  the flat valley of ``tests/test_torch_calib.py``, which the stereo solve
  inherits through both intrinsics).
- `LiveCaptureSource`, `LiveStereoCaptureSource` on
  ``tests/test_live_capture.py``'s ``FakeCapture``, and the headless
  `live_sync_frame_picker`: the same frames and errors.
- `compute_sync_frame_indices` and `synchronize_videos` with sidecar
  ``.wav`` files (``tests/test_media.py``'s fixtures): indices, fps and
  frames bit for bit, and the ``*_synced.mp4`` files' frames; the samples
  bit for bit, through both packages' libav decoders and through both
  standard-library ``.wav`` paths (libav scales int16 by 1/32768, ``wave``
  by 1/32767); a video without audio raises the same error in both.
- `record_and_estimate_pose` on prerecorded clips with manual extrinsics,
  from one JAX ``test_tiny`` ``.npz`` checkpoint: the artifacts held as
  ``tests/test_torch_port_cli.py`` holds the estimate CLI, the
  ``configurations/0`` files and ``recording_log.yaml`` bit for bit; and
  the ``record_and_estimate`` command of the port's ``__main__``.
- The fault that test found: PyTorch's CPU bf16 convolution (2.13 CPU
  build) is wrong for a stride-2 3x3 conv of a width-2 map at batches of
  about 24 and more, which test_tiny's stage 4 is at the CLI's default
  block of 64 frames.  The port's HRNet convs run in f32 on the CPU
  (`models.hrnet.conv2d`); a block's results no longer depend on its
  padding.
"""

import os
import pickle

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
yaml = pytest.importorskip("yaml")

from multi_camera_3d_pose_estimation_tpu import acquisition as jacq  # noqa: E402
from multi_camera_3d_pose_estimation_tpu import io as jio  # noqa: E402
from multi_camera_3d_pose_estimation_tpu import sync as jsync  # noqa: E402
from multi_camera_3d_pose_estimation_tpu.cli import configure as jconf  # noqa: E402
from multi_camera_3d_pose_estimation_tpu.cli import (  # noqa: E402
    record_and_estimate as jrec)
from multi_camera_3d_pose_estimation_tpu.models import registry as jreg  # noqa: E402
from multi_camera_3d_pose_estimation_tpu.models.hrnet import HRNet as JHRNet  # noqa: E402
from multi_camera_3d_pose_estimation_tpu_torch import __main__ as port_main  # noqa: E402
from multi_camera_3d_pose_estimation_tpu_torch import acquisition as pacq  # noqa: E402
from multi_camera_3d_pose_estimation_tpu_torch import sync as psync  # noqa: E402
from multi_camera_3d_pose_estimation_tpu_torch.acquisition import live as plive  # noqa: E402
from multi_camera_3d_pose_estimation_tpu_torch.calib import (  # noqa: E402
    board_object_points, create_checkerboard_image)
from multi_camera_3d_pose_estimation_tpu_torch.cli import configure as pconf  # noqa: E402
from multi_camera_3d_pose_estimation_tpu_torch.cli import (  # noqa: E402
    record_and_estimate as prec)

from tests._torch_port_util import fast_flax_init, random_variables  # noqa: E402
from tests.test_live_capture import (COLS, ROWS, FakeCapture, _board_frame,  # noqa: E402
                                     _noise_frame)
from tests.test_media import write_test_video, write_test_wav  # noqa: E402
from tests.test_torch_calib import rel, rodrigues_np  # noqa: E402


def tree_bytes(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


# ------------------------------------------------------------------ configure


def test_configure_with_manual_extrinsics_writes_jax_files(tmp_path):
    K = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1]])
    disp = tmp_path / "display.yaml"
    disp.write_text(yaml.dump({"r": 7, "c": 10, "height": 540, "width": 960, "boarder": 5,
                               "width_mm": 300.0}))
    settings = tmp_path / "calibration_settings.yaml"
    settings.write_text(yaml.dump({"checkerboard_rows": 6, "checkerboard_columns": 9}))
    nums = {}
    for side, conf in (("jax", jconf), ("port", pconf)):
        project = tmp_path / side
        for name in ("camA", "camB", "camC"):
            jio.save_camera_intrinsics(K, np.array([[-0.1, 0.01, 0, 0, 0]]), name,
                                       root_path=str(project))
        extra = {"device": "cpu"} if side == "port" else {}
        nums[side] = [conf.configure_cameras(
            camera_names={0: "camA", 1: "camB", 2: "camC"},
            calibration_settings_yaml=str(settings), project_dir=str(project),
            origin_camera="camB", checkerboard_display_parameter_yaml=str(disp),
            manual_measurements={"camA": ([100.0, 0.0, 50.0], 3.0, 4.0),
                                 "camC": ([-80.0, 2.0, 30.0], 5.0, -2.0)}, **extra)
            for _ in range(2)]  # a second configuration beside the first
    assert nums["port"] == nums["jax"] == [0, 1]
    jax_files, port_files = tree_bytes(tmp_path / "jax"), tree_bytes(tmp_path / "port")
    assert sorted(port_files) == sorted(jax_files)
    assert "configurations/1/checkerboard.jpg" in port_files
    assert "configurations/0/extrinsic_camera_parameters/rot_trans_camC.dat" in port_files
    for name, data in jax_files.items():
        assert port_files[name] == data, name


def render_pairs(n_views=6, rows=5, cols=7, seed=11):
    """Board photos of two cameras from ``n_views`` shared board poses,
    warped as ``tests/test_cli_viz.py::render_board_views`` warps them; and
    the truth (K, camera 1's R, T relative to camera 0)."""
    rng = np.random.default_rng(seed)
    K = np.array([[620.0, 0, 320.0], [0, 620.0, 240.0], [0, 0, 1]])
    board, k = create_checkerboard_image(rows + 1, cols + 1, 1200, 900, border_px=6)
    y0 = (900 - (rows + 1) * k) // 2
    x0 = (1200 - (cols + 1) * k) // 2
    offset = np.array([-(x0 + k), -(y0 + k), 0.0])
    R_rel = rodrigues_np(np.array([0.0, 0.12, 0.0]))
    t_rel = np.array([-250.0, 0.0, 30.0])
    pairs = []
    for _ in range(n_views):
        R = rodrigues_np(rng.uniform(-0.25, 0.25, 3))
        t = np.array([rng.uniform(-80, 20), rng.uniform(-100, 30), rng.uniform(2200, 2800)])
        views = []
        for Rc, tc in ((R, t), (R_rel @ R, R_rel @ t + t_rel)):
            H = K @ np.column_stack([Rc[:, 0], Rc[:, 1], Rc @ offset + tc])
            views.append(cv2.warpPerspective(board, H / H[2, 2], (640, 480),
                                             flags=cv2.INTER_LINEAR, borderValue=255))
        pairs.append(tuple(views))
    return pairs, k, K, R_rel, t_rel


def test_configure_from_images_matches_jax(tmp_path):
    pairs, k, K, R_rel, t_rel = render_pairs()
    settings = tmp_path / "settings.yaml"
    settings.write_text(yaml.dump({"checkerboard_rows": 5, "checkerboard_columns": 7,
                                   "checkerboard_box_size_scale": float(k)}))
    names = {0: "left", 1: "right"}

    def capture(name):
        return [p[list(names.values()).index(name)] for p in pairs]

    def stereo(name0, name1):
        assert (name0, name1) == ("left", "right")
        return pairs

    for side, conf, extra in (("jax", jconf, {}), ("port", pconf, {"device": "cpu"})):
        assert conf.configure_cameras(camera_names=names,
                                      calibration_settings_yaml=str(settings),
                                      project_dir=str(tmp_path / side), capture_source=capture,
                                      stereo_capture_source=stereo, **extra) == 0
    jax_files, port_files = tree_bytes(tmp_path / "jax"), tree_bytes(tmp_path / "port")
    assert sorted(port_files) == sorted(jax_files)
    for name in ("extrinsic_camera_parameters/camera_names.pkl",
                 "configurations/0/extrinsic_camera_parameters/rot_trans_left.dat"):
        assert port_files[name] == jax_files[name], name
    for name, data in jax_files.items():  # the same layout, line for line
        ours = port_files[name].decode(errors="replace").splitlines()
        theirs = data.decode(errors="replace").splitlines()
        assert [len(ln.split()) for ln in ours] == [len(ln.split()) for ln in theirs]
    for side in ("jax", "port"):
        with open(tmp_path / side / "extrinsic_camera_parameters" / "camera_names.pkl",
                  "rb") as f:
            assert pickle.load(f) == (names, "left")
    intr = {s: tmp_path / s / "intrinsic_camera_parameters" for s in ("jax", "port")}
    extr = {s: tmp_path / s / "configurations/0/extrinsic_camera_parameters"
            for s in ("jax", "port")}
    for cam in names.values():
        Kj, dj = jio.read_camera_parameters(cam, str(intr["jax"]))
        Kp, dp = jio.read_camera_parameters(cam, str(intr["port"]))
        assert rel(Kp, Kj) < 1e-8 and np.abs(dp - dj).max() < 1e-8
        assert rel(Kp, K) < 0.05
    Rj, Tj = jio.read_rotation_translation("right", str(extr["jax"]))
    Rp, Tp = jio.read_rotation_translation("right", str(extr["port"]))
    assert rel(Rp, Rj) < 1e-7 and rel(Tp, Tj) < 1e-7
    np.testing.assert_allclose(Rp, R_rel, atol=0.02)
    np.testing.assert_allclose(Tp.ravel(), t_rel, atol=0.1 * np.abs(t_rel).max())


def test_configure_needs_a_source(tmp_path):
    with pytest.raises(RuntimeError, match="no intrinsics for 'a'"):
        pconf.configure_cameras(camera_names={0: "a"}, project_dir=str(tmp_path), device="cpu")
    K = np.eye(3)
    for name in ("a", "b"):
        jio.save_camera_intrinsics(K, np.zeros((1, 5)), name, root_path=str(tmp_path))
    with pytest.raises(RuntimeError, match="no extrinsics for 'b'"):
        pconf.configure_cameras(camera_names={0: "a", 1: "b"}, project_dir=str(tmp_path),
                                device="cpu")
    with pytest.raises(RuntimeError, match="only 0 image"):
        pconf.calibrate_intrinsics_from_images([np.zeros((60, 80), np.uint8)], 4, 6,
                                               device="cpu")


# -------------------------------------------------------------------- capture


def test_live_capture_sources_match_jax(monkeypatch):
    rng = np.random.default_rng(3)
    board = _board_frame()
    frames = {0: [board, _noise_frame(rng), board, board, _noise_frame(rng), board],
              1: [board, board, _noise_frame(rng), board, board, board]}
    got = {}
    for side, acq in (("jax", jacq), ("port", pacq)):
        FakeCapture.frames_by_device = frames
        mono = acq.LiveCaptureSource({"a": 0}, n_frames=3, cooldown_s=0.0, rows=ROWS,
                                     columns=COLS, require_checkerboard=True,
                                     capture_factory=FakeCapture)("a")
        pairs = acq.LiveStereoCaptureSource({"a": 0, "b": 1}, rows=ROWS, columns=COLS,
                                            n_pairs=2, cooldown_s=0.0,
                                            capture_factory=FakeCapture)("a", "b")
        with pytest.raises(RuntimeError) as err:
            acq.LiveCaptureSource({"a": 0}, n_frames=10, cooldown_s=0.0,
                                  capture_factory=FakeCapture)("a")
        got[side] = (mono, pairs, str(err.value))
    assert got["port"][2] == got["jax"][2] and "6/10" in got["port"][2]
    assert len(got["port"][0]) == 3 and len(got["port"][1]) == 2
    for a, b in zip(got["port"][0], got["jax"][0]):
        np.testing.assert_array_equal(a, b)
    for (a0, a1), (b0, b1) in zip(got["port"][1], got["jax"][1]):
        np.testing.assert_array_equal(a0, b0)
        np.testing.assert_array_equal(a1, b1)
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    monkeypatch.setattr(plive, "_has_display", lambda: False)
    assert pacq.live_sync_frame_picker(["a.mp4", "b.mp4"], [12, 30]) == [12, 30]


def test_cpu_bf16_conv_does_not_depend_on_the_batch():
    import torch
    import torch.nn.functional as F

    from multi_camera_3d_pose_estimation_tpu_torch.models.hrnet import conv2d

    gen = torch.Generator().manual_seed(0)
    w = torch.randn(64, 32, 3, 3, generator=gen).to(torch.bfloat16)
    x = torch.randn(4, 32, 4, 2, generator=gen).to(torch.bfloat16)
    ref = F.conv2d(x.float(), w.float(), None, 2, 1)
    for B in (4, 24, 32, 64):
        xb = torch.cat([x, torch.zeros(B - 4, 32, 4, 2, dtype=torch.bfloat16)])
        y = conv2d(xb.contiguous(memory_format=torch.channels_last), w, 2, 1)[:4]
        assert y.dtype == torch.bfloat16
        # One bf16 step of the largest output (the fault is off by about 100%).
        torch.testing.assert_close(y.float(), ref, rtol=0, atol=2.0 ** -8 * ref.abs().max().item())


# ----------------------------------------------------------------------- sync


def test_audio_sync_matches_jax(tmp_path, monkeypatch):
    """Two 20-frame videos whose sidecar claps are 4 frames apart."""
    import multi_camera_3d_pose_estimation_tpu.sync.audio as jaudio
    import multi_camera_3d_pose_estimation_tpu_torch.sync.audio as paudio

    fps = 10.0
    out = {}
    for side, sync in (("jax", jsync), ("port", psync)):
        d = tmp_path / side
        d.mkdir()
        videos = [write_test_video(d / f"a{i}.mp4", n_frames=20, fps=fps) for i in range(2)]
        wavs = [write_test_wav(d / f"a{i}.wav", sr=8000, seconds=2.5, peak_at=p)
                for i, p in enumerate((1.0, 0.6))]
        idx = sync.compute_sync_frame_indices(videos, audio_paths=wavs)
        frames, outs = sync.synchronize_videos(videos, audio_paths=wavs, save_as_files=True)
        grid = sync.build_sync_inspection_grid(videos, idx[0], thumb_width=32)
        synced = [np.stack(list(jio.VideoReader(p, bgr=True))) for p in outs]
        out[side] = (idx, frames, [os.path.basename(p) for p in outs], grid, synced,
                     sync.decode_audio(wavs[0]), sync.get_loudest_point(wavs[1]))
    j, p = out["jax"], out["port"]
    assert p[0] == j[0] and p[0][0] == [10, 6]
    assert len(p[1]) == len(j[1]) == 10
    for fj, fp in zip(j[1], p[1]):
        for a, b in zip(fp, fj):
            np.testing.assert_array_equal(a, b)
    assert p[2] == j[2] == ["a0_synced.mp4", "a1_synced.mp4"]
    np.testing.assert_array_equal(p[3], j[3])
    for a, b in zip(p[4], j[4]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(p[5][0], j[5][0])  # both through libav
    assert p[5][1] == j[5][1] and p[6] == j[6] == 0.6
    # The standard library's .wav path, in both packages.
    monkeypatch.setattr(jaudio, "load_mediadec", lambda: None)
    monkeypatch.setattr(paudio, "load_mediadec", lambda: None)
    wav = str(tmp_path / "port" / "a0.wav")
    for a, b in zip(psync.decode_audio(wav, max_seconds=1.5), jsync.decode_audio(wav, 1.5)):
        np.testing.assert_array_equal(a, b)
    monkeypatch.undo()
    no_audio = write_test_video(tmp_path / "no_wav.mp4", n_frames=2)
    for sync in (psync, jsync):  # libav finds no audio stream, and it is not a .wav
        with pytest.raises(RuntimeError, match="no audio decoder available"):
            sync.decode_audio(no_audio)


# -------------------------------------------------------- record_and_estimate

N_CLIP, CH, CW = 6, 128, 160


@pytest.fixture(scope="module")
def clips_and_checkpoint(tmp_path_factory):
    root = tmp_path_factory.mktemp("rec")
    rng = np.random.default_rng(12)
    paths = []
    (root / "clips").mkdir()
    for name in ("left", "right"):
        p = str(root / "clips" / f"{name}_synced.mp4")
        vw = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"mp4v"), 15.0, (CW, CH))
        for _ in range(N_CLIP):
            vw.write(rng.integers(0, 256, (CH, CW, 3), dtype=np.uint8))
        vw.release()
        paths.append(p)
    spec = jreg.MODEL_REGISTRY["test_tiny"]
    in_w, in_h = spec["input_size"]
    ckpt = str(root / "test_tiny.npz")
    jreg.save_checkpoint_npz(
        random_variables(JHRNet(num_joints=17, cfg=spec["cfg"]), (1, in_h, in_w, 3), 0), ckpt)
    return root, paths, ckpt


def test_record_and_estimate_matches_jax(tmp_path, clips_and_checkpoint, monkeypatch):
    root, paths, ckpt = clips_and_checkpoint
    fast_flax_init(monkeypatch, JHRNet)  # the checkpoint overwrites every leaf
    K = np.array([[300.0, 0, CW / 2], [0, 300.0, CH / 2], [0, 0, 1]])
    out = {}
    for side, rec, extra in (("jax", jrec, {}), ("port", prec, {"device": "cpu"})):
        project = tmp_path / side
        for name in ("left", "right"):
            jio.save_camera_intrinsics(K, np.array([[-0.02, 0.01, 0, 0, 0]]), name,
                                       root_path=str(project))
        (project / "clips").mkdir()
        clips = []
        for p in paths:
            clips.append(str(project / "clips" / os.path.basename(p)))
            with open(p, "rb") as src, open(clips[-1], "wb") as dst:
                dst.write(src.read())
        out[side] = rec.record_and_estimate_pose(
            camera_names=["left", "right"], estimator_model="test_tiny", checkpoint=ckpt,
            recording_paths=clips, synchronize_video=False, project_dir=str(project),
            manual_measurements={"right": ([50.0, 0.0, 10.0], 3.0, 4.0)}, conf_threshold=-1.0,
            **extra)
    _hold_end_to_end_clips(out["jax"], out["port"])
    jax_files, port_files = tree_bytes(tmp_path / "jax"), tree_bytes(tmp_path / "port")
    assert sorted(port_files) == sorted(jax_files)
    for name, data in jax_files.items():
        if name.startswith(("configurations", "extrinsic", "intrinsic")):
            assert port_files[name] == data, name
    logs = {s: yaml.safe_load((tmp_path / s / "clips" / "recording_log.yaml").read_text())
            for s in ("jax", "port")}
    assert logs["port"].keys() == logs["jax"].keys()
    assert logs["port"]["estimator_model"] == "test_tiny"
    assert logs["port"]["kpts_3d"] == str(tmp_path / "port" / "clips" / "kpts_3d.npy")

    # The package's record_and_estimate command on a copy of the clips, with
    # the configuration above: the same arrays.
    project = tmp_path / "port"
    (project / "again").mkdir()
    again = []
    for p in paths:
        again.append(str(project / "again" / os.path.basename(p)))
        with open(p, "rb") as src, open(again[-1], "wb") as dst:
            dst.write(src.read())
    port_main.main(["record_and_estimate", "--camera_names", "left", "right",
                    "--estimator_model", "test_tiny", "--checkpoint", ckpt,
                    "--configuration_number", "0", "--recording_paths", *again,
                    "--project_dir", str(project), "--device", "cpu"])
    for key, arr in zip(("kpts_2d", "heatmaps_2d", "kpts_3d"), out["port"]):
        on_disk = np.load(project / "again" / f"{key}.npy")
        if key == "kpts_2d":  # the CLI's conf_threshold is the default 0.3
            np.testing.assert_array_equal(on_disk[..., 2, :], arr[..., 2, :])
        else:
            assert on_disk.shape == arr.shape
    assert (project / "again" / "recording_log.yaml").exists()


def _hold_end_to_end_clips(ref, out):
    """``tests/test_torch_port_cli.py::_hold_end_to_end`` at this clip length:
    equal shapes and float32 dtypes, confidences within 5e-2 of their
    largest, and kpts_3d (rtol 1e-3, atol 1e-2) wherever both sides decoded
    the same peak in every view (at least half the joints)."""
    for r, o in zip(ref, out):
        assert o.shape == r.shape and o.dtype == r.dtype == np.float32
    k2r, k2o = ref[0], out[0]
    assert k2o.shape == (N_CLIP, 17, 3, 2) and ref[1].shape == (N_CLIP, 2, 17, 6)
    assert np.isfinite(out[1]).all() and np.isfinite(k2o[:, :, 2]).all()
    conf_scale = np.abs(k2r[:, :, 2]).max()
    np.testing.assert_allclose(k2o[:, :, 2], k2r[:, :, 2], rtol=0, atol=5e-2 * conf_scale)
    same = (np.abs(k2o[:, :, :2] - k2r[:, :, :2]) < 1e-2).all(axis=2).all(axis=-1)
    assert same.mean() >= 0.5, same.mean()
    both = same & np.isfinite(out[2]).all(-1) & np.isfinite(ref[2]).all(-1)
    assert both.sum() >= 5
    np.testing.assert_allclose(out[2][both], ref[2][both], rtol=1e-3, atol=1e-2)
