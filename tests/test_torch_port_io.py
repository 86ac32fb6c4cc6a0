"""The port's camera, manifest and config IO against the JAX package's.

Files written by one side are read by the other, and the files the two
write from the same inputs are byte for byte equal.  Camera parameters and
projection matrices are held at 1e-12 (float64 on both sides).
"""

import os

import numpy as np
import pytest

from multi_camera_3d_pose_estimation_tpu import io as jio
from multi_camera_3d_pose_estimation_tpu_torch import io as pio
from multi_camera_3d_pose_estimation_tpu_torch.refine import linear_interpolation


def _camera(c):
    th = np.deg2rad(-12.0 + 9.5 * c)
    K = np.array([[512.25 + c, 0, 320.5], [0, 511.75, 240.125], [0, 0, 1]])
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]])
    T = np.array([[25.0 * c - 10.0], [0.5], [3.0 * c + 0.25]])
    dist = np.array([[-0.1 + 0.01 * c, 0.02, 1e-3, -2e-4, 0.0]])
    return K, R, T, dist


def _write(side, root, names):
    for c, name in enumerate(names):
        K, R, T, dist = _camera(c)
        side.save_camera_intrinsics(K, dist, name, root_path=str(root))
        side.save_extrinsic_calibration_parameters(R, T, name, root_dir=str(root))
    side.save_camera_names(dict(enumerate(names)), names[0], str(root))


def _files(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def test_camera_files_are_byte_equal_and_cross_read(tmp_path):
    names = ["left", "right", "top"]
    _write(jio, tmp_path / "jax", names)
    _write(pio, tmp_path / "port", names)
    a, b = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(a) == sorted(b) and len(a) == 2 * len(names) + 1
    assert all(a[k] == b[k] for k in a)
    for reader, root in ((pio, tmp_path / "jax"), (jio, tmp_path / "port")):
        assert reader.load_camera_names(str(root / "extrinsic_camera_parameters")) == (
            dict(enumerate(names)), "left")
        for c, name in enumerate(names):
            K, R, T, dist = _camera(c)
            k, d = reader.read_camera_parameters(name, str(root / "intrinsic_camera_parameters"))
            r, t = reader.read_rotation_translation(name, str(root / "extrinsic_camera_parameters"))
            for got, want in ((k, K), (d, dist), (r, R), (t, T)):
                assert got.shape == want.shape
                np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_params_from_name_and_stack_match_jax(tmp_path):
    names = ["left", "right", "top"]
    _write(jio, tmp_path, names)
    intr, extr = str(tmp_path / "intrinsic_camera_parameters"), str(
        tmp_path / "extrinsic_camera_parameters")
    os.remove(os.path.join(extr, "rot_trans_top.dat"))  # a camera without extrinsics
    lists = {}
    for name in names + ["missing"]:
        (Pj, lj), (Pp, lp) = (side.get_params_from_name(name, intr, extr) for side in (jio, pio))
        assert [x is None for x in lj] == [x is None for x in lp]
        assert (Pj is None) == (Pp is None)
        if Pj is not None:
            assert Pp.dtype == np.float64 and Pp.shape == (3, 4)
            np.testing.assert_allclose(Pp, np.asarray(Pj), rtol=1e-12, atol=1e-12)
        for x, y in zip(lj, lp):
            if x is not None:
                np.testing.assert_array_equal(x, y)
        lists[name] = lp
    assert lists["missing"] == [None, None, None, None]
    assert lists["top"][1] is None and lists["top"][0] is not None
    cams = {i: lists[n] for i, n in enumerate(names[:2])}
    cams[2] = [lists["top"][0], np.eye(3), np.zeros(3), None]  # dist None -> zeros
    cams[3] = [lists["left"][0], np.eye(3), np.zeros((3, 1)), np.array([0.1, 0.2])]  # padded
    for arg in (cams, [cams[k] for k in sorted(cams)]):
        sj, sp = jio.stack_camera_params(arg), pio.stack_camera_params(arg)
        assert sorted(sj) == sorted(sp) == ["K", "R", "T", "dist"]
        for k in sj:
            assert sp[k].dtype == np.float64 and sp[k].shape == sj[k].shape
            np.testing.assert_allclose(sp[k], sj[k], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("user", [None, {"k": 7, "median_std": ".inf"},
                                  {"betas": [0.8, 0.99], "lr": ".inf", "other": 3}])
def test_prepare_kwargs_matches_jax(user):
    def fn(points, k=5, median_std=2.0, betas=(0.9, 0.999), lr=1e-3):
        return points

    for func in (fn, linear_interpolation):
        kj = jio.prepare_kwargs(func, dict(user) if user else user)
        kp = pio.prepare_kwargs(func, dict(user) if user else user)
        assert kj == kp
        assert pio.get_function_defaults(func) == jio.get_function_defaults(func)
    if user and "betas" in user:
        assert kp["betas"] == (0.8, 0.99) and kp["lr"] == np.inf


def test_config_and_recording_log_round_trip(tmp_path):
    yaml = pytest.importorskip("yaml")
    cfg = {"SGD": {"lr": 0.05, "betas": [0.9, 0.99]}, "linear_interpolation": {"k": 3}}
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    assert pio.load_config(str(path)) == jio.load_config(str(path)) == cfg
    assert pio.load_config(None) == {}
    paths = [tmp_path / "a.mp4", tmp_path / "b.mp4"]
    for side, sub in ((jio, "jax"), (pio, "port")):
        (tmp_path / sub).mkdir()
        side.write_recording_log(str(tmp_path / sub), paths, "test_tiny", "full_frame",
                                 extra={"note": 1})
    logs = {sub: (tmp_path / sub / "recording_log.yaml").read_text() for sub in ("jax", "port")}
    assert logs["jax"].replace("/jax/", "/port/") == logs["port"]
    for reader in (jio, pio):
        log = reader.read_recording_log(str(tmp_path / "port" / "recording_log.yaml"))
        assert log["recording_paths"] == [str(p) for p in paths]
        assert log["kpts_3d"] == str(tmp_path / "port" / "kpts_3d.npy") and log["note"] == 1


def test_numbered_folders_and_load_if_exists(tmp_path):
    for side, sub in ((jio, "jax"), (pio, "port")):
        base = str(tmp_path / sub)
        assert [side.create_new_numbered_folder(base) for _ in range(3)] == [0, 1, 2]
        os.makedirs(os.path.join(base, "7"))
        assert side.create_new_numbered_folder(base) == 8
    np.save(tmp_path / "x.npy", np.arange(4))
    np.testing.assert_array_equal(pio.load_if_exists(str(tmp_path / "x.npy")), np.arange(4))
    assert pio.load_if_exists(str(tmp_path / "y.npy")) is None and pio.load_if_exists("") is None
