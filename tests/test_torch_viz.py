"""The port's ``viz``, plot CLI and live preview against the JAX package's.

Figures are held pixel for pixel: frame k of an animation drawn by both
packages from the same inputs (the port's given tensors, the JAX
package's numpy arrays) gives the same Agg RGBA buffer; the plot CLI's
GIFs are the same bytes.  The live preview's JPEGs, written by the port's
`estimate_pose_from_video(live_preview_dir=...)` on test_tiny, are the
bytes the JAX package's `make_preview_writer` writes for the same frames
and keypoints.  Videos are ``tests/test_media.py``'s mp4v files, decoded
by both packages' libav readers (cv2 where the library is missing).
"""

import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
yaml = pytest.importorskip("yaml")
pytest.importorskip("matplotlib")

import matplotlib.pyplot as plt  # noqa: E402

from multi_camera_3d_pose_estimation_tpu import viz as jviz  # noqa: E402
from multi_camera_3d_pose_estimation_tpu.cli import plot as jplot  # noqa: E402
from multi_camera_3d_pose_estimation_tpu.io import frames as jframes  # noqa: E402
from multi_camera_3d_pose_estimation_tpu_torch import __main__ as port_main  # noqa: E402
from multi_camera_3d_pose_estimation_tpu_torch import viz as pviz  # noqa: E402
from multi_camera_3d_pose_estimation_tpu_torch.cli import plot as pplot  # noqa: E402
from multi_camera_3d_pose_estimation_tpu_torch.cli.estimate import (  # noqa: E402
    estimate_pose_from_video)

from tests.test_media import write_test_video  # noqa: E402

T = 5


def rgba(ani, k):
    """Frame k of ``ani`` drawn on its Agg canvas: the RGBA buffer."""
    seq = ani.new_frame_seq()
    for _ in range(k):
        next(seq)
    ani._draw_frame(next(seq))
    ani._fig.canvas.draw()
    return np.asarray(ani._fig.canvas.buffer_rgba()).copy()


def same_frames(make, ks=(0, 3)):
    """``make(side)`` -> an animation, for side "jax" and "port": frame k of
    each the same RGBA buffer."""
    for k in ks:
        a, b = make("jax"), make("port")
        try:
            ra, rb = rgba(a, k), rgba(b, k)
            assert ra.shape == rb.shape and ra.dtype == np.uint8
            np.testing.assert_array_equal(ra, rb)
        finally:
            plt.close(a._fig)
            plt.close(b._fig)
    return ra


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    rng = np.random.default_rng(0)
    d = tmp_path_factory.mktemp("viz")
    paths = [write_test_video(d / f"cam{c}.mp4", n_frames=T + 2) for c in range(2)]
    t = np.linspace(0, 1, T)[:, None, None]
    traj = rng.normal(0, 20, (1, 17, 3)) + 30 * t * np.array([1.0, -0.5, 0.25])
    traj[1, 4] = np.nan  # a missing joint vanishes from the plot
    kpts = np.concatenate([rng.uniform(5, 60, (T, 17, 2, 2)),
                           rng.uniform(0, 1, (T, 17, 1, 2))], axis=2)
    heat = np.zeros((T, 2, 17, 6))
    heat[..., :2] = rng.uniform(5, 60, (T, 2, 17, 2))
    heat[..., 2] = heat[..., 5] = rng.uniform(2, 9, (T, 2, 17))
    heat[..., 3] = heat[..., 4] = rng.uniform(-1, 1, (T, 2, 17))
    heat[2, 0, 3, 2:] = [1.0, 2.0, 2.0, 1.0]  # not positive definite: skipped
    return d, paths, traj, kpts, heat


def arg(side, x):
    return torch.from_numpy(np.array(x)) if side == "port" else x


def viz(side):
    return pviz if side == "port" else jviz


def test_calculate_plot_lims_match_jax(scene):
    _, _, traj, kpts, _ = scene
    for x in (traj.reshape(-1, 3), kpts[..., :2, 0].reshape(-1, 2)):
        assert pviz.calculate_plot_lims(torch.from_numpy(x)) == jviz.calculate_plot_lims(x)
        assert (pviz.calculate_plot_lims(x, homogeneous_lims=False, iqr_margin=0.2)
                == jviz.calculate_plot_lims(x, homogeneous_lims=False, iqr_margin=0.2))


def test_visualize_3d_frames_match_jax(scene):
    _, paths, traj, _, _ = scene
    metric = np.linspace(0, 1, T)
    same_frames(lambda s: viz(s).visualize_3d(arg(s, traj), additional_metrics=[arg(s, metric)],
                                              additional_metric_names=["speed"],
                                              recording_paths=paths, plane_views=("xy", "zx")))


def test_heatmap_animation_frames_match_jax(scene):
    _, paths, _, _, heat = scene
    img = same_frames(lambda s: viz(s).heatmap_animation(arg(s, heat), paths), ks=(0, 2))
    assert (img[..., :3] < 250).any()  # something was drawn


def test_visualize_2d_and_other_animations_match_jax(scene):
    _, paths, traj, kpts, heat = scene
    same_frames(lambda s: viz(s).visualize_2d(arg(s, kpts)))
    same_frames(lambda s: viz(s).interactive_3d_pose_animation(arg(s, traj)), ks=(1,))
    frames = [[np.full((48, 64, 3), 40 * t, np.uint8)] * 2 for t in range(T)]
    same_frames(lambda s: viz(s).create_heatmap_animation(arg(s, heat), frames), ks=(2,))
    same_frames(lambda s: viz(s).animate_trackpoints(arg(s, kpts[..., 0]), paths[0],
                                                     labels=["nose", "", "ear"]), ks=(1,))


def _log(d, paths, traj, heat, side):
    out = d / side
    out.mkdir(exist_ok=True)
    np.save(out / "kpts_3d.npy", traj)
    np.save(out / "heatmaps_2d.npy", heat)
    log = {"kpts_3d": str(out / "kpts_3d.npy"), "heatmaps_2d": str(out / "heatmaps_2d.npy"),
           "recording_paths": list(paths), "estimator_model": "coco_hrnet_w32"}
    with open(out / "recording_log.yaml", "w") as f:
        yaml.safe_dump(log, f)
    return out


def test_run_plots_matches_jax(scene, capsys):
    """The plot CLI backfilled from recording_log.yaml: the same frames and
    the same GIF bytes; through the port's ``plot`` command too."""
    d, paths, traj, _, heat = scene
    anis = {}
    for side, mod in (("jax", jplot), ("port", pplot)):
        out = _log(d, paths, traj[:3], heat[:3], side)
        args = mod.build_parser().parse_args(["--recording_log", str(out / "recording_log.yaml"),
                                              "--plot_types", "heatmap", "3D_pose", "--fps", "4"])
        anis[side] = mod.run_plots(args)
    assert list(anis["port"]) == list(anis["jax"]) == ["heatmap", "3D_pose"]
    for kind in ("heatmap", "3D_pose"):
        a, b = (open(d / side / f"{kind}.gif", "rb").read() for side in ("jax", "port"))
        assert a == b and a[:3] == b"GIF"
        for side in ("jax", "port"):
            plt.close(anis[side][kind]._fig)
    said = capsys.readouterr().out
    assert f"saving animation 3D_pose at path {d / 'port' / '3D_pose.gif'}" in said
    os.remove(d / "port" / "heatmap.gif")
    port_main.main(["plot", "--recording_log", str(d / "port" / "recording_log.yaml"),
                    "--save_path", str(d / "port" / "cli"), "--fps", "4"])
    assert open(d / "port" / "cli_heatmap.gif", "rb").read() == \
        open(d / "jax" / "heatmap.gif", "rb").read()
    plt.close("all")
    with pytest.raises(ValueError, match="is invalid"):
        pplot.run_plots(pplot.build_parser().parse_args(
            ["--recording_log", str(d / "port" / "recording_log.yaml"), "--plot_types", "x"]))


def test_preview_writer_matches_jax(scene, tmp_path):
    """The same frames and keypoints (tensors for the port) give the same
    JPEG bytes; a wild keypoint and a NaN are clipped or skipped alike."""
    _, _, _, kpts, _ = scene
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (T, 2, 48, 64, 3), dtype=np.uint8)
    kp = kpts.copy()
    kp[1, 3, :2, 0] = [1e9, -1e9]
    kp[1, 5, 0, 1] = np.nan
    for side, mod in (("jax", jviz), ("port", pviz)):
        hook = mod.make_preview_writer(save_dir=str(tmp_path / side), every=2)
        hook(arg(side, frames), arg(side, kp), 10)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert names == [f"preview_{10 + t:06d}_cam{c}.jpg" for t in (0, 2, 4) for c in (0, 1)]
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes()


def test_live_preview_of_the_estimate_cli_matches_jax(tmp_path):
    """``estimate_pose_from_video(live_preview_dir=...)`` on test_tiny: the
    JPEGs the JAX package's writer draws for the same decoded frames and
    the port's kpts_2d artifact, byte for byte."""
    from tests.test_torch_port_cli import H, W, _write_cameras

    _write_cameras(tmp_path, 2)
    rng = np.random.default_rng(2)
    paths = []
    for c in range(2):
        p = str(tmp_path / f"cam{c}_synced.mp4")
        vw = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"mp4v"), 15.0, (W, H))
        for _ in range(7):
            vw.write(rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
        vw.release()
        paths.append(p)
    preview = tmp_path / "preview"
    kpts_2d, _, _ = estimate_pose_from_video(paths, project_dir=str(tmp_path),
                                             pose_estimation_model="test_tiny", block_size=3,
                                             save_dir=str(tmp_path / "out"),
                                             live_preview_dir=str(preview), device="cpu")
    want = tmp_path / "want"
    hook = jviz.make_preview_writer(save_dir=str(want))
    src = jframes.BatchedFramePipeline(paths, block_size=3, stage_to_device=False)
    offset = 0
    for block, n in src:
        hook(block[:n], kpts_2d[offset:offset + n], offset)
        offset += n
    src.close()
    assert offset == 7
    names = sorted(os.listdir(preview))
    assert names == sorted(os.listdir(want)) == [f"preview_{t:06d}_cam{c}.jpg"
                                                 for t in (0, 3, 6) for c in (0, 1)]
    for n in names:
        assert (preview / n).read_bytes() == (want / n).read_bytes()
