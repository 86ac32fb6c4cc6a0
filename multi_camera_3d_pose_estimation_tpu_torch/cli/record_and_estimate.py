"""Main orchestrator: calibrate → record → sync → estimate → manifest.

Counterpart of the JAX package's ``cli/record_and_estimate.py``, with
``device=`` (``--device``, the card unless the caller asks for the CPU)
passed to `configure_cameras` and `estimate_pose_from_video`.  Flag and
behaviour parity with `record_and_estimate_pose`
(record_and_estimate_pose.py:12-84): numbered recordings folder, optional
pre-recorded ``--recording_paths``, audio sync with original-file cleanup,
end-to-end estimation, and the `recording_log.yaml` manifest schema
(:41-52).  The interactive "press Enter" gate is a ``wait_for_user``
callback (None = start immediately) so the orchestrator runs headless.
"""

from __future__ import annotations

import argparse
import os

from ..acquisition import record_from_cameras
from ..io.manifest import create_new_numbered_folder, write_recording_log
from ..sync import synchronize_videos
from .configure import configure_cameras
from .estimate import estimate_pose_from_video

__all__ = ["record_and_estimate_pose", "main"]


def record_and_estimate_pose(
    camera_names,
    estimator_model: str = "coco_hrnet_w32",
    detector_model: str = "full_frame",
    configuration_number=None,
    recording_paths=None,
    synchronize_video: bool = True,
    model_yaml: str = "./model_paths.yaml",
    calibration_settings_yaml: str = "./calibration_settings.yaml",
    checkerboard_display_parameter_yaml: str = "./checkerboard_display_parameters.yaml",
    origin_camera_idx: int = 0,
    project_dir: str = "",
    recording_length_seconds: float = 10,
    keep_unsynced_files: bool = False,
    checkpoint: str | None = None,
    detector_checkpoint: str | None = None,
    conf_threshold: float = 0.3,
    decode_mode: str = "default",
    flip_test: bool = False,
    triangulation: str = "top2",
    wait_for_user=None,
    device="cuda",
    **configure_kwargs,
):
    """Configure (unless ``configuration_number`` is given), record (unless
    ``recording_paths`` are given), synchronize and estimate; write
    ``recording_log.yaml`` beside the recordings.  Returns ``(kpts_2d,
    heatmaps_2d, kpts_3d)``; extra keywords go to `configure_cameras`."""
    project_dir = project_dir or os.getcwd()
    if isinstance(camera_names, (list, tuple)):
        camera_names = {i: n for i, n in enumerate(camera_names)}

    if configuration_number is None:
        origin = list(camera_names.values())[origin_camera_idx]
        configuration_number = configure_cameras(
            camera_names,
            calibration_settings_yaml if os.path.exists(calibration_settings_yaml) else None,
            project_dir=project_dir,
            origin_camera=origin,
            checkerboard_display_parameter_yaml=(
                checkerboard_display_parameter_yaml
                if os.path.exists(checkerboard_display_parameter_yaml)
                else None
            ),
            device=device,
            **configure_kwargs,
        )
    configuration_dir = os.path.join(project_dir, "configurations", str(configuration_number))

    if recording_paths is None:
        if wait_for_user is not None:
            wait_for_user(
                "Press Enter to begin recording. Remember to create a loud "
                "noise for the synchronization point."
            )
        run_folder = os.path.join(configuration_dir, "recordings")
        record_id = create_new_numbered_folder(run_folder)
        recordings_folder = os.path.join(run_folder, str(record_id))
        recording_paths = record_from_cameras(
            recordings_folder, camera_names, recording_time=recording_length_seconds
        )
    else:
        recordings_folder = os.path.dirname(str(recording_paths[0]))

    if synchronize_video:
        _, recording_paths = synchronize_videos(
            recording_paths, delete_originals=not keep_unsynced_files
        )

    kpts_2d, heatmaps, kpts_3d = estimate_pose_from_video(
        recording_paths,
        project_dir=project_dir,
        camera_names=list(camera_names.values()),
        pose_estimation_model=estimator_model,
        checkpoint=checkpoint,
        detector_model=detector_model,
        detector_checkpoint=detector_checkpoint,
        save_dir=recordings_folder,
        conf_threshold=conf_threshold,
        triangulation=triangulation,
        estimator_kwargs={"decode_mode": decode_mode, "flip_test": flip_test},
        # The reference's layout: per-configuration extrinsics
        # (record_and_estimate_pose.py:38 passes the configuration dir).
        extrinsic_params_dir=os.path.join(
            configuration_dir, "extrinsic_camera_parameters"
        ),
        device=device,
    )

    log_path = write_recording_log(
        recordings_folder, recording_paths, estimator_model, detector_model
    )
    print(f"wrote {log_path}")
    return kpts_2d, heatmaps, kpts_3d


def main(argv=None):
    p = argparse.ArgumentParser(description="Record and estimate 3D pose")
    p.add_argument("--camera_names", nargs="+", required=True)
    p.add_argument("--estimator_model")
    p.add_argument("--detector_model")
    p.add_argument("--configuration_number", type=int)
    p.add_argument("--recording_paths", nargs="*")
    p.add_argument("--synchronize_video", action="store_true")
    p.add_argument("--model_yaml")
    p.add_argument("--calibration_settings_yaml")
    p.add_argument("--checkerboard_display_parameter_yaml")
    p.add_argument("--origin_camera_idx", type=int)
    p.add_argument("--project_dir")
    p.add_argument("--recording_length_seconds", type=int)
    p.add_argument("--keep_unsynced_files", action="store_true")
    p.add_argument("--checkpoint")
    p.add_argument("--detector_checkpoint")
    p.add_argument("--decode_mode", choices=["default", "dark"])
    p.add_argument("--triangulation", choices=["top2", "nview"],
                   help="3D lift: reference top-2-view parity (default) or "
                        "robust confidence-weighted all-view DLT")
    p.add_argument("--flip_test", action="store_true", default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    # Drop Nones so the function defaults win (reference :81-84).
    kwargs = {k: v for k, v in vars(args).items() if v is not None}
    record_and_estimate_pose(**kwargs)


if __name__ == "__main__":
    main()
