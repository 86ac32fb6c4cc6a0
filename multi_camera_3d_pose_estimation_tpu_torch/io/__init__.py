"""Artifact-compatible IO of the port: camera parameters, manifests,
configs, frames, and the staging of frame blocks to the card."""

from .camera_params import (CameraParams, get_params_from_name, read_camera_parameters,
                            read_rotation_translation, save_camera_intrinsics,
                            save_extrinsic_calibration_parameters, stack_camera_params)
from .config import get_function_defaults, load_config, prepare_kwargs
from .frames import (BatchedFramePipeline, VideoReader, frame_generator, load_frames,
                     load_image_frames, stage_blocks, write_keypoints_to_disk)
from .manifest import (create_new_numbered_folder, load_camera_names, load_if_exists,
                       read_recording_log, save_camera_names, write_recording_log)

__all__ = [
    "save_camera_intrinsics",
    "read_camera_parameters",
    "save_extrinsic_calibration_parameters",
    "read_rotation_translation",
    "get_params_from_name",
    "CameraParams",
    "stack_camera_params",
    "create_new_numbered_folder",
    "load_if_exists",
    "write_recording_log",
    "read_recording_log",
    "save_camera_names",
    "load_camera_names",
    "load_config",
    "VideoReader",
    "frame_generator",
    "load_frames",
    "load_image_frames",
    "write_keypoints_to_disk",
    "BatchedFramePipeline",
    "stage_blocks",
    "get_function_defaults",
    "prepare_kwargs",
]
