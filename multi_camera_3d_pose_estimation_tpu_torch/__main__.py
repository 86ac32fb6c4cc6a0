"""Command dispatcher of the port.

    python -m multi_camera_3d_pose_estimation_tpu_torch <command> [args...]

Commands (the JAX package's six):
  record_and_estimate   calibrate -> record -> sync -> estimate
                        (``--device cuda`` by default, ``--device cpu``)
  refine                linear interpolation / SGD refinement CLI
                        (``--device cuda`` by default, ``--device cpu``)
  plot                  heatmap / 3D-pose animations (host; matplotlib)
  train                 train a 2D model on COCO-format keypoints
                        (``--device cuda`` by default, ``--device cpu``)
  convert               load an MMPose .pth checkpoint (--out: the .npz format;
                        --verify: the per-stage drill; ``--device cuda`` by
                        default, ``--device cpu``)
  doctor                environment health check (imports, the libav media
                        runtime, a 4-rank gloo CPU mesh, a bounded probe of the
                        card and its kernel libraries)
"""

from __future__ import annotations

import importlib
import sys

_COMMANDS = {"record_and_estimate":
             "multi_camera_3d_pose_estimation_tpu_torch.cli.record_and_estimate",
             "refine": "multi_camera_3d_pose_estimation_tpu_torch.cli.refine",
             "plot": "multi_camera_3d_pose_estimation_tpu_torch.cli.plot",
             "train": "multi_camera_3d_pose_estimation_tpu_torch.cli.train",
             "convert": "multi_camera_3d_pose_estimation_tpu_torch.cli.convert",
             "doctor": "multi_camera_3d_pose_estimation_tpu_torch.cli.doctor"}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        raise SystemExit(0)
    if argv[0] not in _COMMANDS:
        print(__doc__)
        print(f"error: unknown command {argv[0]!r}", file=sys.stderr)
        raise SystemExit(2)
    importlib.import_module(_COMMANDS[argv[0]]).main(argv[1:])


if __name__ == "__main__":
    main()
