"""Command dispatcher of the port.

    python -m multi_camera_3d_pose_estimation_tpu_torch <command> [args...]

Commands:
  convert               load an MMPose .pth checkpoint (--out: the .npz format;
                        --verify: the per-stage drill; ``--device cuda`` by
                        default, ``--device cpu``)
  refine                linear interpolation / SGD refinement CLI
                        (``--device cuda`` by default, ``--device cpu``)
  train                 train a 2D model on COCO-format keypoints
                        (``--device cuda`` by default, ``--device cpu``)

The JAX package's other commands (record_and_estimate, plot, doctor) are
not ported yet: they print so and exit with code 2.
"""

from __future__ import annotations

import importlib
import sys

_COMMANDS = {"convert": "multi_camera_3d_pose_estimation_tpu_torch.cli.convert",
             "refine": "multi_camera_3d_pose_estimation_tpu_torch.cli.refine",
             "train": "multi_camera_3d_pose_estimation_tpu_torch.cli.train"}
_NOT_PORTED = ("record_and_estimate", "plot", "doctor")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        raise SystemExit(0)
    if argv[0] not in _COMMANDS:
        print(__doc__)
        what = "is not ported yet" if argv[0] in _NOT_PORTED else "is not a command"
        print(f"error: {argv[0]!r} {what}", file=sys.stderr)
        raise SystemExit(2)
    importlib.import_module(_COMMANDS[argv[0]]).main(argv[1:])


if __name__ == "__main__":
    main()
