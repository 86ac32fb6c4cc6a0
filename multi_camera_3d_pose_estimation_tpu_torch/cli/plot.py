"""Plot CLI of the port: ``python -m multi_camera_3d_pose_estimation_tpu_torch plot``.

The JAX package's ``cli/plot.py`` (the reference's plot_utils.py:631-702
flag surface): ``--plot_types heatmap 3D_pose`` -> GIFs at ``--fps`` 10;
arguments not given are taken from ``--recording_log`` (the reference's
log merge, :662-664).  Needs matplotlib (`viz`) and PyYAML for the log.
Runs on the host: no device is used.
"""

from __future__ import annotations

import argparse
import os

from ..io.manifest import load_if_exists
from ..utils.skeleton import BODYPARTS
from ..viz import heatmap_animation, visualize_3d

__all__ = ["main", "run_plots"]


def build_parser():
    p = argparse.ArgumentParser(description="Create pose/heatmap animations")
    p.add_argument("--recording_log", type=str)
    p.add_argument("--heatmaps_2d", type=str)
    p.add_argument("--kpts_2d", type=str)
    p.add_argument("--kpts_3d", type=str)
    p.add_argument("--estimator_model", type=str)
    p.add_argument("--recording_paths", nargs="+")
    p.add_argument("--plot_types", nargs="+", default=None)
    p.add_argument("--save_plots", action="store_true", default=True)
    p.add_argument("--save_path", type=str)
    p.add_argument("--fps", type=int, default=10)
    return p


def run_plots(args) -> dict:
    if args.plot_types is None:
        args.plot_types = ["heatmap"]
    if args.save_path is None:
        args.save_path = (
            os.path.dirname(args.recording_log) if args.recording_log else os.getcwd()
        )

    log = {}
    if args.recording_log is not None:
        import yaml

        with open(args.recording_log) as f:
            log = yaml.safe_load(f) or {}
    for name, value in vars(args).items():
        if value is None and name in log:
            setattr(args, name, log[name])

    kpts_3d = load_if_exists(args.kpts_3d)
    heatmaps = load_if_exists(args.heatmaps_2d)

    anis = {}
    for plot_type in args.plot_types:
        if plot_type == "heatmap":
            anis[plot_type] = heatmap_animation(heatmaps, args.recording_paths)
        elif plot_type == "3D_pose":
            key = "coco" if "coco" in (args.estimator_model or "coco") else ""
            anis[plot_type] = visualize_3d(
                kpts_3d, BODYPARTS[key], recording_paths=args.recording_paths
            )
        else:
            raise ValueError(
                f'plot_type "{plot_type}" is invalid! Must be "heatmap" or "3D_pose"'
            )

    if args.save_plots:
        for plot_type, ani in anis.items():
            if os.path.isdir(args.save_path):
                out = os.path.join(args.save_path, f"{plot_type}.gif")
            else:
                out = args.save_path + f"_{plot_type}.gif"
            print(f"saving animation {plot_type} at path {out}")
            ani.save(out, fps=args.fps)
    return anis


def main(argv=None):
    run_plots(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
