"""Refinement CLI, as the JAX package's ``cli/refine.py``: the same flags,
the ``recording_log.yaml`` backfill, the ``refinement_params_yaml`` sections
(``linear_interpolation:`` / ``SGD:``) merged over the introspected defaults
(`io.prepare_kwargs`), the same artifacts (``kpts_3d_linear_interpolation.npy``,
``kpts_3d_SGD.npy``) and printed report, on the port's
`refine.linear_interpolation` and `refine.PoseRefiner`; plus ``--device``
(default ``cuda``).  PyYAML is imported only where a YAML file is read.

    python -m multi_camera_3d_pose_estimation_tpu_torch refine --run_path RUN \\
        --refinement_types linear_interpolation SGD --device cuda
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..io.camera_params import get_params_from_name
from ..io.config import load_config, prepare_kwargs
from ..io.manifest import load_camera_names
from ..refine import PoseRefiner, linear_interpolation
from ..utils.skeleton import get_body_part_lengths

__all__ = ["build_parser", "main", "run_refinement"]


def build_parser():
    p = argparse.ArgumentParser(description="Refine estimated 3D pose trajectories")
    p.add_argument("--run_path", type=str, default=".",
                   help="Path containing heatmaps, 3D pose, and recording log")
    p.add_argument("--refinement_types", nargs="+", default=["linear_interpolation"],
                   choices=["linear_interpolation", "SGD"])
    p.add_argument("--recording_log", type=str)
    p.add_argument("--heatmaps_2d", type=str)
    p.add_argument("--kpts_2d", type=str)
    p.add_argument("--kpts_3d", type=str)
    p.add_argument("--model", type=str)
    p.add_argument("--save_path", type=str)
    p.add_argument("--extrinsic_params_dir", type=str)
    p.add_argument("--intrinsic_params_dir", type=str)
    p.add_argument("--refinement_params_yaml", type=str)
    p.add_argument("--body_part_lengths_yaml", type=str)
    p.add_argument("--body_part_lengths_individual_name_yaml", type=str, default="my_lengths")
    p.add_argument("--ignore_body_lengths", action="store_true")
    p.add_argument("--interpolate_before_SGD", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="device of the interpolation and the refinement (cuda or cpu)")
    return p


def _report_body_lengths(label: str, trajectory: np.ndarray) -> None:
    print(f"mean and std of {label} body part lengths")
    for name, vals in get_body_part_lengths(torch.as_tensor(trajectory)).items():
        v = vals.numpy()
        print("; ".join([name, str(np.nanmean(v)), str(np.nanstd(v))]))


def _report_gate(gate_weights) -> None:
    """Per-window auto-gate report: the noise-floor auto-gate
    (`refine.RefineConfig.auto_gate`, on by default) freezes windows whose
    initial trajectory already sits below the 2D noise floor, a deviation
    from the reference objective, so the CLI always prints the tally and how
    to turn it off."""
    if gate_weights is None:
        return
    gw = np.asarray(gate_weights)
    n_frozen = int((gw == 0).sum())
    print(f"auto-gate report: {n_frozen}/{gw.size} windows frozen at the 2D "
          f"noise floor (frozen windows keep their initial trajectory)")
    if n_frozen:
        print(f"auto-gate frozen window indices: {np.flatnonzero(gw == 0).tolist()}")
        print("NOTE: the noise-floor auto-gate deviates from the reference "
              "SGD objective; set `auto_gate: false` under `SGD:` in "
              "--refinement_params_yaml for exact reference behavior.")


def run_refinement(args) -> dict:
    run_path = args.run_path or "."
    save_path = args.save_path or run_path

    # Paths the flags leave out come from the run's recording_log.yaml.
    log_path = args.recording_log or os.path.join(run_path, "recording_log.yaml")
    log = load_config(log_path) if os.path.exists(log_path) else {}
    for key in ("heatmaps_2d", "kpts_2d", "kpts_3d"):
        if getattr(args, key) is None and key in log:
            setattr(args, key, log[key])

    kpts_3d = np.load(args.kpts_3d)
    params = load_config(args.refinement_params_yaml)
    results = {}

    # Linear interpolation always runs (it is also the SGD start with
    # --interpolate_before_SGD).
    li_kwargs = prepare_kwargs(linear_interpolation, params.get("linear_interpolation"))
    li_kwargs.pop("points", None)
    li_kwargs["device"] = args.device
    kpts_3d_interp = linear_interpolation(kpts_3d, **li_kwargs).cpu().numpy()
    if "linear_interpolation" in args.refinement_types:
        out = os.path.join(save_path, "kpts_3d_linear_interpolation.npy")
        print(f"saving linear interpolation at {out}")
        np.save(out, kpts_3d_interp)
        results["linear_interpolation"] = kpts_3d_interp

    if "SGD" in args.refinement_types:
        heatmaps = np.load(args.heatmaps_2d)
        extr_dir = args.extrinsic_params_dir or os.path.normpath(
            os.path.join(run_path, "..", "..", "extrinsic_camera_parameters"))
        intr_dir = args.intrinsic_params_dir or os.path.join(
            os.getcwd(), "intrinsic_camera_parameters")
        cameras, _origin = load_camera_names(extr_dir)
        cam_params = {}
        for idx in sorted(cameras):
            _P, plist = get_params_from_name(cameras[idx], intrinsic_params_dir=intr_dir,
                                             extrinsic_params_dir=extr_dir)
            cam_params[idx] = plist

        body_lengths = None
        if not args.ignore_body_lengths:
            bl_yaml = args.body_part_lengths_yaml
            if bl_yaml is None and os.path.exists("./body_part_lengths.yaml"):
                bl_yaml = "./body_part_lengths.yaml"
            if bl_yaml is not None:
                body_lengths = load_config(bl_yaml)[args.body_part_lengths_individual_name_yaml]

        init = kpts_3d_interp if args.interpolate_before_SGD else kpts_3d
        refiner = PoseRefiner(heatmaps, init, cam_params, body_lengths=body_lengths,
                              device=args.device)
        sgd_kwargs = dict(params.get("SGD") or {})
        time_interval = tuple(sgd_kwargs.pop("time_interval", (0, -1)))
        res = refiner.sgd_optimize(time_interval=time_interval, **sgd_kwargs)

        _report_body_lengths("initial trajectory's", init)
        _report_body_lengths("estimated trajectory's", res.trajectory)
        _report_gate(res.gate_weights)

        out = os.path.join(save_path, "kpts_3d_SGD.npy")
        print(f"saving SGD refinement at {out} ({res.n_iter} epochs, "
              f"best cost {res.best_total_cost:.4e})")
        np.save(out, res.trajectory)
        results["SGD"] = res.trajectory
        results["SGD_result"] = res
    return results


def main(argv=None):
    run_refinement(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
