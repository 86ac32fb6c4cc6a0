"""Accuracy from trained weights: the harness as a command.

Trains the CenterNet detector and a 2D pose model on synthetic COCO-17
scenes, deploys both in the block pipeline (detector -> crop -> model ->
flip-TTA + DARK decode -> top-2 triangulation) and prints the errors
against the scene's geometry oracle as JSON (3-D errors in the scene's
units, cm).

    python -m multi_camera_3d_pose_estimation_tpu_torch.examples.accuracy_harness \\
        [--pose_steps 2500] [--det_steps 400] [--device cpu]

The flags are those of the JAX package's ``examples/accuracy_harness.py``,
with ``--device`` (default ``cuda``) in place of ``--cpu``.
"""

from __future__ import annotations

import argparse
import json


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pose_steps", type=int, default=2500)
    p.add_argument("--det_steps", type=int, default=400)
    p.add_argument("--frames", type=int, default=48)
    p.add_argument("--cams", type=int, default=2)
    p.add_argument("--family", choices=("heatmap", "simcc"), default="heatmap",
                   help="2D model family: HRNet heatmaps or RTMPose-t SimCC")
    p.add_argument("--model", default=None,
                   help="registry model name (e.g. test_small_192x256, coco_hrnet_w32)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--out", default=None, help="optional JSON output path")
    p.add_argument("--distortion", action="store_true",
                   help="the rig with the default 5-coefficient lens distortion")
    p.add_argument("--hard", action="store_true",
                   help="hard domain: clutter, occluders, scale variation, distractor person")
    p.add_argument("--det_select", choices=("top1", "consistent"), default="top1",
                   help="box selection: top-1, or top-k with the cross-view and "
                        "temporal consistency re-pick")
    p.add_argument("--sgd", action="store_true",
                   help="refine the pipeline's output with the MLE SGD refinement and "
                        "report mpjpe_3d_sgd")
    p.add_argument("--sgd_max_iter", type=int, default=3000)
    p.add_argument("--sgd_variants", default=None,
                   help="JSON dict of named RefineConfig overrides run on the same "
                        'pipeline output, e.g. \'{"no_priors": {"lambda_smooth": 0.0, '
                        '"lambda_body_length": 0.0}}\'')
    p.add_argument("--schedule", choices=("auto", "cosine", "constant"), default="auto",
                   help="the trainers' lr schedule; 'auto' picks warmup+cosine for big "
                        "models and constant for small ones")
    p.add_argument("--workdir", default=None,
                   help="checkpoint directory of the trainers (a run resumes from it); "
                        "'<out>.ckpt' when --out is given, 'none' to disable")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    workdir = args.workdir
    if workdir is None and args.out:
        workdir = args.out + ".ckpt"
    if workdir == "none":
        workdir = None

    from ..training import run_accuracy_harness

    metrics = run_accuracy_harness(
        n_frames=args.frames, det_steps=args.det_steps, pose_steps=args.pose_steps,
        n_cams=args.cams, pose_family=args.family, pose_model_name=args.model,
        distortion=True if args.distortion else None, hard=args.hard, sgd_refine=args.sgd,
        sgd_kwargs={"max_iter": args.sgd_max_iter},
        sgd_variants=json.loads(args.sgd_variants) if args.sgd_variants else None,
        schedule=args.schedule, workdir=workdir, det_select=args.det_select,
        device=args.device)
    print(json.dumps(metrics, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(metrics, f, indent=1)
    return metrics


if __name__ == "__main__":
    main()
