"""Train-CLI convergence on a generated COCO dataset.

Writes a synthetic COCO person_keypoints set (JSON and PNG images), trains
a registry model on it through the train command, loads the checkpoint by
registry name and prints, as JSON, the held-out pixel error of the trained
weights beside random init's and whether it beat ``--px_threshold`` (the
exit code is 1 when it did not).

    python -m multi_camera_3d_pose_estimation_tpu_torch.examples.train_synthetic_coco \\
        [--steps 3000] [--model test_small_128] [--device cpu]

The flags are those of the JAX package's ``examples/train_synthetic_coco.py``,
with ``--device`` (default ``cuda``) in place of ``--cpu``; it trains in
bfloat16 on the card and in float32 on the CPU, as that script chooses.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np


def held_out_set(n_eval: int = 32, width: int = 256, height: int = 256, seed: int = 7):
    """Freshly rendered held-out poses of `make_scaled_scene` seed ``seed``:
    (frames (n_eval, height, width, 3) uint8, person boxes (n_eval, 4),
    projected joints (n_eval, 17, 2))."""
    from ..training.synthetic import make_scaled_scene, person_bbox, project_oracle, render_frame

    scene = make_scaled_scene(width, height, seed=seed)
    K, R, T, _ = scene.cams[0]
    frames, boxes, projs = [], [], []
    for _ in range(n_eval):
        proj = project_oracle(scene.sample_pose(), K, R, T)
        frames.append(render_frame(proj, width, height, scene.rng))
        boxes.append(person_bbox(proj, width, height))
        projs.append(proj)
    return np.stack(frames), np.stack(boxes), np.stack(projs)


def evaluate_px_error(est, n_eval: int = 32, width: int = 256, height: int = 256,
                      seed: int = 7) -> float:
    """Mean pixel error of ``est`` (a `TopDownEstimator`) on `held_out_set`."""
    frames, boxes, projs = held_out_set(n_eval, width, height, seed)
    out = est.predict_batch(frames, boxes)
    pred = out["keypoints"][..., :2].double().cpu().numpy()
    return float(np.linalg.norm(pred - projs, axis=-1).mean())


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--model", default="test_small_128")
    p.add_argument("--images", type=int, default=256, help="dataset size")
    p.add_argument("--size", type=int, default=256, help="frame width=height")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--px_threshold", type=float, default=6.0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--out", default=None, help="optional JSON output path")
    return p


def train_checkpoint(args, workdir: str) -> tuple[str, float]:
    """Write the dataset under ``workdir`` and train on it through the train
    command; returns (the checkpoint's path, the training's seconds)."""
    from ..cli.train import main as train_main
    from ..training.synthetic import write_coco_dataset

    ann, imgs = write_coco_dataset(workdir, n_images=args.images, width=args.size,
                                   height=args.size)
    ckpt = os.path.join(workdir, "model.npz")
    t0 = time.time()
    train_main([
        "--annotations", ann, "--images", imgs, "--model", args.model,
        "--steps", str(args.steps), "--batch_size", str(args.batch_size),
        "--learning_rate", str(args.learning_rate), "--out", ckpt,
        "--checkpoint_every", "0", "--log_every", "200",
        "--image_size", str(args.size), str(args.size),
        "--dtype", "float32" if args.device == "cpu" else "bfloat16",
        "--device", args.device,
    ])
    return ckpt, time.time() - t0


def score(args, ckpt: str, train_s: float) -> dict:
    """The result dict: ``ckpt``'s held-out pixel error beside random init's."""
    from ..models.registry import build_estimator

    trained = build_estimator(args.model, checkpoint=ckpt, device=args.device)
    random_init = build_estimator(args.model, seed=3, device=args.device)
    px_trained = evaluate_px_error(trained, width=args.size, height=args.size)
    px_random = evaluate_px_error(random_init, width=args.size, height=args.size)
    return {
        "px_err_trained": round(px_trained, 3),
        "px_err_random_init": round(px_random, 3),
        "px_threshold": args.px_threshold,
        "passed": px_trained < args.px_threshold,
        "steps": args.steps,
        "model": args.model,
        "train_wall_s": round(train_s, 1),
    }


def run(args) -> dict:
    """Write the dataset, train, evaluate; returns the result dict."""
    with tempfile.TemporaryDirectory() as td:
        return score(args, *train_checkpoint(args, td))


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    result = run(args)
    print(json.dumps(result, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    if not result["passed"]:
        raise SystemExit(1)
    return result


if __name__ == "__main__":
    main()
