"""Training CLI: COCO-format keypoints -> a trained 2D model checkpoint.

Counterpart of the JAX package's ``cli/train.py``, with its flags and
files, plus ``--device`` (``cuda`` unless ``cpu`` is asked for):

    python -m multi_camera_3d_pose_estimation_tpu_torch train \\
        --annotations ann.json --images imgs/ --model coco_hrnet_w32 \\
        --steps 20000 --out hrnet_w32.npz

``--out`` is the JAX package's inference ``.npz`` (both packages'
``build_estimator(checkpoint=)`` read it); ``<out>.train_state.npz`` is its
TrainState file, which ``--resume`` takes from either package.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Callable

import torch

from ..models.convert import save_checkpoint_npz
from ..training import (KeypointBatcher, TrainState, build_train_model, heatmap_mse_loss,
                        make_train_step, parse_coco_keypoints, simcc_kl_loss)

__all__ = ["main", "train_model", "build_parser", "build_trainer", "Trainer"]


def build_parser():
    p = argparse.ArgumentParser(description="Train a 2D pose model")
    p.add_argument("--annotations", required=True, help="COCO person_keypoints JSON")
    p.add_argument("--images", required=True, help="image directory")
    p.add_argument("--model", default="coco_hrnet_w32")
    p.add_argument("--steps", type=int, default=10000)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--learning_rate", type=float, default=5e-4)
    p.add_argument("--out", default="model_checkpoint.npz")
    p.add_argument("--resume", default=None, help="TrainState npz to resume from")
    p.add_argument("--checkpoint_every", type=int, default=1000)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no_augment", action="store_true")
    p.add_argument("--image_size", type=int, nargs=2, default=(512, 512), metavar=("W", "H"),
                   help="common decode size for source images (static batch shapes); match "
                        "the dataset resolution to avoid host-side resampling")
    p.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                   help="activation dtype (parameters stay float32)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


@dataclass
class Trainer:
    """What `build_trainer` makes: the model (random weights from the
    seed), its registry entry, the batcher's target kind, and
    `make_train_step`'s ``init_fn`` / ``step_fn``."""

    model: torch.nn.Module
    spec: dict
    target: str
    init_fn: Callable
    step_fn: Callable


def build_trainer(model_name: str = "coco_hrnet_w32", dtype: str = "bfloat16",
                  learning_rate: float = 5e-4, seed: int = 0, device="cuda") -> Trainer:
    """The train CLI's model, loss and step: heatmap MSE for the HRNet and
    Swin families (Swin on its plain attention), SimCC KL for RTMPose;
    clip 1.0 -> AdamW (weight decay 1e-4) at ``learning_rate``."""
    model, spec = build_train_model(model_name, getattr(torch, dtype), seed, device)
    if spec["family"] in ("hrnet", "swin"):
        def loss_fn(outputs, batch):
            return heatmap_mse_loss(outputs, batch["targets"], batch["weights"])

        target = "heatmap"
    else:
        def loss_fn(outputs, batch):
            px, py = outputs
            return simcc_kl_loss(px, py, batch["lx"], batch["ly"], batch["w"])

        target = "simcc"
    init_fn, step_fn = make_train_step(model, loss_fn, learning_rate=learning_rate)
    return Trainer(model, spec, target, init_fn, step_fn)


def train_model(args) -> TrainState:
    trainer = build_trainer(args.model, args.dtype, args.learning_rate, args.seed, args.device)
    records = parse_coco_keypoints(args.annotations, args.images)
    print(f"{len(records)} training instances")
    state = trainer.init_fn()
    if args.resume:
        state = TrainState.load(args.resume, state)
        print(f"resumed at step {state.step}")
    batcher = KeypointBatcher(records, batch_size=args.batch_size,
                              input_size=trainer.spec["input_size"],
                              image_size=tuple(args.image_size), target=trainer.target,
                              seed=args.seed, augment=not args.no_augment, device=args.device)
    state_path = args.out + ".train_state.npz"
    t0 = time.perf_counter()
    it = iter(batcher)
    try:
        while state.step < args.steps:
            state, loss = trainer.step_fn(state, next(it))
            if state.step % args.log_every == 0:
                rate = state.step / max(time.perf_counter() - t0, 1e-9)
                print(f"step {state.step}: loss {float(loss):.5f} ({rate:.1f} it/s)")
            if args.checkpoint_every and state.step % args.checkpoint_every == 0:
                state.save(state_path)
    finally:
        batcher.close()
    state.save(state_path)
    save_checkpoint_npz(state.model, args.out, state.family)
    print(f"saved inference checkpoint to {args.out} (train state: {state_path})")
    return state


def main(argv=None):
    train_model(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
