"""Training of the 2D models (heatmap, SimCC, detector) on the card.

Counterpart of the JAX package's ``training`` subsystem: target rendering,
losses, augmentation, the train step with its optimizer and the JAX
package's TrainState files, the COCO batcher, the synthetic scenes and the
train -> deploy accuracy harness.
"""

from .augment import (apply_flip_pose, draw_flip_mask, flip_permutation, random_affine_params,
                      random_flip_pose)
from .data import KeypointBatcher, make_crop_batch, parse_coco_keypoints
from .harness import (run_accuracy_harness, train_synthetic_detector, train_synthetic_pose,
                      train_synthetic_simcc)
from .loop import (ClipAdamW, TrainState, adam, build_train_model, make_train_step,
                   warmup_cosine_decay_schedule)
from .losses import centernet_focal_loss, heatmap_mse_loss, simcc_kl_loss
from .synthetic import (SyntheticSceneConfig, coco17_pose, make_rig, make_scaled_scene,
                        project_oracle, write_coco_dataset)
from .targets import render_centernet_targets, render_heatmap_targets, render_simcc_targets

__all__ = [
    "ClipAdamW",
    "KeypointBatcher",
    "SyntheticSceneConfig",
    "TrainState",
    "adam",
    "apply_flip_pose",
    "build_train_model",
    "centernet_focal_loss",
    "coco17_pose",
    "draw_flip_mask",
    "flip_permutation",
    "heatmap_mse_loss",
    "make_crop_batch",
    "make_rig",
    "make_scaled_scene",
    "make_train_step",
    "parse_coco_keypoints",
    "project_oracle",
    "random_affine_params",
    "random_flip_pose",
    "render_centernet_targets",
    "render_heatmap_targets",
    "render_simcc_targets",
    "run_accuracy_harness",
    "simcc_kl_loss",
    "train_synthetic_detector",
    "train_synthetic_pose",
    "train_synthetic_simcc",
    "warmup_cosine_decay_schedule",
    "write_coco_dataset",
]
