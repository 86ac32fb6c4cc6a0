"""``convert``: bring an MMPose ``.pth`` checkpoint into the port, and check it.

Counterpart of the JAX package's ``cli/convert.py``, with its arguments
and exit codes, plus ``--device``:

    python -m multi_camera_3d_pose_estimation_tpu_torch convert ckpt.pth \\
        --model coco_hrnet_w32 --out ckpt.npz
    python -m multi_camera_3d_pose_estimation_tpu_torch convert ckpt.pth \\
        --model coco_swin-b --verify --device cpu

The checkpoint is loaded through the family's strict name map
(`models.convert`: a missing or leftover key or a shape mismatch aborts).
``--out`` writes the JAX package's ``.npz`` checkpoint, which both
packages' ``build_estimator(checkpoint=...)`` read.  ``--verify`` runs the
import drill (`models.checkpoint_verify`): the same state dict in the
independent MMPose mirror, both forwards compared stage by stage; exit
status 1 unless every stage passes.  A family without a converter exits
with status 2.  ``--device`` (cuda by default, or cpu) is where the models
are built and the drill runs.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(prog="convert", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("checkpoint", help="torch .pth checkpoint path")
    p.add_argument("--model", default="coco_hrnet_w32",
                   help="registry model name the checkpoint targets (sets family/cfg/input size)")
    p.add_argument("--num_joints", type=int, default=17)
    p.add_argument("--out", default=None,
                   help="write the converted weights as the JAX package's .npz checkpoint, "
                        "loadable by build_estimator(checkpoint=...)")
    p.add_argument("--verify", action="store_true",
                   help="run the per-stage mirror agreement drill and print the divergence "
                        "report")
    p.add_argument("--device", type=str, default="cuda",
                   help="device of the models and the drill (cuda or cpu)")
    args = p.parse_args(argv)

    import torch

    from ..models.convert import TORCH_LOADERS, flax_leaves, save_checkpoint_npz
    from ..models.registry import MODEL_REGISTRY, new_model, resolve_model_name

    spec = MODEL_REGISTRY[resolve_model_name(args.model)]
    family, cfg, input_size = spec["family"], spec["cfg"], spec["input_size"]

    if args.verify:
        from ..models.checkpoint_verify import format_report, verify_checkpoint

        report = verify_checkpoint(args.checkpoint, family, cfg=cfg, num_joints=args.num_joints,
                                   input_size=input_size, device=args.device)
        print(format_report(report))
        if not report["ok"]:
            raise SystemExit(1)
        if not args.out:
            return

    if family not in ("hrnet", "rtmpose", "swin"):
        print(f"no converter for family '{family}'", file=sys.stderr)
        raise SystemExit(2)
    model = new_model(family, cfg, args.device, input_size, args.num_joints, torch.float32,
                      swin_attention=False)
    TORCH_LOADERS[family](model, args.checkpoint, cfg)
    if args.out:
        save_checkpoint_npz(model, args.out, family)
        print(f"converted checkpoint written to {args.out}")
    else:
        sd = model.state_dict()
        n = sum(sd[key].numel() for _, key, _ in flax_leaves(model, family))
        print(f"conversion OK ({n} values); pass --out to save")


if __name__ == "__main__":
    main()
