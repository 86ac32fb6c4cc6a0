"""The JAX package's accuracy drills, runnable with ``python -m``.

- `accuracy_harness`: train the detector and a 2D model on synthetic
  scenes, deploy both in the block pipeline, print pixel and 3-D errors;
- `train_synthetic_coco`: the train CLI on a generated COCO set, held-out
  pixel error against random init;
- `synthetic_demo`: a 2-camera rig's videos through the estimate and
  refine commands, with the 3-D error after each stage.

Each runs on the card unless given ``--device cpu``.
"""
