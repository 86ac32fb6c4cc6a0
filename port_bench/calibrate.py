"""The readings that a cell's limits for ``correct`` are set from: the
program on many seeds and the controls (the reference one precision step
below the configuration's: `reference.lowp.CONTROL` in every stage,
`reference.lowp.MODEL_CONTROL` in the 2D model's alone) on a few, at the
cell's own sizes, in one process.

    python3 port_bench/calibrate.py --workload <name> --seeds 1,2,... \\
        --control-seeds 1,2,3 --model-control-seeds 1,2,3 [--cycles 2] \\
        [--out <file.jsonl>]

Each program seed builds the pipeline as the benchmark does and runs
``cycles`` rounds of the cell's distinct blocks through the same loop
(`cli.estimate.run_pipeline_on_blocks` over `io.stage_blocks`), then judges
them (`judge`); each control seed judges that control's outputs for the
same blocks.  One JSON line per reading, with the spread of the reference
maps' peaks and the share of joints over the confidence gate.
"""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ints(text: str) -> list:
    return [int(v) for v in text.split(",") if v]


def readings(cell, side: str, cycles: int = 2) -> dict:
    """The judged numbers of ``side`` ("program": the pipeline through the
    timed path's loop over ``cycles`` rounds of the cell's blocks;
    "control" / "model_control": `reference.lowp.CONTROL` /
    `reference.lowp.MODEL_CONTROL` on the same blocks) of a
    `harness.Cell`."""
    import numpy as np
    import torch

    from multi_camera_3d_pose_estimation_tpu_torch.cli.estimate import run_pipeline_on_blocks
    from multi_camera_3d_pose_estimation_tpu_torch.io.frames import stage_blocks
    from port_bench.reference import CONTROL, MODEL_CONTROL
    from port_bench.traffic import cycle_blocks

    refs = cell.references()
    n_src = len(cell.host)
    if side == "program":
        pipeline = cell.pipeline()
        outputs = run_pipeline_on_blocks(
            pipeline, stage_blocks(cycle_blocks(cell.host, n_src * cycles), cell.device),
            progress=False, inflight=cell.traffic["inflight"])
        n_blocks = n_src * cycles
        del pipeline
    else:
        ctrl = cell.references({"control": CONTROL, "model_control": MODEL_CONTROL}[side])
        outputs = tuple(np.concatenate([r[k].cpu().numpy() for r in ctrl])
                        for k in ("kpts_2d", "heatmaps_2d", "kpts_3d"))
        n_blocks = n_src
        del ctrl
    gc.collect()
    if torch.device(cell.device).type == "cuda":
        torch.cuda.empty_cache()
    numbers = cell.judge(outputs, n_blocks, refs)["numbers"]
    score = torch.cat([r["score"].flatten() for r in refs]).float().cpu()
    numbers["peak_q05_q50_q95"] = [float(v) for v in torch.quantile(
        score, torch.tensor([0.05, 0.5, 0.95]))]
    numbers["over_gate"] = float((score > cell.cfg["conf_threshold"]).double().mean())
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--model-control-seeds", type=_ints, default=[])
    ap.add_argument("--cycles", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from port_bench.catalog import Catalog
    from port_bench.harness import Cell

    cat = Catalog(ROOT)
    out = open(args.out, "a") if args.out else None
    try:
        sides = (("program", args.seeds), ("control", args.control_seeds),
                 ("model_control", args.model_control_seeds))
        for seed in sorted(set().union(*(seeds for _, seeds in sides))):
            cell = Cell(cat, args.workload, seed, args.device)
            for side, seeds in sides:
                if seed in seeds:
                    t = time.perf_counter()
                    row = {"workload": args.workload, "seed": seed, "side": side,
                           **readings(cell, side, args.cycles),
                           "seconds": time.perf_counter() - t}
                    print(json.dumps(row), flush=True)
                    if out:
                        out.write(json.dumps(row) + "\n")
                        out.flush()
            del cell
            gc.collect()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
