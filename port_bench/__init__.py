"""The benchmark of ``multi_camera_3d_pose_estimation_tpu_torch``, the
PyTorch/CUDA port, on an NVIDIA H100: the estimate step streamed through
``cli.estimate.run_pipeline_on_blocks``, judged against a plain PyTorch
reference (``port_bench.reference``).  Run one cell with

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Cells, configurations, traffic mixes, limits
and per-layer metrics are files found by the names in ``BENCHMARK.json``
(`catalog`).
"""
