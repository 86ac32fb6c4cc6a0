"""Run one cell of the benchmark and print its result as the last line of
standard output (a JSON object), the numbers compared for ``correct`` with
their limits as the last lines of standard error.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``port_bench/``
and the program.  Exits non-zero, printing no result, without enough CUDA
devices for the cell or if the process loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _caches() -> None:
    """Kernel caches inside the checkout, at fixed paths."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        path = os.path.join(ROOT, ".bench_cache", sub)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    _caches()
    import torch

    from port_bench.catalog import Catalog
    from port_bench.harness import forbidden_modules, run_cell

    cat = Catalog(ROOT)
    chips = cat.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"port_bench: {args.workload} needs {chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 2
    result = run_cell(cat, args.workload, args.seed, args.seconds, bool(args.trace),
                      device="cuda", t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"port_bench: the process holds {found}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
