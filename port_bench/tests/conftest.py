"""Shared set-up of the benchmark's own tests: the repository root on the
path, and the test-sized benchmark under ``data/`` (a ``BENCHMARK.json``
with two small cells, their configurations, traffic and limits), put
together with the benchmark's metric readers and reference modules in a
directory of its own."""

import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
DATA = os.path.join(HERE, "data")


def tiny_root(path) -> str:
    """The test-sized benchmark under ``path``: ``data/``, the metric
    readers of ``port_bench/metrics`` and the family and pipeline modules
    of ``port_bench/reference``."""
    shutil.copytree(DATA, path, dirs_exist_ok=True)
    for part in ("metrics", "reference"):
        shutil.copytree(os.path.join(ROOT, "port_bench", part),
                        os.path.join(path, "port_bench", part), dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    return str(path)


@pytest.fixture
def tiny_catalog(tmp_path):
    from port_bench.catalog import Catalog

    return Catalog(tiny_root(tmp_path / "root"))


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.fixture
def one_thread():
    """One CPU thread: the convolutions' sums in one order, and a CPU run
    that keeps its pace beside other test processes (threads oversubscribed
    across processes stall each other's blocks past a few-second window)."""
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)
