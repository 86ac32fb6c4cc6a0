"""Shared set-up of the benchmark's own tests: the repository root on the
path, and the test-sized benchmark under ``data/`` (a ``BENCHMARK.json``
with two small cells, their configurations, traffic and limits), put
together with the benchmark's metric readers in a directory of its own."""

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
    """The test-sized benchmark under ``path``: ``data/`` and the metric
    readers of ``port_bench/metrics``."""
    shutil.copytree(DATA, path, dirs_exist_ok=True)
    shutil.copytree(os.path.join(ROOT, "port_bench", "metrics"),
                    os.path.join(path, "port_bench", "metrics"), dirs_exist_ok=True)
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
