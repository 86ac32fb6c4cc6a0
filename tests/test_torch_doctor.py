"""The port's ``doctor`` against the JAX package's, on this CPU machine.

- ``python -m multi_camera_3d_pose_estimation_tpu_torch doctor --no_device``
  in a subprocess (its own timeout): every row ok, the 4-rank gloo mesh
  included, exit 0, the JAX package's report layout;
- the exit rule, both packages on the same faults: the media runtime
  missing fails (exit 1, the JAX package's row text); without a card the
  device probe fails, which is advisory unless ``--require_device``;
- a device probe or a rank that hangs is killed at its timeout and
  reported.
"""

import os
import subprocess
import sys

import pytest
import torch

from multi_camera_3d_pose_estimation_tpu.cli import doctor as jdoctor
from multi_camera_3d_pose_estimation_tpu_torch.cli import doctor as pdoctor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_doctor_without_device_is_healthy_here():
    pytest.importorskip("cv2")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-m", "multi_camera_3d_pose_estimation_tpu_torch",
                           "doctor", "--no_device"], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "doctor: healthy"
    names = [ln.split("  ")[0].strip() for ln in lines[:-1]]
    assert names == ["import torch", "import numpy", "import cv2", "import yaml",
                     "native mediadec", "4-rank gloo CPU mesh"]
    width = max(len(n) for n in names)
    for ln, name in zip(lines, names):  # the JAX layout: name padded, status in 4, detail
        assert ln[:width] == name.ljust(width) and ln[width + 2:width + 6] == "ok  "
    assert "all_reduce_sum over the ranks" in lines[5]


def _main(mod, argv, capsys):
    with pytest.raises(SystemExit) as exc:
        mod.main(argv)
    return exc.value.code, capsys.readouterr().out


@pytest.fixture
def quick_mesh(monkeypatch):
    """The mesh rows stubbed ok (the real ones run above and below)."""
    monkeypatch.setattr(jdoctor, "_check_cpu_mesh", lambda report: (
        report.append(("virtual 4-device CPU mesh", "ok", "stub")), True)[1])
    monkeypatch.setattr(pdoctor, "_check_cpu_mesh", lambda report: (
        report.append(("4-rank gloo CPU mesh", "ok", "stub")), True)[1])


def test_missing_media_runtime_fails_as_in_jax(monkeypatch, capsys, quick_mesh):
    from multi_camera_3d_pose_estimation_tpu import native as jnative
    from multi_camera_3d_pose_estimation_tpu_torch import native as pnative

    monkeypatch.setattr(jnative, "load_mediadec", lambda: None)
    monkeypatch.setattr(pnative, "load_mediadec", lambda: None)
    out = {}
    for side, mod in (("jax", jdoctor), ("port", pdoctor)):
        code, text = _main(mod, ["--no_device"], capsys)
        assert code == 1 and text.strip().endswith("doctor: PROBLEMS FOUND"), text
        out[side] = [ln for ln in text.splitlines() if ln.startswith("native mediadec")][0]
    assert out["port"].split() == out["jax"].split()
    assert "FAIL  libmediadec.so unavailable (build or libav missing)" in out["port"]


def test_device_probe_without_a_card(capsys, quick_mesh):
    """No CUDA here: the device row fails, advisory by default (exit 0),
    fatal with --require_device (exit 1)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: this test is for a machine without one")
    code, text = _main(pdoctor, ["--probe_timeout", "120"], capsys)
    row = [ln for ln in text.splitlines() if ln.startswith("device backend")][0]
    assert code == 0 and "FAIL  torch.cuda.is_available() is False" in row, text
    assert "kernel libraries" not in text and text.strip().endswith("doctor: healthy")
    code, text = _main(pdoctor, ["--require_device", "--probe_timeout", "120"], capsys)
    assert code == 1 and text.strip().endswith("doctor: PROBLEMS FOUND"), text


def test_hung_probe_and_ranks_are_killed_at_their_timeout(monkeypatch):
    monkeypatch.setattr(pdoctor, "_PROBE", "import time; time.sleep(60)")
    report = []
    assert pdoctor._probe_device(report, 2.0) is False
    assert report == [("device backend", "FAIL",
                       "no answer after 2s: CUDA hung or card unavailable")]
    monkeypatch.setattr(pdoctor, "_RANK", "import time; time.sleep(60)")
    report = []
    assert pdoctor._check_cpu_mesh(report, n_ranks=2, timeout_s=3.0) is False
    assert report == [("2-rank gloo CPU mesh", "FAIL", "timed out after 3s")]
    monkeypatch.setattr(pdoctor, "_RANK", "raise SystemExit('rank failed')")
    report = []
    assert pdoctor._check_cpu_mesh(report, n_ranks=2, timeout_s=30.0) is False
    assert report == [("2-rank gloo CPU mesh", "FAIL", "rank failed")]
