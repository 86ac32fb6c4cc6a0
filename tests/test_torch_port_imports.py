"""The port imports neither JAX nor the JAX package.

Every module of the port is imported in a fresh interpreter in which
``import jax`` and ``import multi_camera_3d_pose_estimation_tpu`` fail; and
again, with ``chip_smoke.py``, where ``cv2``, ``yaml`` and ``tqdm`` fail too
(the card's machine may have none of them: the port imports them only
where a video, an image file, a YAML file or a progress bar is used); and
the training modules and the train CLI by name, the same way; and the
checkpoint modules (the ``.pth`` readers, the drill, the MMPose mirrors'
copy and the convert CLI) by name.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CODE = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["multi_camera_3d_pose_estimation_tpu"] = None
import multi_camera_3d_pose_estimation_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax")
                and sys.modules[m] is not None)
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", CODE], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) >= 15  # every module was imported


def test_chip_smoke_imports_without_jax():
    """chip_smoke.py's imports, minus the card: it must also stay JAX-free."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['multi_camera_3d_pose_estimation_tpu'] = None; "
            "import importlib.util as u; "
            "s = u.spec_from_file_location('chip_smoke', 'chip_smoke.py'); "
            "m = u.module_from_spec(s); s.loader.exec_module(m)")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_port_and_chip_smoke_import_without_optional_modules():
    code = CODE.replace('sys.modules["jax"] = None',
                        'sys.modules["jax"] = None\n'
                        'for m in ("cv2", "yaml", "tqdm"): sys.modules[m] = None')
    code += ("import importlib.util as u\n"
             "s = u.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
             "m = u.module_from_spec(s); s.loader.exec_module(m)\n"
             "assert all(sys.modules[k] is None for k in ('cv2', 'yaml', 'tqdm'))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) >= 45  # every module, the io and cli ones too


def test_training_and_train_cli_import_without_jax_or_optional_modules():
    """The training subsystem and the train CLI, named one by one: no JAX,
    no cv2 (a lazy import where an image is read or drawn), yaml or tqdm."""
    code = """
import importlib, sys
for m in ("jax", "multi_camera_3d_pose_estimation_tpu", "cv2", "yaml", "tqdm"):
    sys.modules[m] = None
port = "multi_camera_3d_pose_estimation_tpu_torch"
names = [f"{port}.training.{m}" for m in ("targets", "losses", "augment", "loop", "data",
                                          "synthetic", "harness")]
names += [f"{port}.training", f"{port}.cli.train", f"{port}.models.batchnorm"]
for name in names:
    importlib.import_module(name)
from multi_camera_3d_pose_estimation_tpu_torch.__main__ import _COMMANDS
assert "train" in _COMMANDS
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax")
                and sys.modules[m] is not None)
assert not leaked, leaked
print(len(names))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) == 10


def test_checkpoint_modules_and_convert_cli_import_without_jax_or_optional_modules():
    """The ``.pth`` readers, the drill, the mirrors' copy and the convert
    CLI, named one by one: no JAX, nothing of the JAX package (whose own
    mirrors import only torch, and are still not imported), no cv2, yaml or
    tqdm; ``convert`` is a command."""
    code = """
import importlib, sys
for m in ("jax", "multi_camera_3d_pose_estimation_tpu", "cv2", "yaml", "tqdm"):
    sys.modules[m] = None
port = "multi_camera_3d_pose_estimation_tpu_torch"
names = [f"{port}.models.{m}" for m in ("convert", "checkpoint_verify", "registry", "mirrors",
                                        "mirrors.hrnet", "mirrors.rtmpose", "mirrors.swin")]
names += [f"{port}.cli.convert"]
for name in names:
    importlib.import_module(name)
from multi_camera_3d_pose_estimation_tpu_torch.__main__ import _COMMANDS, _NOT_PORTED
assert "convert" in _COMMANDS and "convert" not in _NOT_PORTED
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax")
                and sys.modules[m] is not None)
leaked += sorted(m for m in sys.modules if m.startswith("multi_camera_3d_pose_estimation_tpu.")
                 and sys.modules[m] is not None)
assert not leaked, leaked
print(len(names))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) == 8
