"""The port imports neither JAX nor the JAX package.

Every module of the port is imported in a fresh interpreter in which
``import jax`` and ``import multi_camera_3d_pose_estimation_tpu`` fail; and
again, with ``chip_smoke.py``, where ``cv2``, ``yaml`` and ``tqdm`` fail too
(the card's machine may have none of them: the port imports them only
where a video, an image file, a YAML file or a progress bar is used); and
the training modules and the train CLI by name, the same way; and the
checkpoint modules (the ``.pth`` readers, the drill, the MMPose mirrors'
copy and the convert CLI) by name; and the mesh modules by name; and the
front end (calibration, capture, sync, the configure and record_and_estimate
CLIs) by name, with cv2 absent as on the card's machine; and the modules the
card's machine runs without matplotlib (doctor, profiling, keypoint
conversion, the media runtime's loader, the estimate CLI) by name, with
matplotlib and cv2 absent; and the accuracy drills (``examples``) by name,
with cv2, yaml and matplotlib absent and the repository's JAX ``examples``
blocked.
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
from multi_camera_3d_pose_estimation_tpu_torch.__main__ import _COMMANDS
assert "convert" in _COMMANDS
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


def test_parallel_modules_import_without_jax_or_optional_modules():
    """The rank meshes and the mesh paths, named one by one: no JAX, nothing
    of the JAX package, no cv2, yaml or tqdm; ``parallel`` exports the JAX
    package's eight names."""
    code = """
import importlib, sys
for m in ("jax", "multi_camera_3d_pose_estimation_tpu", "cv2", "yaml", "tqdm"):
    sys.modules[m] = None
port = "multi_camera_3d_pose_estimation_tpu_torch"
names = [f"{port}.parallel", f"{port}.parallel.mesh", f"{port}.parallel.pipeline"]
for name in names:
    importlib.import_module(name)
parallel = sys.modules[f"{port}.parallel"]
assert parallel.__all__ == ["make_mesh", "make_clip_mesh", "init_distributed", "data_sharding",
                            "replicated", "ShardedPosePipeline", "sharded_refine_step",
                            "run_clips_batched"], parallel.__all__
assert all(hasattr(parallel, n) for n in parallel.__all__)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax")
                and sys.modules[m] is not None)
assert not leaked, leaked
print(len(names))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) == 3


def test_front_end_modules_import_without_jax_or_cv2():
    """Calibration, capture, sync and the configure and record_and_estimate
    CLIs, named one by one: no JAX, nothing of the JAX package, no cv2 (the
    corner detector falls back to numpy), yaml or tqdm; ``calib`` exports the
    JAX package's 18 names; the dispatcher has the JAX package's six
    commands and no list of commands left to port."""
    code = """
import importlib, sys
for m in ("jax", "multi_camera_3d_pose_estimation_tpu", "cv2", "yaml", "tqdm"):
    sys.modules[m] = None
port = "multi_camera_3d_pose_estimation_tpu_torch"
names = [f"{port}.calib"] + [f"{port}.calib.{m}" for m in (
    "lm", "homography", "intrinsic", "pnp", "stereo", "manual", "checkerboard", "corners",
    "verify")]
names += [f"{port}.acquisition", f"{port}.acquisition.record", f"{port}.acquisition.live",
          f"{port}.sync", f"{port}.sync.audio", f"{port}.sync.videos", f"{port}.cli.configure",
          f"{port}.cli.record_and_estimate"]
for name in names:
    importlib.import_module(name)
calib = sys.modules[f"{port}.calib"]
assert len(calib.__all__) == 18 and all(hasattr(calib, n) for n in calib.__all__)
assert sys.modules[f"{port}.calib.corners"]._cv2 is None
from multi_camera_3d_pose_estimation_tpu_torch import __main__ as commands
assert "record_and_estimate" in commands._COMMANDS and not hasattr(commands, "_NOT_PORTED")
assert sorted(commands._COMMANDS) == ["convert", "doctor", "plot", "record_and_estimate",
                                      "refine", "train"]  # the JAX package's six
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
    assert int(proc.stdout.split()[-1]) == 18


def test_card_side_modules_import_without_matplotlib_or_cv2():
    """The card's machine has neither matplotlib nor cv2: doctor, profiling,
    keypoint conversion, the media runtime's loader and the estimate CLI
    import without them (and without JAX or the JAX package), and none of
    them imports ``viz``; the loader builds nothing on import."""
    code = """
import importlib, sys
for m in ("jax", "multi_camera_3d_pose_estimation_tpu", "cv2", "matplotlib"):
    sys.modules[m] = None
port = "multi_camera_3d_pose_estimation_tpu_torch"
names = [f"{port}.cli.doctor", f"{port}.utils.profiling", f"{port}.utils.keypoint_convert",
         f"{port}.utils", f"{port}.native", f"{port}.cli.estimate", f"{port}.cli"]
for name in names:
    importlib.import_module(name)
utils = sys.modules[f"{port}.utils"]
assert len(utils.__all__) == 12 and all(hasattr(utils, n) for n in utils.__all__)
assert sys.modules[f"{port}.native"]._tried is False  # nothing built or loaded on import
leaked = sorted(m for m in sys.modules if (m.split(".")[0] in ("jax", "jaxlib", "flax", "cv2",
                                                               "matplotlib")
                                           or m.startswith(f"{port}.viz")
                                           or m.startswith("multi_camera_3d_pose_estimation_tpu."))
                and sys.modules[m] is not None)
assert not leaked, leaked
print(len(names))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) == 7


def test_examples_import_without_jax_or_optional_modules():
    """The accuracy drills (`examples`), named one by one: no JAX, nothing of
    the JAX package (nor the repository's own ``examples/``, the JAX
    scripts), no cv2, yaml or matplotlib until a drill draws, writes or
    plots; each is a ``python -m`` command with its JAX script's flags
    and ``--device`` in place of ``--cpu``."""
    code = """
import importlib, sys
for m in ("jax", "multi_camera_3d_pose_estimation_tpu", "examples", "bench", "cv2", "yaml",
          "matplotlib"):
    sys.modules[m] = None
port = "multi_camera_3d_pose_estimation_tpu_torch"
names = [f"{port}.examples"] + [f"{port}.examples.{m}" for m in (
    "accuracy_harness", "train_synthetic_coco", "synthetic_demo")]
for name in names:
    importlib.import_module(name)
ex = sys.modules[f"{port}.examples.accuracy_harness"]
flags = {a.dest for a in ex.build_parser()._actions}
assert {"pose_steps", "det_steps", "frames", "cams", "family", "model", "device", "out",
        "distortion", "hard", "det_select", "sgd", "sgd_max_iter", "sgd_variants", "schedule",
        "workdir"} <= flags and "cpu" not in flags, flags
tr = sys.modules[f"{port}.examples.train_synthetic_coco"]
flags = {a.dest for a in tr.build_parser()._actions}
assert {"steps", "model", "images", "size", "batch_size", "learning_rate", "px_threshold",
        "device", "out"} <= flags and "cpu" not in flags, flags
assert ex.build_parser().parse_args([]).device == "cuda"
leaked = sorted(m for m in sys.modules if (m.split(".")[0] in ("jax", "jaxlib", "flax", "cv2",
                                                               "yaml", "matplotlib")
                                           or m.startswith("multi_camera_3d_pose_estimation_tpu."))
                and sys.modules[m] is not None)
assert not leaked, leaked
print(len(names))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) == 4
