"""The port's rank meshes and their collectives, against the JAX package's
meshes.

One gloo group of four CPU processes for the module (`run_ranks`): the 1-D
mesh, the 2x2 clip mesh (ranks node-major, rows clips-major, as JAX's
``P(("clips", "data"))``), the row helpers and their gradients, and
`run_clips_batched` on the 2x2 mesh against ``mesh=None`` at
``tests/test_parallel.py``'s limit (rtol 5e-4 / atol 1e-4).  Without a group:
the errors, and the one-rank group a single device starts by itself.
"""

import os
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

from multi_camera_3d_pose_estimation_tpu_torch.parallel import mesh as pm

from tests._torch_port_util import run_ranks

SMALL = {"widths": (8, 16, 32, 64), "modules": (1, 1, 1, 1), "stem": 16}


def _rank_main(rank, world, address, out_dir):
    from multi_camera_3d_pose_estimation_tpu_torch.entry import synthetic_rig
    from multi_camera_3d_pose_estimation_tpu_torch.models import TopDownEstimator
    from multi_camera_3d_pose_estimation_tpu_torch.models.registry import build_model
    from multi_camera_3d_pose_estimation_tpu_torch.parallel import (ShardedPosePipeline,
                                                                    run_clips_batched)

    pm.init_distributed(address, world, rank, device="cpu")
    res = {}
    flat = pm.make_mesh(device="cpu")
    res["flat"] = (tuple(flat.shape), flat.mesh_dim_names, tuple(flat.get_coordinate()))
    try:
        pm.make_mesh(64, device="cpu")
    except ValueError as e:
        res["need_64"] = str(e)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        part = pm.make_clip_mesh(1, 2, device="cpu")
    res["idle"] = [str(w.message) for w in caught]
    coord = part.get_coordinate()
    res["part_coordinate"] = None if coord is None else tuple(coord)
    try:
        pm.make_clip_mesh(3, 2, device="cpu")
    except ValueError as e:
        res["too_big"] = str(e)
    os.environ["LOCAL_WORLD_SIZE"] = "2"  # two nodes of two ranks, as torchrun says
    clip = pm.make_clip_mesh(device="cpu")
    res["clip"] = (tuple(clip.shape), clip.mesh_dim_names, tuple(clip.get_coordinate()),
                   clip.mesh.tolist())
    res["placements"] = (repr(pm.data_sharding(clip, 2)), repr(pm.data_sharding(clip, 2, "data")),
                         repr(pm.replicated(clip)))

    full = torch.arange(24, dtype=torch.float64).reshape(8, 3)
    weights = full + 1.0
    local = pm.local_rows(full, clip)
    res["local"], res["gathered"] = local, pm.gather_rows(local, clip)
    x = local.clone().requires_grad_(True)
    (pm.gather_rows(x, clip) * weights).sum().backward()
    res["gather_grad"] = x.grad
    y = local.clone().requires_grad_(True)
    (pm.all_reduce_sum(y, clip) * weights[:2]).sum().backward()
    res["reduced"], res["reduce_grad"] = pm.all_reduce_sum(local, clip), y.grad
    try:
        pm.local_rows(torch.zeros(6, 3), clip)
    except ValueError as e:
        res["uneven"] = str(e)
    t = torch.full((2,), float(rank))
    pm.broadcast_from_first([t], clip)
    res["broadcast"], res["first"] = t, pm.is_first_rank(clip)
    pm.mesh_barrier(clip)

    # tests/test_parallel.py's float32 SMALL HRNet.
    model = build_model("hrnet", SMALL, "cpu", seed=0, input_size=(32, 64), dtype=torch.float32)
    est = TopDownEstimator(model, input_size=(32, 64), device="cpu")
    rig = synthetic_rig(2, 64, 64)
    pipe = ShardedPosePipeline(est, rig, device="cpu")
    on_mesh = ShardedPosePipeline(est, rig, mesh=clip, device="cpu")
    clips = np.random.default_rng(5).uniform(size=(2, 4, 2, 64, 64, 3)).astype(np.float32)
    res["clips_mesh"] = {k: v.numpy() for k, v in
                         run_clips_batched(on_mesh, clips, split=False).items()}
    res["clips_none"] = {k: v.numpy() for k, v in
                         run_clips_batched(pipe, clips, split=False).items()}
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel_mesh")
    run_ranks(__file__, "_rank_main", 4, out)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(4)]


def test_mesh_creation(ranks):
    for r, res in enumerate(ranks):
        assert res["flat"] == ((4,), ("data",), (r,))


def test_mesh_too_many_devices(ranks):
    assert "need 64 devices, have 4" in ranks[0]["need_64"]
    # Without a process group: one device, and no group is started.
    with pytest.raises(ValueError, match="need 64 devices, have 1"):
        pm.make_mesh(64, device="cpu")
    assert not dist.is_initialized()


def test_clip_mesh_is_node_major(ranks):
    for r, res in enumerate(ranks):
        assert res["clip"] == ((2, 2), ("clips", "data"), (r // 2, r % 2), [[0, 1], [2, 3]])
        assert "too_big" in res and "needs 6 devices, have 4" in res["too_big"]
        assert res["idle"] == ["make_clip_mesh 1x2 uses only 2 of 4 devices; "
                               "2 chips will sit idle"]
        assert res["part_coordinate"] == ((0, r) if r < 2 else None)
    assert ranks[0]["placements"] == ("(Shard(dim=0), Shard(dim=0))",
                                      "(Replicate(), Shard(dim=0))",
                                      "(Replicate(), Replicate())")


def test_rows_are_clips_major_and_gather_back(ranks):
    full = torch.arange(24, dtype=torch.float64).reshape(8, 3)
    weights = full + 1.0
    for r, res in enumerate(ranks):
        # Rank (i, j) holds block i * 2 + j, as JAX's P(("clips", "data")) lays it out.
        assert torch.equal(res["local"], full[2 * r:2 * r + 2])
        assert torch.equal(res["gathered"], full)
        # Every rank's loss is the same function of the gathered rows, so the
        # backward sums four equal gradients.
        assert torch.equal(res["gather_grad"], 4 * weights[2 * r:2 * r + 2])
        assert torch.equal(res["reduced"], sum(full[2 * i:2 * i + 2] for i in range(4)))
        assert torch.equal(res["reduce_grad"], 4 * weights[:2])
        assert torch.equal(res["broadcast"], torch.zeros(2))
        assert res["first"] == (r == 0)


def test_uneven_rows_raise_like_jax(ranks):
    """A leading axis the mesh does not divide: ``jax.jit`` with
    ``in_shardings`` raises ``ValueError``, and so does the port."""
    import jax

    from multi_camera_3d_pose_estimation_tpu.parallel import data_sharding, make_mesh

    mesh = make_mesh(8)
    with pytest.raises(ValueError, match="divisible"):
        jax.jit(lambda x: x.sum(), in_shardings=data_sharding(mesh, 2))(np.zeros((6, 3)))
    assert "divisible by 4" in ranks[0]["uneven"]


def test_run_clips_batched_on_the_clip_mesh(ranks):
    for res in ranks:
        assert res["clips_mesh"]["kpts_3d"].shape == (2, 4, 17, 3)
        for k, ref in res["clips_none"].items():
            tol = 1e-4 if k != "kpts_3d" else 2e-5 * np.nanmax(np.abs(ref))
            np.testing.assert_allclose(res["clips_mesh"][k], ref, rtol=5e-4, atol=tol,
                                       equal_nan=True, err_msg=k)
            np.testing.assert_array_equal(res["clips_mesh"][k], ranks[0]["clips_mesh"][k])


def test_one_device_needs_no_launcher():
    """``make_mesh(1)`` with no group starts a one-rank group by itself; the
    pipeline on it equals ``mesh=None`` bit for bit."""
    from multi_camera_3d_pose_estimation_tpu_torch.entry import build_pipeline
    from multi_camera_3d_pose_estimation_tpu_torch.parallel import ShardedPosePipeline

    assert not dist.is_initialized()
    try:
        mesh = pm.make_mesh(1, device="cpu")
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        assert tuple(mesh.shape) == (1,) and pm.is_first_rank(mesh)
        pipe = build_pipeline(SMALL, (32, 64), (2, 2, 64, 64, 3), device="cpu")
        frames = np.random.default_rng(0).integers(0, 256, (2, 2, 64, 64, 3), dtype=np.uint8)
        a = ShardedPosePipeline(pipe.estimator, pipe.cam_stack, mesh=mesh, device="cpu").run(frames)
        b = pipe.run(frames)
        for k in a:
            np.testing.assert_array_equal(a[k].numpy(), b[k].numpy())
        with pytest.raises(ValueError, match="runs gloo"):
            pm.make_mesh(1, device="cuda")
    finally:
        dist.destroy_process_group()


def test_no_quiet_cpu_path_for_a_cuda_mesh():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pm.init_distributed("127.0.0.1:1", 1, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pm.make_mesh(1)
    with pytest.raises(ValueError, match="together"):
        pm.init_distributed("127.0.0.1:1", device="cpu")
    assert not dist.is_initialized()


def test_a_mesh_must_be_a_device_mesh():
    with pytest.raises(TypeError, match="DeviceMesh"):
        pm.check_mesh(object(), "cpu")
    pm.check_mesh(None, "cpu")
