"""The configurations that name no ``pipeline`` and no ``detector`` read what
they read before the families and the pipeline were found by file: the
values below were recorded with the reference's modules imported by name
(``_FAMILIES``, ``reference.pipeline``, ``judge``), one CPU thread, and
must come back bit for bit.

- test size (``data/``): the drawn state dict at two seeds, and for a cell
  at one seed the head's scale, the scaled state dict and the reference's
  ``run_block`` of each distinct block;
- every configuration, the two of ``BENCHMARK.json`` built on the meta
  device: the state dict's names and shapes, and ``flops_per_crop``
  (15.29 G for HRNet-W32, 37.92 G for Swin-B);
- the judge's ``NAMES`` and ``MEANS``.
"""

import hashlib

import pytest
import torch

from port_bench.catalog import Catalog
from port_bench.harness import Cell
from port_bench.reference import build_model
from port_bench.weights import draw_state_dict

from conftest import ROOT

SEED = 2 ** 31 + 7
NAMES = ("score_gap", "peak_gap", "peak_mean", "gauss_err", "gauss_mean", "tri_gap", "tri_mean")
MEANS = ("peak_mean", "gauss_mean", "tri_mean")
DRAWN = {
    "tiny_hrnet": {5: "d6df2f3c6603aa30870b991c32e4d288617f5c7dfbd19cc7f88017fcb9f30ce9",
                   2 ** 33 + 1: "81a0896682f3c873b3cad62404f6f5a08d3edbb7a8829c5a8051eeb22f4ffa8b"},
    "tiny_swin": {5: "16f474134fa7b4b637bf170cd9d20ff98ae4627623fb3d9eaa586721f6e6e1a3",
                  2 ** 33 + 1: "f169ccbeaf3a8f00ec00dcde8ac658a129f4bd36345cc5c60c1dd49e58148e91"},
}
CELLS = {
    "tiny_hrnet_cell": {
        "head_scale": 0.03447423128200653,
        "state": "88d691625880749242542a6cf22e28332c27d052439fcab9a7b4bcf99f0432e8",
        "run_block": ["885311a906e2d306ffc4c25ba965d10c53e2077633ffe5ed0a2b7cd0197f1e4c",
                      "ed4e254d76f3b15852ce97612978ca39a3a241bfeea96452f33cdf63f775ada7"]},
    "tiny_swin_cell": {
        "head_scale": 0.20797221457992202,
        "state": "f49421ceec6a036a19286cd644ffeddb97cee410a551296601693f31090071c1",
        "run_block": ["7562d238c203051ecd870e02c7856ef30a275e9a7e4f078d533f71b21166ae0d",
                      "5b744aaf94b925e8c2ff9fe66ebb3a1d104dc07e7b7d1f60f4c2fe34cf2e9318"]},
}
CONFIGS = {
    "tiny_hrnet": (87666688.0,
                   "7602171311d91bab292f89c1a89cec8be06491513541f7b03dd300119dd23b13"),
    "tiny_swin": (32800768.0, "8b9903b53f21088df4a33708626f032e16ce2ca2fcd896cb88fc48ca1a31211e"),
    "hrnet_w32_coco_256x192": (
        15290007552.0, "02ed5d0b9400f72985b1e88dfb38698f8cb92f5c569e4e4f30482eed82b88530"),
    "swin_b_coco_256x192": (
        37921642496.0, "14266bb14bf19e853cc004e66f35fcab135ea64b24efc264c43694fa91371079"),
}


def digest(values: dict) -> str:
    """sha256 over the sorted keys of ``values``: each name, and each
    tensor's dtype, shape and bytes (or a number's repr)."""
    h = hashlib.sha256()
    for k in sorted(values):
        v = values[k]
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().contiguous()
            h.update(f"{k}|{v.dtype}|{tuple(v.shape)}|".encode())
            h.update(v.numpy().tobytes())
        else:
            h.update(f"{k}|{v!r}|".encode())
    return h.hexdigest()


@pytest.mark.parametrize("config", sorted(DRAWN))
@pytest.mark.parametrize("seed", [5, 2 ** 33 + 1])
def test_drawn_state_dict_is_the_parents(tiny_catalog, config, seed):
    cfg = tiny_catalog.config(config)
    family = tiny_catalog.family(cfg["family"])
    meta = build_model(cfg, "meta", root=tiny_catalog.root)
    state = draw_state_dict(meta, seed, "cpu", 0, getattr(family, "weight_kind", None))
    assert digest(state) == DRAWN[config][seed]


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_head_scale_and_reference_blocks_are_the_parents(tiny_catalog, workload, one_thread):
    cell = Cell(tiny_catalog, workload, SEED, "cpu")
    want = CELLS[workload]
    assert cell.head_scale == want["head_scale"]
    assert set(cell.states) == {"pose"}
    assert digest(cell.states["pose"]) == want["state"]
    assert [digest(ref) for ref in cell.references()] == want["run_block"]


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_names_shapes_and_flops_per_crop_are_the_parents(tiny_catalog, config):
    cat = tiny_catalog if config.startswith("tiny_") else Catalog(ROOT)
    cfg = cat.config(config)
    meta = {"pose": build_model(cfg, "meta", root=cat.root)}
    flops, names_shapes = CONFIGS[config]
    h = hashlib.sha256()
    for k, v in sorted(meta["pose"].state_dict().items()):
        h.update(f"{k}|{tuple(v.shape)}|".encode())
    assert h.hexdigest() == names_shapes
    pipe = cat.pipeline(cfg)
    assert "pipeline" not in cfg and "detector" not in cfg
    assert pipe.flops_per_crop(meta, cfg, None) == flops
    assert pipe.program_kwargs(cfg, {"pose": "weights.pth"}) == {}
    assert tuple(pipe.NAMES) == NAMES and tuple(pipe.MEANS) == MEANS
