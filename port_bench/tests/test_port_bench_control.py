"""The controls must come out not correct: the reference computed one
precision step below the configuration's, put in the program's place and
judged as the program is.  ``control``: fp8 e4m3 products in the bf16
stages, bf16 in the float32 decode and triangulation; ``model_control``:
the fp8 products alone, the decode and triangulation in float32 (the fp8
model behind a float32 decode).  On the CPU at test size, also through a
whole run with the control serving the timed path; on the card (marked
``cuda``) at a cell's own block size against its own limits, where the
program must come out correct."""

import pytest

from port_bench.calibrate import readings
from port_bench.catalog import Catalog
from port_bench.harness import Cell, run_cell
from port_bench.reference import MODEL_CONTROL, no_tf32

from conftest import ROOT


def _verdict(numbers: dict, limits: dict) -> bool:
    return all(numbers[n] <= spec["limit"] for n, spec in limits.items())


@pytest.mark.parametrize("workload", ["tiny_hrnet_cell", "tiny_swin_cell"])
@pytest.mark.parametrize("seed", [1, 2 ** 32 + 5])
def test_controls_fail_and_program_passes_at_test_size(tiny_catalog, workload, seed):
    cell = Cell(tiny_catalog, workload, seed, "cpu")
    assert _verdict(readings(cell, "program", cycles=1), cell.limits)
    assert not _verdict(readings(cell, "control"), cell.limits)
    assert not _verdict(readings(cell, "model_control"), cell.limits)


class _ReferenceInPlace:
    """The reference at ``rounding`` serving the timed path in the
    pipeline's place, from the cell's own seeded weights and rig."""

    def __init__(self, pipeline, cell: Cell, rounding):
        self.pipeline, self.cell, self.rounding = pipeline, cell, rounding
        self.models = cell.reference_models(rounding)

    def run(self, frames, bboxes=None):
        with no_tf32():
            out = self.cell.pipe.run_block(self.models, frames, self.cell.cfg,
                                           self.cell.rig_tensors(), self.rounding)
        return {k: out[k] for k in ("kpts_2d", "heatmaps_2d", "kpts_3d")}

    def __getattr__(self, name):
        return getattr(self.pipeline, name)


@pytest.mark.parametrize("workload", ["tiny_hrnet_cell", "tiny_swin_cell"])
def test_model_control_serving_the_window_is_not_correct(tiny_catalog, workload):
    seed = 2 ** 31 + 3
    cell = Cell(tiny_catalog, workload, seed, "cpu")
    result = run_cell(tiny_catalog, workload, seed, 2.0, trace=False, device="cpu",
                      tamper=lambda p: _ReferenceInPlace(p, cell, MODEL_CONTROL),
                      log=lambda msg: None)
    assert result["correct"] is False
    assert result["failed"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["w32_vga_c2_b256", "swinb_vga_c2_b128"])
def test_controls_fail_at_the_cells_size(cuda_device, workload):
    cell = Cell(Catalog(ROOT), workload, 2 ** 31 + 99, cuda_device)
    assert _verdict(readings(cell, "program", cycles=1), cell.limits)
    assert not _verdict(readings(cell, "control"), cell.limits)
    assert not _verdict(readings(cell, "model_control"), cell.limits)
