"""On the card, at each cell's own size: three seeds of the program pass the
check and the float32 controls fail it.  Skips without a card; run there
with ``python -m pytest -m gpu benchmark/tests/test_bench_control_gpu.py``."""
from __future__ import annotations

import pytest

from benchmark.harness import calibrate, spec
from benchmark.tests.conftest import CELLS


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_program_passes_and_control_fails_at_the_cells_size(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = spec.load_cell(name)
    seeds = [2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303]
    for line in calibrate.calibrate(cell, seeds, 10.0, len(seeds), "cuda"):
        assert line["correct"] is True, line
        for ctl, _ in calibrate.controls(cell.config):
            reading = line[f"control.{ctl}"]
            assert isinstance(reading, str) or reading["correct"] is False, (ctl, line)
