"""The control on the card at each cell's own size, on three seeds: the
reference in fp8 put in the program's place has to read not correct, every
time. Skips without a CUDA card.

    python3 -m pytest benchmark/tests/test_bench_control.py -q
"""

import pytest

import core
import run

CELLS = [w["name"] for w in core.manifest()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    run.cache_dirs()
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        args = run.parse(["--workload", cell, "--seed", str(seed), "--seconds", "15",
                          "--trace", "0", "--control", "1"])
        result = run.run_cell(args)
        assert result["correct"] is False, (seed, result["checks"])
        torch.cuda.empty_cache()
