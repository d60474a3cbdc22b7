"""A whole run on the host at a small size, the harness's look for a card
skipped, with the timed path broken underneath: ``correct`` has to come
out false for every fault the cell can have (``programs/faults.py``), and
for the control put in the program's place."""

import time

import pytest

import core
import run

SMALL = {
    "seg.serve.512x512.b128": dict(batch=4, height=64, width=96, pool=2, warmup=1, keep_from=2,
                                   keep=1),
    "seg.serve.320x240.b128": dict(batch=4, height=64, width=48, pool=2, warmup=1, keep_from=2,
                                   keep=1),
    "pose.serve.480x640.b128": dict(batch=4, height=64, width=96, pool=2, warmup=1, keep_from=2,
                                    keep=1, config_overrides={"heatmap_hw": [16, 24]}),
}
FAULTS = [(c, f) for c in SMALL for f in core.load_module("programs/faults.py").SERVE]


def small_run(cell, seed=2**33 + 17, **flags):
    argv = ["--workload", cell, "--seed", str(seed), "--seconds", "1.5", "--trace", "0"]
    for k, v in flags.items():
        argv += [f"--{k}", str(v)]
    return run.run_cell(run.parse(argv), device="cpu", t0=time.perf_counter(),
                        overrides=SMALL[cell])


@pytest.mark.parametrize("cell, fault", FAULTS, ids=[f"{c}-{f}" for c, f in FAULTS])
def test_a_planted_fault_reads_not_correct(cell, fault):
    result = small_run(cell, fault=fault)
    assert result["correct"] is False, result["checks"]
    assert result["attempted"] > 0


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_control_reads_not_correct(cell):
    assert small_run(cell, control=1)["correct"] is False


def test_the_result_line_carries_its_numbers_last():
    result = small_run("seg.serve.512x512.b128")
    assert list(result)[-1] == "checks"
    for name, c in result["checks"].items():
        assert set(c) == {"value", "limit"} and c["limit"] is not None
    assert set(result) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert set(result["metrics"]) == {"serve_images_per_s", "serve_batch_ms_p95", "setup_s"}


def test_set_up_leaves_out_the_references_own_seconds():
    result = small_run("seg.serve.320x240.b128")
    parts = result["host"]["setup_parts_s"]
    assert result["host"]["reference_in_setup_s"] > 0
    whole = sum(v for k, v in parts.items() if k != "setup")
    assert result["metrics"]["setup_s"]["value"] == pytest.approx(
        whole - result["host"]["reference_in_setup_s"], abs=1e-3)
