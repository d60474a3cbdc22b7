"""The port's ONNX export against the JAX package's, on the CPU: the writer
(``export/onnx_proto.py``, ``onnx_export.py``, ``onnx_optimize.py``,
``quantize.py::convert_to_int8``) held to byte identity with the JAX writer
from the same folded numpy tree of the full-width model (LR-ASPP /
MobileNetV3-Large, 4,201,348 parameters) at 64x48; the torch executor
(``export/onnx_torch_runner.py``) against the port's fp32 model and the
JAX mini runtime (< 1e-4, the reference's fp32 gate); and
``export_seg_torch.py`` end to end with ``--device cpu``.

Any difference in bytes is a fault of the port, not a tolerance.
"""

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mtg_card_image_segmentation_tpu.export import fold_batch_norm as jax_fold
from mtg_card_image_segmentation_tpu.export import onnx_export as jax_onnx
from mtg_card_image_segmentation_tpu.export.onnx_optimize import optimize as jax_optimize
from mtg_card_image_segmentation_tpu.export.onnx_runtime_mini import make_runner as jax_runner
from mtg_card_image_segmentation_tpu.export.quantize import convert_to_int8 as jax_int8
from mtg_card_image_segmentation_tpu.models import create_model as jax_create_model

import export_seg_torch
import prune_seg_torch
from mtg_card_image_segmentation_tpu_torch.compression.slim import (
    expansion_channel_prune,
    slim_seg_state,
)
from mtg_card_image_segmentation_tpu_torch.export import onnx_proto as op
from mtg_card_image_segmentation_tpu_torch.export.fold_bn import fold_batch_norm
from mtg_card_image_segmentation_tpu_torch.export.onnx_export import (
    auto_mixed_precision,
    convert_to_fp16,
    export_seg_model,
)
from mtg_card_image_segmentation_tpu_torch.export.onnx_optimize import optimize
from mtg_card_image_segmentation_tpu_torch.export.onnx_torch_runner import make_runner
from mtg_card_image_segmentation_tpu_torch.export.quantize import convert_to_int8
from mtg_card_image_segmentation_tpu_torch.training.checkpoint import save_params
from mtg_card_image_segmentation_tpu_torch.utils.params import from_flax, init_flax_like
from mtg_card_image_segmentation_tpu_torch.utils.platform import ieee_fp32

torch.set_num_threads(2)

H, W = 64, 48
FP32_GATE = 1e-4  # ExportConfig.parity_atol_fp32, train/export.py:159-162
SMALL = ["--set", f"model.input_height={H}", f"model.input_width={W}", "data.batch_size=2"]


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_leaves(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


@pytest.fixture(scope="module")
def weights():
    return init_flax_like(0)


@pytest.fixture(scope="module")
def folded(weights):
    return fold_batch_norm(*weights)


@pytest.fixture(scope="module")
def slim_folded(weights):
    p, _ = expansion_channel_prune(weights[0], 0.3)
    sp, ss, overrides = slim_seg_state(p, weights[1])
    assert 471 in overrides  # block 12's 672 expansion, an odd width
    return fold_batch_norm(sp, ss)


def test_proto_roundtrip(tmp_path):
    """tests/test_onnx_export.py::test_proto_roundtrip, on the port's copy."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((4, 3, 3, 3)).astype(np.float32)
    model = op.Model(
        graph_name="toy",
        nodes=[
            op.Node("Conv", ["input", "w"], ["conv1"], "conv1",
                    {"kernel_shape": [3, 3], "strides": [1, 1],
                     "pads": [1, 1, 1, 1], "dilations": [1, 1], "group": 1}),
            op.Node("Relu", ["conv1"], ["output"], "relu1", {}),
        ],
        initializers=[op.Tensor("w", w)],
        inputs=[("input", op.FLOAT, (1, 3, 8, 8))],
        outputs=[("output", op.FLOAT, (1, 4, 8, 8))],
        opset=17,
    )
    path = str(tmp_path / "toy.onnx")
    model.save(path)
    loaded = op.Model.load(path)
    assert loaded.graph_name == "toy"
    assert loaded.opset == 17
    assert [n.op_type for n in loaded.nodes] == ["Conv", "Relu"]
    assert loaded.nodes[0].attributes["pads"] == [1, 1, 1, 1]
    assert loaded.nodes[0].attributes["group"] == 1
    np.testing.assert_array_equal(loaded.initializers[0].array, w)
    assert loaded.inputs == [("input", op.FLOAT, (1, 3, 8, 8))]


def test_fold_batch_norm_is_bit_equal_to_jax(weights, folded):
    want = _leaves(jax.tree.map(np.asarray, jax_fold(*weights)))
    got = _leaves(folded)
    assert set(got) == set(want) and len(want) == 131
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def _both(tree, case):
    """(port model, JAX model) for one case of the writer test."""
    dyn = case == "dynamic"
    port = export_seg_model(tree, (H, W), dynamic_batch=dyn)
    ref = jax_onnx.export_seg_model(tree, (H, W), dynamic_batch=dyn)
    if case == "optimized":
        assert optimize(port) == jax_optimize(ref)
    elif case == "fp16":
        port, ref = convert_to_fp16(port), jax_onnx.convert_to_fp16(ref)
    elif case == "fp16_mixed":
        names = {n.name for n in port.nodes[: len(port.nodes) // 2]}
        port = convert_to_fp16(port, fp16_nodes=names)
        ref = jax_onnx.convert_to_fp16(ref, fp16_nodes=names)
    elif case == "int8":
        port, ref = convert_to_int8(port), jax_int8(ref)
    return port, ref


@pytest.mark.parametrize("case", ["static", "dynamic", "optimized", "fp16", "fp16_mixed",
                                  "int8", "slim"])
def test_writer_bytes_equal_jax(case, folded, slim_folded):
    """The same serialized bytes as the JAX writer from the same folded
    tree: static, ``dynamic_batch=True``, after ``optimize`` (equal stats
    too), ``convert_to_fp16`` (all nodes and a node subset, the mechanism
    of ``auto_mixed_precision``), ``convert_to_int8``, and the slimmed 0.3
    tree (widths read from the params)."""
    tree = slim_folded if case == "slim" else folded
    port, ref = _both(tree, case)
    a, b = port.serialize(), ref.serialize()
    assert len(a) == len(b) and a == b
    # and the bytes parse back to the same graph
    back = op.Model.parse(a)
    assert [n.name for n in back.nodes] == [n.name for n in port.nodes]


@pytest.fixture(scope="module")
def graphs(folded):
    static = export_seg_model(folded, (H, W))
    optimize(static)
    dynamic = export_seg_model(folded, (H, W), dynamic_batch=True)
    optimize(dynamic)
    return {"static": static, "dynamic": dynamic}


def _nchw(seed, b):
    return np.random.default_rng(seed).standard_normal((b, 3, H, W)).astype(np.float32)


def _port_reference(weights, x_nchw):
    model = from_flax(*weights, dtype=torch.float32)
    with torch.no_grad():
        out = model(torch.from_numpy(np.ascontiguousarray(x_nchw.transpose(0, 2, 3, 1))))
    return out.numpy().transpose(0, 3, 1, 2)


@pytest.mark.parametrize("graph,b", [("static", 1), ("dynamic", 1), ("dynamic", 4)])
def test_runner_matches_port_model_and_jax_mini_runtime(graph, b, graphs, weights):
    """The CPU runner on the exported bytes against the port's fp32 model
    (BN unfolded) and against the JAX mini runtime (jitted) on the same
    bytes: max|d| < 1e-4 each."""
    model = op.Model.parse(graphs[graph].serialize())
    x = _nchw(b, b)
    got = make_runner(model, "cpu")({"input": x})["output"]
    assert got.shape == (b, 2, H, W) and got.dtype == np.float32
    want = _port_reference(weights, x)
    assert np.abs(got - want).max() < FP32_GATE
    mini = np.asarray(jax_runner(model)(jnp.asarray(x)))
    assert np.abs(got - mini).max() < FP32_GATE


def test_runner_runs_fp16_graphs_in_fp16_and_int8_graphs_like_jax(graphs, weights):
    """fp16 is real: the fp16 graph's output moves off the fp32 one (by far
    more than fp32 rounding) yet stays inside the export gate in
    probability space. The int8 QDQ graph dequantizes in fp32, as the JAX
    mini runtime does: < 1e-4 apart."""
    x = _nchw(3, 1)
    fp32 = make_runner(graphs["static"], "cpu")({"input": x})["output"]
    fp16 = make_runner(convert_to_fp16(graphs["static"]), "cpu")({"input": x})["output"]
    d = np.abs(fp16 - fp32).max()
    assert 1e-5 < d < 0.05

    def probs(z):
        e = np.exp(z - z.max(axis=1, keepdims=True))
        return e / e.sum(axis=1, keepdims=True)

    assert np.abs(probs(fp16) - probs(fp32)).max() <= 1e-2
    q = convert_to_int8(graphs["static"])
    got = make_runner(q, "cpu")({"input": x})["output"]
    mini = np.asarray(jax_runner(op.Model.parse(q.serialize()))(jnp.asarray(x)))
    assert np.abs(got - mini).max() < FP32_GATE


def test_auto_mixed_precision_keeps_an_fp32_suffix(graphs):
    """With a tolerance the all-fp16 graph misses, the search returns a
    graph with a strict fp16 prefix that meets it, re-verified."""
    x = _nchw(4, 1)
    ref = make_runner(graphs["static"], "cpu")({"input": x})["output"]
    fp16 = make_runner(convert_to_fp16(graphs["static"]), "cpu")({"input": x})["output"]
    atol = float(np.abs(fp16 - ref).max()) / 4
    mixed, n16 = auto_mixed_precision(
        graphs["static"], ref, lambda m: make_runner(m, "cpu")({"input": x})["output"],
        rtol=0.0, atol=atol, log=lambda *_: None)
    assert 0 <= n16 < len(graphs["static"].nodes)
    got = make_runner(mixed, "cpu")({"input": x})["output"]
    assert np.abs(got - ref).max() <= atol


def test_ieee_fp32_turns_cudnn_and_tf32_off_and_restores():
    """The export gates' float32 block: cuDNN and TF32 off inside, the
    caller's settings back after, also when the block raises."""
    kept = (torch.backends.cudnn.enabled, torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    with pytest.raises(KeyError):
        with ieee_fp32():
            assert not torch.backends.cudnn.enabled
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
            raise KeyError
    assert (torch.backends.cudnn.enabled, torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == kept


def test_runner_defaults_to_the_card(graphs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_runner(graphs["static"])


FILES = {"model.onnx", "model_fp16.onnx", "model_int8.onnx", "model_dynamic.onnx",
         "model.pt2", "model.pt2.json", "params.npz", "model_info.json", "README.md",
         "inference_example.py"}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_export_cli_on_cpu(weights, tmp_path, capsys):
    """``export_seg_torch.py --device cpu`` at 64x48: dense from a seeded
    checkpoint, and ``--slim`` from its expansion-pruned tree. Both exit 0,
    write the JAX CLI's files, and pass every gate; model.onnx holds the
    JAX writer's bytes for the same tree; params.npz has the JAX CLI's flat
    keys."""
    save_params(str(tmp_path), "dense", *weights, epoch=3)
    pruned, _ = expansion_channel_prune(weights[0], 0.3)
    save_params(str(tmp_path), "pruned", pruned, weights[1])
    smoke = _chip_smoke()
    for name, extra in (("dense", []), ("pruned", ["--slim"])):
        out = tmp_path / f"export_{name}"
        capsys.readouterr()
        info = export_seg_torch.main(["--checkpoint", str(tmp_path / name), "--device", "cpu",
                                      "--output-dir", str(out), *extra, *SMALL])
        # chip_smoke reads the CLI's verdicts from this log
        verdicts = smoke.export_gate_verdicts(capsys.readouterr().out)
        assert verdicts == dict.fromkeys(("fp32", "fp16", "int8", "dynamic b1", "dynamic b4"),
                                         "PASS")
        assert smoke.export_gate_faults({"exit": 0}, verdicts, frozenset()) == []
        assert FILES <= set(os.listdir(out))
        on_disk = json.loads((out / "model_info.json").read_text())
        assert on_disk == json.loads(json.dumps(info))
        par = info["parity"]
        assert par["fp32_pass"] and par["fp16_pass"] and par["int8_pass"]
        assert par["fp32_max_abs_diff"] < FP32_GATE
        assert all(r["pass"] for r in par["dynamic_batch"].values())
        assert par.get("protoc_decode_pass", True)
        program = info["torch_export"]
        assert program["self_test_pass"] and program["self_test_max_diff"] < 1e-5
        assert program == json.loads((out / "model.pt2.json").read_text())
        assert program["bytes"] == (out / "model.pt2").stat().st_size
        assert info["device"] == "cpu" and "model.pt2" in (out / "README.md").read_text()
    assert info["slimmed_expansions"][12] == 471
    assert info["parameters"] == 3_358_648
    ref = jax_onnx.export_seg_model(jax.tree.map(np.asarray, jax_fold(*weights)), (H, W))
    jax_optimize(ref)
    assert (tmp_path / "export_dense" / "model.onnx").read_bytes() == ref.serialize()
    with np.load(tmp_path / "export_dense" / "params.npz") as z:
        keys = set(z.files)
    assert "params/backbone/stem/conv/kernel" in keys
    assert "batch_stats/backbone/block12/expand/bn/var" in keys


def test_export_cli_exits_nonzero_when_a_gate_fails(tmp_path, capsys):
    """The prune CLI's checkpoint of random weights, recalibrated and
    slimmed, has logits near 190 at 64x48, where fp32 rounding alone (BN
    folded in the graph, unfolded in the source model) exceeds the absolute
    1e-4 gate: on the CLI's input the JAX package's own model and mini
    runtime disagree by 5.5e-3, the port's model and runner by 7.8e-3. The
    CLI says so and exits non-zero, as export_seg.py does."""
    save_params(str(tmp_path), "seeded", *init_flax_like(0))
    prune_seg_torch.main(["--checkpoint", str(tmp_path / "seeded"), "--device", "cpu",
                          "--method", "expansion", "--eval-batches", "1",
                          "--output-dir", str(tmp_path / "pruned"), *SMALL])
    capsys.readouterr()
    with pytest.raises(SystemExit, match="parity gate FAILED"):
        export_seg_torch.main(["--checkpoint", str(tmp_path / "pruned" / "pruned_model"),
                               "--device", "cpu", "--slim",
                               "--output-dir", str(tmp_path / "out"), *SMALL])
    smoke = _chip_smoke()
    verdicts = smoke.export_gate_verdicts(capsys.readouterr().out)
    assert verdicts["fp32"] == "FAIL"
    # chip_smoke fails such a run even where fp16 and int8 may miss
    assert "gate fp32 FAIL" in smoke.export_gate_faults(
        {"exit": 1}, verdicts, frozenset({"fp16", "int8"}))


_ALL_PASS = dict.fromkeys(("fp32", "fp16", "int8", "dynamic b1", "dynamic b4"), "PASS")


@pytest.mark.parametrize("failed,exit_code,may_miss,faults", [
    ((), 0, (), []),
    (("fp16",), 1, (), ["gate fp16 FAIL"]),
    (("fp16", "int8"), 1, ("fp16", "int8"), []),
    (("int8",), 0, ("fp16", "int8"), ["exit 0 with verdicts"]),
    (("fp32",), 1, ("fp16", "int8"), ["gate fp32 FAIL"]),
    (("dynamic b4",), 1, ("fp16", "int8"), ["gate dynamic b4 FAIL"]),
    ((), 1, ("fp16", "int8"), ["exit 1 with verdicts"]),
    (("missing dynamic b1",), 0, (), ["gate dynamic b1 not reported"]),
    # the slim export when the referee excused fp32 and dynamic b4
    (("fp32", "dynamic b4"), 1, ("fp32", "dynamic b4"), []),
])
def test_chip_smoke_export_gate_rules(failed, exit_code, may_miss, faults):
    """chip_smoke's rule for an export CLI run: every gate reported, no
    missed gate outside ``may_miss`` (none for the slim export, fp16 and
    int8 for the dense one, and for either the absolute float32 gates that
    the CPU referee excused, test_chip_smoke_export_referee), and exit 1
    exactly when a gate missed."""
    verdicts = dict(_ALL_PASS)
    for k in failed:
        if k.startswith("missing "):
            del verdicts[k[len("missing "):]]
        else:
            verdicts[k] = "FAIL"
    got = _chip_smoke().export_gate_faults({"exit": exit_code}, verdicts, frozenset(may_miss))
    assert len(got) == len(faults)
    assert all(g.startswith(f) for g, f in zip(got, faults))


@pytest.mark.parametrize("card,cpu,excused", [
    # a checkpoint whose float32 rounding reaches the 1e-4 gate on both
    ({"fp32": 1.14e-4}, {"fp32": 1.22e-4}, {"fp32"}),
    ({"dynamic b4": 1.14e-4}, {"dynamic b4": 0.8e-4}, {"dynamic b4"}),
    ({"fp32": 1.1e-4, "dynamic b1": 1.2e-4}, {"fp32": 0.9e-4, "dynamic b1": 0.7e-4},
     {"fp32", "dynamic b1"}),
    # a card that misses by far more than the CPU's rounding
    ({"fp32": 1e-2}, {"fp32": 1.01e-4}, set()),
    ({"dynamic b1": 2.5e-4}, {"dynamic b1": 1.2e-4}, set()),
    ({"fp32": 1.1e-4, "dynamic b4": 3e-4}, {"fp32": 1e-4, "dynamic b4": 1e-4}, {"fp32"}),
    # no CPU reading, no excuse
    ({"fp32": 1.1e-4}, {}, set()),
])
def test_chip_smoke_export_referee(card, cpu, excused):
    """chip_smoke's CPU referee for the absolute float32 export gates (fp32,
    dynamic b1 and b4, max|diff| < 1e-4): a gate the card missed is excused
    only where the card's max|diff| is at most twice the CPU's on the same
    checkpoint and probe, read from the CLIs' log lines; fp16 and int8 are
    never excused by it, and a card that misses by far more than the CPU
    fails the export."""
    smoke = _chip_smoke()

    def log(readings, fp16="PASS"):
        lines = [f"fp16 parity: logits max|diff|=5.00e-02 prob max|diff|=2.00e-02 "
                 f"mask agreement=0.999000 {fp16}",
                 "int8 parity: prob max|diff|=1.00e-01 mask agreement=0.999500 (>= 0.999) PASS"]
        for g in ("fp32", "dynamic b1", "dynamic b4"):
            d = readings.get(g, 3e-5)
            v = "PASS" if d < 1e-4 else "FAIL"
            lines.append(f"fp32 parity: max|diff|={d:.2e} (< 0.0001) {v}" if g == "fp32" else
                         f"dynamic-batch parity {g[-2:]}: max|diff|={d:.2e} {v}")
        return "\n".join(lines)

    card_log = log(card, fp16="FAIL")
    verdicts = smoke.export_gate_verdicts(card_log)
    readings = smoke.export_gate_readings(card_log)
    assert set(readings) == {"fp32", "dynamic b1", "dynamic b4"}
    cpu_readings = {k: v for k, v in smoke.export_gate_readings(log(cpu)).items() if k in cpu}
    got = smoke.export_gate_refereed(verdicts, readings, cpu_readings)
    assert got == excused and "fp16" not in got
    faults = smoke.export_gate_faults({"exit": 1}, verdicts, got)
    assert sorted(faults) == sorted([f"gate {g} FAIL" for g in set(card) - excused]
                                    + ["gate fp16 FAIL"])


def test_gate_probes_are_the_jax_clis_draws():
    """``export_seg_torch.gate_probes`` gives the float32 gates' inputs in
    export_seg.py's order from one ``default_rng(0)``: the fp32 probe (b1),
    then the dynamic graph's b1 and b4; chip_smoke's float64 referee reruns
    a missed gate on the same input."""
    rng = np.random.default_rng(0)
    want = [rng.standard_normal((nb, 3, H, W)).astype(np.float32) for nb in (1, 1, 4)]
    got = export_seg_torch.gate_probes(H, W)
    assert list(got) == ["fp32", "dynamic b1", "dynamic b4"]
    for a, b in zip(got.values(), want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fault", [None, "artifact", "card"])
def test_chip_smoke_float64_referee(weights, folded, tmp_path, fault):
    """chip_smoke's float64 referee of a missed float32 seg gate, at 64x48
    with the CPU standing in for the card. A right artifact on a right
    device is excused: the two float64 runs agree exactly, the artifact
    computes the model within the 1e-4 gate in float64 (BN folded into
    float32 weights), and the float32 runs lie near their float64 values. An
    artifact whose classifier weights are 1 % off is not (its float64
    error is the fault's size), nor a "card" whose float64 run computes
    another function (one BN mean moved by 1e-3)."""
    smoke = _chip_smoke()
    graph = export_seg_model(folded, (H, W))
    optimize(graph)
    if fault == "artifact":
        last = [t for t in graph.initializers if t.array.ndim == 4][-1]
        last.array = last.array * np.float32(1.01)
    path = tmp_path / "model.onnx"
    graph.save(str(path))
    calls = []

    def source():
        calls.append(None)
        params, stats = weights
        if fault == "card" and len(calls) == 1:
            stats = jax.tree.map(np.array, stats)
            stats["backbone"]["stem"]["bn"]["mean"][0] += 1e-3
        return from_flax(params, stats, dtype=torch.float32)

    x = export_seg_torch.gate_probes(H, W)["fp32"]
    row = smoke.export_gate_float64(torch, path, source, x, devices=("cpu", "cpu"))
    assert len(calls) == 2
    if fault is None:
        assert row["float64_card_vs_cpu"] == 0.0
        assert row["export_error_float64"] < 1e-5
        assert row["reading_card"] == row["reading_cpu"] < FP32_GATE
        assert row["graph_rounding"][0] == row["graph_rounding"][1] > 0
    elif fault == "artifact":
        assert row["export_error_float64"] > 5 * FP32_GATE
    else:
        assert row["float64_card_vs_cpu"] > 1e-6
    assert smoke.export_gate_rounding_excused(row, FP32_GATE) == (fault is None)


class _Downcasts(torch.overrides.TorchFunctionMode):
    """Records every op that takes a float64 tensor and returns a float32
    one: a float32 rounding inside a float64 pass."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        flat = [*args, *(kwargs or {}).values()]
        if (any(torch.is_tensor(a) and a.dtype == torch.float64 for a in flat)
                and torch.is_tensor(out) and out.dtype in (torch.float32, torch.bfloat16)):
            self.found.append(getattr(func, "__name__", str(func)))
        return out


@pytest.mark.parametrize("family", ["seg", "hrnet", "yolo"])
def test_float64_pass_rounds_nothing_to_float32(family):
    """A float64 copy of each model (``training.loop.float64_copy`` inside
    ``float64_casts``) rounds no activation to float32: chip_smoke's
    float64 referees hold the card's float64 outputs to the CPU's within
    1e-10, which a float32 step (the seg model's pooled means were taken
    in float32) would part by ~4e-7."""
    from mtg_card_image_segmentation_tpu_torch.training.loop import float64_casts, float64_copy
    from mtg_card_image_segmentation_tpu_torch.utils.params import (
        hrnet_from_flax,
        init_hrnet_flax_like,
        init_yolo_flax_like,
        yolo_from_flax,
    )

    model, x = {
        "seg": lambda: (from_flax(*init_flax_like(0)[:2], dtype=torch.float32), (1, H, W, 3)),
        "hrnet": lambda: (hrnet_from_flax(*init_hrnet_flax_like(0)[:2], (16, 16),
                                          dtype=torch.float32), (1, 64, 64, 3)),
        "yolo": lambda: (yolo_from_flax(*init_yolo_flax_like(0)[:2], dtype=torch.float32),
                         (1, 64, 64, 3)),
    }[family]()
    ref = float64_copy(model.eval())
    x = torch.from_numpy(np.random.default_rng(0).random(x))
    seen = _Downcasts()
    with float64_casts(), torch.inference_mode(), seen:
        out = ref(x)
    outs = out if isinstance(out, (tuple, list)) else [out]
    assert all(o.dtype == torch.float64 for o in outs if torch.is_tensor(o))
    assert seen.found == []


_ROUNDING_ROW = {"float64_card_vs_cpu": 1.4e-15, "export_error_float64": 1.5e-5,
                 "graph_rounding": [1.2e-6, 0.9e-6], "model_rounding": [1.1e-6, 1.3e-6]}


@pytest.mark.parametrize("change,excused", [
    ({}, True),
    # the card's float32 runs within 1e-5 of the largest logit of float64,
    # however far the CPU's happen to lie
    ({"graph_rounding": [1e-5, 1e-7]}, True),
    ({"graph_rounding": [1.1e-5, 1e-5]}, False),
    ({"model_rounding": [3e-5, 1e-6]}, False),
    # the card computes another function
    ({"float64_card_vs_cpu": 2e-10}, False),
    # the artifact misses the gate in exact arithmetic
    ({"export_error_float64": 1e-4}, False),
])
def test_chip_smoke_float64_referee_rule(change, excused):
    """``export_gate_rounding_excused``: a miss is excused only where the
    card's float64 outputs are the CPU's within 1e-10 of the largest logit,
    the artifact's float64 error is under the gate, and the card's float32
    graph and model each lie within 1e-5 of the largest logit of their
    float64 values."""
    smoke = _chip_smoke()
    assert smoke.export_gate_rounding_excused(_ROUNDING_ROW | change, FP32_GATE) == excused


def test_executor_float64_run(folded):
    """``make_runner(..., dtype=torch.float64)`` runs a float32 graph in
    float64: its output is the float32 run's within float32 rounding, and a
    graph with Cast nodes (the fp16 graph) refuses."""
    graph = export_seg_model(folded, (H, W))
    x = export_seg_torch.gate_probes(H, W)["fp32"]
    out64 = make_runner(graph, "cpu", torch.float64)({"input": x})["output"]
    out32 = make_runner(graph, "cpu")({"input": x})["output"]
    assert out64.dtype == np.float64 and out32.dtype == np.float32
    assert 0 < np.abs(out64 - out32).max() < 1e-5 * np.abs(out64).max()
    with pytest.raises(NotImplementedError, match="Cast"):
        make_runner(convert_to_fp16(graph), "cpu", torch.float64)


def _probs(z):
    e = np.exp(z - z.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


def test_seeded_weights_miss_fp16_and_int8_gates_in_both_packages(weights):
    """The export gates' verdicts follow the weights, not the package. At
    the config's 320x240, on the CLIs' probe (standard normal, seed 0), the
    seeded untrained tree's logits stay below 0.4, so many pixels sit at
    the decision boundary: both packages' gate arithmetic (each its own
    fp32 model as the reference, the JAX mini runtime jitted and the torch
    executor on the CPU running the same graph bytes) passes fp32 and
    misses the fp16 mask agreement (>= 0.9999) and the int8 one
    (>= 0.999). The fp16 probabilities stay within 1e-2, so the CLIs'
    mixed-precision search keeps every node fp16 and their final fp16
    verdict is this one."""
    hw = (320, 240)
    graph = export_seg_model(fold_batch_norm(*weights), hw)
    optimize(graph)
    theirs = jax_onnx.export_seg_model(jax.tree.map(np.asarray, jax_fold(*weights)), hw)
    jax_optimize(theirs)
    assert graph.serialize() == theirs.serialize()
    x = np.random.default_rng(0).standard_normal((1, 3, *hw)).astype(np.float32)
    graphs = {"fp32": graph, "fp16": convert_to_fp16(graph), "int8": convert_to_int8(graph)}
    jmodel = jax_create_model("lraspp_mobilenet_v3_large", compute_dtype="float32")
    variables = {"params": weights[0], "batch_stats": weights[1]}
    with jax.default_matmul_precision("float32"):
        jref = np.asarray(jax.jit(lambda v, xx: jmodel.apply(v, xx, train=False))(
            variables, jnp.asarray(x.transpose(0, 2, 3, 1)))).transpose(0, 3, 1, 2)
        jout = {k: np.asarray(jax_runner(op.Model.parse(g.serialize()))(jnp.asarray(x)))
                for k, g in graphs.items()}
    pout = {k: make_runner(g, "cpu")({"input": x})["output"] for k, g in graphs.items()}
    verdicts = {}
    for pkg, ref, out in (("jax", jref, jout), ("port", _port_reference(weights, x), pout)):
        assert np.abs(ref).max() < 0.4
        mask = ref.argmax(axis=1)
        agree = {k: float((o.argmax(axis=1) == mask).mean()) for k, o in out.items()}
        assert np.abs(_probs(out["fp16"]) - _probs(ref)).max() <= 1e-2
        verdicts[pkg] = {"fp32": float(np.abs(out["fp32"] - ref).max()) < FP32_GATE,
                         "fp16": agree["fp16"] >= 0.9999, "int8": agree["int8"] >= 0.999,
                         "int8_agreement": agree["int8"]}
    assert verdicts["jax"] == verdicts["port"]
    assert verdicts["port"]["fp32"] and not verdicts["port"]["fp16"]
    assert not verdicts["port"]["int8"]
