"""The port's HRNet pose export and evaluation against the JAX package's, on
the CPU at 64x96 (16x24 heatmaps) with the full-width HRNet-W18-small: the
BatchNorm fold with the head's deconv pairs, ``export_pose_model`` held to
byte identity with the JAX writer (static, dynamic, optimized, fp16,
int8), the torch executor on the pose graph (ConvTranspose, nearest
Resize) against the port's model, both packages' export-gate verdicts on
a seeded and a barely trained tree, ``PoseEvaluator`` and ``CornerEvaluator`` against the JAX
evaluators, and ``train_pose_torch.py``, ``evaluate_pose_torch.py`` and
``export_pose_torch.py`` end to end with ``--device cpu``.

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

import evaluate_pose_torch
import export_pose_torch
import train_pose_torch
from mtg_card_image_segmentation_tpu_torch.evaluation import CornerEvaluator, PoseEvaluator
from mtg_card_image_segmentation_tpu_torch.export import onnx_proto as op
from mtg_card_image_segmentation_tpu_torch.export.fold_bn import fold_batch_norm
from mtg_card_image_segmentation_tpu_torch.export.onnx_export import (
    convert_to_fp16,
    export_pose_model,
)
from mtg_card_image_segmentation_tpu_torch.export.onnx_optimize import optimize
from mtg_card_image_segmentation_tpu_torch.export.onnx_torch_runner import make_runner
from mtg_card_image_segmentation_tpu_torch.export.quantize import convert_to_int8
from mtg_card_image_segmentation_tpu_torch.ops.resize import nearest_resize
from mtg_card_image_segmentation_tpu_torch.training.checkpoint import save_params
from mtg_card_image_segmentation_tpu_torch.utils.params import (
    hrnet_from_flax,
    init_hrnet_flax_like,
    init_yolo_flax_like,
    yolo_from_flax,
)

torch.set_num_threads(2)

H, W, HM = 64, 96, (16, 24)
FP32_GATE = 1e-4  # ExportConfig.parity_atol_fp32
SMALL = ["--set", f"pose.input_height={H}", f"pose.input_width={W}",
         f"pose.heatmap_height={HM[0]}", f"pose.heatmap_width={HM[1]}", "data.batch_size=2"]
GATES = ("fp32", "fp16", "int8", "dynamic b1", "dynamic b4")


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_leaves(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def weights():
    return init_hrnet_flax_like(0)


@pytest.fixture(scope="module")
def folded(weights):
    return fold_batch_norm(*weights)


def _port_reference(weights, x_nchw):
    model = hrnet_from_flax(*weights, HM, dtype=torch.float32)
    with torch.no_grad():
        out = model(torch.from_numpy(np.ascontiguousarray(x_nchw.transpose(0, 2, 3, 1))))
    return out.numpy().transpose(0, 3, 1, 2)


def _nchw(seed, b):
    return np.random.default_rng(seed).random((b, 3, H, W)).astype(np.float32)


# --------------------------------------------------------------------------
# fold and writer
# --------------------------------------------------------------------------


def test_fold_batch_norm_folds_the_deconv_pairs_like_jax(weights, folded):
    """Bit-equal to the JAX fold, the head's deconv0/1 included: they gain
    a bias and their deconv_bn subtrees go."""
    want = _leaves(jax.tree.map(np.asarray, jax_fold(*weights)))
    got = _leaves(folded)
    assert set(got) == set(want)
    assert {"head/deconv0/bias", "head/deconv1/bias"} <= set(got)
    assert not any("deconv_bn" in k or "/bn/" in k for k in got)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def _both(tree, case):
    dyn = case == "dynamic"
    port = export_pose_model(tree, (H, W), HM, dynamic_batch=dyn)
    ref = jax_onnx.export_pose_model(tree, (H, W), HM, dynamic_batch=dyn)
    if case == "optimized":
        assert optimize(port) == jax_optimize(ref)
    elif case == "fp16":
        port, ref = convert_to_fp16(port), jax_onnx.convert_to_fp16(ref)
    elif case == "int8":
        port, ref = convert_to_int8(port), jax_int8(ref)
    return port, ref


@pytest.mark.parametrize("case", ["static", "dynamic", "optimized", "fp16", "int8"])
def test_pose_writer_bytes_equal_jax(case, folded):
    """The same serialized bytes as the JAX writer from the same folded
    tree: static, ``dynamic_batch=True``, after ``optimize`` (equal stats
    too), ``convert_to_fp16`` and ``convert_to_int8``."""
    port, ref = _both(folded, case)
    a, b = port.serialize(), ref.serialize()
    assert len(a) == len(b) and a == b
    ops = {n.op_type for n in op.Model.parse(a).nodes}
    assert {"ConvTranspose", "Resize"} <= ops


@pytest.fixture(scope="module")
def graphs(folded):
    static = export_pose_model(folded, (H, W), HM)
    optimize(static)
    dynamic = export_pose_model(folded, (H, W), HM, dynamic_batch=True)
    optimize(dynamic)
    return {"static": static, "dynamic": dynamic}


@pytest.mark.parametrize("graph,b", [("static", 1), ("dynamic", 1), ("dynamic", 4)])
def test_runner_runs_the_pose_graph_like_the_port_model(graph, b, graphs, weights):
    """The CPU executor on the exported bytes (ConvTranspose, nearest and
    bilinear Resize) against the port's fp32 model with BN unfolded:
    max|d| < 1e-4, the fp32 export gate."""
    model = op.Model.parse(graphs[graph].serialize())
    x = _nchw(b, b)
    got = make_runner(model, "cpu")({"input": x})["heatmaps"]
    assert got.shape == (b, 4, *HM) and got.dtype == np.float32
    assert np.abs(got - _port_reference(weights, x)).max() < FP32_GATE


@pytest.mark.parametrize("in_hw,out_hw", [((2, 3), (4, 6)), ((2, 3), (16, 24)), ((5, 7), (8, 9))])
def test_runner_nearest_resize_is_the_exporters_convention(in_hw, out_hw):
    """A nearest Resize node (asymmetric coordinates, floor) gives
    ops/resize.py::nearest_resize, also at a non-integer ratio, with sizes
    and with scales."""
    from mtg_card_image_segmentation_tpu_torch.export.onnx_export import GraphBuilder

    x = np.random.default_rng(0).standard_normal((2, 3, *in_hw)).astype(np.float32)
    want = nearest_resize(torch.from_numpy(x).permute(0, 2, 3, 1), *out_hw).permute(0, 3, 1, 2)
    cases = [None]
    if out_hw[0] % in_hw[0] == 0 and out_hw[1] % in_hw[1] == 0:
        cases.append((out_hw[0] / in_hw[0], out_hw[1] / in_hw[1]))
    for scale in cases:
        g = GraphBuilder()
        g.resize_nearest_to("input", 2, 3, *out_hw, "rs", scale=scale)
        g.nodes[-1].outputs = ["out"]
        model = op.Model("t", g.nodes, g.initializers, [("input", op.FLOAT, (2, 3, *in_hw))],
                         [("out", op.FLOAT, (2, 3, *out_hw))], 19)
        got = make_runner(model, "cpu")({"input": x})["out"]
        np.testing.assert_array_equal(got, want.numpy())


def _verdicts(ref, run, probe, card):
    """The export CLIs' gate arithmetic: ``ref(x)`` the source model,
    ``run(graph, x)`` an executor, ``card`` the int8 gate's rendered
    probe."""
    from export_pose_torch import peaks

    out = {k: run(k, probe) for k in ("fp32", "fp16")}
    r = ref(probe)
    ref_card, out8 = run("fp32", card), run("int8", card)
    v = {"fp32": float(np.abs(out["fp32"] - r).max()) < FP32_GATE,
         "fp16": bool(np.all(np.abs(out["fp16"] - r) <= 1e-3 + 1e-2 * np.abs(r))),
         "int8": float(np.abs(peaks(out8) - peaks(ref_card)).max()) <= 1.0}
    for nb in (1, 4):
        xb = _nchw(10 + nb, nb)
        v[f"dynamic b{nb}"] = float(np.abs(run("dynamic", xb) - ref(xb)).max()) < FP32_GATE
    return v


@pytest.fixture(scope="module")
def barely_trained(tmp_path_factory):
    """The tree of two AdamW steps of PoseTrainer from Flax's default
    initial values (seed 0) on its own rendered stream, as a short
    training run leaves it."""
    from mtg_card_image_segmentation_tpu_torch.config import pose_default_config
    from mtg_card_image_segmentation_tpu_torch.data.pipeline import PoseSyntheticPipeline
    from mtg_card_image_segmentation_tpu_torch.training.pose_trainer import PoseTrainer

    tmp = tmp_path_factory.mktemp("barely")
    cfg = pose_default_config().with_cli(
        [a for a in SMALL[1:]] + ["train.num_epochs=1", "train.steps_per_epoch=2",
                                  f"train.checkpoint_dir={tmp}", f"train.log_dir={tmp}"])
    trainer = PoseTrainer(cfg, device="cpu")
    stream = PoseSyntheticPipeline(2, H, W, *HM, augment=None, seed=0, device="cpu")
    trainer.train(iter(stream), lambda: [stream.next_batch()],
                  lambda: [stream.next_batch()[0]])
    v = trainer.state.variables()
    return v["params"], v["batch_stats"]


# the verdicts of both packages on each tree: the seeded tree passes every
# gate; the barely trained one misses fp16 and int8 (its heatmaps reach
# ~10, where fp16's rounding exceeds 1e-3 + 1e-2 |ref| and int8 weights move
# the flat peaks), which is why chip_smoke lets the trained pose export miss
# those two and nothing else
VERDICTS = {"seeded": dict.fromkeys(GATES, True),
            "trained": {**dict.fromkeys(GATES, True), "fp16": False, "int8": False}}


@pytest.mark.parametrize("tree", ["seeded", "trained"])
def test_export_gate_verdicts_are_the_jax_packages(tree, weights, barely_trained):
    """The export gates' verdicts follow the weights, not the package: each
    package's own fp32 model as the reference and its own executor (the JAX
    mini runtime jitted, the torch executor on the CPU) running the same
    graph bytes, on the CLIs' [0,1] noise probe and one rendered card for
    int8, give the same verdicts, those of ``VERDICTS``."""
    params, stats = weights if tree == "seeded" else barely_trained
    folded = fold_batch_norm(params, stats)
    static = export_pose_model(folded, (H, W), HM)
    optimize(static)
    dynamic = export_pose_model(folded, (H, W), HM, dynamic_batch=True)
    optimize(dynamic)
    g = {"fp32": static, "dynamic": dynamic, "fp16": convert_to_fp16(static),
         "int8": convert_to_int8(static)}
    probe, card = _nchw(0, 1), export_pose_torch.int8_probe(H, W)
    jmodel = jax_create_model("hrnet_pose", heatmap_height=HM[0], heatmap_width=HM[1],
                              compute_dtype="float32")
    variables = {"params": params, "batch_stats": stats}
    apply = jax.jit(lambda v, xx: jmodel.apply(v, xx, train=False))
    jgraphs = {k: jax_runner(op.Model.parse(m.serialize())) for k, m in g.items()}
    with jax.default_matmul_precision("float32"):
        theirs = _verdicts(
            lambda x: np.asarray(apply(variables, x.transpose(0, 2, 3, 1))).transpose(0, 3, 1, 2),
            lambda k, x: np.asarray(jgraphs[k](jnp.asarray(x))), probe, card)
    runners = {k: make_runner(m, "cpu") for k, m in g.items()}
    ours = _verdicts(lambda x: _port_reference((params, stats), x),
                     lambda k, x: runners[k]({"input": x})["heatmaps"], probe, card)
    assert ours == theirs == VERDICTS[tree]


# --------------------------------------------------------------------------
# evaluators
# --------------------------------------------------------------------------


def _eval_batches(seed, n, h, w, b=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        img = rng.random((b, h, w, 3)).astype(np.float32)
        corners = np.stack([rng.uniform(0, w - 1, (b, 4)), rng.uniform(0, h - 1, (b, 4))],
                           -1).astype(np.float32)
        out.append((img, corners))
    return out


def _assert_reports_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if k in ("platform", "mean_inference_time_ms_per_image"):
            continue
        if k == "per_corner":
            for name, d in v.items():
                for kk, vv in d.items():
                    np.testing.assert_allclose(got[k][name][kk], vv, rtol=1e-3, atol=1e-3)
        elif k == "worst_cases":
            assert [c["index"] for c in got[k]] == [c["index"] for c in v]
            np.testing.assert_allclose([c["max_error_px"] for c in got[k]],
                                       [c["max_error_px"] for c in v], rtol=1e-3)
        elif isinstance(v, (bool, dict, int)):
            assert got[k] == v, k
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-3, atol=1e-3, err_msg=k)


def test_pose_evaluator_report_matches_jax(weights):
    """PoseEvaluator (gated sub-pixel decode) on two batches of three:
    every number of the report schema (accuracies at 3/5/6/10/20 px, per
    corner, detection rate, tiers, worst cases) as the JAX evaluator's."""
    from mtg_card_image_segmentation_tpu.evaluation import PoseEvaluator as JaxEvaluator

    batches = _eval_batches(1, 2, H, W)
    jmodel = jax_create_model("hrnet_pose", heatmap_height=HM[0], heatmap_width=HM[1],
                              compute_dtype="float32")
    want = JaxEvaluator(jmodel.apply, {"params": weights[0], "batch_stats": weights[1]},
                        (H, W)).evaluate(batches, worst_k=3)
    model = hrnet_from_flax(*weights, HM, dtype=torch.float32)
    got = PoseEvaluator(model, (H, W)).evaluate(
        [(torch.from_numpy(i), torch.from_numpy(c)) for i, c in batches], worst_k=3)
    assert got["platform"] == "cpu" and got["num_images"] == 6
    _assert_reports_equal(got, want)


def test_corner_evaluator_report_matches_jax():
    """CornerEvaluator (YOLO12n-pose top-1 detection) at 64x64 on the same
    batches as the JAX one, same report."""
    from mtg_card_image_segmentation_tpu.evaluation import CornerEvaluator as JaxCorner

    s = 64
    params, stats = init_yolo_flax_like(0)
    batches = _eval_batches(2, 2, s, s)
    jmodel = jax_create_model("yolo12n_pose", compute_dtype="float32")
    want = JaxCorner(jmodel.apply, {"params": params, "batch_stats": stats},
                     (s, s)).evaluate(batches, worst_k=2)
    got = CornerEvaluator(yolo_from_flax(params, stats, dtype=torch.float32), (s, s)).evaluate(
        [(torch.from_numpy(i), torch.from_numpy(c)) for i, c in batches], worst_k=2)
    _assert_reports_equal(got, want)


# --------------------------------------------------------------------------
# the CLIs
# --------------------------------------------------------------------------


def test_train_pose_cli_trains_and_resumes_on_cpu(tmp_path):
    """train_pose_torch.py --device cpu: one epoch of two steps, then
    --resume for a second; the history grows by one epoch."""
    sets = [*SMALL, "train.steps_per_epoch=2", f"train.checkpoint_dir={tmp_path / 'ck'}",
            f"train.log_dir={tmp_path / 'logs'}"]
    hist = train_pose_torch.main(["--device", "cpu", "--set", *sets[1:],
                                  "train.num_epochs=1"])
    assert len(hist["val_loss"]) == 1 and np.isfinite(hist["train_loss"]).all()
    again = train_pose_torch.main(["--device", "cpu", "--resume", "--set", *sets[1:],
                                   "train.num_epochs=2"])
    assert len(again["val_loss"]) == 2 and again["val_loss"][0] == hist["val_loss"][0]
    assert {"best_model", "final_model", "history.json"} <= set(os.listdir(tmp_path / "ck"))


def test_export_pose_cli_on_cpu(weights, tmp_path, capsys):
    """export_pose_torch.py --device cpu on a seeded checkpoint: the JAX
    CLI's files (pose.pt2 in place of its StableHLO artifact), pose.onnx with the JAX writer's bytes, the
    verdicts of the seeded tree (fp32 and dynamic pass), an exit code that
    agrees with them, and --info."""
    save_params(str(tmp_path), "seeded", *weights, epoch=2)
    out = tmp_path / "export"
    capsys.readouterr()
    args = ["--checkpoint", str(tmp_path / "seeded"), "--device", "cpu",
            "--output-dir", str(out), *SMALL]
    try:
        export_pose_torch.main(args)
        code = 0
    except SystemExit as e:
        assert str(e) == "parity gate FAILED"
        code = 1
    log = capsys.readouterr().out
    smoke = _chip_smoke()
    verdicts = smoke.export_gate_verdicts(log)
    assert set(verdicts) == set(GATES)
    assert smoke.export_gate_faults({"exit": code}, verdicts,
                                    frozenset({"fp16", "int8"})) == []
    assert {"pose.onnx", "pose_fp16.onnx", "pose_int8.onnx", "pose_dynamic.onnx", "pose.pt2",
            "pose.pt2.json"} <= set(os.listdir(out))
    ref = jax_onnx.export_pose_model(jax.tree.map(np.asarray, jax_fold(*weights)), (H, W), HM)
    jax_optimize(ref)
    assert (out / "pose.onnx").read_bytes() == ref.serialize()
    if code == 0:
        info = json.loads((out / "pose_info.json").read_text())
        assert info["torch_export"]["self_test_pass"] and info["parity"]["fp32_pass"]
        assert info["torch_export"]["self_test_max_diff"] < 1e-5
    info = export_pose_torch.main([*args, "--info"])
    assert info["parameters"] == 4_233_508 and info["epoch"] == 2
    assert info["heatmaps"] == [1, 4, *HM]


def test_evaluate_pose_cli_on_cpu(weights, tmp_path):
    """evaluate_pose_torch.py --device cpu for both families: the report,
    report.txt, both plots and the worst-case panels (matplotlib)."""
    save_params(str(tmp_path), "hrnet", *weights)
    save_params(str(tmp_path), "yolo", *init_yolo_flax_like(0))
    for family, extra in (("hrnet", SMALL), ("yolo", ["--imgsz", "64"])):
        out = tmp_path / f"eval_{family}"
        report = evaluate_pose_torch.main(
            ["--family", family, "--checkpoint", str(tmp_path / family), "--device", "cpu",
             "--batches", "2", "--batch-size", "2", "--worst-k", "2",
             "--output-dir", str(out), *extra])
        assert report["num_images"] == 4 and report["platform"] == "cpu"
        assert {"pose_evaluation.json", "report.txt", "error_distribution.png",
                "accuracy_curve.png"} <= set(os.listdir(out))
        assert len(os.listdir(out / "failures")) == 2
        assert json.loads((out / "pose_evaluation.json").read_text()) == json.loads(
            json.dumps(report))
