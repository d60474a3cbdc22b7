"""The port's YOLO12n-pose export against the JAX package's, on the CPU at
64x64 with the full-width model: ``export_yolo_model`` held to byte
identity with the JAX writer (static, dynamic, optimized, fp16, int8), the
torch executor on the YOLO graph (Concat, MatMul, Reshape, Slice, Softmax,
Sub, Transpose) against the folded and the unfolded model, the client
decode copy against the original and on the frozen fixture, both packages'
export-gate verdicts on one probe, and ``train_yolo_torch.py`` and
``export_yolo_torch.py`` end to end with ``--device cpu``.

Any difference in bytes is a fault of the port, not a tolerance.
"""

import importlib.util
import inspect
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
from mtg_card_image_segmentation_tpu.export import onnx_proto as jax_op
from mtg_card_image_segmentation_tpu.export import onnx_yolo as jax_onnx_yolo
from mtg_card_image_segmentation_tpu.export import yolo_client_decode as jax_decode
from mtg_card_image_segmentation_tpu.export.onnx_optimize import optimize as jax_optimize
from mtg_card_image_segmentation_tpu.export.onnx_runtime_mini import make_runner as jax_runner
from mtg_card_image_segmentation_tpu.export.quantize import convert_to_int8 as jax_int8
from mtg_card_image_segmentation_tpu.models import yolo12_pose as jax_yolo

import export_yolo_torch
import train_yolo_torch
from mtg_card_image_segmentation_tpu_torch.export import onnx_proto as op
from mtg_card_image_segmentation_tpu_torch.export import yolo_client_decode
from mtg_card_image_segmentation_tpu_torch.export.fold_bn import fold_batch_norm
from mtg_card_image_segmentation_tpu_torch.export.onnx_export import (
    GraphBuilder,
    convert_to_fp16,
)
from mtg_card_image_segmentation_tpu_torch.export.onnx_optimize import optimize
from mtg_card_image_segmentation_tpu_torch.export.onnx_torch_runner import make_runner
from mtg_card_image_segmentation_tpu_torch.export.onnx_yolo import export_yolo_model
from mtg_card_image_segmentation_tpu_torch.export.quantize import convert_to_int8
from mtg_card_image_segmentation_tpu_torch.models import yolo12_pose as yolo
from mtg_card_image_segmentation_tpu_torch.training.checkpoint import save_params
from mtg_card_image_segmentation_tpu_torch.utils.params import (
    init_yolo_flax_like,
    yolo_from_flax,
)

torch.set_num_threads(2)

S = 64
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "yolo_decode_fixture.npz")
GATES = ("fp32", "fp16", "int8", "dynamic b1", "dynamic b4")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def weights():
    return init_yolo_flax_like(0)


@pytest.fixture(scope="module")
def folded(weights):
    return fold_batch_norm(*weights)


def _nchw(seed, b):
    return np.random.default_rng(seed).random((b, 3, S, S)).astype(np.float32)


# --------------------------------------------------------------------------
# writer
# --------------------------------------------------------------------------


def _both(tree, case):
    dyn = case == "dynamic"
    port = export_yolo_model(tree, imgsz=S, dynamic_batch=dyn)
    ref = jax_onnx_yolo.export_yolo_model(tree, imgsz=S, dynamic_batch=dyn)
    if case == "optimized":
        assert optimize(port) == jax_optimize(ref)
    elif case == "fp16":
        port, ref = convert_to_fp16(port), jax_onnx.convert_to_fp16(ref)
    elif case == "int8":
        port, ref = convert_to_int8(port), jax_int8(ref)
    return port, ref


@pytest.mark.parametrize("case", ["static", "dynamic", "optimized", "fp16", "int8"])
def test_yolo_writer_bytes_equal_jax(case, folded):
    """The same serialized bytes as the JAX writer from the same folded
    tree: static, ``dynamic_batch=True``, after ``optimize`` (equal stats
    too), ``convert_to_fp16`` and ``convert_to_int8``; the graph holds the
    YOLO graph's tensor ops."""
    port, ref = _both(folded, case)
    a, b = port.serialize(), ref.serialize()
    assert len(a) == len(b) and a == b
    ops = {n.op_type for n in op.Model.parse(a).nodes}
    assert {"Concat", "MatMul", "Reshape", "Slice", "Softmax", "Sub", "Transpose"} <= ops


# --------------------------------------------------------------------------
# the executor
# --------------------------------------------------------------------------


def _reference(tree, stats, x_nchw):
    model = yolo_from_flax(tree, stats, dtype=torch.float32)
    with torch.no_grad():
        out = model(torch.from_numpy(np.ascontiguousarray(x_nchw.transpose(0, 2, 3, 1))))
    return export_yolo_torch.output0(*(o.numpy() for o in out))


@pytest.mark.parametrize("dynamic,b", [(False, 1), (True, 1), (True, 4)])
def test_runner_runs_the_yolo_graph_like_the_model(dynamic, b, folded, weights):
    """The CPU executor on the exported (optimized) bytes against the port's
    fp32 ``YOLO12Pose(fold_bn=True)`` and the unfolded eval model: max|d|
    below the fp32 export gate (2e-3 px) on a [0,1] probe."""
    graph = export_yolo_model(folded, imgsz=S, dynamic_batch=dynamic)
    optimize(graph)
    x = _nchw(b, b)
    got = make_runner(op.Model.parse(graph.serialize()), "cpu")({"input": x})["output0"]
    assert got.shape == (b, 17, 84) and got.dtype == np.float32
    assert np.abs(got - _reference(folded, None, x)).max() < export_yolo_torch.ATOL32
    assert np.abs(got - _reference(*weights, x)).max() < export_yolo_torch.ATOL32


def test_runner_tensor_ops_match_numpy():
    """Reshape (-1), Transpose, Slice (negative and past-the-end bounds),
    MatMul with broadcast leading dims, Softmax, Sub and Concat against
    numpy on one small graph."""
    g = GraphBuilder()
    r = g.reshape("input", (-1, 3, 4, 5), "r")
    t = g.transpose(r, (0, 2, 1, 3), "t")  # (2, 4, 3, 5)
    s = g.slice(t, [1, -4], [100, -1], [1, 3], "s")  # (2, 3, 3, 3)
    m = g.matmul(s, g.const(np.arange(9, dtype=np.float32).reshape(3, 3) / 9, "w"), "m")
    sm = g.softmax(m, -1, "sm")
    d = g.node("Sub", [sm, s], "d")
    g.concat([d, s], 2, "c")
    g.nodes[-1].outputs = ["out"]
    model = op.Model("t", g.nodes, g.initializers, [("input", op.FLOAT, (2, 60))],
                     [("out", op.FLOAT, (2, 3, 6, 3))], 19)
    x = np.random.default_rng(0).standard_normal((2, 60)).astype(np.float32)
    want_s = x.reshape(-1, 3, 4, 5).transpose(0, 2, 1, 3)[:, 1:, :, 1:4]
    mm = want_s @ (np.arange(9, dtype=np.float32).reshape(3, 3) / 9)
    e = np.exp(mm - mm.max(-1, keepdims=True))
    want = np.concatenate([e / e.sum(-1, keepdims=True) - want_s, want_s], 2)
    got = make_runner(op.Model.parse(model.serialize()), "cpu")({"input": x})["out"]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# the client decode
# --------------------------------------------------------------------------


def _output0_of(boxes, scores, kpts, i):
    return export_yolo_torch.output0(boxes[i:i + 1], scores[i:i + 1], kpts[i:i + 1])


def test_client_decode_copy_is_the_jax_packages():
    """The copy's code is the original's (only the module docstring
    differs), and it decodes 8 random output0 tensors (336 anchors, 4
    corners) to the original's box, score and corners, and to the port's
    top1_detection's corners within 1e-3 px."""
    body = inspect.getsource(yolo_client_decode).split('"""', 2)[2]
    assert body == inspect.getsource(jax_decode).split('"""', 2)[2]
    rng = np.random.default_rng(7)
    for _ in range(8):
        boxes = rng.uniform(0, 128, (1, 336, 4)).astype(np.float32)
        scores = rng.uniform(0, 1, (1, 336, 1)).astype(np.float32)
        kpts = np.concatenate([rng.uniform(0, 128, (1, 336, 4, 2)),
                               rng.uniform(0, 1, (1, 336, 4, 1))], -1).astype(np.float32)
        out0 = _output0_of(boxes, scores, kpts, 0)
        b, s, kp = yolo_client_decode.decode(out0)
        jb, js, jkp = jax_decode.decode(out0)
        np.testing.assert_array_equal(b, jb)
        assert s == js
        np.testing.assert_array_equal(kp, jkp)
        _, _, tk = yolo.top1_detection(*(torch.from_numpy(a) for a in (boxes, scores, kpts)))
        np.testing.assert_allclose(kp[:, :2], tk[0, :, :2].numpy(), rtol=1e-5, atol=1e-3)


def test_client_decode_on_the_fixture():
    """On the frozen real-model outputs (tests/fixtures/
    yolo_decode_fixture.npz): the copy's corners equal the original's and
    the port's top1_detection's (1e-3 px), within 20 px of the ground
    truth (tests/test_decode_fixtures.py's bound)."""
    fx = np.load(FIXTURE)
    boxes, scores, kpts = fx["boxes"], fx["scores"].astype(np.float32), fx["kpts"]
    _, _, tk = yolo.top1_detection(*(torch.from_numpy(a) for a in (boxes, scores, kpts)))
    for i in range(boxes.shape[0]):
        out0 = _output0_of(boxes, scores, kpts, i)
        _, _, kp = yolo_client_decode.decode(out0, num_keypoints=4)
        np.testing.assert_array_equal(kp, jax_decode.decode(out0, num_keypoints=4)[2])
        np.testing.assert_allclose(kp[:, :2], tk[i, :, :2].numpy(), rtol=1e-5, atol=1e-3)
        assert np.sqrt(((kp[:, :2] - fx["gt_corners"][i]) ** 2).sum(-1)).max() < 20.0


# --------------------------------------------------------------------------
# gate verdicts and the CLIs
# --------------------------------------------------------------------------


def _jax_verdicts(folded, graphs, card, gt):
    """``export_yolo.py``'s gate arithmetic (:150-288) on the same probes as
    ``export_yolo_torch.gates``: the JAX folded model, the JAX mini runtime
    on each graph's bytes, the JAX client decode."""
    model = jax_yolo.YOLO12Pose(fold_bn=True, dtype=jnp.float32)
    apply = jax.jit(lambda p, img: model.apply({"params": p}, img, train=False))
    params = jax.tree.map(jnp.asarray, folded)
    runners = {k: jax_runner(jax_op.Model.parse(g.serialize())) for k, g in graphs.items()}

    def run(k, x):
        return np.asarray(runners[k](jnp.asarray(x)))

    def ref(x):
        out = apply(params, jnp.asarray(np.transpose(x, (0, 2, 3, 1))))
        return export_yolo_torch.output0(*(np.asarray(o) for o in out))

    rng = np.random.default_rng(0)
    x = rng.random((1, 3, S, S)).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        r = ref(x)
        v = {"fp32": float(np.abs(run("fp32", x) - r).max()) < 2e-3}
        diff16 = np.abs(run("fp16", x) - r)
        prob = [4] + [i for i in range(5, 17) if (i - 5) % 3 == 2]
        px = [i for i in range(17) if i not in prob]
        v["fp16"] = float(diff16[:, px].max()) <= 1.0 and float(diff16[:, prob].max()) <= 1e-2
        err = {}
        for k in ("fp32", "int8"):
            c = np.asarray(jax_decode.decode(run(k, card))[2][:, :2], np.float64)
            err[k] = float(np.sqrt(((c - gt) ** 2).sum(-1)).mean())
        v["int8"] = err["int8"] <= err["fp32"] + 2.0
        for nb in (1, 4):
            xb = rng.random((nb, 3, S, S)).astype(np.float32)
            v[f"dynamic b{nb}"] = float(np.abs(run("dynamic", xb) - ref(xb)).max()) < 2e-3
    return v


def test_export_gate_verdicts_are_the_jax_packages(weights, folded, capsys):
    """On one probe set (the CLIs' [0,1] noise, the port's rendered int8
    card) each package's own folded fp32 model and executor (the JAX mini
    runtime jitted, the torch executor on the CPU) running the same graph
    bytes give the same verdicts: every gate passes on the seeded tree."""
    static = export_yolo_model(folded, imgsz=S)
    optimize(static)
    dynamic = export_yolo_model(folded, imgsz=S, dynamic_batch=True)
    optimize(dynamic)
    graphs = {"fp32": static, "fp16": convert_to_fp16(static),
              "int8": convert_to_int8(static), "dynamic": dynamic}
    card, gt = export_yolo_torch.int8_probe(S)
    assert card.shape == (1, 3, S, S) and gt.shape == (4, 2)
    capsys.readouterr()
    parity = export_yolo_torch.gates(yolo_from_flax(folded, None, dtype=torch.float32),
                                     {k: op.Model.parse(g.serialize()) for k, g in graphs.items()},
                                     "cpu", card, gt)
    printed = _chip_smoke().export_gate_verdicts(capsys.readouterr().out)
    ours = export_yolo_torch._verdicts(parity)
    assert printed == {k: "PASS" if v else "FAIL" for k, v in ours.items()}
    assert ours == _jax_verdicts(folded, graphs, card, gt) == dict.fromkeys(GATES, True)


def test_train_yolo_cli_trains_and_resumes_on_cpu(tmp_path):
    """train_yolo_torch.py --device cpu at 64x64 b2: one epoch of two
    steps, then --resume for a second; the history grows by one epoch, and
    the checkpoints of the JAX CLI are written."""
    sets = ["--device", "cpu", "--imgsz", str(S), "--set", "data.batch_size=2",
            "train.steps_per_epoch=2", "train.save_every_epochs=1",
            f"train.checkpoint_dir={tmp_path / 'ck'}", f"train.log_dir={tmp_path / 'logs'}"]
    hist = train_yolo_torch.main([*sets, "train.num_epochs=1"])
    assert len(hist["val_mean_corner_distance"]) == 1 and np.isfinite(hist["train_loss"]).all()
    again = train_yolo_torch.main(["--resume", *sets, "train.num_epochs=2"])
    assert len(again["val_mean_corner_distance"]) == 2
    assert again["val_mean_corner_distance"][0] == hist["val_mean_corner_distance"][0]
    assert {"best_model", "final_model", "checkpoint_epoch_1", "checkpoint_epoch_2",
            "history.json"} <= set(os.listdir(tmp_path / "ck"))
    meta = json.loads((tmp_path / "ck" / "final_model.meta.json").read_text())
    assert meta["epoch"] == 1 and meta["best_metric"] == min(again["val_mean_corner_distance"])


def test_export_yolo_cli_on_cpu(weights, tmp_path, capsys):
    """export_yolo_torch.py --device cpu on a seeded checkpoint: the JAX
    CLI's files (yolo.pt2 in place of its StableHLO artifact), yolo.onnx
    with the JAX writer's bytes, the
    shipped decode_yolo.py, five verdicts that all pass and exit 0, and
    --info."""
    save_params(str(tmp_path), "seeded", *weights, epoch=2)
    out = tmp_path / "export"
    capsys.readouterr()
    args = ["--checkpoint", str(tmp_path / "seeded"), "--device", "cpu", "--imgsz", str(S),
            "--output-dir", str(out)]
    info = export_yolo_torch.main(args)
    log = capsys.readouterr().out
    smoke = _chip_smoke()
    verdicts = smoke.export_gate_verdicts(log)
    assert verdicts == dict.fromkeys(GATES, "PASS")
    assert smoke.export_gate_faults({"exit": 0}, verdicts, frozenset()) == []
    assert {"yolo.onnx", "yolo_fp16.onnx", "yolo_int8.onnx", "yolo_dynamic.onnx",
            "yolo.pt2", "yolo.pt2.json", "yolo_info.json", "decode_yolo.py"} <= set(
                os.listdir(out))
    ref = jax_onnx_yolo.export_yolo_model(jax.tree.map(np.asarray, jax_fold(*weights)), imgsz=S)
    jax_optimize(ref)
    assert (out / "yolo.onnx").read_bytes() == ref.serialize()
    assert (out / "decode_yolo.py").read_text() == Path(yolo_client_decode.__file__).read_text()
    saved = json.loads((out / "yolo_info.json").read_text())
    assert saved["torch_export"]["self_test_pass"] and saved["parity"]["fp32_pass"]
    assert saved["torch_export"]["self_test_max_diff"] < 1e-5
    assert saved["torch_export"]["bytes"] == (out / "yolo.pt2").stat().st_size
    assert saved == json.loads(json.dumps(info))
    info = export_yolo_torch.main([*args, "--info"])
    assert info["parameters"] == 2_640_455 and info["epoch"] == 2
    assert info["output0"] == [1, 17, 84]
