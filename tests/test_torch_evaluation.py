"""The port's segmentation evaluator (``evaluation/segmentation.py``,
``evaluation/worstk.py``, ``utils/plots.py``) against the JAX package's, on
the CPU, and ``evaluate_seg_torch.py`` end to end with ``--device cpu``.

Both packages run the fp32 full-width model (LR-ASPP / MobileNetV3-Large)
from the same seeded weights over 3 batches of 4 at 64x48, the last padded
(2 valid rows): confusion matrices equal, per-image IoU within 1e-6, the
same failures and worst-k indices, the same report keys and targets, the
panels under the same file names.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from mtg_card_image_segmentation_tpu.evaluation import SegEvaluator as JaxSegEvaluator
from mtg_card_image_segmentation_tpu.models import create_model as jax_create_model

import evaluate_seg_torch
from mtg_card_image_segmentation_tpu_torch.evaluation import SegEvaluator
from mtg_card_image_segmentation_tpu_torch.evaluation.worstk import merge_worst_k
from mtg_card_image_segmentation_tpu_torch.training.checkpoint import save_params
from mtg_card_image_segmentation_tpu_torch.utils.params import from_flax, init_flax_like

torch.set_num_threads(2)

H, W, B = 64, 48, 4
SMALL = ["--set", f"model.input_height={H}", f"model.input_width={W}", "data.batch_size=2"]


@pytest.fixture(scope="module")
def weights():
    return init_flax_like(0)


@pytest.fixture(scope="module")
def batches(weights):
    """3 batches (images, masks, valid): every other image's mask is the
    model's own prediction (IoU 1, or no card at all: union 0), the others
    a random rectangle; the last batch has 2 valid rows and 2 of padding."""
    rng = np.random.default_rng(5)
    model = from_flax(*weights, dtype=torch.float32)
    out = []
    for b in range(3):
        imgs = rng.standard_normal((B, H, W, 3)).astype(np.float32)
        with torch.no_grad():
            own = model(torch.from_numpy(imgs)).argmax(-1).numpy().astype(np.int32)
        masks = np.zeros((B, H, W), np.int32)
        for i in range(B):
            if i % 2:
                masks[i] = own[i]
            else:
                y0, x0 = rng.integers(0, H // 2), rng.integers(0, W // 2)
                masks[i, y0:y0 + H // 2, x0:x0 + W // 2] = 1
        out.append((imgs, masks, B if b < 2 else 2))
    return out


@pytest.fixture(scope="module")
def reports(weights, batches, tmp_path_factory):
    """Both evaluators' reports and output directories (3 failures at most,
    worst-k 3)."""
    kw = dict(failure_iou_threshold=0.5, max_failures=3, worst_k=3, save_plots=True)
    jdir = tmp_path_factory.mktemp("jax")
    jmodel = jax_create_model("lraspp_mobilenet_v3_large", compute_dtype="float32")
    jev = JaxSegEvaluator(jmodel.apply, {"params": jax.tree.map(np.asarray, weights[0]),
                                         "batch_stats": jax.tree.map(np.asarray, weights[1])})
    jrep = jev.evaluate(batches, output_dir=str(jdir), **kw)
    pdir = tmp_path_factory.mktemp("port")
    (pdir / "failures").mkdir()
    (pdir / "failures" / "worst_00_iou0.999.png").write_bytes(b"stale panel")
    ev = SegEvaluator(from_flax(*weights, dtype=torch.float32))
    rep = ev.evaluate([(torch.from_numpy(i), torch.from_numpy(m), v) for i, m, v in batches],
                      output_dir=str(pdir), **kw)
    return {"jax": (jrep, jdir), "port": (rep, pdir)}


def test_confusion_matrix_and_metrics_equal_jax(reports):
    (jrep, _), (rep, _) = reports["jax"], reports["port"]
    assert rep["confusion_matrix"] == jrep["confusion_matrix"]
    assert sum(map(sum, rep["confusion_matrix"])) == 10 * H * W  # padding weighted out
    assert rep["metrics"] == jrep["metrics"]
    assert rep["num_images"] == jrep["num_images"] == 10


def test_per_image_iou_failures_and_worst_k_equal_jax(reports):
    (jrep, _), (rep, _) = reports["jax"], reports["port"]
    for k in ("mean", "median", "min"):
        assert abs(rep["per_image_iou"][k] - jrep["per_image_iou"][k]) <= 1e-6, k
    for k in ("below_threshold", "threshold"):
        assert rep["per_image_iou"][k] == jrep["per_image_iou"][k]
    assert len(rep["failures"]) == 3 and rep["per_image_iou"]["below_threshold"] > 3
    assert [(f["batch"], f["index_in_batch"]) for f in rep["failures"]] == \
        [(f["batch"], f["index_in_batch"]) for f in jrep["failures"]]
    for f, g in zip(rep["failures"], jrep["failures"]):
        assert abs(f["iou"] - g["iou"]) <= 1e-6
    assert [w["index"] for w in rep["worst_cases"]] == [w["index"] for w in jrep["worst_cases"]]
    assert len(rep["worst_cases"]) == 3
    for w, v in zip(rep["worst_cases"], jrep["worst_cases"]):
        assert abs(w["iou"] - v["iou"]) <= 1e-6
    # the worst-k skip the images already mined as failures
    mined = {f["batch"] * B + f["index_in_batch"] for f in rep["failures"]}
    assert not mined & {w["index"] for w in rep["worst_cases"]}


def test_report_keys_targets_and_panels_equal_jax(reports):
    """The same report (keys, targets, panel paths) and the same files,
    the stale panel cleared."""
    (jrep, jdir), (rep, pdir) = reports["jax"], reports["port"]
    assert set(rep) == set(jrep) and rep["targets"] == jrep["targets"]
    assert [f["panel"] for f in rep["failures"]] == [f["panel"] for f in jrep["failures"]]
    assert [w["panel"] for w in rep["worst_cases"]] == [w["panel"] for w in jrep["worst_cases"]]
    files = sorted(os.listdir(pdir / "failures"))
    assert files == sorted(os.listdir(jdir / "failures")) and len(files) == 6
    assert "worst_00_iou0.999.png" not in files
    for f in files:
        assert (pdir / "failures" / f).stat().st_size > 1000
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
    assert {"confusion_matrix.png", "prediction_analysis.png",
            "evaluation_report.json"} <= set(os.listdir(pdir))
    on_disk = json.loads((pdir / "evaluation_report.json").read_text())
    assert on_disk == json.loads(json.dumps(rep))


def test_merge_worst_k_multi_displacement():
    """tests/test_evaluation.py::test_merge_worst_k_multi_displacement, on
    the port's copy: a full buffer accepts EVERY qualifying candidate from
    one batch; entries are built lazily, only on admission."""
    built = []

    def entry(tag):
        return lambda: (built.append(tag) or tag,)

    # seg-style (smaller IoU = more extreme)
    buf = [(0.2, "a"), (0.3, "b"), (0.5, "c")]
    merge_worst_k(
        buf, [(0.1, entry("d")), (0.25, entry("e")), (0.45, entry("f"))],
        3, reverse=False,
    )
    assert [k for k, *_ in buf] == [0.1, 0.2, 0.25]
    assert built == ["d", "e"]  # 0.45 rejected without building

    # pose-style (larger error = more extreme)
    buf2 = [(10.0, "a"), (9.0, "b"), (8.0, "c")]
    merge_worst_k(
        buf2, [(12.0, entry("x")), (9.5, entry("y")), (7.0, entry("z"))],
        3, reverse=True,
    )
    assert [k for k, *_ in buf2] == [12.0, 10.0, 9.5]
    assert built == ["d", "e", "x", "y"]


def _write_split(root, count, seed):
    """``count`` JPEG frames 48x64 (w x h) with PNG masks: a bright
    rectangle."""
    import cv2

    r = np.random.default_rng(seed)
    for sub in ("images", "masks"):
        os.makedirs(os.path.join(root, "test", sub), exist_ok=True)
    for i in range(count):
        img = r.integers(0, 256, (H, W, 3), np.uint8)
        mask = np.zeros((H, W), np.uint8)
        mask[8:40, 6:30] = 255
        cv2.imwrite(os.path.join(root, "test", "images", f"f{i:03d}.jpg"), img)
        cv2.imwrite(os.path.join(root, "test", "masks", f"f{i:03d}.png"), mask)


def test_evaluate_cli_on_cpu(weights, tmp_path):
    """``evaluate_seg_torch.py --device cpu`` at 64x48 b2 on a seeded
    checkpoint: the synthetic source, then the file source over 5 frames
    (the padded tail batch adds no counts); with ``--failure-threshold 0
    --worst-k 0`` nothing is plotted, as on a host without matplotlib."""
    save_params(str(tmp_path), "final_model", *weights)
    ck = str(tmp_path / "final_model")
    out = tmp_path / "synthetic"
    rep = evaluate_seg_torch.main(["--checkpoint", ck, "--device", "cpu", "--batches", "2",
                                   "--output-dir", str(out), *SMALL])
    assert rep["num_images"] == 4 and sum(map(sum, rep["confusion_matrix"])) == 4 * H * W
    assert json.loads((out / "evaluation_report.json").read_text()) == json.loads(json.dumps(rep))
    _write_split(str(tmp_path / "ds"), 5, seed=2)
    out = tmp_path / "files"
    rep = evaluate_seg_torch.main(["--checkpoint", ck, "--device", "cpu", "--source", "files",
                                   "--failure-threshold", "0", "--worst-k", "0",
                                   "--output-dir", str(out), *SMALL,
                                   f"data.dataset_root={tmp_path / 'ds'}"])
    assert rep["num_images"] == 5 and sum(map(sum, rep["confusion_matrix"])) == 5 * H * W
    assert rep["failures"] == [] and rep["worst_cases"] == []
    assert os.listdir(out / "failures") == []


def test_evaluate_cli_defaults_to_the_card(weights, tmp_path, monkeypatch):
    save_params(str(tmp_path), "final_model", *weights)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_seg_torch.main(["--checkpoint", str(tmp_path / "final_model"), *SMALL])
