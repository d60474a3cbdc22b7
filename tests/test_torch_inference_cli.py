"""The port's inference CLIs and ONNX artifact ladder against the JAX
package's, on the CPU: ``serving/artifact_backend.py::load_onnx`` (the
ladder's order, a corrupted rung falling to the next with its reason, every
rung broken), ``seg_inference_torch.py`` and ``pose_inference_torch.py``
against ``seg_inference.py`` and ``pose_inference.py`` on the same
``--image`` file (an Orbax checkpoint of seeded weights for the JAX CLIs,
converted by ``tools/orbax_to_torch_checkpoint.py`` for the port's, and
the same ONNX package for both; YOLO12n-pose from its ONNX package through
the client decode), ``--pt2`` (the ``torch.export`` artifact in the same
packages) against ``--checkpoint`` and, for YOLO, against the fp32 ONNX
graph, and the new CLIs end to end with ``--device cpu``.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import optax

from mtg_card_image_segmentation_tpu.models import create_model as jax_create_model
from mtg_card_image_segmentation_tpu.serving import artifact_backend as jax_backend
from mtg_card_image_segmentation_tpu.training.checkpoint import save_checkpoint as jax_save
from mtg_card_image_segmentation_tpu.training.state import SegTrainState as JaxState

import pose_inference_torch
import seg_inference_torch
from mtg_card_image_segmentation_tpu_torch.export.fold_bn import fold_batch_norm
from mtg_card_image_segmentation_tpu_torch.export.onnx_export import (
    convert_to_fp16,
    export_pose_model,
    export_seg_model,
)
from mtg_card_image_segmentation_tpu_torch.export.onnx_optimize import optimize
from mtg_card_image_segmentation_tpu_torch.export.onnx_yolo import export_yolo_model
from mtg_card_image_segmentation_tpu_torch.export.quantize import convert_to_int8
from mtg_card_image_segmentation_tpu_torch.export.torch_export import (
    NCHW,
    YoloOutput0,
    export_program,
)
from mtg_card_image_segmentation_tpu_torch.serving import artifact_backend
from mtg_card_image_segmentation_tpu_torch.training.checkpoint import save_params
from mtg_card_image_segmentation_tpu_torch.utils.params import (
    from_flax,
    hrnet_from_flax,
    init_flax_like,
    init_hrnet_flax_like,
    init_yolo_flax_like,
    yolo_from_flax,
)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SEG_HW, POSE_HW, HM, YOLO_S = (64, 48), (64, 96), (16, 24), 64
SEG_SET = ["--set", f"model.input_height={SEG_HW[0]}", f"model.input_width={SEG_HW[1]}",
           "model.compute_dtype=float32"]
POSE_SET = ["--set", f"pose.input_height={POSE_HW[0]}", f"pose.input_width={POSE_HW[1]}",
            f"pose.heatmap_height={HM[0]}", f"pose.heatmap_width={HM[1]}",
            "pose.compute_dtype=float32"]


def _package(tmp, family, graph):
    """A deployment-package directory with the family's four ladder files."""
    names = artifact_backend.ONNX_LADDERS[family]
    d = tmp / family
    d.mkdir()
    optimize(graph)
    convert_to_int8(graph).save(str(d / names[0]))
    convert_to_fp16(graph).save(str(d / names[1]))
    graph.save(str(d / names[2]))
    graph.save(str(d / names[3]))
    return d


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """Seeded seg and HRNet weights as Orbax checkpoints (JAX) and their
    conversions (port), their ONNX packages and a YOLO one at 64x64, and a
    100x72 photo-like PNG."""
    import cv2

    sys.path.insert(0, str(REPO / "tools"))
    try:
        import orbax_to_torch_checkpoint as conv
    finally:
        sys.path.remove(str(REPO / "tools"))
    tmp = tmp_path_factory.mktemp("inference")
    trees = {"seg": init_flax_like(0), "hrnet": init_hrnet_flax_like(0)}
    for name, (params, stats) in trees.items():
        model = jax_create_model("lraspp_mobilenet_v3_large" if name == "seg" else "hrnet_pose")
        state = JaxState.create(apply_fn=model.apply, params=jax.tree.map(np.asarray, params),
                                batch_stats=jax.tree.map(np.asarray, stats), tx=optax.sgd(0.1))
        jax_save(str(tmp / "orbax"), name, state, epoch=1)
        conv.convert(str(tmp / "orbax"), name, str(tmp / "torch"), name)
    packages = {
        "seg": _package(tmp, "seg", export_seg_model(fold_batch_norm(*trees["seg"]), SEG_HW)),
        "hrnet": _package(tmp, "hrnet", export_pose_model(fold_batch_norm(*trees["hrnet"]),
                                                          POSE_HW, HM)),
        "yolo": _package(tmp, "yolo", export_yolo_model(fold_batch_norm(*init_yolo_flax_like(0)),
                                                        imgsz=YOLO_S))}
    # each package's torch.export artifact, from the same trees, in float32
    programs = {"seg": (NCHW(from_flax(*trees["seg"], dtype=torch.float32)), SEG_HW),
                "hrnet": (NCHW(hrnet_from_flax(*trees["hrnet"], HM, dtype=torch.float32)),
                          POSE_HW),
                "yolo": (YoloOutput0(yolo_from_flax(fold_batch_norm(*init_yolo_flax_like(0)),
                                                    None, dtype=torch.float32)),
                         (YOLO_S, YOLO_S))}
    for family, (module, hw) in programs.items():
        export_program(module, (torch.zeros(1, 3, *hw),),
                       str(packages[family] / artifact_backend.PROGRAM_NAMES[family]))
    rng = np.random.default_rng(0)
    base = torch.from_numpy(rng.random((1, 3, 9, 6)).astype(np.float32))
    img = torch.nn.functional.interpolate(base, size=(100, 72), mode="bilinear",
                                          align_corners=False)[0].permute(1, 2, 0).numpy()
    image = tmp / "card.png"
    cv2.imwrite(str(image), (img * 255).round().astype(np.uint8))
    return {"tmp": tmp, "packages": packages, "image": str(image)}


# --------------------------------------------------------------------------
# the ladder
# --------------------------------------------------------------------------


def test_ladders_are_the_jax_packages():
    assert artifact_backend.ONNX_LADDERS == jax_backend.ONNX_LADDERS


@pytest.mark.parametrize("family", ["seg", "hrnet", "yolo"])
def test_ladder_takes_the_int8_rung_first(work, family):
    d = work["packages"][family]
    fn, chosen, reasons = artifact_backend.load_onnx(str(d), family, "cpu")
    assert os.path.basename(chosen) == artifact_backend.ONNX_LADDERS[family][0]
    assert reasons == []
    h, w = {"seg": SEG_HW, "hrnet": POSE_HW, "yolo": (YOLO_S, YOLO_S)}[family]
    out = fn(np.zeros((1, 3, h, w), np.float32))
    assert out.shape == {"seg": (1, 2, h, w), "hrnet": (1, 4, *HM), "yolo": (1, 17, 84)}[family]
    assert os.path.basename(jax_backend.load_onnx(str(d), family)[1]) == os.path.basename(chosen)


def test_corrupted_int8_rung_falls_to_fp16_with_its_reason(work, tmp_path):
    """A corrupt int8 file falls to fp16, the reason names the file; an
    int8 graph that parses but holds an op outside the executor's set
    falls at the probe; every rung broken raises with every reason."""
    src = work["packages"]["seg"]
    d = tmp_path / "pkg"
    d.mkdir()
    for n in artifact_backend.ONNX_LADDERS["seg"]:
        (d / n).write_bytes((src / n).read_bytes())
    (d / "model_int8.onnx").write_bytes(b"not a protobuf")
    _, chosen, reasons = artifact_backend.load_onnx(str(d), "seg", "cpu")
    assert chosen.endswith("model_fp16.onnx")
    assert len(reasons) == 1 and reasons[0].startswith("model_int8.onnx: ")

    from mtg_card_image_segmentation_tpu_torch.export import onnx_proto as op

    bad = op.Model.load(str(src / "model_int8.onnx"))
    bad.nodes[0].op_type = "Gelu"
    bad.save(str(d / "model_int8.onnx"))
    _, chosen, reasons = artifact_backend.load_onnx(str(d), "seg", "cpu")
    assert chosen.endswith("model_fp16.onnx") and "Gelu" in reasons[0]

    for n in artifact_backend.ONNX_LADDERS["seg"]:
        (d / n).write_bytes(b"broken")
    with pytest.raises(RuntimeError, match="every ONNX artifact in the ladder failed") as e:
        artifact_backend.load_onnx(str(d), "seg", "cpu")
    assert all(n in str(e.value) for n in artifact_backend.ONNX_LADDERS["seg"])
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        artifact_backend.load_onnx(str(tmp_path / "empty"), "seg", "cpu")


def test_single_file_and_the_card_default(work, monkeypatch):
    """An .onnx file path is taken as it is; without a device the ladder
    runs on the card, which this host lacks."""
    path = str(work["packages"]["seg"] / "model.onnx")
    _, chosen, reasons = artifact_backend.load_onnx(path, "seg", "cpu")
    assert chosen == path and reasons == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="every ONNX artifact") as e:
        artifact_backend.load_onnx(path, "seg")
    assert "CUDA is not available" in str(e.value)


# --------------------------------------------------------------------------
# the CLIs against the JAX CLIs
# --------------------------------------------------------------------------


def _jax_cli(module, args, out, monkeypatch):
    mod = __import__(module)
    monkeypatch.setattr(sys, "argv", [f"{module}.py", *args, "--output-dir", str(out)])
    mod.main()
    return json.loads((out / "results.json").read_text())


@pytest.mark.parametrize("source", ["checkpoint", "onnx"])
def test_seg_inference_matches_the_jax_cli(work, source, tmp_path, monkeypatch):
    """The card fraction and confidence of the same --image within 1e-3,
    from a checkpoint (fp32) and from the same ONNX package (int8 rung)."""
    tmp = work["tmp"]
    src = {"checkpoint": (["--checkpoint", str(tmp / "orbax" / "seg")],
                          ["--checkpoint", str(tmp / "torch" / "seg")]),
           "onnx": (["--onnx", str(work["packages"]["seg"])],) * 2}[source]
    want = _jax_cli("seg_inference", [*src[0], "--image", work["image"], *SEG_SET],
                    tmp_path / "jax", monkeypatch)
    got = seg_inference_torch.main([*src[1], "--image", work["image"], "--device", "cpu",
                                    "--output-dir", str(tmp_path / "port"), *SEG_SET])
    assert got["ladder_fell_past"] == []
    (g,), (w,) = got["results"], want
    assert g["sample"] == w["sample"] == "card.png"
    assert abs(g["card_pixel_fraction"] - w["card_pixel_fraction"]) <= 1e-3
    assert 0.0 < w["card_pixel_fraction"] < 1.0
    assert abs(g["mean_card_confidence"] - w["mean_card_confidence"]) <= 1e-3


@pytest.mark.parametrize("source", ["checkpoint", "onnx"])
def test_pose_inference_matches_the_jax_cli(work, source, tmp_path, monkeypatch):
    """The four corners of the same --image within 1e-3 px of the JAX CLI's
    (both round to 0.01 px), the same validity, from a checkpoint (fp32)
    and from the same ONNX package (int8 rung)."""
    tmp = work["tmp"]
    src = {"checkpoint": (["--checkpoint", str(tmp / "orbax" / "hrnet")],
                          ["--checkpoint", str(tmp / "torch" / "hrnet")]),
           "onnx": (["--onnx", str(work["packages"]["hrnet"])],) * 2}[source]
    want = _jax_cli("pose_inference", [*src[0], "--image", work["image"], *POSE_SET],
                    tmp_path / "jax", monkeypatch)
    got = pose_inference_torch.main([*src[1], "--image", work["image"], "--device", "cpu",
                                     "--output-dir", str(tmp_path / "port"), *POSE_SET])
    (g,), (w,) = got["results"], want
    np.testing.assert_allclose(g["corners_xy"], w["corners_xy"], rtol=0, atol=1e-3)
    assert g["valid"] == w["valid"]
    np.testing.assert_allclose(g["confidences"], w["confidences"], rtol=0, atol=1e-3)


def test_yolo_onnx_inference_matches_the_jax_cli(work, tmp_path, monkeypatch):
    """--family yolo --onnx on the same package and --image as the JAX CLI:
    both take the int8 rung, and the client-decoded corners and confidences
    agree within 1e-3 px (both round to 0.01 px)."""
    args = ["--onnx", str(work["packages"]["yolo"]), "--family", "yolo", "--imgsz",
            str(YOLO_S), "--image", work["image"]]
    want = _jax_cli("pose_inference", args, tmp_path / "jax", monkeypatch)
    got = pose_inference_torch.main([*args, "--device", "cpu", "--output-dir",
                                     str(tmp_path / "port")])
    assert got["source"].endswith("yolo_int8.onnx") and got["ladder_fell_past"] == []
    (g,), (w,) = got["results"], want
    assert np.asarray(g["corners_xy"]).shape == (4, 2)
    np.testing.assert_allclose(g["corners_xy"], w["corners_xy"], rtol=0, atol=1e-3)
    assert g["valid"] == w["valid"]
    np.testing.assert_allclose(g["confidences"], w["confidences"], rtol=0, atol=1e-3)


@pytest.mark.parametrize("family", ["seg", "hrnet"])
def test_pt2_gives_the_checkpoints_float32_output(work, family, tmp_path):
    """--pt2 on the package against --checkpoint on the same trees, float32,
    the same --image: the seg card fraction equal and its confidence within
    1e-6 (and the program's mask equal to the model's at every pixel of a
    probe), the HRNet corners within 1e-3 px (both round to 0.01 px)."""
    tmp, mod = work["tmp"], {"seg": seg_inference_torch, "hrnet": pose_inference_torch}[family]
    sets = SEG_SET if family == "seg" else POSE_SET
    runs = {src: mod.main([*args, "--image", work["image"], "--device", "cpu",
                           "--output-dir", str(tmp_path / src), *sets])
            for src, args in (("pt2", ["--pt2", str(work["packages"][family])]),
                              ("checkpoint", ["--checkpoint", str(tmp / "torch" / family)]))}
    assert runs["pt2"]["source"].endswith(artifact_backend.PROGRAM_NAMES[family])
    assert runs["pt2"]["ladder_fell_past"] == []
    (g,), (w,) = runs["pt2"]["results"], runs["checkpoint"]["results"]
    if family == "hrnet":
        np.testing.assert_allclose(g["corners_xy"], w["corners_xy"], rtol=0, atol=1e-3)
        assert g["valid"] == w["valid"]
        return
    assert g["card_pixel_fraction"] == w["card_pixel_fraction"]
    assert 0.0 < w["card_pixel_fraction"] < 1.0
    assert abs(g["mean_card_confidence"] - w["mean_card_confidence"]) <= 1e-6
    runner, _ = artifact_backend.load_program(str(work["packages"]["seg"]), "seg", "cpu")
    x = np.random.default_rng(4).standard_normal((1, 3, *SEG_HW)).astype(np.float32)
    model = from_flax(*init_flax_like(0), dtype=torch.float32)
    with torch.no_grad():
        want = model(torch.from_numpy(x.transpose(0, 2, 3, 1))).numpy().argmax(-1)
    assert (runner(x).argmax(1) == want).all()


def test_yolo_pt2_matches_its_fp32_onnx_graph(work, tmp_path):
    """--family yolo --pt2 and --onnx on the fp32 graph of the same package:
    the same client decode of the same output0, corners within 1e-3 px."""
    pkg = work["packages"]["yolo"]
    common = ["--family", "yolo", "--imgsz", str(YOLO_S), "--image", work["image"],
              "--device", "cpu"]
    got = pose_inference_torch.main(["--pt2", str(pkg), *common, "--output-dir",
                                     str(tmp_path / "pt2")])
    want = pose_inference_torch.main(["--onnx", str(pkg / "yolo.onnx"), *common,
                                      "--output-dir", str(tmp_path / "onnx")])
    assert got["source"].endswith("yolo.pt2")
    (g,), (w,) = got["results"], want["results"]
    np.testing.assert_allclose(g["corners_xy"], w["corners_xy"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(g["confidences"], w["confidences"], rtol=0, atol=1e-3)


# --------------------------------------------------------------------------
# end to end
# --------------------------------------------------------------------------


def test_inference_clis_end_to_end_on_cpu(work, tmp_path, capsys):
    """Synthetic samples, --visualize, YOLO from a checkpoint, the printed
    ladder line, and the JSON line per sample."""
    tmp = work["tmp"]
    r = seg_inference_torch.main(["--onnx", str(work["packages"]["seg"]), "--synthetic", "2",
                                  "--visualize", "--device", "cpu", "--output-dir",
                                  str(tmp_path / "seg"), *SEG_SET])
    assert [x["sample"] for x in r["results"]] == ["synthetic_0", "synthetic_1"]
    assert r["source"].endswith("model_int8.onnx")
    out = capsys.readouterr().out
    assert "ladder fell past: []" in out
    assert sum(1 for ln in out.splitlines() if ln.startswith('{"sample"')) == 2
    assert {"synthetic_0_mask.png", "results.json"} <= set(os.listdir(tmp_path / "seg"))
    r = pose_inference_torch.main(["--checkpoint", str(tmp / "torch" / "hrnet"), "--synthetic",
                                   "1", "--visualize", "--device", "cpu", "--output-dir",
                                   str(tmp_path / "pose"), *POSE_SET])
    assert len(r["results"][0]["corners_xy"]) == 4
    assert "synthetic_0_corners.png" in os.listdir(tmp_path / "pose")
    save_params(str(tmp_path), "yolo", *init_yolo_flax_like(0))
    r = pose_inference_torch.main(["--checkpoint", str(tmp_path / "yolo"), "--family", "yolo",
                                   "--imgsz", "64", "--image", work["image"], "--device", "cpu",
                                   "--output-dir", str(tmp_path / "yolo_out")])
    xy = np.asarray(r["results"][0]["corners_xy"])
    assert xy.shape == (4, 2) and np.isfinite(xy).all()


def test_inference_clis_refuse_what_is_not_ported_and_need_the_card(work, tmp_path,
                                                                     monkeypatch):
    """--family yolo --onnx runs (a synthetic sample through the YOLO
    ladder's int8 rung on the CPU); --pt2 runs (the seg program, a
    synthetic sample), and no two sources go together; without --device
    cpu the CLIs ask for the card and raise where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    r = pose_inference_torch.main(["--onnx", str(work["packages"]["yolo"]), "--family", "yolo",
                                   "--imgsz", str(YOLO_S), "--synthetic", "1", "--device", "cpu",
                                   "--output-dir", str(tmp_path / "yolo")])
    assert r["source"].endswith("yolo_int8.onnx") and r["ladder_fell_past"] == []
    xy = np.asarray(r["results"][0]["corners_xy"])
    assert xy.shape == (4, 2) and np.isfinite(xy).all()
    r = seg_inference_torch.main(["--pt2", str(work["packages"]["seg"]), "--synthetic", "1",
                                  "--device", "cpu", "--output-dir", str(tmp_path / "seg"),
                                  *SEG_SET])
    assert r["source"].endswith("model.pt2") and len(r["results"]) == 1
    with pytest.raises(SystemExit):
        seg_inference_torch.main(["--pt2", "x", "--onnx", "y", "--synthetic", "1"])
    for main, args in ((seg_inference_torch.main, ["--onnx", str(work["packages"]["seg"])]),
                       (seg_inference_torch.main, ["--pt2", str(work["packages"]["seg"])]),
                       (pose_inference_torch.main, ["--onnx", str(work["packages"]["hrnet"])]),
                       (pose_inference_torch.main, ["--pt2", str(work["packages"]["hrnet"])])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main([*args, "--synthetic", "1"])
