"""The port's fixture and analysis tools against the JAX tools, on the CPU:
``tools/make_slim_fixture_torch.py`` (the prune and the checkpoint it
writes, served), ``tools/make_decode_fixtures_torch.py`` (the selection
functions and ``ungated_top1``) and ``tools/analyze_dead_channel_torch.py``
(``corner_geometry`` and the report), each on the same inputs as its JAX
original. The JAX tools' ``main`` runs in-process with its model and eval
stream monkeypatched to hand it the test's arrays; no JAX file changes.
Then each CLI at a tiny size on the host, and its refusal without a card.

On the card ``chip_smoke.py`` (phase ``tools``) runs the three tools on the
checkpoints of its earlier phases."""

import contextlib
import io
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mtg_card_image_segmentation_tpu.data.synthetic as jax_synthetic
import mtg_card_image_segmentation_tpu.models as jax_models
from mtg_card_image_segmentation_tpu.compression import slim as jax_slim
from mtg_card_image_segmentation_tpu.config import OptimizerConfig, default_config
from mtg_card_image_segmentation_tpu.models import registry as jax_registry
from mtg_card_image_segmentation_tpu.serving import predictor as jax_pred
from mtg_card_image_segmentation_tpu.training import checkpoint as jax_ckpt
from mtg_card_image_segmentation_tpu.training import create_optimizer, create_seg_state

from mtg_card_image_segmentation_tpu_torch.compression.slim import slim_seg_state
from mtg_card_image_segmentation_tpu_torch.data.synthetic import synthetic_batch
from mtg_card_image_segmentation_tpu_torch.serving.predictor import SegPredictor
from mtg_card_image_segmentation_tpu_torch.training import checkpoint as ckpt
from mtg_card_image_segmentation_tpu_torch.utils.params import (
    init_hrnet_flax_like,
    init_yolo_flax_like,
    yolo_from_flax,
)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

import analyze_dead_channel as jax_dead_tool  # noqa: E402
import analyze_dead_channel_torch as dead_tool  # noqa: E402
import make_decode_fixtures as jax_decode_tool  # noqa: E402
import make_decode_fixtures_torch as decode_tool  # noqa: E402
import make_slim_fixture_torch as slim_tool  # noqa: E402
import profile_blocks_torch  # noqa: E402

torch.set_num_threads(2)

POSE_HW = (480, 640)        # the pose config's input, as both tools read it
YOLO_SIZE = 640
N_BATCHES, BATCH = 2, 6
TINY_POSE = ["--set", "pose.input_height=64", "pose.input_width=96",
             "pose.heatmap_height=16", "pose.heatmap_width=24"]


# --------------------------------------------------------------------------
# slim fixture
# --------------------------------------------------------------------------


def test_slim_fixture_prunes_the_jax_state_as_the_jax_tool():
    """The JAX tool's state (``create_seg_state`` from ``jax.random.key(0)``):
    the JAX ``expansion_channel_prune(0.3)`` and ``dead_expansion_channels``
    against the port tool's ``slim_fixture`` on the same weights as numpy.
    The same channels zeroed in the same blocks, the same count, the same
    pruned tree."""
    cfg = default_config()
    model = jax_registry.from_config(cfg.model)
    tx, _ = create_optimizer(OptimizerConfig(), num_epochs=1, steps_per_epoch=1)
    state = jax.jit(lambda k: create_seg_state(model, tx, (1, 64, 48, 3), k))(jax.random.key(0))
    j_pruned, _ = jax_slim.expansion_channel_prune(state.params, 0.3)
    j_dead = jax_slim.dead_expansion_channels(j_pruned)
    pruned, dead, n_dead = slim_tool.slim_fixture(jax.tree.map(np.asarray, state.params), 0.3)
    assert sorted(dead) == sorted(j_dead) and len(dead) == 14
    for i in dead:
        np.testing.assert_array_equal(dead[i], np.asarray(j_dead[i]))
    assert n_dead == sum(np.asarray(v).size for v in j_dead.values()) > 0
    flat, j_flat = ckpt.flatten_tree(pruned), ckpt.flatten_tree(jax.tree.map(np.asarray, j_pruned))
    assert flat.keys() == j_flat.keys()
    for k in flat:
        np.testing.assert_array_equal(flat[k], j_flat[k], err_msg=k)


@pytest.fixture(scope="module")
def slim_checkpoint(tmp_path_factory):
    """The slim fixture CLI's run on the host: (its record, its stdout)."""
    out, printed = tmp_path_factory.mktemp("slim"), io.StringIO()
    with contextlib.redirect_stdout(printed):
        rec = slim_tool.main(["--device", "cpu", "--output-dir", str(out), "--seed", "0"])
    return rec, printed.getvalue()


def test_slim_fixture_checkpoint_serves_as_the_jax_slim_reference(slim_checkpoint):
    """The CLI on the host writes a train-state checkpoint with the JAX
    tool's config record; loaded through ``slim_seg_state`` into a float32
    CPU ``SegPredictor`` (kernel path and stock-op path) at 64x48 b2, its
    masks agree >= 0.999 with the JAX reference path on the same weights
    (the repo's deployment gate, serving/predictor.py:403). The JAX
    reference path builds the dense model only, so it runs the
    checkpoint's masked dense tree, which slim equals (tests/test_slim.py)."""
    rec, out = slim_checkpoint
    assert f"expansion prune: {rec['dead_channels']} channels zeroed removably across 14 blocks" \
        in out and "measure: python tools/profile_blocks_torch.py --checkpoint" in out
    ck_dir = str(Path(rec["path"]).parent)
    params, stats, meta = ckpt.load_params(ck_dir, "slim_model")
    assert meta["config"] == {"fixture": "make_slim_fixture", "amount": 0.3, "seed": 0}
    assert "step" in ckpt.read_arrays(ck_dir, "slim_model", ("step",))
    sp, ss, overrides = slim_seg_state(params, stats)
    assert sum(o is not None for o in overrides) == 14
    imgs = np.random.default_rng(5).integers(0, 256, (2, 64, 48, 3), np.uint8)
    theirs = np.asarray(jax_pred.SegPredictor(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats), 64, 48,
        use_pallas=False, dtype=jnp.float32, auto_layout=False).predict(imgs))
    for use_kernels in (True, False):
        ours = SegPredictor(sp, ss, 64, 48, dtype=torch.float32, device="cpu",
                            use_kernels=use_kernels).predict(imgs).numpy()
        assert (ours == theirs).mean() >= 0.999, use_kernels


def test_profile_blocks_profiles_the_slim_fixture(slim_checkpoint):
    """``tools/profile_blocks_torch.py --checkpoint <fixture> --slim`` (the
    command the fixture tool prints) at 64x64 b2 on the host: the graph's
    blocks take the narrowed widths of ``slim_seg_state`` and every cut is
    timed."""
    rec, _ = slim_checkpoint
    path = rec["path"]
    _, _, overrides = slim_seg_state(*ckpt.load_params(str(Path(path).parent), "slim_model")[:2])
    model = profile_blocks_torch.build(64, "cpu", path, slim=True)
    assert [model.backbone.block(i).expanded for i in (12, 13, 14)] == list(overrides[12:])
    prof = profile_blocks_torch.run(size=64, batch=2, iters=1, warmup=0, device="cpu",
                                    checkpoint=path, slim=True)
    assert prof["slim"] and prof["out_shape"] == [2, 64, 64]
    assert [r["cut"] for r in prof["stages"]] == profile_blocks_torch.DEFAULT_CUTS.split(",")


# --------------------------------------------------------------------------
# decode fixtures and the dead-channel analysis: the same arrays in both
# --------------------------------------------------------------------------


def _quads(rng, n, h, w):
    """(n, 4, 2) rotated-rectangle corner pixels in TL TR BR BL order."""
    c = rng.uniform([0.35 * w, 0.35 * h], [0.65 * w, 0.65 * h], (n, 2))
    half = rng.uniform([0.12 * w, 0.18 * h], [0.22 * w, 0.28 * h], (n, 2))
    ang = rng.uniform(-0.4, 0.4, n)
    base = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float64)[None] * half[:, None]
    rot = np.stack([np.stack([np.cos(ang), -np.sin(ang)], -1),
                    np.stack([np.sin(ang), np.cos(ang)], -1)], -2)
    return (np.einsum("nij,nkj->nki", rot, base) + c[:, None]).astype(np.float32)


@pytest.fixture(scope="module")
def hrnet_arrays():
    """(heatmaps (N, 30, 40, 4), GT pixels (N, 4, 2)) at the pose config's
    480x640: a Gaussian peak near each corner, noise, image 5's channel 2
    dead (max 0.002) and image 9's channel 0 weak (0.15)."""
    rng = np.random.default_rng(3)
    n, (h, w), (hh, hw) = N_BATCHES * BATCH, POSE_HW, (30, 40)
    gt = _quads(rng, n, h, w)
    peak = gt / np.array([w - 1, h - 1]) * np.array([hw - 1, hh - 1])
    peak = peak + rng.normal(0, 1.5, peak.shape)
    yy, xx = np.mgrid[:hh, :hw]
    d2 = (xx[None, :, :, None] - peak[:, None, None, :, 0]) ** 2 \
        + (yy[None, :, :, None] - peak[:, None, None, :, 1]) ** 2
    hm = 0.9 * np.exp(-d2 / 4.5) + 0.02 * rng.random((n, hh, hw, 4))
    hm[5, ..., 2] *= 0.002 / hm[5, ..., 2].max()
    hm[9, ..., 0] *= 0.15 / hm[9, ..., 0].max()
    return hm.astype(np.float32), gt


@pytest.fixture(scope="module")
def yolo_arrays():
    """Decoded YOLO outputs at 640x640 (N, 40 anchors): boxes, scores in
    (0, 1), keypoints scattered 30 px around each GT corner (so that the
    greedy NMS and the collision penalty both act), GT pixels."""
    rng = np.random.default_rng(4)
    n, a = N_BATCHES * BATCH, 40
    gt = _quads(rng, n, YOLO_SIZE, YOLO_SIZE)
    boxes = rng.uniform(0, YOLO_SIZE, (n, a, 4)).astype(np.float32)
    scores = rng.random((n, a, 1)).astype(np.float32)
    xy = gt[:, None] + rng.normal(0, 30, (n, a, 4, 2))
    kpts = np.concatenate([xy, rng.random((n, a, 4, 1))], -1).astype(np.float32)
    return boxes, scores, kpts, gt


class _Identity:
    """Stands in for the JAX model: ``apply`` returns its input, so the
    eval stream hands the tool the test's model outputs."""

    def apply(self, variables, x, train=False):
        return x


def _batches(*arrays):
    return [tuple(a[i * BATCH:(i + 1) * BATCH] for a in arrays) for i in range(N_BATCHES)]


def _patch_jax_tool(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", argv)
    monkeypatch.setattr(jax_ckpt, "load_params", lambda d, n: ({}, {}, {"epoch": 7}))
    monkeypatch.setattr(jax_registry, "pose_from_config", lambda cfg: _Identity())
    monkeypatch.setattr(jax_models, "create_model", lambda name: _Identity())


def test_hrnet_fixture_selects_as_the_jax_tool(hrnet_arrays, tmp_path, monkeypatch):
    """``hrnet_fixture`` against the JAX tool's ``main --family hrnet`` on
    the same heatmaps and GT: the same indices (the dead image first, then
    the three worst under the gated decode), the same stored arrays (the
    float16 heatmaps bit for bit) and the dead channel's maxima."""
    hm, gt = hrnet_arrays
    _patch_jax_tool(monkeypatch, ["make_decode_fixtures.py", "--family", "hrnet",
                                  "--checkpoint", "ck/best_model", "--out", str(tmp_path)])
    monkeypatch.setattr(jax_decode_tool, "eval_batches", lambda h, w: iter(_batches(hm, gt)))
    jax_decode_tool.main()
    theirs = np.load(tmp_path / "hrnet_decode_fixture.npz")
    ours = decode_tool.hrnet_fixture(torch.from_numpy(hm), torch.from_numpy(gt), *POSE_HW)
    assert ours["dead_idx"] == 5 and int(theirs["indices"][0]) == 5
    assert set(theirs.files) == set(ours["arrays"]) | {"platform", "epoch"}
    for k, v in ours["arrays"].items():
        assert v.dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(v, theirs[k], err_msg=k)


def test_yolo_fixture_selects_as_the_jax_tool(yolo_arrays, tmp_path, monkeypatch):
    """``yolo_fixture`` against the JAX tool's ``main --family yolo`` on the
    same decoded outputs and GT: the same indices (the ungated decode's
    worst first, then the three worst under ``top1_detection``), the same
    stored arrays, the ungated errors within 1e-3 px."""
    boxes, scores, kpts, gt = yolo_arrays
    _patch_jax_tool(monkeypatch, ["make_decode_fixtures.py", "--family", "yolo",
                                  "--checkpoint", "ck/best_model", "--out", str(tmp_path)])
    monkeypatch.setattr(jax_decode_tool, "eval_batches", lambda h, w: iter(
        [((b, s, k), g) for b, s, k, g in _batches(boxes, scores, kpts, gt)]))
    jax_decode_tool.main()
    theirs = np.load(tmp_path / "yolo_decode_fixture.npz")
    ours = decode_tool.yolo_fixture(*(torch.from_numpy(a) for a in (boxes, scores, kpts)), gt)
    assert set(theirs.files) == set(ours["arrays"]) | {"platform", "epoch", "image_hw"}
    for k, v in ours["arrays"].items():
        assert v.dtype == theirs[k].dtype, k
        if k == "ungated_err_px":
            np.testing.assert_allclose(v, theirs[k], rtol=0, atol=1e-3)
        else:
            np.testing.assert_array_equal(v, theirs[k], err_msg=k)


@pytest.mark.parametrize("source", ["drawn", "model"])
def test_ungated_top1_matches_the_jax_function(yolo_arrays, source):
    """The port's ``ungated_top1`` against the JAX tool's on the same YOLO
    outputs, corners within 1e-3 px: the drawn 640x640 outputs, and the
    seeded YOLO model's own outputs on rendered 64x64 images (every
    keypoint within the 24 px collision radius of the others)."""
    if source == "drawn":
        boxes, scores, kpts, _ = yolo_arrays
    else:
        model = yolo_from_flax(*init_yolo_flax_like(0), dtype=torch.float32)
        images = synthetic_batch(torch.Generator().manual_seed(9), 4, 64, 64, 0.0,
                                 keep_in_frame=True).image
        with torch.no_grad():
            boxes, scores, kpts = (t.numpy() for t in model(images))
    ours = decode_tool.ungated_top1(*(torch.from_numpy(a) for a in (boxes, scores, kpts)))
    theirs = jax_decode_tool.ungated_top1(jnp.asarray(boxes), jnp.asarray(scores),
                                          jnp.asarray(kpts))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0, atol=1e-3)


def test_corner_geometry_copy_is_bit_equal():
    """The copied ``corner_geometry`` against the original on 100 seeded
    quads at 480x640: every field equal bit for bit."""
    rng = np.random.default_rng(11)
    for gt in _quads(rng, 100, *POSE_HW):
        assert dead_tool.corner_geometry(gt, *POSE_HW) == \
            jax_dead_tool.corner_geometry(gt, *POSE_HW)


def test_dead_channel_report_matches_the_jax_main(hrnet_arrays, tmp_path, monkeypatch):
    """``dead_channel_report`` against the JAX tool's ``analysis.json`` on
    the same patched stream at ``--dead-conf 0.2``: the same dead images
    (5 and 9) and channels, their maxima, geometry, the population's
    statistics and the weakest-channel percentiles, to 1e-6."""
    hm, gt = hrnet_arrays
    batches = iter(_batches(hm, gt))
    _patch_jax_tool(monkeypatch, ["analyze_dead_channel.py", "--checkpoint", "ck/best_model",
                                  "--out", str(tmp_path), "--batches", str(N_BATCHES),
                                  "--batch-size", str(BATCH)])
    monkeypatch.setattr(jax_synthetic, "synthetic_batch", lambda *a, **k: SimpleNamespace(
        **dict(zip(("image", "corners"), next(batches)))))
    jax_dead_tool.main()
    theirs = json.loads((tmp_path / "analysis.json").read_text())
    ours = dead_tool.dead_channel_report(hm.max(axis=(1, 2)), gt, *POSE_HW, 0.2)
    assert [e["index"] for e in ours["dead_channel_images"]] == [5, 9]

    def close(a, b, path=""):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                close(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                close(x, y, f"{path}/{i}")
        elif isinstance(a, float):
            assert a == pytest.approx(b, rel=0, abs=1e-6), path
        else:
            assert a == b, path

    close(ours, theirs)


# --------------------------------------------------------------------------
# the CLIs
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pose_checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("ck")
    ckpt.save_params(str(root), "hrnet", *init_hrnet_flax_like(0), epoch=3)
    ckpt.save_params(str(root), "yolo", *init_yolo_flax_like(0), epoch=4)
    return root


def test_decode_fixture_cli_on_the_host(pose_checkpoints, tmp_path):
    """``--family hrnet`` at 64x96 and ``--family yolo`` at 64x64 on the
    host, 2 batches of 3: the JAX tool's npz keys and shapes, the platform
    and the checkpoint's epoch; the indices are the selection function's
    on the returned outputs."""
    stream = ["--batches", "2", "--batch-size", "3", "--device", "cpu", "--out", str(tmp_path)]
    hr = decode_tool.main(["--family", "hrnet", "--checkpoint", str(pose_checkpoints / "hrnet"),
                           *stream, *TINY_POSE])
    z = np.load(hr["path"])
    assert z["heatmaps"].shape == (4, 16, 24, 4) and z["heatmaps"].dtype == np.float16
    assert z["gt_corners"].shape == (4, 4, 2) and list(z["image_hw"]) == [64, 96]
    assert str(z["platform"]) == "cpu" and int(z["epoch"]) == 3
    assert hr["indices"] == list(z["indices"]) == decode_tool.hrnet_fixture(
        hr["outputs"]["hm"], hr["outputs"]["gt"], 64, 96)["arrays"]["indices"].tolist()
    yo = decode_tool.main(["--family", "yolo", "--checkpoint", str(pose_checkpoints / "yolo"),
                           "--imgsz", "64", *stream])
    z = np.load(yo["path"])
    a = yo["outputs"]["boxes"].shape[1]
    assert z["boxes"].shape == (4, a, 4) and z["scores"].shape == (4, a, 1)
    assert z["kpts"].shape == (4, a, 4, 3) and z["ungated_err_px"].shape == (4,)
    assert list(z["image_hw"]) == [64, 64] and int(z["epoch"]) == 4
    assert set(z.files) == {"boxes", "scores", "kpts", "gt_corners", "indices",
                            "ungated_err_px", "image_hw", "platform", "epoch"}


def test_dead_channel_cli_on_the_host(pose_checkpoints, tmp_path):
    """The CLI at 64x96 on the host, 2 batches of 2, with a threshold above
    every channel maximum: every image reported, one panel each, and
    ``analysis.json`` equal to the returned report."""
    report = dead_tool.main(["--checkpoint", str(pose_checkpoints / "hrnet"), "--out",
                             str(tmp_path), "--dead-conf", "1e9", "--batches", "2",
                             "--batch-size", "2", "--device", "cpu", *TINY_POSE])
    assert report["num_images"] == 4
    assert [e["index"] for e in report["dead_channel_images"]] == [0, 1, 2, 3]
    assert sorted(p.name for p in tmp_path.glob("dead_*.png")) == [
        f"dead_{i}.png" for i in range(4)]
    assert json.loads((tmp_path / "analysis.json").read_text()) == report


@pytest.mark.parametrize("tool,argv", [
    (slim_tool, []),
    (decode_tool, ["--family", "hrnet", "--checkpoint", "ck/x"]),
    (dead_tool, ["--checkpoint", "ck/x"]),
])
def test_the_tools_need_the_card_unless_asked(tool, argv, monkeypatch, tmp_path):
    """Without ``--device cpu`` each tool asks for the card and refuses the
    host before it reads or writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(argv)
    assert list(tmp_path.iterdir()) == []
