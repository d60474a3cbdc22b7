"""The port's YOLO12n-pose (model, bridge, decode, YoloCornerPredictor)
against the JAX package's, on the CPU, from numpy-seeded weights and inputs.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mtg_card_image_segmentation_tpu.models import create_model as jax_create_model
from mtg_card_image_segmentation_tpu.models import yolo12_pose as jax_yolo
from mtg_card_image_segmentation_tpu.serving.pose_predictor import (
    YoloCornerPredictor as JaxYoloCornerPredictor,
)

from mtg_card_image_segmentation_tpu_torch.models import yolo12_pose as yolo
from mtg_card_image_segmentation_tpu_torch.models.registry import create_model
from mtg_card_image_segmentation_tpu_torch.serving.pose_predictor import YoloCornerPredictor
from mtg_card_image_segmentation_tpu_torch.training import checkpoint as ckpt
from mtg_card_image_segmentation_tpu_torch.utils.params import (
    count_parameters,
    flax_to_state_dict,
    init_yolo_flax_like,
    state_dict_to_flax,
    yolo_from_flax,
)

torch.set_num_threads(2)

S = 64
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "yolo_decode_fixture.npz")


def _paths(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = tuple(v.shape)
    return out


@pytest.fixture(scope="module")
def weights():
    return init_yolo_flax_like(0)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).integers(0, 256, (2, S, S, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def jax_levels(weights, images):
    """The JAX graph's raw level outputs, float32, on images / 255."""
    params, stats = weights
    net = jax_yolo.YOLO12PoseBackboneHead(dtype=jnp.float32)
    x = jnp.asarray(images, jnp.float32) * (1.0 / 255.0)
    outs = jax.jit(lambda p, s, x: net.apply({"params": p, "batch_stats": s}, x, train=False))(
        jax.tree.map(jnp.asarray, params["net"]), jax.tree.map(jnp.asarray, stats["net"]), x)
    return [np.asarray(o) for o in outs]


def test_param_counts():
    """2,886,715 parameters at ultralytics' published head (80 classes, 17
    keypoints of 3) less the 16 of the frozen DFL conv, which is computed as
    an expectation (tests/test_yolo.py); 2,640,455 at this repo's head (1
    class, 4 corners)."""
    big = yolo.YOLO12Pose(num_classes=80, num_keypoints=17, kpt_dim=3)
    assert sum(p.numel() for p in big.parameters()) == 2_886_715 - 16
    ours = create_model("yolo12n_pose", compute_dtype="float32")
    assert sum(p.numel() for p in ours.parameters()) == 2_640_455


def test_tree_matches_jax_init_and_priors(weights):
    """init_yolo_flax_like has the names and shapes of the JAX model's own
    init tree, its head biases carry the reference's priors, and the bridge
    round-trips (a 7x7 depthwise (7,7,1,C) included)."""
    params, stats = weights
    model = jax_create_model("yolo12n_pose", compute_dtype="float32")
    own = jax.eval_shape(lambda k: model.init(k, jnp.zeros((1, S, S, 3)), train=False),
                         jax.random.key(0))
    assert _paths(params) == _paths(own["params"])
    assert _paths(stats) == _paths(own["batch_stats"])
    assert count_parameters(params) == 2_640_455
    net = params["net"]
    for li in range(3):
        np.testing.assert_array_equal(net[f"cls{li}_2"]["bias"], np.float32(-4.595))
        kb = net[f"kpt{li}_2"]["bias"].reshape(4, 3)
        np.testing.assert_array_equal(kb[:, 2], np.float32(-4.595))
        np.testing.assert_array_equal(kb[:, :2], 0)
    assert net["l6"]["m0_0"]["attn"]["pe"]["conv"]["kernel"].shape == (7, 7, 1, 64)
    back_p, back_s = state_dict_to_flax(flax_to_state_dict(params, stats))
    assert _paths(back_p) == _paths(params) and _paths(back_s) == _paths(stats)
    pe = net["l6"]["m0_0"]["attn"]["pe"]["conv"]["kernel"]
    np.testing.assert_array_equal(back_p["net"]["l6"]["m0_0"]["attn"]["pe"]["conv"]["kernel"], pe)
    sd = flax_to_state_dict(params, stats)
    assert tuple(sd["net.l6.m0_0.attn.pe.conv.weight"].shape) == (64, 1, 7, 7)
    np.testing.assert_array_equal(sd["net.l6.m0_0.attn.pe.conv.weight"][5, 0].numpy(),
                                  pe[:, :, 0, 5])


def test_level_outputs_match_jax_fp32(weights, images, jax_levels):
    """float32 level outputs at 64x64 against the JAX graph: 1e-4 at values
    of order 1-5 (the stride-2 convs pad (1, 1) on both sides here, the area
    attention splits 4x4 tokens into 4 areas; sums differ in order only)."""
    model = yolo_from_flax(*weights, dtype=torch.float32)
    x = torch.from_numpy(images).float() * (1.0 / 255.0)
    with torch.no_grad():
        outs = model.levels(x)
    assert [tuple(o.shape) for o in outs] == [(2, 8, 8, 77), (2, 4, 4, 77), (2, 2, 2, 77)]
    for ours, theirs in zip(outs, jax_levels):
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-4, atol=1e-4)


def _decode_both(levels):
    jb, js, jk = jax_yolo.decode_predictions([jnp.asarray(o) for o in levels])
    tb, ts, tk = yolo.decode_predictions([torch.from_numpy(np.array(o)) for o in levels])
    return (jb, js, jk), (tb, ts, tk)


def test_decode_predictions_match_jax(jax_levels):
    """The anchor decode of the same level outputs: boxes and keypoints
    within 1e-4 px, scores within 1e-6."""
    (jb, js, jk), (tb, ts, tk) = _decode_both(jax_levels)
    a = 8 * 8 + 4 * 4 + 2 * 2
    assert tuple(tb.shape) == (2, a, 4) and tuple(ts.shape) == (2, a, 1)
    assert tuple(tk.shape) == (2, a, 4, 3)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0, atol=1e-4)


def _seeded_detections(seed, b=3, a=336, k=4, size=128.0):
    rng = np.random.default_rng(seed)
    boxes = rng.uniform(0, size, (b, a, 4)).astype(np.float32)
    scores = rng.uniform(0, 1, (b, a, 1)).astype(np.float32)
    kpts = np.concatenate([rng.uniform(0, size, (b, a, k, 2)),
                           rng.uniform(0, 1, (b, a, k, 1))], axis=-1).astype(np.float32)
    return boxes, scores, kpts


def _duplicate_peak_case():
    """tests/test_yolo.py:134: one channel's two best anchors sit on another
    corner's peak; greedy NMS must reach the true corner at rank 3."""
    a, k = 64, 4
    true = np.array([[10.0, 10.0], [100.0, 12.0], [98.0, 120.0], [12.0, 118.0]])
    kpts = np.zeros((1, a, k, 3), np.float32)
    kpts[..., :2] = 64.0
    for ch in range(k):
        kpts[0, ch, ch, :] = (*true[ch], 0.6)
    kpts[0, 40, 2] = (true[1][0] + 0.5, true[1][1] + 0.3, 0.8)
    kpts[0, 41, 2] = (true[1][0] - 0.4, true[1][1] + 0.6, 0.7)
    boxes = np.tile(np.array([5, 5, 105, 125], np.float32), (1, a, 1))
    scores = np.full((1, a, 1), 0.9, np.float32)
    return boxes, scores, kpts


def _tie_case():
    """Equal confidences everywhere: every arg-max is a tie and must take
    the first index, as the reference's does."""
    boxes, scores, kpts = _seeded_detections(5, b=2, a=80)
    scores[:] = 0.5
    kpts[..., 2] = 0.5
    return boxes, scores, kpts


def _fixture_case():
    fx = np.load(FIXTURE)
    return fx["boxes"], fx["scores"].astype(np.float32), fx["kpts"]


@pytest.mark.parametrize("case", ["seeded0", "seeded1", "seeded2", "duplicate_peak", "ties",
                                  "fixture"])
def test_top1_detection_matches_jax(case):
    """top1_detection on identical detections (frozen real-model outputs of
    tests/fixtures/yolo_decode_fixture.npz, seeded random ones, the
    duplicate-peak regression, all-ties): box, confidence and keypoints
    within 1e-4 px of the JAX decode."""
    if case.startswith("seeded"):
        boxes, scores, kpts = _seeded_detections(int(case[-1]))
    else:
        boxes, scores, kpts = {"duplicate_peak": _duplicate_peak_case, "ties": _tie_case,
                               "fixture": _fixture_case}[case]()
    jb, jc, jk = jax.jit(jax_yolo.top1_detection)(jnp.asarray(boxes), jnp.asarray(scores),
                                                  jnp.asarray(kpts))
    tb, tc, tk = yolo.top1_detection(torch.from_numpy(boxes), torch.from_numpy(scores),
                                     torch.from_numpy(kpts))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=0, atol=1e-4)
    if case == "duplicate_peak":
        true = np.array([[10.0, 10.0], [100.0, 12.0], [98.0, 120.0], [12.0, 118.0]])
        np.testing.assert_allclose(tk.numpy()[0, :, :2], true, atol=1.5)
    if case == "fixture":
        gt = np.load(FIXTURE)["gt_corners"]
        err = np.sqrt(((tk.numpy()[..., :2] - gt) ** 2).sum(-1))
        assert err.max() < 20.0  # the repo's bound, tests/test_decode_fixtures.py


def test_predictor_matches_jax_predictor(weights, images, jax_levels, tmp_path):
    """YoloCornerPredictor(device="cpu", float32): its level outputs equal
    the model's on images/255; its decode of the JAX level outputs equals
    the JAX predictor's corners on the same images within 1e-3 px (random
    weights give near-flat confidences, so the decode is compared on
    identical inputs); from_checkpoint equals the direct predictor;
    scale_to_original is the JAX half-pixel map."""
    params, stats = weights
    pred = YoloCornerPredictor(params, stats, imgsz=S, dtype=torch.float32, device="cpu")
    for ours, theirs in zip(pred.levels(images), jax_levels):
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-4, atol=1e-4)
    jpred = JaxYoloCornerPredictor(jax.tree.map(jnp.asarray, params),
                                   jax.tree.map(jnp.asarray, stats), imgsz=S,
                                   dtype=jnp.float32, auto_layout=False)
    jpx, jconf, jvalid = jpred.predict_valid(images)
    px, conf = pred.decode([torch.from_numpy(np.array(o)) for o in jax_levels])
    assert px.dtype == conf.dtype == torch.float32
    assert tuple(px.shape) == (2, 4, 2) and tuple(conf.shape) == (2, 4)
    np.testing.assert_allclose(px.numpy(), np.asarray(jpx), rtol=0, atol=1e-3)
    np.testing.assert_allclose(conf.numpy(), np.asarray(jconf), rtol=0, atol=1e-5)
    _, _, valid = pred.predict_valid(images)
    assert valid.dtype == torch.bool and pred.threshold == jpred.threshold == 0.25
    ckpt.save_params(str(tmp_path), "yolo", params, stats)
    again = YoloCornerPredictor.from_checkpoint(str(tmp_path), "yolo", imgsz=S,
                                                dtype=torch.float32, device="cpu")
    for a, b in zip(again.predict(images), pred.predict(images)):
        assert torch.equal(a, b)
    pts = np.random.default_rng(2).uniform(0, S, (4, 2)).astype(np.float32)
    want = np.asarray(jpred.scale_to_original(pts, (480, 640)))
    np.testing.assert_allclose(pred.scale_to_original(pts, (480, 640)), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(pred.scale_to_original(torch.from_numpy(pts), (480, 640)).numpy(),
                               want, rtol=0, atol=1e-5)


def test_predictor_bf16_runs_and_refuses_cpu_unless_asked(weights, images, monkeypatch):
    params, stats = weights
    pred = YoloCornerPredictor(params, stats, imgsz=S, device="cpu")
    px, conf = pred.predict(images)
    assert pred.dtype == torch.bfloat16 and px.dtype == torch.float32
    assert bool(torch.isfinite(px).all()) and bool(torch.isfinite(conf).all())
    assert all(o.dtype == torch.float32 for o in pred.levels(images))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        YoloCornerPredictor(params, stats, imgsz=S)


def test_area_attention_refuses_uneven_split():
    attn = yolo.AAttn(32, 1, area=4, dtype=torch.float32)
    with pytest.raises(ValueError, match="not divisible"):
        attn(torch.zeros(1, 3, 3, 32))
