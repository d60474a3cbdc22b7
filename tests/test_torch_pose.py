"""The port's HRNet corner-pose path against the JAX package, on the CPU:
nearest resize, the weight bridge, HRNetPose, the heatmap decodes and
PosePredictor, on the same numpy inputs and the same weights.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from mtg_card_image_segmentation_tpu.models import create_model as jax_create_model
from mtg_card_image_segmentation_tpu.models.hrnet import HRNetBackbone as JaxHRNetBackbone
from mtg_card_image_segmentation_tpu.ops import heatmap as jax_hm
from mtg_card_image_segmentation_tpu.ops.resize import nearest_resize as jax_nearest
from mtg_card_image_segmentation_tpu.serving import PosePredictor as JaxPosePredictor

from mtg_card_image_segmentation_tpu_torch.models.hrnet import HRNetBackbone, HRNetPose
from mtg_card_image_segmentation_tpu_torch.models.registry import create_model
from mtg_card_image_segmentation_tpu_torch.ops import heatmap as hm
from mtg_card_image_segmentation_tpu_torch.ops.resize import nearest_resize
from mtg_card_image_segmentation_tpu_torch.serving.pose_predictor import PosePredictor
from mtg_card_image_segmentation_tpu_torch.utils.params import (
    count_parameters,
    flax_to_state_dict,
    hrnet_from_flax,
    init_hrnet_flax_like,
    state_dict_to_flax,
)

torch.set_num_threads(2)

H, W, HM = 64, 96, (16, 24)
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "hrnet_decode_fixture.npz")


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
    """Numpy-seeded HRNet weights in the Flax layout, BN statistics off
    their init values."""
    return init_hrnet_flax_like(0)


@pytest.fixture(scope="module")
def jax_model(weights):
    """The JAX HRNetPose (float32, 64x96 -> 16x24), the shapes of its own
    init tree, and the shared weights as jax arrays; built once."""
    model = jax_create_model("hrnet_pose", heatmap_height=HM[0], heatmap_width=HM[1],
                             compute_dtype="float32")
    own = jax.eval_shape(lambda k: model.init(k, jnp.zeros((1, H, W, 3)), train=False),
                         jax.random.key(0))
    variables = {"params": jax.tree.map(jnp.asarray, weights[0]),
                 "batch_stats": jax.tree.map(jnp.asarray, weights[1])}
    return model, own, variables


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).integers(0, 256, (2, H, W, 3), dtype=np.uint8)


# --------------------------------------------------------------------------
# resize, bridge, model
# --------------------------------------------------------------------------


@pytest.mark.parametrize("in_hw,out_hw", [((4, 3), (8, 6)), ((4, 3), (16, 12)),
                                          ((5, 7), (13, 9)), ((6, 10), (15, 23)),
                                          ((15, 20), (120, 160)), ((9, 9), (4, 5))])
def test_nearest_resize_matches_jax(in_hw, out_hw):
    """Integer and non-integer ratios, up and down: a gather, so exact."""
    x = np.random.default_rng(1).standard_normal((2, *in_hw, 3)).astype(np.float32)
    ours = nearest_resize(torch.from_numpy(x), *out_hw).numpy()
    theirs = np.asarray(jax_nearest(jnp.asarray(x), *out_hw))
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(
        nearest_resize(torch.from_numpy(x[0]), *out_hw).numpy(), theirs[0])


def test_conv_transpose_bridge_matches_flax():
    """A random (4, 4, 3, 5) Flax ConvTranspose kernel through the bridge
    (flip both spatial axes, then (in, out, kh, kw)) with stride 2,
    padding 1 against nn.ConvTranspose(k4, s2, SAME): 1e-5, float32 sums in
    another order."""
    rng = np.random.default_rng(2)
    kernel = rng.standard_normal((4, 4, 3, 5)).astype(np.float32)
    x = rng.standard_normal((2, 6, 5, 3)).astype(np.float32)
    flax_mod = nn.ConvTranspose(5, (4, 4), strides=(2, 2), padding="SAME", use_bias=False)
    theirs = np.asarray(flax_mod.apply({"params": {"kernel": jnp.asarray(kernel)}},
                                       jnp.asarray(x)))
    sd = flax_to_state_dict({"deconv0": {"kernel": kernel}})
    assert tuple(sd["deconv0.weight"].shape) == (3, 5, 4, 4)
    ours = torch.nn.functional.conv_transpose2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), sd["deconv0.weight"], None,
        stride=2, padding=1).permute(0, 2, 3, 1).numpy()
    assert ours.shape == theirs.shape == (2, 12, 10, 5)
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-5)
    back, _ = state_dict_to_flax(sd)
    np.testing.assert_array_equal(back["deconv0"]["kernel"], kernel)


def test_hrnet_backbone_strides():
    """Feature shapes at 128x96, as tests/test_pose.py:148-157, on both
    sides."""
    want = [(1, 32, 24, 16), (1, 16, 12, 32), (1, 8, 6, 64), (1, 4, 3, 128)]
    with torch.no_grad():
        feats = HRNetBackbone(dtype=torch.float32).eval()(torch.zeros(1, 128, 96, 3))
    assert [tuple(f.shape) for f in feats] == want
    model = JaxHRNetBackbone(dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda k, x: model.apply(model.init(k, x), x),
        jax.random.key(0), jnp.zeros((1, 128, 96, 3), jnp.float32))
    assert [s.shape for s in shapes] == want


def test_hrnet_tree_and_param_count_match_jax(weights, jax_model):
    """The numpy-seeded tree has the names and shapes of the JAX model's
    own init, and the port's module counts the same parameters."""
    _, own, _ = jax_model
    params, stats = weights
    assert _paths(params) == _paths(own["params"])
    assert _paths(stats) == _paths(own["batch_stats"])
    n_jax = sum(int(np.prod(v.shape)) for v in jax.tree.leaves(own["params"]))
    model = create_model("hrnet_pose", heatmap_height=HM[0], heatmap_width=HM[1])
    assert isinstance(model, HRNetPose)
    assert sum(p.numel() for p in model.parameters()) == n_jax == count_parameters(params)
    assert 1e6 < n_jax < 10e6


def test_hrnet_bridge_round_trip(weights):
    """state_dict_to_flax(flax_to_state_dict(t)) == t, exactly, and the
    strict load takes every name."""
    params, stats = weights
    sd = flax_to_state_dict(params, stats)
    hrnet_from_flax(params, stats, HM)  # strict
    p2, s2 = state_dict_to_flax(sd)
    assert _paths(p2) == _paths(params) and _paths(s2) == _paths(stats)
    for a, b in zip(jax.tree.leaves((params, stats)), jax.tree.leaves((p2, s2))):
        np.testing.assert_array_equal(a, b)


def test_hrnet_heatmaps_match_jax(weights, jax_model):
    """HRNetPose heatmaps, float32, 64x96 -> (16, 24), same weights through
    the bridge, BN statistics off their init values: max |d| <= 1e-4 (the
    two frameworks sum the convs in another order)."""
    model, _, variables = jax_model
    x = np.random.default_rng(3).standard_normal((2, H, W, 3)).astype(np.float32)
    theirs = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    port = hrnet_from_flax(*weights, HM, dtype=torch.float32)
    with torch.no_grad():
        ours = port(torch.from_numpy(x))
    assert ours.dtype == torch.float32 and tuple(ours.shape) == theirs.shape == (2, *HM, 4)
    assert float(np.abs(theirs).max()) > 0.1  # not a dead network
    assert float(np.abs(ours.numpy() - theirs).max()) <= 1e-4


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------


def _gaussians(centers, h=30, w=40, sigma=2.0, amp=0.94):
    """(B, K, 2) heatmap-pixel centers -> (B, h, w, K) Gaussian heatmaps
    plus a little seeded noise."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    c = np.asarray(centers, np.float32)
    d2 = (xx[None, :, :, None] - c[:, None, None, :, 0]) ** 2 + (
        yy[None, :, :, None] - c[:, None, None, :, 1]) ** 2
    noise = 0.002 * np.random.default_rng(4).standard_normal(d2.shape)
    return (amp * np.exp(-d2 / (2 * sigma ** 2)) + noise).astype(np.float32)


def _cases():
    quad = [[8.3, 6.1], [31.6, 7.2], [30.2, 23.7], [9.4, 22.5]]
    good = _gaussians([quad, [[5, 5], [35, 4], [34, 25], [6, 26]]])
    dead = good.copy()
    dead[0, :, :, 2] *= 0.002 / 0.94  # a dead channel: completion fires
    swapped = _gaussians([[quad[1], quad[0], quad[2], quad[3]]])  # TL <-> TR
    # corner 1 peaks on corner 0's location, with its own as a weaker peak
    confused = _gaussians([quad])
    confused[0, :, :, 1] = 0.6 * confused[0, :, :, 1] + _gaussians([[quad[0]] * 4])[0, :, :, 1]
    noise = np.random.default_rng(5).standard_normal((3, 12, 16, 4)).astype(np.float32)
    flat = np.zeros((1, 12, 16, 4), np.float32)  # all ties
    cases = {"good": good, "dead": dead, "swapped": swapped, "confused": confused,
             "noise": noise, "flat": flat}
    if os.path.exists(FIXTURE):
        cases["fixture"] = np.load(FIXTURE)["heatmaps"].astype(np.float32)
    return cases


CASES = _cases()
DECODES = ("decode_argmax", "decode_argmax_subpixel", "decode_joint_nms",
           "decode_argmax_subpixel_gated")


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("fn", DECODES)
def test_decode_matches_jax(fn, case):
    """Each decode against its JAX counterpart on the same heatmaps: coords
    (normalized to [0, 1]) and confidences within 1e-5."""
    heat = CASES[case]
    c_ours, v_ours = getattr(hm, fn)(torch.from_numpy(heat))
    c_theirs, v_theirs = getattr(jax_hm, fn)(jnp.asarray(heat))
    assert tuple(c_ours.shape) == (heat.shape[0], 4, 2)
    np.testing.assert_allclose(c_ours.numpy(), np.asarray(c_theirs), rtol=0, atol=1e-5)
    np.testing.assert_allclose(v_ours.numpy(), np.asarray(v_theirs), rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_repairs_match_jax(case):
    """complete_dead_corner, quad_plausible, canonicalize_corners and
    coords01_to_pixels on each case's sub-pixel decode: coords within 1e-5,
    the ``fired`` and ``ok`` masks equal."""
    heat = CASES[case]
    h, w = heat.shape[1:3]
    c_t, v_t = hm.decode_argmax_subpixel(torch.from_numpy(heat))
    c_j, v_j = jax_hm.decode_argmax_subpixel(jnp.asarray(heat))
    done_t, fired_t = hm.complete_dead_corner(c_t, v_t)
    done_j, fired_j = jax_hm.complete_dead_corner(c_j, v_j)
    np.testing.assert_array_equal(fired_t.numpy(), np.asarray(fired_j))
    np.testing.assert_allclose(done_t.numpy(), np.asarray(done_j), rtol=0, atol=1e-5)
    px_t = hm.coords01_to_pixels(done_t, (h, w))
    px_j = jax_hm.coords01_to_pixels(done_j, (h, w))
    np.testing.assert_allclose(px_t.numpy(), np.asarray(px_j), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(hm.quad_plausible(px_t).numpy(),
                                  np.asarray(jax_hm.quad_plausible(px_j)))
    kp = np.concatenate([np.asarray(px_j), np.asarray(v_j)[..., None]], axis=-1)
    np.testing.assert_allclose(hm.canonicalize_corners(torch.from_numpy(kp)).numpy(),
                               np.asarray(jax_hm.canonicalize_corners(jnp.asarray(kp))),
                               rtol=0, atol=1e-5)


def test_decode_cases_exercise_the_repairs():
    """The seeded cases do what their names say: the dead channel fires the
    completion and lands near the true corner; the swapped and the confused
    quadrilaterals fail the gate and the gated decode returns the joint
    decode's corners, in canonical order."""
    c, v = hm.decode_argmax_subpixel(torch.from_numpy(CASES["dead"]))
    done, fired = hm.complete_dead_corner(c, v)
    assert fired.tolist() == [[False, False, True, False], [False] * 4]
    px = hm.coords01_to_pixels(done, (30, 40))[0, 2]
    assert float((px - torch.tensor([32.5, 24.8])).abs().max()) < 2.0
    size = torch.tensor([39.0, 29.0])
    for name in ("swapped", "confused"):
        heat = torch.from_numpy(CASES[name])
        raw, _ = hm.decode_argmax_subpixel(heat)
        assert not bool(hm.quad_plausible(raw * size)[0])
        gated, _ = hm.decode_argmax_subpixel_gated(heat)
        joint, _ = hm.decode_joint_nms(heat)
        assert torch.equal(gated, joint)
        assert bool(hm.quad_plausible(gated * size)[0])
    good = torch.from_numpy(CASES["good"])
    assert torch.equal(hm.decode_argmax_subpixel_gated(good)[0],
                       hm.decode_argmax_subpixel(good)[0])


def test_gated_decode_bounds_on_fixture():
    """The fixture's own bound (tests/test_decode_fixtures.py:30-43): max
    corner error < 20 px on every frozen real-model image."""
    if not os.path.exists(FIXTURE):
        pytest.skip("fixture hrnet_decode_fixture.npz not generated")
    fx = np.load(FIXTURE)
    h, w = (int(v) for v in fx["image_hw"])
    coords01, _ = hm.decode_argmax_subpixel_gated(
        torch.from_numpy(fx["heatmaps"].astype(np.float32)))
    px = hm.coords01_to_pixels(coords01, (h, w)).numpy()
    err = np.sqrt(((px - fx["gt_corners"]) ** 2).sum(-1))
    assert err.max() < 20.0, err.max(axis=1)


def test_first_arg_takes_first_of_ties():
    x = torch.tensor([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0]])
    assert hm._first_arg(x, 1).tolist() == [1, 0]
    assert hm._first_arg(x, 1, largest=False).tolist() == [3, 0]


# --------------------------------------------------------------------------
# predictor
# --------------------------------------------------------------------------


@pytest.mark.parametrize("refine", [False, True])
def test_pose_predictor_matches_jax_predictor(weights, images, refine):
    """PosePredictor(device="cpu", float32) against the JAX
    PosePredictor(use_pallas=False, float32) on the same uint8 images: px
    within atol 1e-2, conf within 1e-4 (tests/test_serving.py:233-247)."""
    params, stats = weights
    theirs_px, theirs_conf = JaxPosePredictor(
        params, stats, H, W, heatmap_hw=HM, dtype=jnp.float32, refine=refine,
        use_pallas=False, auto_layout=False).predict(jnp.asarray(images))
    pred = PosePredictor(params, stats, H, W, heatmap_hw=HM, dtype=torch.float32,
                         refine=refine, device="cpu")
    px, conf = pred.predict(images)
    assert px.dtype == conf.dtype == torch.float32
    assert tuple(px.shape) == (2, 4, 2) and tuple(conf.shape) == (2, 4)
    np.testing.assert_allclose(px.numpy(), np.asarray(theirs_px), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(conf.numpy(), np.asarray(theirs_conf), rtol=1e-4, atol=1e-4)
    stock = PosePredictor(params, stats, H, W, heatmap_hw=HM, dtype=torch.float32,
                          refine=refine, use_kernels=False, device="cpu")
    np.testing.assert_allclose(stock.predict(images)[0].numpy(), px.numpy(), atol=1e-2)


def test_pose_predictor_valid_and_scale(weights, images):
    """predict_valid thresholds the confidences; scale_to_original maps by
    the (size-1) ratio, as the JAX predictor does."""
    params, stats = weights
    pred = PosePredictor(params, stats, H, W, heatmap_hw=HM, dtype=torch.float32,
                         threshold=0.8, device="cpu")
    px, conf, valid = pred.predict_valid(images)
    assert torch.equal(valid, conf >= 0.8) and valid.any() and not valid.all()
    theirs = JaxPosePredictor(params, stats, H, W, heatmap_hw=HM, dtype=jnp.float32,
                              use_pallas=False, auto_layout=False)
    want = theirs.scale_to_original(px.numpy(), (480, 640))
    np.testing.assert_allclose(pred.scale_to_original(px, (480, 640)).numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(pred.scale_to_original(px.numpy(), (480, 640)), want, rtol=1e-6)


def test_pose_predictor_bf16_runs_and_refuses_cpu_unless_asked(weights, images, monkeypatch):
    """The default dtype is bfloat16 and its heatmaps stay near the float32
    ones (<= 0.1 at values of order 1: bf16 keeps 8 bits through ~40 layers);
    no device means the card, and without CUDA that raises."""
    params, stats = weights
    pred = PosePredictor(params, stats, H, W, heatmap_hw=HM, device="cpu")
    assert pred.dtype == torch.bfloat16
    hm16 = pred.heatmaps(images)
    hm32 = PosePredictor(params, stats, H, W, heatmap_hw=HM, dtype=torch.float32,
                         device="cpu").heatmaps(images)
    assert hm16.dtype == torch.float32 and bool(torch.isfinite(hm16).all())
    assert float((hm16 - hm32).abs().max()) <= 0.1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PosePredictor(params, stats, H, W, heatmap_hw=HM)
