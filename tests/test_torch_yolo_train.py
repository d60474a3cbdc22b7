"""The port's YOLO12n-pose training against the JAX package's, on the CPU:
the BatchNorm momentum (Flax 0.97), the from-scratch priors, the loss
(``training/yolo_loss.py``: each part, the positive mask and its top-k tie
rule), one train step at 64x64 b2 (loss, BatchNorm statistics, gradients
in float32 and float64), the decode in float64 and the folded layout
``YOLO12Pose(fold_bn=True)``, all with ``init_yolo_flax_like(0)`` weights.

fp32 XLA:CPU and fp32 PyTorch differ in summation order: losses agree to
1e-5 relative, BatchNorm statistics to 1e-5. The gradients are held as the
HRNet step's are (``tests/test_torch_pose_train.py``), each tensor against
its largest entry: the port's float64 gradient against the JAX package's
float64 one (x64, the float32 casts of the JAX model and loss made
float64) to 1e-10, and the port's fp32 gradient against the JAX float64
one to 1e-3: no further from it than the JAX fp32 gradient is (see
:func:`test_yolo_train_step_gradients`).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mtg_card_image_segmentation_tpu.export import fold_batch_norm as jax_fold
from mtg_card_image_segmentation_tpu.models import create_model as jax_create_model
from mtg_card_image_segmentation_tpu.models import yolo12_pose as jax_yolo
from mtg_card_image_segmentation_tpu.training import yolo_loss as jax_loss

from mtg_card_image_segmentation_tpu_torch.config import OptimizerConfig
from mtg_card_image_segmentation_tpu_torch.export.fold_bn import fold_batch_norm
from mtg_card_image_segmentation_tpu_torch.models import yolo12_pose as yolo
from mtg_card_image_segmentation_tpu_torch.models.registry import create_model
from mtg_card_image_segmentation_tpu_torch.training import yolo_loss
from mtg_card_image_segmentation_tpu_torch.training.loop import batch_norms
from mtg_card_image_segmentation_tpu_torch.training.optim import create_optimizer
from mtg_card_image_segmentation_tpu_torch.training.state import create_seg_state
from mtg_card_image_segmentation_tpu_torch.utils.params import (
    flax_to_state_dict,
    init_flax_defaults,
    init_yolo_flax_like,
    state_dict_to_flax,
    yolo_from_flax,
)
from pose_common import _Float64Numpy, leaves, two_pass_variance

torch.set_num_threads(2)

S, B = 64, 2
SGD = dict(name="sgd", schedule="constant", warmup_epochs=0, learning_rate=0.05,
           weight_decay=1e-4)


def yolo_batch(seed, s=S, b=B):
    """Smooth [0,1] NHWC images and one card-like quadrilateral per image
    (TL, TR, BR, BL corner pixels, inside the image), as numpy."""
    rng = np.random.default_rng(seed)
    base = torch.from_numpy(rng.random((b, 3, s // 8, s // 8)).astype(np.float32))
    imgs = torch.nn.functional.interpolate(base, size=(s, s), mode="bilinear",
                                           align_corners=False).permute(0, 2, 3, 1)
    ctr = rng.uniform(0.4 * s, 0.6 * s, (b, 1, 2))
    half = rng.uniform(0.2 * s, 0.3 * s, (b, 1, 2)) * np.array([[[-1, -1], [1, -1], [1, 1],
                                                                  [-1, 1]]])
    ang = rng.uniform(-0.3, 0.3, (b, 1))
    c, sn = np.cos(ang)[..., None], np.sin(ang)[..., None]
    rot = np.concatenate([half[..., :1] * c - half[..., 1:] * sn,
                          half[..., :1] * sn + half[..., 1:] * c], -1)
    return imgs.contiguous().numpy(), (ctr + rot).astype(np.float32)


def port_model(weights, dtype=torch.float32):
    model = yolo.YOLO12Pose(dtype=dtype)
    model.load_state_dict(flax_to_state_dict(*weights), strict=True)
    return model.train()


@pytest.fixture(scope="module")
def weights():
    return init_yolo_flax_like(0)


def _jax_x64(fn):
    """``fn()`` with x64 on, the JAX YOLO model's and loss's float32 casts
    made float64 and Flax's BatchNorm variance in two passes."""
    mods = (jax_yolo, jax_loss)
    saved = [m.jnp for m in mods]
    for m in mods:
        m.jnp = _Float64Numpy()
    try:
        with jax.enable_x64(True), two_pass_variance():
            return fn()
    finally:
        for m, j in zip(mods, saved):
            m.jnp = j


def _jax_step(weights, imgs, corners, float64=False):
    """(loss, parts, gradients, BN statistics after the step) of the JAX
    train-mode loss, as numpy leaves."""
    dt = jnp.float64 if float64 else jnp.float32
    model = jax_yolo.YOLO12Pose(dtype=dt, param_dtype=dt)
    params, stats = (jax.tree.map(lambda a: jnp.asarray(a, dt), t) for t in weights)

    def loss_fn(p):
        outs, mutated = model.apply({"params": p, "batch_stats": stats}, imgs.astype(dt),
                                    train=True, mutable=["batch_stats"])
        loss, parts = jax_loss.yolo_pose_loss(outs, corners.astype(dt))
        return loss, (parts, mutated["batch_stats"])

    (loss, (parts, new_stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    assert loss.dtype == dt
    return (float(loss), {k: float(v) for k, v in parts.items()},
            leaves(jax.tree.map(np.asarray, grads)), leaves(jax.tree.map(np.asarray, new_stats)))


@pytest.fixture(scope="module")
def one_step(weights):
    """One fp32 train step of both packages from the same weights and batch
    (the JAX model with Flax's two-pass variance), and both packages'
    float64 gradients."""
    imgs, corners = yolo_batch(1)
    with two_pass_variance():
        jax32 = _jax_step(weights, imgs, corners)
    jax64 = _jax_x64(lambda: _jax_step(weights, imgs, corners, float64=True))
    opt_def, _ = create_optimizer(OptimizerConfig(**SGD), 1, 10)
    state = create_seg_state(port_model(weights), opt_def)
    state, parts = yolo_loss.make_yolo_train_step()(state, torch.from_numpy(imgs),
                                                    torch.from_numpy(corners))
    grads = state_dict_to_flax({n: p.grad for n, p in state.model.named_parameters()})[0]
    loss64, g64, _ = yolo_loss.yolo_grads_float64(port_model(weights), torch.from_numpy(imgs),
                                               torch.from_numpy(corners))
    return {"jax": jax32, "jax_float64": jax64,
            "port": ({k: float(v) for k, v in parts.items()}, leaves(grads),
                     leaves(state.variables()["batch_stats"])),
            "port_float64": (loss64, leaves(state_dict_to_flax(g64)[0])), "step": state.step}


# --------------------------------------------------------------------------
# BatchNorm momentum, priors
# --------------------------------------------------------------------------


def test_yolo_batch_norms_move_at_the_references_momentum(weights):
    """Every one of the 119 BatchNorms is a FlaxBatchNorm2d at Flax momentum
    0.97 (torch 0.03), the reference's ``nn.BatchNorm(momentum=0.97)``."""
    model = create_model("yolo12n_pose")
    bns = batch_norms(model)
    assert len(bns) == len(leaves(weights[1])) // 2 == 119
    assert len(bns) == sum(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())
    assert {round(bn.momentum, 12) for bn in bns} == {0.03}


def test_yolo_train_step_batch_stats_match_jax(one_step):
    """Every BatchNorm's running statistics after one train-mode step, to
    1e-5 (Flax momentum 0.97, biased variance): with the port's former
    momentum of 0.99 every one of the 238 leaves misses."""
    js, ps = one_step["jax"][3], one_step["port"][2]
    assert set(ps) == set(js) and len(js) == 238
    for k, w in js.items():
        np.testing.assert_allclose(ps[k], w, rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def jax_init():
    """The JAX model's own ``model.init`` tree (jitted: eager it takes ~50 s
    on the CPU)."""
    model = jax_create_model("yolo12n_pose", compute_dtype="float32")
    init = jax.jit(lambda k: model.init(k, jnp.zeros((1, S, S, 3)), train=False))
    return leaves(jax.tree.map(np.asarray, init(jax.random.key(0))["params"]))


def test_from_scratch_init_carries_the_references_priors(jax_init):
    """init_flax_defaults on the registry's model: the class logits' and
    the keypoint confidences' biases equal JAX ``model.init``'s (-4.595)
    exactly, the keypoint offsets' and every other bias are 0 (as are
    JAX's), and the leaves are the JAX tree's."""
    model = init_flax_defaults(create_model("yolo12n_pose"), 0)
    params = leaves(state_dict_to_flax(model.state_dict())[0])
    assert set(params) == set(jax_init)
    biases = [k for k in params if k.endswith("/bias") and "/bn/" not in k]
    assert len(biases) == 9
    for k in biases:
        np.testing.assert_array_equal(params[k], jax_init[k], err_msg=k)
    for li in range(3):
        assert (params[f"net/cls{li}_2/bias"] == np.float32(-4.595)).all()
        kb = params[f"net/kpt{li}_2/bias"].reshape(4, 3)
        assert (kb[:, 2] == np.float32(-4.595)).all() and not kb[:, :2].any()
        assert not params[f"net/box{li}_2/bias"].any()
    for k, v in params.items():
        if k.endswith("/bn/bias"):
            assert not v.any(), k


# --------------------------------------------------------------------------
# the loss
# --------------------------------------------------------------------------


def _levels(seed, s):
    rng = np.random.default_rng(seed)
    return [(2.0 * rng.standard_normal((B, s // st, s // st, 77))).astype(np.float32)
            for st in yolo.STRIDES]


def _jax_positive_mask(shapes, corners, k):
    """The JAX loss's assignment (``training/yolo_loss.py:114-136``), at
    ``k`` positives."""
    anchors = jax_loss._anchor_centers(shapes)
    gt_box = jax_loss.corners_to_box(jnp.asarray(corners))
    gt_cx = (gt_box[:, 0] + gt_box[:, 2]) / 2
    gt_cy = (gt_box[:, 1] + gt_box[:, 3]) / 2
    inside = ((anchors[None, :, 0] > gt_box[:, None, 0])
              & (anchors[None, :, 0] < gt_box[:, None, 2])
              & (anchors[None, :, 1] > gt_box[:, None, 1])
              & (anchors[None, :, 1] < gt_box[:, None, 3]))
    dist = jnp.sqrt((anchors[None, :, 0] - gt_cx[:, None]) ** 2
                    + (anchors[None, :, 1] - gt_cy[:, None]) ** 2)
    _, idx = jax.lax.top_k(-jnp.where(inside, dist, jnp.inf), k)
    mask = jnp.zeros(inside.shape, bool)
    mask = jax.vmap(lambda m, i, ins: m.at[i].set(True) & ins)(mask, idx, inside)
    return np.asarray(mask)


def _port_positive_mask(shapes, corners, k):
    anchors = yolo_loss._anchor_centers(shapes, torch.float32, "cpu")
    return yolo_loss.positive_mask(anchors, yolo_loss.corners_to_box(torch.from_numpy(corners)),
                                   k).numpy()


@pytest.mark.parametrize("s,seed", [(64, 0), (64, 1), (128, 2), (128, 3)])
def test_loss_parts_and_positives_match_jax(s, seed):
    """Every part of yolo_pose_loss on the same level outputs and corners,
    to 1e-5 relative; the positive mask equal."""
    lv = _levels(seed, s)
    _, corners = yolo_batch(seed + 10, s)
    _, want = jax.jit(jax_loss.yolo_pose_loss)([jnp.asarray(x) for x in lv],
                                               jnp.asarray(corners))
    _, got = yolo_loss.yolo_pose_loss([torch.from_numpy(x) for x in lv],
                                      torch.from_numpy(corners))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5, atol=0, err_msg=k)
    shapes = [(s // st, s // st) for st in yolo.STRIDES]
    mask = _port_positive_mask(shapes, corners, yolo_loss.TOP_K)
    assert mask.sum() == B * yolo_loss.TOP_K
    np.testing.assert_array_equal(mask, _jax_positive_mask(shapes, corners,
                                                           yolo_loss.TOP_K))


@pytest.mark.parametrize("k", [10, 13])
def test_topk_ties_take_the_lower_index_first(k):
    """A box centred at (320, 320) on the 640 grid: the 8 stride-8 anchors
    of the second ring lie at one distance, so the 10th and the 13th
    positive are picked among ties; the port picks JAX's (the lower flat
    index first)."""
    corners = np.array([[[220.0, 220.0], [420.0, 220.0], [420.0, 420.0], [220.0, 420.0]]],
                       np.float32)
    shapes = [(640 // st, 640 // st) for st in yolo.STRIDES]
    anchors = yolo_loss._anchor_centers(shapes, torch.float32, "cpu")
    d = ((anchors[:, :2] - 320.0) ** 2).sum(-1).sqrt()
    kth = torch.sort(d).values[k - 1]
    assert int((d == kth).sum()) == 8 and int((d < kth).sum()) == 8
    got = _port_positive_mask(shapes, corners, k)
    np.testing.assert_array_equal(got, _jax_positive_mask(shapes, corners, k))
    assert got.sum() == k


def test_decode_runs_in_float64_in_the_float64_pass():
    """With ``Tensor.float`` made ``double``, as the float64 gradient pass
    (``training.loop.grads_float64``) makes it, decode_predictions runs in
    float64 throughout, its anchor grids and DFL bins included, and agrees
    with the float32 decode."""
    lv = _levels(4, S)
    d32 = yolo.decode_predictions([torch.from_numpy(x) for x in lv])
    cast = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    try:
        d64 = yolo.decode_predictions([torch.from_numpy(x).double() for x in lv])
    finally:
        torch.Tensor.float = cast
    for a, b in zip(d32, d64):
        assert a.dtype == torch.float32 and b.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-4)


# --------------------------------------------------------------------------
# one train step
# --------------------------------------------------------------------------


def test_yolo_train_step_loss_matches_jax(one_step):
    """Every loss part of the step to 1e-5 relative; the step counted."""
    want, got = one_step["jax"][1], one_step["port"][0]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=0, err_msg=k)
    assert one_step["step"] == 1 and got["count"] == 1.0


# the gradients that are zero in exact arithmetic: the stride-32 box
# branch (no positive anchor at 64x64) and the area-attention blocks' BN
# biases whose shift reaches a train-mode BN through 1x1 convs only
ZERO_GRAD = {f"net/box2_{i}/{leaf}" for i in range(2) for leaf in
             ("bn/bias", "bn/scale", "conv/kernel")} | {"net/box2_2/bias", "net/box2_2/kernel"} | {
    f"net/l{l}/m{i}_{j}/{sub}/bn/bias" for l in (6, 8) for i in range(2) for j in range(2)
    for sub in ("attn/pe", "attn/proj", "mlp2")}


@pytest.mark.parametrize("held", ["port_float64", "port_fp32"])
def test_yolo_train_step_gradients(one_step, weights, held):
    """Every gradient tensor against the JAX package's float64 gradient,
    relative to the tensor's largest entry. The port's float64 gradient to
    1e-10 (measured 1.1e-12): the same function, so a wrong term shows at
    its own size. The port's fp32 gradient to 1e-3 (measured 1.6e-4), and
    no further from float64 than twice the JAX fp32 gradient is (3.9e-4):
    the train-mode BatchNorms' backward cancels in fp32 in both packages.
    The 32 tensors whose gradient is zero in exact arithmetic (``ZERO_GRAD``;
    the float64 ones below 1e-12 of the largest gradient, every other
    tensor's largest entry above 1e-6 of it) are held below 1e-12 of the
    largest gradient in float64 and 1e-5 in fp32 instead."""
    want = one_step["jax_float64"][2]
    got = one_step["port_float64"][1] if held == "port_float64" else one_step["port"][1]
    assert set(got) == set(want) == set(leaves(weights[0]))
    gmax = max(float(np.abs(w).max()) for w in want.values())
    assert {k for k, w in want.items() if np.abs(w).max() <= 1e-12 * gmax} == ZERO_GRAD
    assert min(np.abs(w).max() for k, w in want.items() if k not in ZERO_GRAD) > 1e-6 * gmax

    def worst(g):
        return max(float(np.abs(g[k] - w).max() / np.abs(w).max())
                   for k, w in want.items() if k not in ZERO_GRAD)

    def zero_max(g):
        return max(float(np.abs(g[k]).max()) for k in ZERO_GRAD) / gmax

    if held == "port_float64":
        assert {v.dtype for v in got.values()} == {np.dtype(np.float64)}
        np.testing.assert_allclose(one_step["port_float64"][0], one_step["jax_float64"][0],
                                   rtol=1e-12)
        assert worst(got) <= 1e-10 and zero_max(got) <= 1e-12
    else:
        assert worst(got) <= 1e-3 and zero_max(got) <= 1e-5
        assert worst(got) <= 2 * worst(one_step["jax"][2])


# --------------------------------------------------------------------------
# the folded layout
# --------------------------------------------------------------------------


def test_folded_model_matches_the_unfolded_one_and_jax(weights):
    """fold_batch_norm's tree equals the JAX fold bit for bit; the port's
    ``YOLO12Pose(fold_bn=True)`` loaded from it (``yolo_from_flax`` with no
    statistics) gives the unfolded eval model's level outputs and decode
    within 1e-4 in fp32, and JAX ``YOLO12Pose(fold_bn=True)``'s on the same
    folded tree."""
    folded = fold_batch_norm(*weights)
    want_tree = leaves(jax.tree.map(np.asarray, jax_fold(*weights)))
    got_tree = leaves(folded)
    assert set(got_tree) == set(want_tree) and len(got_tree) == 256
    for k, v in want_tree.items():
        assert got_tree[k].dtype == v.dtype and np.array_equal(got_tree[k], v), k
    imgs, _ = yolo_batch(3)
    x = torch.from_numpy(imgs)
    model = yolo_from_flax(folded, None, dtype=torch.float32)
    assert not batch_norms(model) and model.net.l0.conv.bias is not None
    unfolded = yolo_from_flax(*weights, dtype=torch.float32)
    jmodel = jax_yolo.YOLO12Pose(fold_bn=True, dtype=jnp.float32)
    jlevels = jax.jit(lambda p, xx: jmodel.apply({"params": p}, xx, train=True))(
        jax.tree.map(jnp.asarray, folded), imgs)
    with torch.no_grad():
        got, ref = model.levels(x), unfolded.levels(x)
        dec, dec_ref = model(x), unfolded(x)
    for a, b, j in zip(got, ref, jlevels):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-4)
        np.testing.assert_allclose(a.numpy(), np.asarray(j), rtol=0, atol=1e-4)
    for a, b in zip(dec, dec_ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-3)
