"""The port's HRNet pose training against the JAX package's, fp32 on the CPU
at 64x96 b2 (16x24 heatmaps): the heatmap target functions, the pose
pipeline's targets, ReduceLROnPlateau, one train step of the full-width
HRNet-W18-small (4,233,508 parameters), the head's BatchNorms and the exact
BatchNorm recalibration. ``test_torch_pose_trainer.py`` holds the trainer.

fp32 XLA:CPU and fp32 PyTorch differ in summation order: the loss agrees to
1e-5 relative, the BatchNorm statistics to 1e-5. The gradients are held
three ways (see :func:`test_pose_train_step_gradients`), each tensor
against its largest entry: the port's float64 gradient against the JAX
package's float64 one to 1e-10, the port's fp32 gradient against the JAX
float64 one to 1e-4, and against the JAX fp32 one, which sits up to 0.9 %
from the float64 one here, to 2e-2.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mtg_card_image_segmentation_tpu import losses as jax_losses
from mtg_card_image_segmentation_tpu.models import create_model as jax_create_model
from mtg_card_image_segmentation_tpu.ops import heatmap as jax_hm
from mtg_card_image_segmentation_tpu.training import loop as jax_loop
from mtg_card_image_segmentation_tpu.training.state import SegTrainState as JaxState

from mtg_card_image_segmentation_tpu_torch import config as port_config
from mtg_card_image_segmentation_tpu_torch.config import OptimizerConfig
from mtg_card_image_segmentation_tpu_torch.data.pipeline import PoseSyntheticPipeline
from mtg_card_image_segmentation_tpu_torch.models import registry
from mtg_card_image_segmentation_tpu_torch.models.hrnet import HRNetPoseHead
from mtg_card_image_segmentation_tpu_torch.ops import heatmap as hm
from mtg_card_image_segmentation_tpu_torch.training.loop import (
    batch_norms,
    make_pose_eval_step,
    make_pose_train_step,
    recalibrate_batch_stats,
)
from mtg_card_image_segmentation_tpu_torch.training.optim import create_optimizer
from mtg_card_image_segmentation_tpu_torch.training.pose_trainer import ReduceLROnPlateau
from mtg_card_image_segmentation_tpu_torch.training.state import create_seg_state
from mtg_card_image_segmentation_tpu_torch.utils.params import (
    flax_to_state_dict,
    init_hrnet_flax_like,
    state_dict_to_flax,
)
from pose_common import (
    B,
    HM,
    H,
    W,
    batch,
    jax_grads_float64,
    leaves,
    port_grads_float64,
    port_model,
    two_pass_variance,
)

torch.set_num_threads(2)

SGD = dict(name="sgd", schedule="constant", warmup_epochs=0, learning_rate=0.05,
           weight_decay=1e-4)


@pytest.fixture(scope="module")
def weights():
    return init_hrnet_flax_like(0)


def _jax_model(**kw):
    return jax_create_model("hrnet_pose", heatmap_height=HM[0], heatmap_width=HM[1],
                            compute_dtype="float32", **kw)


def _jax_state(model, weights):
    return JaxState.create(apply_fn=model.apply,
                           params=jax.tree.map(jnp.asarray, weights[0]),
                           batch_stats=jax.tree.map(jnp.asarray, weights[1]),
                           tx=optax.sgd(0.1))


def _port_state(weights):
    opt_def, _ = create_optimizer(OptimizerConfig(**SGD), 1, 10)
    return create_seg_state(port_model(weights), opt_def)


# --------------------------------------------------------------------------
# heatmap targets
# --------------------------------------------------------------------------


@pytest.mark.parametrize("sigma", [1.0, 2.0, 3.5])
def test_gaussian_heatmaps_match_jax(sigma):
    """Targets of (B, K, 2) heatmap-pixel centers, a negative (missing) one
    among them rendering as zeros, to 1e-6; the one-sample form is the
    batch's first row."""
    rng = np.random.default_rng(int(sigma * 10))
    c = np.stack([rng.uniform(-2, 25, (3, 4)), rng.uniform(-2, 17, (3, 4))], -1)
    c = c.astype(np.float32)
    c[1, 3] = (-1.0, 5.0)
    want = np.asarray(jax_hm.gaussian_heatmaps_batch(jnp.asarray(c), *HM, sigma))
    got = hm.gaussian_heatmaps_batch(torch.from_numpy(c), *HM, sigma).numpy()
    assert got.shape == (3, *HM, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert not got[1, ..., 3].any()
    one = hm.gaussian_heatmaps(torch.from_numpy(c[0]), *HM, sigma).numpy()
    np.testing.assert_allclose(one, np.asarray(jax_hm.gaussian_heatmaps(c[0], *HM, sigma)),
                               rtol=0, atol=1e-6)


def test_pixel_to_heatmap_coords_soft_argmax_and_peaks_match_jax():
    """pixels_to_heatmap_coords (missing corners stay -1),
    decode_soft_argmax at two temperatures and extract_peaks, to 1e-6."""
    rng = np.random.default_rng(3)
    px = np.stack([rng.uniform(0, W - 1, (2, 4)), rng.uniform(0, H - 1, (2, 4))], -1)
    px = px.astype(np.float32)
    px[0, 1, 0] = -5.0
    want = np.asarray(jax_hm.pixels_to_heatmap_coords(jnp.asarray(px), (H, W), HM))
    got = hm.pixels_to_heatmap_coords(torch.from_numpy(px), (H, W), HM).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got[0, 1] == -1.0).all()
    maps = rng.standard_normal((2, *HM, 4)).astype(np.float32)
    for temp in (1.0, 4.0):
        (wc, wv), (gc, gv) = (jax_hm.decode_soft_argmax(jnp.asarray(maps), temp),
                              hm.decode_soft_argmax(torch.from_numpy(maps), temp))
        np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=0, atol=1e-6)
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=0, atol=0)
    thr = float(np.median(maps.reshape(2, -1, 4).max(1)))  # half the peaks pass
    wc, wv, wok = jax_hm.extract_peaks(jnp.asarray(maps), thr)
    gc, gv, gok = hm.extract_peaks(torch.from_numpy(maps), thr)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(gok.numpy(), np.asarray(wok))
    assert 0 < int(gok.sum()) < gok.numel()


def test_pose_targets_from_the_jax_pipelines_corners():
    """The JAX PoseSyntheticPipeline's own corners through the port's
    pixels_to_heatmap_coords and gaussian_heatmaps_batch give its targets
    (1e-6); the port's pipeline yields the same structure on its device:
    [0,1] images, corners in view, targets peaking at their corners."""
    from mtg_card_image_segmentation_tpu.data.pipeline import (
        PoseSyntheticPipeline as JaxPosePipeline,
    )

    _, targets, corners = next(iter(JaxPosePipeline(B, H, W, *HM, seed=5)))
    got = hm.gaussian_heatmaps_batch(
        hm.pixels_to_heatmap_coords(torch.from_numpy(np.asarray(corners)), (H, W), HM),
        *HM, 2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(targets), rtol=0, atol=1e-6)

    pipe = PoseSyntheticPipeline(B, H, W, *HM, augment=None, seed=5, device="cpu")
    img, tgt, cor = next(iter(pipe))
    assert img.shape == (B, H, W, 3) and tgt.shape == (B, *HM, 4) and cor.shape == (B, 4, 2)
    assert float(img.min()) >= 0.0 and float(img.max()) <= 1.0
    assert (cor[..., 0] >= 0).all() and (cor[..., 0] <= W - 1).all()
    peak, _ = hm.decode_argmax_subpixel(tgt)
    np.testing.assert_allclose((peak * torch.tensor([W - 1, H - 1])).numpy(), cor.numpy(),
                               atol=(W - 1) / (HM[1] - 1))
    aug = PoseSyntheticPipeline(B, H, W, *HM, augment=port_config.AugmentConfig(), seed=5,
                                device="cpu")
    assert not torch.equal(next(iter(aug))[0], img)


def test_reduce_lr_on_plateau_matches_jax_on_a_scripted_sequence():
    from mtg_card_image_segmentation_tpu.training.pose_trainer import (
        ReduceLROnPlateau as JaxPlateau,
    )

    rng = np.random.default_rng(0)
    losses = list(1.0 - 0.01 * np.arange(5)) + [0.96] * 14 + list(rng.uniform(0.9, 1.0, 40))
    ours = ReduceLROnPlateau(factor=0.5, patience=3, min_scale=0.05)
    theirs = JaxPlateau(factor=0.5, patience=3, min_scale=0.05)
    seen = []
    for x in losses:
        a, b = ours.step(float(x)), theirs.step(float(x))
        assert a == b and ours.bad == theirs.bad and ours.best == theirs.best
        seen.append(a)
    assert seen[0] == 1.0 and 0.5 in seen and seen[-1] == 0.05


# --------------------------------------------------------------------------
# train step, BatchNorm, recalibration
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def one_step(weights):
    """One fp32 pose train step of both packages from the same weights and
    batch (the JAX model with Flax's two-pass variance): (loss, gradients,
    BN statistics after the step) of each, and both packages' float64
    gradients."""
    imgs, targets, _ = batch(1)
    params, stats = (jax.tree.map(jnp.asarray, t) for t in weights)
    jax_model = _jax_model()

    def loss_fn(p):
        out, mutated = jax_model.apply({"params": p, "batch_stats": stats}, imgs,
                                       train=True, mutable=["batch_stats"])
        return jax_losses.heatmap_mse_loss(out, targets), mutated["batch_stats"]

    with two_pass_variance():
        (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    state = _port_state(weights)
    state, st = make_pose_train_step()(state, torch.from_numpy(imgs), torch.from_numpy(targets))
    grads = state_dict_to_flax({n: p.grad for n, p in state.model.named_parameters()})[0]
    return {"jax": (float(jloss), leaves(jax.tree.map(np.asarray, jgrads)),
                    leaves(jax.tree.map(np.asarray, jstats))),
            "port": (float(st["loss"]), leaves(grads), leaves(state.variables()["batch_stats"])),
            "port_float64": port_grads_float64(weights, imgs, targets),
            "jax_float64": jax_grads_float64(weights, imgs, targets)[1],
            "count": float(st["count"]), "step": state.step}


def test_pose_train_step_loss_matches_jax(one_step):
    (jl, _, _), (pl, _, _) = one_step["jax"], one_step["port"]
    assert abs(pl - jl) <= 1e-5 * abs(jl), (pl, jl)
    assert one_step["count"] == 1.0 and one_step["step"] == 1


# (the gradients held, the gradients they are held to)
GRADIENT_PAIRS = {"float64": ("port", "jax_float64"), "jax": ("port", "jax"),
                  "port_float64": ("port_float64", "jax_float64")}


@pytest.mark.parametrize("against,tol", [("float64", 1e-4), ("jax", 2e-2),
                                         ("port_float64", 1e-10)])
def test_pose_train_step_gradients(one_step, weights, against, tol):
    """Every gradient tensor within ``tol`` of its largest entry. The
    port's float64 gradient against the JAX package's float64 one to 1e-10
    (measured: 1.1e-13): the same function, so a wrong term shows at its
    own size. The port's fp32 gradient against the JAX float64 one to 1e-4
    (the port's fp32 rounding: 7e-5), and against the JAX fp32 one to
    2e-2: XLA's fp32 gradient of this step is itself up to 0.9 % of a
    tensor's largest entry from the float64 one (head/deconv1). The last
    stage's fusion convs that feed nothing have zero gradients in all."""
    held, reference = GRADIENT_PAIRS[against]
    got = one_step[held] if held == "port_float64" else one_step["port"][1]
    want = one_step[reference] if reference == "jax_float64" else one_step["jax"][1]
    assert set(got) == set(want) == set(leaves(weights[0]))
    if held == "port_float64":
        assert {v.dtype for v in got.values()} == {np.dtype(np.float64)}
    dead = {k for k, w in want.items() if not np.abs(w).any()}
    assert dead and all(k.startswith("backbone/fuse2/") for k in dead)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=tol * np.abs(w).max(), err_msg=k)


def test_pose_train_step_batch_stats_match_jax(one_step):
    """Every BatchNorm's running statistics after the step, the head's
    deconv_bn0/1 included (Flax momentum 0.99, biased variance)."""
    (_, _, js), (_, _, ps) = one_step["jax"], one_step["port"]
    assert set(ps) == set(js)
    assert {"head/deconv_bn0/var", "head/deconv_bn1/mean"} <= set(ps)
    for k, w in js.items():
        np.testing.assert_allclose(ps[k], w, rtol=1e-5, atol=1e-5, err_msg=k)


def test_head_deconv_batch_norms_move_like_flax(weights):
    """The head's deconv BatchNorms in train mode move the running variance
    with the batch's biased variance, as Flax does: the batch's share of
    the update, ``ra' - 0.99 ra``, to 1e-4 relative (torch's own module
    would use the unbiased one, 1/(n-1) = 1/47 larger at 4x6 b2 and 1/191
    at 8x12), and batch_norms finds both."""
    from mtg_card_image_segmentation_tpu.models.hrnet import HRNetPoseHead as JaxHead

    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 2, 3, 128)).astype(np.float32)
    head = HRNetPoseHead(128, 4, *HM, dtype=torch.float32)
    head.load_state_dict({k[len("head."):]: v for k, v in flax_to_state_dict(*weights).items()
                          if k.startswith("head.")})

    def fn(p, s, xx):
        return JaxHead(heatmap_height=HM[0], heatmap_width=HM[1], dtype=jnp.float32).apply(
            {"params": p, "batch_stats": s}, xx, train=True,
            mutable=["batch_stats"])[1]["batch_stats"]

    with two_pass_variance():
        want = jax.tree.map(np.asarray, jax.jit(fn)(weights[0]["head"], weights[1]["head"], x))
    head.train()(torch.from_numpy(x))
    for i in range(2):
        bn = getattr(head, f"deconv_bn{i}")
        init = np.asarray(weights[1]["head"][f"deconv_bn{i}"]["var"])
        np.testing.assert_allclose(bn.running_var.numpy() - 0.99 * init,
                                   want[f"deconv_bn{i}"]["var"] - 0.99 * init,
                                   rtol=1e-4, atol=1e-7)
    assert {id(head.deconv_bn0), id(head.deconv_bn1)} <= {id(m) for m in batch_norms(head)}


def test_batch_norms_cover_every_hrnet_batch_norm(weights):
    """Every running-statistics pair of the Flax tree is one BatchNorm that
    batch_norms returns, momentum 0.01 (Flax 0.99)."""
    model = registry.pose_from_config(port_config.PoseModelConfig())
    bns = batch_norms(model)
    assert len(bns) == len(leaves(weights[1])) // 2
    assert len(bns) == sum(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())
    assert {round(bn.momentum, 12) for bn in bns} == {0.01}


def test_pose_recalibration_matches_jax(weights):
    """recalibrate_batch_stats over 3 batches against the JAX one with its
    momentum-0 model: every statistic, the head's included, to 1e-5."""
    batches = [batch(10 + i)[0] for i in range(3)]
    recal_model = _jax_model(bn_momentum=0.0)
    with two_pass_variance():
        jnew = jax_loop.recalibrate_batch_stats(_jax_state(recal_model, weights), recal_model,
                                                batches)
    state = _port_state(weights)
    recalibrate_batch_stats(state, [torch.from_numpy(b) for b in batches])
    want = leaves(jax.tree.map(np.asarray, jnew.batch_stats))
    got = leaves(state.variables()["batch_stats"])
    assert max(np.abs(got[k] - v).max() for k, v in leaves(weights[1]).items()) > 0.3
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-5, err_msg=k)
    assert {round(bn.momentum, 12) for bn in batch_norms(state.model)} == {0.01}


def test_pose_eval_step_matches_jax(weights):
    """make_pose_eval_step: the loss and the (B, K) pixel distances between
    the sub-pixel decodes of prediction and target."""
    imgs, targets, _ = batch(2)
    jstats, jd = jax_loop.make_pose_eval_step((H, W))(_jax_state(_jax_model(), weights), imgs,
                                                      targets)
    state = _port_state(weights)
    stats, d = make_pose_eval_step((H, W))(state, torch.from_numpy(imgs),
                                           torch.from_numpy(targets))
    assert not state.model.training
    np.testing.assert_allclose(float(stats["loss"]), float(jstats["loss"]), rtol=1e-5)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-3)
