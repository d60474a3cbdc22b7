"""Shared inputs of the pose-training tests (``test_torch_pose_train.py``,
``test_torch_pose_trainer.py``): the 64x96 b2 geometry, numpy-seeded
batches, Flax-tree leaves, the JAX model with Flax's two-pass BatchNorm
variance, and both packages' gradients in float64.

Flax's BatchNorm computes the batch variance as E[x^2] - E[x]^2
(``use_fast_variance``). On the [0,1] pose inputs the head's activations
have a large mean, and that formula cancels: the JAX package's fp32
gradient of ``head/deconv1`` is then 13 % of its largest entry away from
the float64 gradient, the port's 2e-5. :func:`two_pass_variance` makes
Flax compute ``E[(x - E[x])^2]``, as torch does: the forward is the same
function; only its rounding changes.
"""

from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mtg_card_image_segmentation_tpu_torch.models.hrnet import HRNetPose
from mtg_card_image_segmentation_tpu_torch.ops import heatmap as hm
from mtg_card_image_segmentation_tpu_torch.training.loop import pose_grads_float64
from mtg_card_image_segmentation_tpu_torch.utils.params import (
    flax_to_state_dict,
    state_dict_to_flax,
)

H, W, HM, B = 64, 96, (16, 24), 2


def leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(leaves(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def batch(seed, b=B):
    """Smooth [0,1] images, corners inside the image (one missing in the
    last image) and their Gaussian targets, as numpy."""
    rng = np.random.default_rng(seed)
    base = torch.from_numpy(rng.random((b, 3, H // 8, W // 8)).astype(np.float32))
    imgs = torch.nn.functional.interpolate(base, size=(H, W), mode="bilinear",
                                           align_corners=False).permute(0, 2, 3, 1)
    corners = np.stack([rng.uniform(0, W - 1, (b, 4)), rng.uniform(0, H - 1, (b, 4))],
                       -1).astype(np.float32)
    corners[-1, 2] = -1.0
    targets = hm.gaussian_heatmaps_batch(
        hm.pixels_to_heatmap_coords(torch.from_numpy(corners), (H, W), HM), *HM)
    return imgs.contiguous().numpy(), targets.numpy(), corners


def port_model(weights, dtype=torch.float32):
    model = HRNetPose(heatmap_height=HM[0], heatmap_width=HM[1], dtype=dtype)
    model.load_state_dict(flax_to_state_dict(*weights), strict=True)
    return model.train()


@contextmanager
def two_pass_variance():
    """Flax BatchNorms traced inside the block compute the batch variance
    in two passes."""
    from flax.linen import normalization

    fast = normalization._compute_stats

    def two_pass(*args, **kwargs):
        kwargs["use_fast_variance"] = False
        return fast(*args, **kwargs)

    normalization._compute_stats = two_pass
    try:
        yield
    finally:
        normalization._compute_stats = fast


def port_grads_float64(weights, imgs, targets):
    """The port's train-mode MSE gradients in float64
    (``training.loop.pose_grads_float64``), as Flax-layout leaves."""
    _, grads = pose_grads_float64(port_model(weights), torch.from_numpy(imgs),
                                  torch.from_numpy(targets))
    return leaves(state_dict_to_flax(grads)[0])


class _Float64Numpy:
    """``jax.numpy`` whose ``float32`` is ``float64``: the JAX modules'
    float32 casts made float64, as the port's are for its float64 pass."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def jax_grads_float64(weights, imgs, targets):
    """The JAX package's train-mode MSE loss and gradients in float64 (x64
    on, the HRNet, layer, resize and loss modules' float32 casts made
    float64, Flax's BatchNorm variance in two passes), as Flax-layout
    leaves."""
    from mtg_card_image_segmentation_tpu import losses as jax_losses
    from mtg_card_image_segmentation_tpu.models import hrnet as jax_hrnet
    from mtg_card_image_segmentation_tpu.models import layers as jax_layers
    from mtg_card_image_segmentation_tpu.ops import resize as jax_resize

    mods = (jax_losses, jax_hrnet, jax_layers, jax_resize)
    saved = [m.jnp for m in mods]
    for m in mods:
        m.jnp = _Float64Numpy()
    try:
        with jax.enable_x64(True), two_pass_variance():
            model = jax_hrnet.HRNetPose(heatmap_height=HM[0], heatmap_width=HM[1],
                                        dtype=jnp.float64, param_dtype=jnp.float64)
            params, stats = (jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)
                             for t in weights)

            def loss_fn(p):
                out = model.apply({"params": p, "batch_stats": stats}, imgs.astype(np.float64),
                                  train=True, mutable=["batch_stats"])[0]
                return jax_losses.heatmap_mse_loss(out, targets.astype(np.float64))

            loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
            assert loss.dtype == jnp.float64
            return float(loss), leaves(jax.tree.map(np.asarray, grads))
    finally:
        for m, j in zip(mods, saved):
            m.jnp = j
