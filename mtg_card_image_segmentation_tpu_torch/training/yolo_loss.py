"""Single-object YOLO pose loss and train step (counterpart of the JAX
package's ``training/yolo_loss.py``).

Every image holds exactly one card, whose box is its four corners' bounds
with 5 % padding (the reference's label converter,
``*_yolo12n/dataset.py:121-152``):

- assignment: the ``TOP_K`` anchors (over all levels) nearest the box
  centre among those whose centres lie inside the box are positives;
- classification: BCE toward IoU-quality soft targets on the positives;
- box: CIoU on the DFL-decoded boxes (positives);
- DFL: cross-entropy on the two integer bins beside each ltrb target;
- keypoints: per anchor and corner a confidence trained with CornerNet's
  penalty-reduced focal loss toward a pixel-space Gaussian of the
  anchor-to-corner distance, and a Huber loss on the local offsets of the
  anchors near the corner.

All of it is dense masked math over the fixed anchor set. Where torch and
JAX differ, the JAX rule is written out: the top-k takes the lower index
first among equal distances (a stable sort); clips that carry a gradient
are ``torch.maximum`` (gradient 1/2 at the boundary, as ``jnp.clip`` and
``jnp.maximum`` give; ``torch.clamp`` gives 1); softplus is
``logaddexp(x, 0)`` (``F.softplus`` switches to ``x`` above 20). Dtypes
follow the level outputs' ``.float()``, so a float64 pass
(``training.loop.grads_float64``) is float64 throughout.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

from mtg_card_image_segmentation_tpu_torch.models.yolo12_pose import (
    KPT_OFFSET_SCALE,
    REG_MAX,
    STRIDES,
    decode_predictions,
)
from mtg_card_image_segmentation_tpu_torch.training.loop import check_mesh, mean_over_ranks
from mtg_card_image_segmentation_tpu_torch.training.state import SegTrainState

TOP_K = 10
# corner-heatmap supervision, in pixels at every level
KPT_SIGMA_PX = 6.0
KPT_RADIUS_PX = 12.0


def corners_to_box(corners_xy: torch.Tensor, pad: float = 0.05) -> torch.Tensor:
    """(B, 4, 2) corner pixels -> (B, 4) xyxy with 5 % padding."""
    mn = corners_xy.amin(1)
    mx = corners_xy.amax(1)
    wh = mx - mn
    return torch.cat([mn - pad * wh, mx + pad * wh], dim=-1)


def _anchor_centers(shapes: Sequence[Tuple[int, int]], dtype: torch.dtype,
                    device) -> torch.Tensor:
    """Flattened (A, 3) [cx_px, cy_px, stride] of all levels."""
    pts = []
    for (h, w), stride in zip(shapes, STRIDES):
        cx = ((torch.arange(w, dtype=dtype, device=device) + 0.5) * stride).expand(h, w)
        cy = ((torch.arange(h, dtype=dtype, device=device) + 0.5) * stride)[:, None].expand(h, w)
        s = torch.full((h, w), float(stride), dtype=dtype, device=device)
        pts.append(torch.stack([cx, cy, s], dim=-1).reshape(-1, 3))
    return torch.cat(pts, dim=0)


def _ciou(box1: torch.Tensor, box2: torch.Tensor) -> torch.Tensor:
    """Complete IoU between (..., 4) xyxy boxes."""
    zero = box1.new_zeros(())
    x1 = torch.maximum(box1[..., 0], box2[..., 0])
    y1 = torch.maximum(box1[..., 1], box2[..., 1])
    x2 = torch.minimum(box1[..., 2], box2[..., 2])
    y2 = torch.minimum(box1[..., 3], box2[..., 3])
    inter = torch.maximum(x2 - x1, zero) * torch.maximum(y2 - y1, zero)
    a1 = (box1[..., 2] - box1[..., 0]) * (box1[..., 3] - box1[..., 1])
    a2 = (box2[..., 2] - box2[..., 0]) * (box2[..., 3] - box2[..., 1])
    union = a1 + a2 - inter + 1e-7
    iou = inter / union
    # enclosing box diagonal + centre distance
    ex1 = torch.minimum(box1[..., 0], box2[..., 0])
    ey1 = torch.minimum(box1[..., 1], box2[..., 1])
    ex2 = torch.maximum(box1[..., 2], box2[..., 2])
    ey2 = torch.maximum(box1[..., 3], box2[..., 3])
    c2 = (ex2 - ex1) ** 2 + (ey2 - ey1) ** 2 + 1e-7
    d2 = (((box1[..., 0] + box1[..., 2]) - (box2[..., 0] + box2[..., 2])) ** 2
          + ((box1[..., 1] + box1[..., 3]) - (box2[..., 1] + box2[..., 3])) ** 2) / 4.0
    eps = box1.new_tensor(1e-7)
    w1 = box1[..., 2] - box1[..., 0]
    h1 = torch.maximum(box1[..., 3] - box1[..., 1], eps)
    w2 = box2[..., 2] - box2[..., 0]
    h2 = torch.maximum(box2[..., 3] - box2[..., 1], eps)
    v = (4 / math.pi**2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    alpha = v / (1 - iou + v + 1e-7)
    return iou - d2 / c2 - alpha * v


def positive_mask(anchors: torch.Tensor, gt_box: torch.Tensor, k: int = TOP_K) -> torch.Tensor:
    """(B, A) positives: the ``k`` anchors nearest the box centre (the
    lower index first among equal distances, ``jax.lax.top_k``'s rule)
    among those whose centres lie strictly inside the box."""
    gt_cx = (gt_box[:, 0] + gt_box[:, 2]) / 2
    gt_cy = (gt_box[:, 1] + gt_box[:, 3]) / 2
    inside = ((anchors[None, :, 0] > gt_box[:, None, 0])
              & (anchors[None, :, 0] < gt_box[:, None, 2])
              & (anchors[None, :, 1] > gt_box[:, None, 1])
              & (anchors[None, :, 1] < gt_box[:, None, 3]))
    dist = torch.sqrt((anchors[None, :, 0] - gt_cx[:, None]) ** 2
                      + (anchors[None, :, 1] - gt_cy[:, None]) ** 2)
    masked = torch.where(inside, dist, torch.full_like(dist, math.inf))
    topk = torch.sort(masked, dim=1, stable=True).indices[:, :k]
    chosen = torch.zeros_like(inside).scatter_(1, topk, True)
    return chosen & inside


def optax_sigmoid_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The reference's elementwise sigmoid BCE, ``max(x, 0) - x t +
    log1p(exp(-|x|))``."""
    return (torch.maximum(logits, logits.new_zeros(())) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, x.new_zeros(()))


def yolo_pose_loss(level_outputs: List[torch.Tensor], gt_corners: torch.Tensor,
                   num_keypoints: int = 4, cls_weight: float = 0.5, box_weight: float = 7.5,
                   dfl_weight: float = 1.5, kpt_weight: float = 12.0,
                   kobj_weight: float = 1.0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, parts) of the three levels' raw head outputs (B, h, w, C)
    against the (B, 4, 2) corner pixels ``gt_corners``; ``parts`` holds the
    total, each weighted term's loss and a count of 1, on the device."""
    outs = [o.float() for o in level_outputs]
    dt, dev = outs[0].dtype, outs[0].device
    gt_corners = gt_corners.to(dt)
    anchors = _anchor_centers([(o.shape[1], o.shape[2]) for o in outs], dt, dev)
    boxes_p, _, _ = decode_predictions(outs, num_classes=1, num_keypoints=num_keypoints)
    b = boxes_p.shape[0]

    gt_box = corners_to_box(gt_corners)
    pos = positive_mask(anchors, gt_box)
    num_pos = pos.sum(1).clamp_min(1)
    posf = pos.to(dt)

    # --- cls BCE toward IoU soft targets ---
    ciou = _ciou(boxes_p, gt_box[:, None, :])
    cls_target = posf * ciou.detach().clamp(0.0, 1.0)
    logits = torch.cat([o[..., 4 * REG_MAX:4 * REG_MAX + 1].reshape(b, -1) for o in outs], 1)
    cls_loss = (optax_sigmoid_bce(logits, cls_target).sum(1) / num_pos).mean()

    # --- box CIoU on positives ---
    box_loss = (((1.0 - ciou) * posf).sum(1) / num_pos).mean()

    # --- DFL on positives ---
    ltrb = torch.stack([anchors[None, :, 0] - gt_box[:, None, 0],
                        anchors[None, :, 1] - gt_box[:, None, 1],
                        gt_box[:, None, 2] - anchors[None, :, 0],
                        gt_box[:, None, 3] - anchors[None, :, 1]], dim=-1) / anchors[None, :, 2:3]
    ltrb = ltrb.clamp(0, REG_MAX - 1.01)
    box_logits = torch.cat([o[..., :4 * REG_MAX].reshape(b, -1, 4, REG_MAX) for o in outs], 1)
    lo = torch.floor(ltrb)
    w_hi = ltrb - lo
    logp = torch.log_softmax(box_logits, dim=-1)
    lo_i = lo.long()[..., None]
    dfl = -(torch.gather(logp, -1, lo_i)[..., 0] * (1 - w_hi)
            + torch.gather(logp, -1, lo_i + 1)[..., 0] * w_hi)
    dfl_loss = ((dfl.mean(-1) * posf).sum(1) / num_pos).mean()

    # --- keypoints: corner heatmap (focal) + local sub-pixel offsets ---
    kpt_raw = torch.cat([o[..., 4 * REG_MAX + 1:].reshape(b, -1, num_keypoints, 3)
                         for o in outs], 1)  # (B, A, K, 3) [dx, dy, conf]
    dxy = gt_corners[:, None, :, :] - anchors[None, :, None, :2]  # (B, A, K, 2)
    d2k = (dxy**2).sum(-1)
    t = torch.exp(-d2k / (2.0 * KPT_SIGMA_PX**2))
    logit = kpt_raw[..., 2]
    p = torch.sigmoid(logit)
    focal = (t * (1 - p) ** 2 * _softplus(-logit)
             + (1 - t) ** 4 * p**2 * _softplus(logit))
    kobj_loss = (focal.sum((1, 2)) / (t.sum((1, 2)) + 1.0)).mean()

    off_mask = (d2k < KPT_RADIUS_PX**2).to(dt)
    off_err = kpt_raw[..., :2] - dxy / KPT_OFFSET_SCALE
    huber = torch.where(off_err.abs() < 1.0, 0.5 * off_err**2, off_err.abs() - 0.5).sum(-1)
    kpt_loss = ((huber * off_mask).sum((1, 2)) / (off_mask.sum((1, 2)) + 1e-6)).mean()

    total = (cls_weight * cls_loss + box_weight * box_loss + dfl_weight * dfl_loss
             + kpt_weight * kpt_loss + kobj_weight * kobj_loss)
    parts = {"loss": total, "cls_loss": cls_loss, "box_loss": box_loss,
             "dfl_loss": dfl_loss, "kpt_loss": kpt_loss, "kobj_loss": kobj_loss,
             "count": torch.ones((), device=dev)}
    return total, parts


def yolo_grads_float64(model: torch.nn.Module, images: torch.Tensor, corners: torch.Tensor,
                       num_keypoints: int = 4):
    """The YOLO train step's loss, gradients and float64 model copy
    (``training.loop.grads_float64`` of :func:`yolo_pose_loss`)."""
    from mtg_card_image_segmentation_tpu_torch.training.loop import grads_float64

    return grads_float64(model, lambda m, x, c: yolo_pose_loss(m.levels(x), c, num_keypoints)[0],
                         images, corners)


def make_yolo_train_step(num_keypoints: int = 4, mesh=None):
    """``step(state, images, corners) -> (state, parts)``: one update of
    ``state`` in place from NHWC [0, 1] ``images`` and (B, 4, 2) corner
    pixels, the model (``YOLO12Pose``) in train mode on its raw level
    outputs. ``parts`` holds the detached loss terms, on the device.

    Under a process group (``training/loop.py``) each rank feeds its slice
    of the global batch: the loss is a mean of per-sample terms, so over
    equal local batches DDP's gradient average is the global gradient;
    ``parts`` are the means over the ranks. The YOLO trainer lays a
    data-only mesh, as the JAX one does (``train_yolo.py``): a mesh with
    ``space`` or ``model`` axes over ranks is refused."""
    check_mesh(mesh)
    if mesh is not None and mesh.layout is not None:
        raise ValueError(f"mesh {mesh.shape}: the YOLO step is data-parallel only")

    def train_step(state: SegTrainState, images: torch.Tensor, corners: torch.Tensor):
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss, parts = yolo_pose_loss(state.train_module("levels")(images), corners,
                                     num_keypoints)
        loss.backward()
        state.apply_gradients()
        return state, {k: mean_over_ranks(v) for k, v in parts.items()}

    return train_step
