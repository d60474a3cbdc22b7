"""Batched segmentation predictor on the card — the serving main path
(counterpart of the JAX package's ``serving/predictor.py``).

``SegPredictor.predict`` takes uint8 (B, H, W, 3) images and returns uint8
{0,1} (B, H, W) masks. With ``use_kernels=True`` (the default):

- BatchNorm is folded into the convs and the uint8 -> ImageNet
  normalization into the stem conv, so the input is only centered;
- the stem, blocks 0-11, ``head_conv`` and the head's 3x3 ``cbr`` conv are
  stock PyTorch convs (channels_last views of NHWC tensors);
- blocks 12-14 run as the hand-written tail chain (``fused_tail_chain``);
- the LR-ASPP head collapses to one card-minus-background score map at
  stride 8 (``_head_score_s8``), which the mask decode kernel
  (``fused_mask_decode``) turns into the full-size uint8 mask.

Two options, both off by default as in the reference: ``fused_stem=True``
runs the stem as the hand-written stem kernel (``fused_stem``: uint8 in,
centering, conv, bias and hardswish in one pass), and ``fused_head=True``
runs the head's tail and the decode as one kernel (``fused_head_decode``,
``_head_decode_mask``).

``fused_blocks`` (default ``FUSED_BLOCKS``, blocks 12-14) and
``fused_chain`` (default True) choose the backbone blocks that run the
hand-written block kernels, as the reference's ``fused_blocks`` and its
``MTG_FUSED_CHAIN`` switch do: exactly blocks 12-14 with ``fused_chain``
run as the tail chain; otherwise every listed block runs the per-block
kernel (``fused_inverted_residual``) at its own kernel size, stride,
activation, SE and dilation, and the other blocks run as their modules.

``use_kernels=False`` is the reference-shaped path: unfolded normalize,
full head, bilinear resize and argmax, all in stock ops.

Spans (``utils/profiling.py``, recorded only under a torch profiler):
``seg.predict`` around each call, ``seg.upload`` (entry); ``seg.stem`` (the
centering or the stem kernel's call, and the stem conv), ``seg.block`` for
each block run as its module, ``seg.head`` (``head_conv``, then the head's
stock part), ``seg.model`` (the whole reference-shaped path) (stock); the
kernel wrappers add their own ``kernel.<name>`` spans.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from mtg_card_image_segmentation_tpu_torch.data.preprocess import (
    IMAGENET_MEAN,
    IMAGENET_STD,
)
from mtg_card_image_segmentation_tpu_torch.compression.slim import tree_map
from mtg_card_image_segmentation_tpu_torch.export.fold_bn import fold_batch_norm
from mtg_card_image_segmentation_tpu_torch.export.quantize import (
    dequantize_params,
    quantize_params,
    torch_xp,
)
from mtg_card_image_segmentation_tpu_torch.models.mobilenetv3 import (
    LOW_TAP_ROW,
    MOBILENET_V3_LARGE_ROWS,
    MobileNetV3Backbone,
)
from mtg_card_image_segmentation_tpu_torch.models.lraspp import LRASPPHead
from mtg_card_image_segmentation_tpu_torch.ops.kernels.decoder import (
    fused_head_decode,
    fused_mask_decode,
)
from mtg_card_image_segmentation_tpu_torch.ops.kernels.fused_block import (
    BlockWeights,
    fused_inverted_residual,
    fused_tail_chain,
    kernel_takes,
)
from mtg_card_image_segmentation_tpu_torch.ops.kernels.stem import apply_stem, prepare_stem
from mtg_card_image_segmentation_tpu_torch.ops.resize import _interp_matrix, bilinear_resize
from mtg_card_image_segmentation_tpu_torch.parallel.mesh import shard_batch
from mtg_card_image_segmentation_tpu_torch.training.checkpoint import load_params
from mtg_card_image_segmentation_tpu_torch.utils.params import from_flax
from mtg_card_image_segmentation_tpu_torch.utils.platform import resolve_device
from mtg_card_image_segmentation_tpu_torch.utils.profiling import Span

# backbone blocks that run through the hand-written kernels: the dilated
# tail, as one chain
FUSED_BLOCKS = (12, 13, 14)

_IMAGENET_MEAN = np.array(IMAGENET_MEAN, np.float32)
_IMAGENET_STD = np.array(IMAGENET_STD, np.float32)

_PREDICT = Span("seg.predict", "entry")
_UPLOAD = Span("seg.upload", "entry")
_STEM = Span("seg.stem", "stock")
_BLOCK = Span("seg.block", "stock")
_HEAD = Span("seg.head", "stock")
_MODEL = Span("seg.model", "stock")

_INTERP: Dict[Tuple[int, int, str], torch.Tensor] = {}
_INTERP_LOCK = threading.Lock()  # a threaded server may fill the cache from two requests


def _fold_normalize_into_stem(params):
    """Fold uint8 -> ImageNet normalization into the stem conv.

    With u = u8 - 255*mean (per channel): (u8/255 - mean)/std == u * a,
    a_c = 1/(255*std_c), exactly, with no bias shift, so the stem's zero
    padding of u still stands for x_norm = 0.
    """
    stem = params["backbone"]["stem"]["conv"]
    k = np.asarray(stem["kernel"], np.float32)  # (3, 3, 3, 16)
    a = 1.0 / (255.0 * _IMAGENET_STD)
    k_new = k * a[None, None, :, None]
    b_new = np.asarray(stem["bias"], np.float32)
    new = dict(params)
    new["backbone"] = dict(params["backbone"])
    new["backbone"]["stem"] = {"conv": {"kernel": k_new, "bias": b_new}}
    return new


def tail_weights(backbone: MobileNetV3Backbone) -> List[BlockWeights]:
    """The kernels' weights of the tail blocks (12-14), in chain order."""
    return [BlockWeights.from_module(backbone.block(i)) for i in FUSED_BLOCKS]


def kernel_block_ids(backbone: MobileNetV3Backbone, fused_blocks: Sequence[int]) -> Tuple[int, ...]:
    """The blocks of ``fused_blocks`` that the per-block kernel takes, decided
    from the weights' shapes (``kernel_takes``); the others run as their
    modules, as the reference's blocks without a tiling do."""
    return tuple(i for i in sorted(set(fused_blocks)) if kernel_takes(backbone.block(i)))


def _fused_backbone(backbone: MobileNetV3Backbone, x: torch.Tensor,
                    tail: Optional[Sequence[BlockWeights]] = None,
                    stem_done: bool = False,
                    blocks: Optional[Mapping[int, BlockWeights]] = None
                    ) -> Dict[str, torch.Tensor]:
    """Backbone forward. With ``tail`` (the kernel weights of blocks 12-14)
    those blocks run as the hand-written tail chain; with ``blocks`` ({block
    id: kernel weights}) each of those blocks runs the per-block kernel;
    every other block runs as its module. With ``stem_done`` the input is
    already the stem's output (the stem-kernel path). Returns the {"low",
    "high"} taps."""
    if not stem_done:
        with _STEM:
            x = backbone.stem(x)
    taps = {}
    for i, (k, _exp, _out, _se, act, _stride, _tail) in enumerate(MOBILENET_V3_LARGE_ROWS):
        blk = backbone.block(i)
        if tail is not None and i in FUSED_BLOCKS:
            if i == FUSED_BLOCKS[0]:
                x = fused_tail_chain(x.contiguous(), tail, kernel_size=k, act=act,
                                     dilation=blk.dilation)
        elif blocks is not None and i in blocks:
            # stride 1 at dilation 2 in the tail (the module's own rule)
            x = fused_inverted_residual(x.contiguous(), blocks[i], k, blk.stride, act,
                                        blk.residual, blk.dilation)
        else:
            with _BLOCK:
                x = blk(x)
        if i == LOW_TAP_ROW:
            taps["low"] = x
    with _HEAD:
        taps["high"] = backbone.head_conv(x)
    return taps


def _head_gate_vectors(head: LRASPPHead):
    """Folded classifier vectors (w_scale, w_hi_d, w_lo_d, bias_d), fp32:
    card-minus-background differences of the two classifiers."""
    w_scale = head.scale.weight.flatten(1).float().t()  # (C_high, C_inter)
    w_hi = head.high_classifier.weight.flatten(1).float()  # (2, C_inter)
    b_hi = head.high_classifier.bias.float()
    w_lo = head.low_classifier.weight.flatten(1).float()  # (2, C_low)
    b_lo = head.low_classifier.bias.float()
    return (
        w_scale,
        w_hi[1] - w_hi[0],
        w_lo[1] - w_lo[0],
        (b_hi[1] - b_hi[0]) + (b_lo[1] - b_lo[0]),
    )


def interp_matrix(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """``_interp_matrix`` as a float32 tensor on ``device``, cached per
    shape."""
    key = (in_size, out_size, str(device))
    with _INTERP_LOCK:
        if key not in _INTERP:
            _INTERP[key] = torch.from_numpy(_interp_matrix(in_size, out_size)).to(device)
        return _INTERP[key]


def _head_gated(head: LRASPPHead, high: torch.Tensor,
                vectors: Optional[Tuple[torch.Tensor, ...]] = None):
    """The head's stock part, shared by its two formulations: the cbr
    features (B, h16, w16, C_inter), the per-image gate folded into the high
    classifier's difference vector (B, C_inter) float32, and the low
    classifier's difference vector and bias. ``vectors`` is
    ``_head_gate_vectors(head)``, computed here if not given."""
    x = head.cbr(high)
    m = high.mean(dim=(1, 2), dtype=torch.float32)
    if vectors is None:
        vectors = _head_gate_vectors(head)
    w_scale, w_hi_d, w_lo_d, bias_d = vectors
    gate = torch.sigmoid(m @ w_scale)  # (B, C_inter)
    return x, gate * w_hi_d[None, :], w_lo_d, bias_d


def _head_score_s8(head: LRASPPHead, low: torch.Tensor, high: torch.Tensor,
                   vectors: Optional[Tuple[torch.Tensor, ...]] = None) -> torch.Tensor:
    """Card-minus-background score at stride 8, equal in exact arithmetic
    to ``logits[..., 1] - logits[..., 0]`` of the head before the final
    upsample:

      score_s8 = up2x(high_cls_diff(cbr(high) * gate(high))) + low_cls_diff(low)

    with the per-(batch, channel) gate folded into the classifier."""
    x, gw, w_lo_d, bias_d = _head_gated(head, high, vectors)
    hs = torch.einsum("bhwc,bc->bhw", x.float(), gw)
    ls = torch.einsum("bhwc,c->bhw", low.float(), w_lo_d)
    uh = interp_matrix(hs.shape[1], ls.shape[1], hs.device)
    uw = interp_matrix(hs.shape[2], ls.shape[2], hs.device)
    hs = torch.einsum("Hh,bhw,Ww->bHW", uh, hs, uw)
    return hs + ls + bias_d


def _head_decode_mask(head: LRASPPHead, low: torch.Tensor, high: torch.Tensor,
                      out_h: int, out_w: int,
                      vectors: Optional[Tuple[torch.Tensor, ...]] = None) -> torch.Tensor:
    """cbr and gate in stock ops, then the head's tail and the mask decode
    as one kernel (``fused_head_decode``): the same function as
    ``_head_score_s8`` -> ``fused_mask_decode``, with one pass over the two
    feature maps."""
    with _HEAD:
        x, gw, w_lo_d, bias_d = _head_gated(head, high, vectors)
    return fused_head_decode(x.contiguous(), gw, low.contiguous(), w_lo_d, bias_d,
                             out_h, out_w)


def _to_images(images_u8, device: torch.device) -> torch.Tensor:
    t = images_u8 if isinstance(images_u8, torch.Tensor) else torch.from_numpy(np.asarray(images_u8))
    if t.dtype != torch.uint8 or t.dim() != 4 or t.shape[-1] != 3:
        raise ValueError(f"want (B, H, W, 3) uint8, got {tuple(t.shape)} {t.dtype}")
    return t.to(device, non_blocking=True)


def split_predict(mesh, replicas: Sequence, call, images_u8):
    """Batch-split serving (the JAX package's ``maybe_shard_predict``):
    ``call(replica, slice)`` for each of the mesh's local devices on its
    slice of the batch, in order, the results (a tensor or a tuple of them)
    concatenated on the first device. Nothing is exchanged between the
    devices: each image is computed whole on one. The batch must be a
    multiple of the number of devices (``ValueError`` otherwise)."""
    images = images_u8 if isinstance(images_u8, torch.Tensor) else torch.from_numpy(
        np.asarray(images_u8))
    outs = [call(r, part) for r, part in zip(replicas, shard_batch(mesh, images))]
    dev = mesh.devices[0]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat([o[i].to(dev) for o in outs]) for i in range(len(outs[0])))
    return torch.cat([o.to(dev) for o in outs])


class SegPredictor:
    """predict(uint8 images) -> uint8 masks, on the card.

    ``params``/``batch_stats`` are the JAX package's Flax trees as numpy
    arrays (or the same layout from ``utils.params.init_flax_like``).
    ``device=None`` means the CUDA card and raises if there is none; the
    CPU is used only with ``device="cpu"``, where the kernels' plain
    versions run. Gate a deployment on :meth:`mask_agreement` >= 0.999.

    ``quantize="int8"``: per-output-channel symmetric weight quantization
    (``export/quantize.py``) of every conv kernel of 512 elements or more;
    the int8 kernels and their float32 scales stay on the device
    (``_qparams``) and the model computes with their product in ``dtype``.

    ``fused_head`` and ``fused_stem`` (both off by default) switch the
    kernel path's head tail + decode and its stem to their hand-written
    kernels; ``fused_stem`` needs ``height`` and ``width`` to be multiples
    of 8. Both need ``use_kernels=True``.

    ``fused_blocks`` (block ids 0-14) and ``fused_chain``: with the default
    blocks 12-14 and ``fused_chain=True`` those blocks run as the tail
    chain; otherwise each listed block runs the per-block kernel and every
    other block its module (``fused_chain=False`` is the reference's
    ``MTG_FUSED_CHAIN=0``). A listed block that the kernel cannot take (no
    expand conv and a width that is not a multiple of 8) runs as its
    module, decided here from the weights. ``kernel_blocks`` holds the
    blocks that run a kernel. Widths come from the weights, so slim trees
    and int8 weights take the same path. Other values than the defaults
    need ``use_kernels=True``.

    ``mesh`` (``parallel/mesh.py``): batch-split serving over the mesh's
    local devices, one replica of the folded weights per device, each
    running the whole program (kernels included) on its slice
    (:func:`split_predict`); the predictor's ``device`` is the mesh's first.
    With one device it is the plain path.
    """

    def __init__(self, params, batch_stats, height: int, width: int,
                 use_kernels: bool = True, dtype: torch.dtype = torch.bfloat16,
                 device=None, fused_head: bool = False,
                 fused_stem: bool = False, quantize: Optional[str] = None,
                 mesh=None, fused_blocks: Sequence[int] = FUSED_BLOCKS,
                 fused_chain: bool = True) -> None:
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode {quantize!r}")
        fused_blocks = tuple(int(i) for i in fused_blocks)
        if any(not 0 <= i < len(MOBILENET_V3_LARGE_ROWS) for i in fused_blocks):
            raise ValueError(f"fused_blocks are block ids 0-{len(MOBILENET_V3_LARGE_ROWS) - 1}, "
                             f"got {fused_blocks}")
        if (fused_head or fused_stem or fused_blocks != FUSED_BLOCKS
                or not fused_chain) and not use_kernels:
            raise ValueError("fused_head, fused_stem, fused_blocks and fused_chain are "
                             "options of use_kernels=True")
        if fused_stem and (height % 8 or width % 8):
            raise ValueError(
                f"fused_stem needs height and width to be multiples of 8, got {height}x{width}")
        self.mesh = mesh
        self.device = resolve_device(mesh.devices[0] if mesh is not None else device)
        self._replicas = [self] + [
            SegPredictor(params, batch_stats, height, width, use_kernels, dtype, d, fused_head,
                         fused_stem, quantize, fused_blocks=fused_blocks,
                         fused_chain=fused_chain)
            for d in (mesh.devices[1:] if mesh is not None else ())]
        self.height, self.width = height, width
        self.dtype = dtype
        self.use_kernels = use_kernels
        self.fused_head, self.fused_stem = fused_head, fused_stem
        self.fused_blocks, self.fused_chain = fused_blocks, fused_chain
        self.quantize = quantize
        folded = fold_batch_norm(params, batch_stats)
        if use_kernels:
            folded = _fold_normalize_into_stem(folded)
        if quantize == "int8":
            # what persists on the card: int8 kernels + float32 scales (and
            # the small leaves that stay dense); the weights the convs and
            # the block kernels use are float32(int8) * scale in ``dtype``
            qtree = quantize_params(tree_map(lambda a: np.asarray(a, np.float32), folded))
            self._qparams = tree_map(lambda a: torch.from_numpy(a).to(self.device), qtree)
            folded = dequantize_params(self._qparams, dtype, xp=torch_xp)
        self.model = from_flax(folded, None, dtype=dtype).to(self.device, dtype)
        self.model = self.model.to(memory_format=torch.channels_last)
        self._tail, self._blocks, self.kernel_blocks = None, None, ()
        if use_kernels:
            backbone = self.model.backbone
            with torch.no_grad():
                if fused_blocks == FUSED_BLOCKS and fused_chain:
                    self._tail = tail_weights(backbone)
                    self.kernel_blocks = FUSED_BLOCKS
                else:
                    self.kernel_blocks = kernel_block_ids(backbone, fused_blocks)
                    self._blocks = {i: BlockWeights.from_module(backbone.block(i))
                                    for i in self.kernel_blocks}
                self._head_vectors = _head_gate_vectors(self.model.head)
        self._center = torch.tensor(255.0 * _IMAGENET_MEAN, dtype=torch.float32,
                                    device=self.device)
        if fused_stem:
            conv = self.model.backbone.stem.conv
            with torch.no_grad():  # OIHW -> HWIO, made into the kernel's operands once
                self._stem = prepare_stem(conv.weight.float().permute(2, 3, 1, 0),
                                          conv.bias.float(), self._center)

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str, name: str, height: int, width: int,
                        **kw) -> "SegPredictor":
        """A predictor from the checkpoint ``<checkpoint_dir>/<name>``
        (``training.checkpoint.load_params``: parameters and statistics
        only, no train state)."""
        params, batch_stats, _ = load_params(checkpoint_dir, name)
        return cls(params, batch_stats, height, width, **kw)

    def predict(self, images_u8) -> torch.Tensor:
        """(B, H, W, 3) uint8 (at model resolution) -> (B, H, W) uint8
        {0,1} masks, on the predictor's device (split over the mesh's
        devices when it has several)."""
        if len(self._replicas) > 1:
            return split_predict(self.mesh, self._replicas, SegPredictor._predict, images_u8)
        return self._predict(images_u8)

    @torch.inference_mode()
    def _predict(self, images_u8) -> torch.Tensor:
        with _PREDICT:
            with _UPLOAD:
                images = _to_images(images_u8, self.device)
            if self.use_kernels:
                # normalization is folded into the stem weights; the
                # centering constant makes zero padding == ImageNet zero
                with _STEM:
                    if self.fused_stem:
                        x = apply_stem(images.contiguous(), self._stem, out_dtype=self.dtype)
                    else:
                        x = (images.float() - self._center).to(self.dtype)
                taps = _fused_backbone(self.model.backbone, x, self._tail,
                                       stem_done=self.fused_stem, blocks=self._blocks)
                if self.fused_head:
                    return _head_decode_mask(self.model.head, taps["low"], taps["high"],
                                             self.height, self.width, self._head_vectors)
                with _HEAD:
                    score = _head_score_s8(self.model.head, taps["low"], taps["high"],
                                           self._head_vectors)
                return fused_mask_decode(score, self.height, self.width)
            with _MODEL:
                x = (images.float() / 255.0).to(self.dtype)
                mean = torch.tensor(IMAGENET_MEAN, dtype=self.dtype, device=self.device)
                std = torch.tensor(IMAGENET_STD, dtype=self.dtype, device=self.device)
                logits = self.model.logits_s8((x - mean) / std)
                full = bilinear_resize(logits.float(), self.height, self.width)
                return torch.argmax(full, dim=-1).to(torch.uint8)

    def mask_agreement(self, other: "SegPredictor", images_u8) -> float:
        """Fraction of pixels whose class decision matches ``other``."""
        a = self.predict(images_u8).cpu()
        b = other.predict(images_u8).cpu()
        return float((a == b).float().mean())
