"""Batched HRNet corner-pose predictor on the card (counterpart of the JAX
package's ``serving/pose_predictor.py::PosePredictor``).

``PosePredictor.predict`` takes uint8 (B, H, W, 3) camera frames and returns
pixel corner coordinates and confidences: uint8 -> normalize kernel
(``fused_normalize``, straight to the compute dtype) -> HRNet with its
BatchNorm statistics (not folded) -> heatmap decode with quadratic
sub-pixel refinement -> input-pixel scaling, with no host round trip
between the stages. ``refine=False`` is the integer arg-max decode.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from mtg_card_image_segmentation_tpu_torch.data.preprocess import normalize_only
from mtg_card_image_segmentation_tpu_torch.ops import heatmap as hm_lib
from mtg_card_image_segmentation_tpu_torch.ops.kernels.preprocess import fused_normalize
from mtg_card_image_segmentation_tpu_torch.serving.predictor import _to_images
from mtg_card_image_segmentation_tpu_torch.utils.params import hrnet_from_flax
from mtg_card_image_segmentation_tpu_torch.utils.platform import resolve_device


class PosePredictor:
    """predict(uint8 images) -> (corners_px (B, 4, 2), conf (B, 4)).

    ``params``/``batch_stats`` are the JAX package's Flax trees of
    ``HRNetPose`` as numpy arrays (or the same layout from
    ``utils.params.init_hrnet_flax_like``). ``device=None`` means the CUDA
    card and raises if there is none; the CPU is used only with
    ``device="cpu"``, where the normalize kernel's plain version runs.
    ``use_kernels=False`` normalizes with stock ops, ``(x/255 - mean)/std``.
    """

    def __init__(self, params, batch_stats, height: int, width: int,
                 heatmap_hw: Tuple[int, int] = (120, 160),
                 dtype: torch.dtype = torch.bfloat16, refine: bool = True,
                 threshold: float = 0.3, use_kernels: bool = True,
                 device=None) -> None:
        self.device = resolve_device(device)
        self.height, self.width = height, width
        self.dtype = dtype
        self.refine = refine
        self.threshold = threshold
        self.use_kernels = use_kernels
        self.model = hrnet_from_flax(params, batch_stats, heatmap_hw, dtype=dtype)
        self.model = self.model.to(self.device).to(memory_format=torch.channels_last)

    @torch.inference_mode()
    def heatmaps(self, images_u8) -> torch.Tensor:
        """(B, H, W, 3) uint8 -> (B, hm_h, hm_w, K) float32 heatmaps."""
        images = _to_images(images_u8, self.device)
        if self.use_kernels:
            x = fused_normalize(images.contiguous(), out_dtype=self.dtype)
        else:
            x = normalize_only(images.float() / 255.0).to(self.dtype)
        return self.model(x)

    @torch.inference_mode()
    def decode(self, heatmaps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Heatmaps -> ((B, K, 2) float32 xy in input pixels, (B, K) float32
        confidences): the gated sub-pixel decode, or with ``refine=False``
        the integer arg-max."""
        if self.refine:
            coords01, conf = hm_lib.decode_argmax_subpixel_gated(heatmaps)
        else:
            coords01, conf = hm_lib.decode_argmax(heatmaps)
        return hm_lib.coords01_to_pixels(coords01, (self.height, self.width)), conf.float()

    def predict(self, images_u8) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, H, W, 3) uint8 -> ((B, 4, 2) float32 xy input pixels, (B, 4)
        float32 peak confidences), on the predictor's device."""
        return self.decode(self.heatmaps(images_u8))

    def predict_valid(self, images_u8):
        """Like :meth:`predict`, plus the validity mask conf >= threshold."""
        px, conf = self.predict(images_u8)
        return px, conf, conf >= self.threshold

    def scale_to_original(self, px, original_hw):
        """Map (..., 2) xy coords from model-input pixels to an
        ``original_hw`` frame the input was stretch-resized from, by the
        (size-1) ratio the whole chain uses."""
        oh, ow = original_hw
        scale = np.asarray([(ow - 1) / (self.width - 1), (oh - 1) / (self.height - 1)],
                           dtype=np.float32)
        if isinstance(px, torch.Tensor):
            return px * torch.from_numpy(scale).to(px.device)
        return px * scale
