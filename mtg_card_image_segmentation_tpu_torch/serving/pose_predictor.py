"""Batched corner-pose predictors on the card (counterpart of the JAX
package's ``serving/pose_predictor.py``): ``PosePredictor`` (HRNet heatmaps)
and ``YoloCornerPredictor`` (YOLO12n-pose), with one interface, so that the
server's ``/api/corners`` serves either family.

``PosePredictor.predict`` takes uint8 (B, H, W, 3) camera frames and returns
pixel corner coordinates and confidences: uint8 -> normalize kernel
(``fused_normalize``, straight to the compute dtype) -> HRNet with its
BatchNorm statistics (not folded) -> heatmap decode with quadratic
sub-pixel refinement -> input-pixel scaling, with no host round trip
between the stages. ``refine=False`` is the integer arg-max decode. Its
spans (``utils/profiling.py``): ``pose.heatmaps`` and ``pose.decode`` around
the two stages, ``pose.upload`` (entry); ``pose.normalize`` (the stock
normalize), ``pose.backbone``, ``pose.head`` and ``pose.peaks`` (the decode
and the pixel scaling) (stock).

``YoloCornerPredictor.predict``: uint8 -> ``/255`` (no ImageNet statistics)
-> YOLO12n-pose -> anchor decode and joint corner assignment in float32
(``models/yolo12_pose.py::top1_detection``) -> per-corner pixel xy and
confidence. It runs no hand-written kernel: the JAX package's YOLO path has
no TPU kernel either.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from mtg_card_image_segmentation_tpu_torch.data.preprocess import normalize_only
from mtg_card_image_segmentation_tpu_torch.ops import heatmap as hm_lib
from mtg_card_image_segmentation_tpu_torch.ops.kernels.preprocess import fused_normalize
from mtg_card_image_segmentation_tpu_torch.serving.predictor import _to_images, split_predict
from mtg_card_image_segmentation_tpu_torch.training.checkpoint import load_params
from mtg_card_image_segmentation_tpu_torch.models.yolo12_pose import (
    decode_predictions,
    top1_detection,
)
from mtg_card_image_segmentation_tpu_torch.utils.params import (
    hrnet_from_flax,
    yolo_from_flax,
)
from mtg_card_image_segmentation_tpu_torch.utils.platform import resolve_device
from mtg_card_image_segmentation_tpu_torch.utils.profiling import Span

_HEATMAPS = Span("pose.heatmaps", "entry")
_UPLOAD = Span("pose.upload", "entry")
_NORMALIZE = Span("pose.normalize", "stock")
_BACKBONE = Span("pose.backbone", "stock")
_HEAD = Span("pose.head", "stock")
_DECODE = Span("pose.decode", "entry")
_PEAKS = Span("pose.peaks", "stock")


class PosePredictor:
    """predict(uint8 images) -> (corners_px (B, 4, 2), conf (B, 4)).

    ``params``/``batch_stats`` are the JAX package's Flax trees of
    ``HRNetPose`` as numpy arrays (or the same layout from
    ``utils.params.init_hrnet_flax_like``). ``device=None`` means the CUDA
    card and raises if there is none; the CPU is used only with
    ``device="cpu"``, where the normalize kernel's plain version runs.
    ``use_kernels=False`` normalizes with stock ops, ``(x/255 - mean)/std``.
    ``mesh``: batch-split serving over the mesh's local devices, one
    replica per device (``serving/predictor.py::split_predict``), as
    ``SegPredictor``'s.
    """

    def __init__(self, params, batch_stats, height: int, width: int,
                 heatmap_hw: Tuple[int, int] = (120, 160),
                 dtype: torch.dtype = torch.bfloat16, refine: bool = True,
                 threshold: float = 0.3, use_kernels: bool = True,
                 device=None, mesh=None) -> None:
        self.mesh = mesh
        self.device = resolve_device(mesh.devices[0] if mesh is not None else device)
        self._replicas = [self] + [
            PosePredictor(params, batch_stats, height, width, heatmap_hw, dtype, refine,
                          threshold, use_kernels, d)
            for d in (mesh.devices[1:] if mesh is not None else ())]
        self.height, self.width = height, width
        self.dtype = dtype
        self.refine = refine
        self.threshold = threshold
        self.use_kernels = use_kernels
        self.model = hrnet_from_flax(params, batch_stats, heatmap_hw, dtype=dtype)
        self.model = self.model.to(self.device).to(memory_format=torch.channels_last)

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str, name: str, height: int, width: int,
                        **kw) -> "PosePredictor":
        """A predictor from the checkpoint ``<checkpoint_dir>/<name>``
        (parameters and statistics only, no train state)."""
        params, batch_stats, _ = load_params(checkpoint_dir, name)
        return cls(params, batch_stats, height, width, **kw)

    @torch.inference_mode()
    def heatmaps(self, images_u8) -> torch.Tensor:
        """(B, H, W, 3) uint8 -> (B, hm_h, hm_w, K) float32 heatmaps."""
        with _HEATMAPS:
            with _UPLOAD:
                images = _to_images(images_u8, self.device)
            if self.use_kernels:
                x = fused_normalize(images.contiguous(), out_dtype=self.dtype)
            else:
                with _NORMALIZE:
                    x = normalize_only(images.float() / 255.0).to(self.dtype)
            # the model's forward, head(backbone(x)[feature_index]), in two spans
            with _BACKBONE:
                feats = self.model.backbone(x)[self.model.feature_index]
            with _HEAD:
                return self.model.head(feats)

    @torch.inference_mode()
    def decode(self, heatmaps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Heatmaps -> ((B, K, 2) float32 xy in input pixels, (B, K) float32
        confidences): the gated sub-pixel decode, or with ``refine=False``
        the integer arg-max."""
        with _DECODE:
            with _PEAKS:
                if self.refine:
                    coords01, conf = hm_lib.decode_argmax_subpixel_gated(heatmaps)
                else:
                    coords01, conf = hm_lib.decode_argmax(heatmaps)
                px = hm_lib.coords01_to_pixels(coords01, (self.height, self.width))
            return px, conf.float()

    def predict(self, images_u8) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, H, W, 3) uint8 -> ((B, 4, 2) float32 xy input pixels, (B, 4)
        float32 peak confidences), on the predictor's device (split over
        the mesh's devices when it has several)."""
        if len(self._replicas) > 1:
            return split_predict(self.mesh, self._replicas,
                                 lambda r, x: r.decode(r.heatmaps(x)), images_u8)
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


class YoloCornerPredictor:
    """predict(uint8 images) -> (corners_px (B, 4, 2), conf (B, 4)) with the
    YOLO12n-pose model; the interface of :class:`PosePredictor`.

    ``params``/``batch_stats`` are the JAX package's Flax trees of
    ``YOLO12Pose`` as numpy arrays (or the same layout from
    ``utils.params.init_yolo_flax_like``). Inputs are square, ``imgsz`` on a
    side. ``device=None`` means the CUDA card and raises if there is none.
    """

    def __init__(self, params, batch_stats, imgsz: int = 640,
                 dtype: torch.dtype = torch.bfloat16, threshold: float = 0.25,
                 device=None) -> None:
        self.device = resolve_device(device)
        self.height = self.width = imgsz
        self.dtype = dtype
        self.threshold = threshold
        self.model = yolo_from_flax(params, batch_stats, dtype=dtype)
        self.model = self.model.to(self.device).to(memory_format=torch.channels_last)

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str, name: str, imgsz: int = 640,
                        **kw) -> "YoloCornerPredictor":
        params, batch_stats, _ = load_params(checkpoint_dir, name)
        return cls(params, batch_stats, imgsz, **kw)

    @torch.inference_mode()
    def levels(self, images_u8):
        """(B, S, S, 3) uint8 -> the three levels' raw head outputs,
        float32."""
        images = _to_images(images_u8, self.device)
        x = images.to(self.dtype) * (1.0 / 255.0)
        return self.model.levels(x)

    @torch.inference_mode()
    def decode(self, level_outputs) -> Tuple[torch.Tensor, torch.Tensor]:
        """Level outputs -> ((B, K, 2) float32 xy in input pixels, (B, K)
        float32 confidences), all in float32."""
        m = self.model
        boxes, scores, kpts = decode_predictions(level_outputs, m.num_classes,
                                                 m.num_keypoints, m.kpt_dim)
        _, _, kp = top1_detection(boxes, scores, kpts)
        return kp[..., :2].float(), kp[..., 2].float()

    def predict(self, images_u8) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, S, S, 3) uint8 -> ((B, 4, 2) float32 xy input pixels, (B, 4)
        float32 per-corner confidences), on the predictor's device."""
        return self.decode(self.levels(images_u8))

    def predict_valid(self, images_u8):
        px, conf = self.predict(images_u8)
        return px, conf, conf >= self.threshold

    def scale_to_original(self, px, original_hw):
        """Map (..., 2) xy coords from model-input pixels to an
        ``original_hw`` frame the input was stretch-resized from. YOLO
        coords live in the training frame's index space and the resize is
        half-pixel, so the inverse map is ``(x + 0.5) * scale - 0.5``."""
        oh, ow = original_hw
        s = np.asarray([ow / self.width, oh / self.height], dtype=np.float32)
        if isinstance(px, torch.Tensor):
            return (px + 0.5) * torch.from_numpy(s).to(px.device) - 0.5
        return (px + 0.5) * s - 0.5
