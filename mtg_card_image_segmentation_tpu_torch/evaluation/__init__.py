"""Dataset-level evaluation (the segmentation half of the JAX package's
``evaluation/``; the pose evaluators are not ported yet)."""

from mtg_card_image_segmentation_tpu_torch.evaluation.segmentation import SegEvaluator

__all__ = ["SegEvaluator"]
