"""Dataset-level evaluation (counterpart of the JAX package's
``evaluation/``): the segmentation evaluator and the two corner
evaluators."""

from mtg_card_image_segmentation_tpu_torch.evaluation.pose import CornerEvaluator, PoseEvaluator
from mtg_card_image_segmentation_tpu_torch.evaluation.segmentation import SegEvaluator

__all__ = ["CornerEvaluator", "PoseEvaluator", "SegEvaluator"]
