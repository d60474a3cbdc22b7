from mtg_card_image_segmentation_tpu_torch.data.augment import (
    augment_batch,
    augment_sample,
)
from mtg_card_image_segmentation_tpu_torch.data.preprocess import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    preprocess_batch,
)
from mtg_card_image_segmentation_tpu_torch.data.synthetic import (
    synthetic_batch,
    synthetic_sample,
)

__all__ = [
    "augment_batch",
    "augment_sample",
    "preprocess_batch",
    "synthetic_batch",
    "synthetic_sample",
    "IMAGENET_MEAN",
    "IMAGENET_STD",
]
