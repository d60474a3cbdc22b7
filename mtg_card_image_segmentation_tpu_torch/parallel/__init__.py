from mtg_card_image_segmentation_tpu_torch.parallel import distributed
from mtg_card_image_segmentation_tpu_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_HOSTS,
    AXIS_MODEL,
    AXIS_SPACE,
    Mesh,
    batch_spec,
    is_trivial,
    make_mesh,
    mask_spec,
    replicated_spec,
    shard_batch,
)

__all__ = [
    "AXIS_DATA",
    "AXIS_HOSTS",
    "AXIS_MODEL",
    "AXIS_SPACE",
    "Mesh",
    "batch_spec",
    "distributed",
    "is_trivial",
    "make_mesh",
    "mask_spec",
    "replicated_spec",
    "shard_batch",
]
