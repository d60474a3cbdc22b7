"""Unified typed configuration tree (a copy of the JAX package's
``config.py``, which imports no framework; the port keeps its own copy so
that it imports nothing of the JAX package, and
``tests/test_torch_train_parts.py`` holds the two equal).

The reference spreads configuration over four uncoordinated mechanisms (static
class ``train/config.py``, JSON-over-defaults ``train-pose-estimation_custom/
train.py:357-414``, an attribute class ``train-pose-estimation_yolo12n/
train.py:33-89`` and YOLO ``data.yaml``). Here every pipeline shares one typed,
immutable dataclass tree with JSON / CLI override support.

Defaults mirror the reference's shipped operating points:
segmentation input 320x240 (``train/config.py:21-22``), batch 32, AdamW 1e-3 /
wd 1e-4, cosine schedule, dice/ce 0.5/0.5, patience 15, pruning 30%
(``train/config.py:26-71``); pose input 480x640 with 160x120 heatmaps
(``train-pose-estimation_custom/config.json``).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Tuple


def _replace_nested(cfg: Any, overrides: dict) -> Any:
    """Recursively apply a nested dict of overrides onto a dataclass tree."""
    updates = {}
    for key, value in overrides.items():
        if not hasattr(cfg, key):
            raise KeyError(
                f"Unknown config field {key!r} for {type(cfg).__name__}; "
                f"valid fields: {[f.name for f in dataclasses.fields(cfg)]}"
            )
        current = getattr(cfg, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            updates[key] = _replace_nested(current, value)
        else:
            if isinstance(current, tuple) and isinstance(value, (list, tuple)):
                value = tuple(value)
            updates[key] = value
    return dataclasses.replace(cfg, **updates)


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout (``parallel/mesh.py::make_mesh``) over the
    ``torch.distributed`` ranks, one process per GPU: ``data`` =
    batch/data-parallel axis; ``hosts`` = the hosts' share of it; ``space``
    = spatial partitioning of the H activation axis (``parallel/space.py``);
    ``model`` = replication, as the JAX package's specs never name it.

    ``data=-1`` means "all remaining devices".
    """

    data: int = -1
    space: int = 1
    model: int = 1
    # DCN axis for multi-host scale-out: one per host process
    hosts: int = 1


@dataclass(frozen=True)
class OptimizerConfig:
    """Mirrors the optimizer/scheduler factories at
    ``train/train.py:155-207``."""

    name: str = "adamw"  # adamw | sgd
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    momentum: float = 0.9  # sgd only
    schedule: str = "cosine"  # cosine | cosine_restarts | constant
    warmup_epochs: int = 5
    # cosine: eta_min = lr * min_lr_ratio (reference: eta_min = lr*0.01)
    min_lr_ratio: float = 0.01
    # cosine_restarts: first cycle = num_epochs // restart_div, x restart_mult
    restart_div: int = 4
    restart_mult: int = 2
    grad_clip_norm: Optional[float] = None


@dataclass(frozen=True)
class AugmentConfig:
    """On-device augmentation suite; probabilities/ranges mirror the
    albumentations pipeline at ``train/dataset.py:100-187``."""

    enabled: bool = True
    hflip_prob: float = 0.5
    affine_prob: float = 0.8
    translate_percent: float = 0.25
    scale_range: Tuple[float, float] = (0.9, 2.0)
    rotate_limit_deg: float = 15.0
    elastic_prob: float = 0.3
    elastic_alpha: float = 50.0
    elastic_sigma: float = 5.0
    grid_distort_prob: float = 0.3
    grid_num_steps: int = 5
    grid_distort_limit: float = 0.1
    color_jitter_prob: float = 0.8
    brightness: float = 0.2
    contrast: float = 0.2
    saturation: float = 0.2
    hue: float = 0.1
    brightness_contrast_prob: float = 0.6
    noise_blur_prob: float = 0.5
    noise_std_range: Tuple[float, float] = (0.1, 0.2)
    blur_sigma_range: Tuple[float, float] = (0.5, 2.0)


@dataclass(frozen=True)
class DataConfig:
    dataset_root: str = "dataset"
    train_split: str = "train"
    test_split: str = "test"
    batch_size: int = 32
    shuffle_buffer: int = 2048
    # "synthetic" renders procedural cards on the fly (no disk dataset needed);
    # "files" reads dataset/{split}/{images,masks} pairs like the reference.
    source: str = "files"
    num_host_workers: int = 4
    prefetch: int = 2
    augment: AugmentConfig = field(default_factory=AugmentConfig)
    # real-asset compositing (synthetic source): directories of downloaded
    # card scans / background photos; empty = fully procedural
    texture_dir: str = ""
    background_dir: str = ""
    hdri_dir: str = ""  # Polyhaven HDRI maps (lighting + env backgrounds)
    real_asset_prob: float = 0.7


@dataclass(frozen=True)
class ModelConfig:
    name: str = "lraspp_mobilenet_v3_large"
    num_classes: int = 2
    input_height: int = 320
    input_width: int = 240
    # LR-ASPP head width (reference inter_channels=128, train/model.py:47)
    inter_channels: int = 128
    # compute dtype: bf16 on TPU replaces the reference's fp16 AMP
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"


@dataclass(frozen=True)
class PoseModelConfig:
    name: str = "hrnet_pose"
    num_keypoints: int = 4
    input_height: int = 480
    input_width: int = 640
    heatmap_height: int = 120
    heatmap_width: int = 160
    gaussian_sigma: float = 2.0
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"


@dataclass(frozen=True)
class TrainConfig:
    num_epochs: int = 100
    steps_per_epoch: Optional[int] = None  # None = derive from dataset size
    eval_every_epochs: int = 1
    save_every_epochs: int = 10
    early_stopping_patience: int = 15
    early_stopping_metric: str = "mean_iou"
    early_stopping_mode: str = "max"
    checkpoint_dir: str = "checkpoints"
    log_dir: str = "logs"
    seed: int = 0
    log_every_steps: int = 20
    wandb: bool = False
    dice_weight: float = 0.5
    ce_weight: float = 0.5
    donate_state: bool = True


@dataclass(frozen=True)
class PruneConfig:
    """Mirrors ``train/prune.py`` semantics: 30% global magnitude or
    structured per-conv channel pruning + fine-tune at 0.1x lr."""

    amount: float = 0.3
    structured: bool = False
    fine_tune_epochs: int = 20
    fine_tune_lr_scale: float = 0.1


@dataclass(frozen=True)
class ExportConfig:
    output_dir: str = "exported_models"
    opset: int = 17
    fp16: bool = True
    keep_io_types: bool = True  # fp32 I/O on the fp16 model
    dynamic_batch: bool = False
    parity_atol_fp32: float = 1e-4  # gate from train/export.py:159-162
    parity_rtol_fp16: float = 1e-2
    parity_atol_fp16: float = 1e-3


@dataclass(frozen=True)
class Config:
    mesh: MeshConfig = field(default_factory=MeshConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    pose: PoseModelConfig = field(default_factory=PoseModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    prune: PruneConfig = field(default_factory=PruneConfig)
    export: ExportConfig = field(default_factory=ExportConfig)

    def override(self, overrides: dict) -> "Config":
        return _replace_nested(self, overrides)

    @classmethod
    def from_json(cls, path: str) -> "Config":
        with open(path) as f:
            return cls().override(json.load(f))

    def with_cli(self, kv_pairs: Sequence[str]) -> "Config":
        """Apply ``a.b.c=value`` style overrides (values parsed as JSON when
        possible, else kept as strings)."""
        tree: dict = {}
        for pair in kv_pairs:
            key, _, raw = pair.partition("=")
            try:
                value = json.loads(raw)
            except json.JSONDecodeError:
                value = raw
            node = tree
            parts = key.split(".")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = value
        return self.override(tree)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)


def default_config() -> Config:
    return Config()


def pose_default_config() -> Config:
    """Operating point of the custom pose pipeline
    (``train-pose-estimation_custom/config.json``)."""
    return Config().override(
        {
            "data": {"batch_size": 24},
            "optimizer": {
                "schedule": "constant",
                "learning_rate": 1e-3,
                "weight_decay": 1e-4,
            },
            "train": {
                "num_epochs": 200,
                "early_stopping_patience": 20,
                "early_stopping_metric": "val_loss",
                "early_stopping_mode": "min",
            },
        }
    )
