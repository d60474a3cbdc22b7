"""The device layout of data-parallel training and batch-split serving
(counterpart of the JAX package's ``parallel/mesh.py``).

The JAX package lays a ``(hosts, data, space, model)`` mesh over its
devices and lets GSPMD shard global arrays. The port follows PyTorch's
idiom instead:

- axis ``data`` (and ``hosts``): data parallelism, one process per GPU
  (torchrun), joined by a ``torch.distributed`` process group
  (``parallel/distributed.py``). Each rank holds its own slice of the
  global batch; ``DistributedDataParallel`` all-reduces the gradients, and
  the BatchNorm statistics, the segmentation loss and the metrics are taken
  over the global batch by all-reduced sums (``models/layers.py``,
  ``losses.py``, ``metrics.py``).
- a process's local devices: a serving batch is split over them, one
  replica of the weights per device (``SegPredictor(mesh=)``,
  ``PosePredictor(mesh=)``; the JAX package's ``maybe_shard_predict``).
- axes ``space`` (the image H split across devices, with halo exchanges)
  and ``model`` (channel sharding; the JAX package only ever replicates on
  it) have no stock counterpart here and stay queued (ROADMAP Queue A):
  asking for either raises ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import torch

from mtg_card_image_segmentation_tpu_torch.parallel import distributed

AXIS_HOSTS = "hosts"
AXIS_DATA = "data"
AXIS_SPACE = "space"
AXIS_MODEL = "model"


@dataclass(frozen=True)
class Mesh:
    """``devices``: this process's devices, over which a serving batch is
    split; ``ranks``: the data-parallel processes of the process group (1
    without one); ``shape``: the axis sizes, as the JAX mesh's."""

    devices: Tuple[torch.device, ...]
    ranks: int
    shape: dict

    @property
    def size(self) -> int:
        """Data shards in all: ranks x local devices."""
        return self.ranks * len(self.devices)


def _local_devices() -> List[torch.device]:
    """Without a process group: every CUDA card of the host. Under one:
    this rank's card (one process per GPU). No card raises: the CPU is used
    only when the caller lists it."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass devices=['cpu', ...] to lay the "
                           "mesh over the host")
    if distributed.is_active():
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(data: int = -1, space: int = 1, model: int = 1, hosts: int = 1,
              devices: Optional[Sequence[Union[str, torch.device]]] = None) -> Mesh:
    """The layout over this process's ``devices`` (default: see
    :func:`_local_devices`) and the process group's ranks. ``data=-1``
    takes every remaining shard; ``hosts * data`` must equal ranks x local
    devices, as the JAX mesh's axes must cover its devices."""
    if space != 1 or model != 1:
        raise NotImplementedError(
            f"mesh space={space}, model={model}: the port splits only the batch; the "
            "spatial and model axes are queued (ROADMAP Queue A)")
    devs = tuple(torch.device(d) for d in (_local_devices() if devices is None else devices))
    ranks = distributed.process_count()
    n = ranks * len(devs)
    if data == -1:
        if n % hosts:
            raise ValueError(f"{n} shards not divisible by hosts={hosts}")
        data = n // hosts
    if hosts * data != n:
        raise ValueError(f"mesh {hosts}x{data}x{space}x{model} != {ranks} ranks x "
                         f"{len(devs)} local devices")
    return Mesh(devs, ranks, {AXIS_HOSTS: hosts, AXIS_DATA: data, AXIS_SPACE: space,
                              AXIS_MODEL: model})


def batch_spec() -> int:
    """The dimension of an NHWC image batch that is split: the batch."""
    return 0


def mask_spec() -> int:
    """The dimension of a (B, H, W) mask batch that is split."""
    return 0


def replicated_spec() -> None:
    """Nothing is split: the weights, replicated on every device."""
    return None


def is_trivial(mesh: Optional[Mesh]) -> bool:
    """True when there is nothing to split: no mesh, or one shard."""
    return mesh is None or mesh.size == 1


def shard_batch(mesh: Mesh, images: torch.Tensor,
                masks: Optional[torch.Tensor] = None):
    """Split a batch over the mesh's local devices in order: a list of
    per-device slices (or of (images, masks) pairs). The batch must be a
    multiple of the number of devices."""
    n = len(mesh.devices)
    if images.shape[batch_spec()] % n:
        raise ValueError(f"batch {images.shape[0]} is not divisible by the mesh's "
                         f"{n} devices")
    parts = [x.to(d, non_blocking=True) for x, d in zip(images.chunk(n), mesh.devices)]
    if masks is None:
        return parts
    return list(zip(parts, [m.to(d, non_blocking=True)
                            for m, d in zip(masks.chunk(n), mesh.devices)]))
