"""The device layout of data-parallel, spatially sharded and replicated
training and of batch-split serving (counterpart of the JAX package's
``parallel/mesh.py``).

The JAX package lays a ``(hosts, data, space, model)`` mesh over its
devices and lets GSPMD shard global arrays. The port follows PyTorch's
idiom instead, one process per GPU (torchrun) joined by a
``torch.distributed`` process group (``parallel/distributed.py``), the
ranks laid over the same grid in the JAX reshape order (``model``
fastest):

- axis ``data`` (and ``hosts``): data parallelism. Each rank holds its own
  slice of the global batch; ``DistributedDataParallel`` all-reduces the
  gradients, and the BatchNorm statistics, the segmentation loss and the
  metrics are taken over the global batch by all-reduced sums
  (``models/layers.py``, ``losses.py``, ``metrics.py``).
- axis ``space``: the rows (H) of every map split over the ranks that share
  a data index, with halo exchanges at the convolutions
  (``parallel/space.py``): the JAX batch spec splits H over ``space``.
- axis ``model``: replication, as in the JAX package, whose specs never
  name it: ranks that differ only in their model index compute the same
  thing (``parallel/space.py``).
- a process's local devices: a serving batch is split over them, one
  replica of the weights per device (``SegPredictor(mesh=)``,
  ``PosePredictor(mesh=)``; the JAX package's ``maybe_shard_predict``).
  Serving splits the batch only, as the JAX predictors do.

A mesh whose ``space`` or ``model`` axis spans ranks carries this rank's
:class:`~parallel.space.Layout` (its coordinates and process groups); the
steps run under it (``parallel/space.py::use``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import torch

from mtg_card_image_segmentation_tpu_torch.parallel import distributed, space as space_lib

AXIS_HOSTS = "hosts"
AXIS_DATA = "data"
AXIS_SPACE = "space"
AXIS_MODEL = "model"


@dataclass(frozen=True)
class Mesh:
    """``devices``: this process's devices, over which a serving batch is
    split; ``ranks``: the processes of the process group (1 without one);
    ``shape``: the axis sizes, as the JAX mesh's; ``layout``: this rank's
    place in the grid when ``space`` or ``model`` spans ranks (else
    None)."""

    devices: Tuple[torch.device, ...]
    ranks: int
    shape: dict
    layout: Optional[space_lib.Layout] = None

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
    """The ``(hosts, data, space, model)`` layout over the shards, the
    process group's ranks x this process's ``devices`` (default: see
    :func:`_local_devices`). ``data=-1`` takes every remaining shard; the
    axes must cover the shards, as the JAX mesh's axes must cover its
    devices. With one device per rank and ``space`` or ``model`` above 1,
    every rank must call it: it makes the process groups of the axes."""
    devs = tuple(torch.device(d) for d in (_local_devices() if devices is None else devices))
    ranks = distributed.process_count()
    n = ranks * len(devs)
    if data == -1:
        if n % (hosts * space * model):
            raise ValueError(f"{n} shards not divisible by hosts*space*model="
                             f"{hosts * space * model}")
        data = n // (hosts * space * model)
    if hosts * data * space * model != n:
        raise ValueError(f"mesh {hosts}x{data}x{space}x{model} != {ranks} ranks x "
                         f"{len(devs)} local devices")
    layout = None
    if (space > 1 or model > 1) and ranks > 1 and len(devs) == 1:
        layout = space_lib.make_layout((hosts, data, space, model))
    return Mesh(devs, ranks, {AXIS_HOSTS: hosts, AXIS_DATA: data, AXIS_SPACE: space,
                              AXIS_MODEL: model}, layout)


def batch_spec() -> Tuple[int, int]:
    """The dimensions of an NHWC image batch that are split: the batch
    (over ``hosts`` x ``data``) and H (over ``space``)."""
    return 0, 1


def mask_spec() -> Tuple[int, int]:
    """The dimensions of a (B, H, W) mask batch that are split, as
    :func:`batch_spec`'s."""
    return 0, 1


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
    multiple of the number of devices. Under a spatial layout (one device
    per rank) the one slice is this rank's rows of the batch (masks and
    heatmap targets by their own rows, ``parallel/space.py::bounds``)."""
    n = len(mesh.devices)
    if images.shape[batch_spec()[0]] % n:
        raise ValueError(f"batch {images.shape[0]} is not divisible by the mesh's "
                         f"{n} devices")
    lay = mesh.layout
    parts = [space_lib.rows_of(lay, x).to(d, non_blocking=True)
             for x, d in zip(images.chunk(n), mesh.devices)]
    if masks is None:
        return parts
    return list(zip(parts, [space_lib.rows_of(lay, m).to(d, non_blocking=True)
                            for m, d in zip(masks.chunk(n), mesh.devices)]))
