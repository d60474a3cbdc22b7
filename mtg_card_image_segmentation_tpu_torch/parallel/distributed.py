"""Multi-GPU and multi-host scale-out over ``torch.distributed`` (counterpart
of the JAX package's ``parallel/distributed.py``).

One process per GPU, as torchrun starts them:

    torchrun --nproc_per_node=N train_seg_torch.py ...
    torchrun --nnodes=2 --node_rank=i --nproc_per_node=N \\
        --master_addr=host0 --master_port=29500 train_seg_torch.py ...

- :func:`initialize` joins the process group from torchrun's environment
  (``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``/``LOCAL_RANK``)
  or its arguments, with ``nccl`` on the card and ``gloo`` on the host, and
  sets the rank's card to ``cuda:LOCAL_RANK``. Without either it returns
  False and the process runs alone, as the JAX function does.
- :func:`process_shard` slices host-side work lists per rank, and
  :func:`local_batch_size` is a rank's share of the global batch.
- :func:`global_batch` / :func:`global_arrays` keep the JAX names: under
  data parallelism each rank keeps its own slice, nothing is assembled.
- :func:`all_reduce_sum` is the sum over ranks that the global-batch
  BatchNorm, the segmentation loss and the metrics take, with a backward
  (``torch.distributed.nn.functional.all_reduce``: its backward sums the
  incoming gradients over ranks). With the gradient average of
  ``DistributedDataParallel`` this gives the global gradient, both for a
  loss made of all-reduced sums and for a local mean over equal local
  batches.

The collectives run whenever a process group is up, also a group of one
rank.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_rank: Optional[int] = None,
               device: str = "cuda") -> bool:
    """Join the process group from the arguments or torchrun's environment.

    ``coordinator_address`` is ``host:port`` (default ``MASTER_ADDR`` and
    ``MASTER_PORT``), ``num_processes`` the world size (``WORLD_SIZE``),
    ``process_id`` the rank (``RANK``), ``local_rank`` the rank's card
    (``LOCAL_RANK``, default the rank). ``device`` ``"cuda"`` joins with
    ``nccl`` and sets the rank's card; ``"cpu"`` joins with ``gloo``.
    Returns False, joining nothing, when neither the arguments nor the
    environment name a world; True once joined (also when already
    joined)."""
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None and "WORLD_SIZE" not in env:
        return False
    if coordinator_address is None:
        coordinator_address = f"{env.get('MASTER_ADDR', 'localhost')}:{env['MASTER_PORT']}"
    world = int(env["WORLD_SIZE"]) if num_processes is None else num_processes
    rank = int(env["RANK"]) if process_id is None else process_id
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to join with gloo")
        torch.cuda.set_device(local_rank)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank)
    return True


def is_active() -> bool:
    """True when a process group is up (of any size)."""
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if is_active() else 1


def process_index() -> int:
    return dist.get_rank() if is_active() else 0


def barrier() -> None:
    """Wait for every rank (nothing without a process group)."""
    if is_active():
        dist.barrier()


def process_shard(items: Sequence, *, index: Optional[int] = None,
                  count: Optional[int] = None) -> list:
    """Deterministic per-rank slice of a host-side work list: rank i takes
    ``items[i::count]``. A single process takes everything."""
    index = process_index() if index is None else index
    count = process_count() if count is None else count
    return list(items[index::count])


def local_batch_size(global_batch: int) -> int:
    n = process_count()
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by {n} processes")
    return global_batch // n


def global_arrays(mesh, *local_arrays, specs=None) -> tuple:
    """Each rank's local slices as tensors on the mesh's first device: under
    data parallelism the global batch is the ranks' slices taken together,
    and nothing is assembled. ``specs`` is accepted for the JAX signature
    (every array is split on its batch dimension)."""
    dev = mesh.devices[0]
    return tuple((a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))).to(dev)
                 for a in local_arrays)


def global_batch(mesh, local_images, local_masks=None):
    """:func:`global_arrays` of a rank's (images[, masks])."""
    if local_masks is None:
        return global_arrays(mesh, local_images)[0]
    return global_arrays(mesh, local_images, local_masks)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of ``x`` over the ranks, with a backward (the incoming gradients
    summed over ranks; inside an autograd ``Function``, which writes its
    own, just the sum); ``x`` itself without a process group."""
    if not is_active():
        return x
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(x)


def all_gather_cat(x: torch.Tensor) -> torch.Tensor:
    """The ranks' ``x`` (same shape on every rank) concatenated on dim 0 in
    rank order, without a backward; ``x`` itself without a process
    group."""
    if not is_active():
        return x
    parts: List[torch.Tensor] = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)
