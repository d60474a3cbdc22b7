"""One rank of a ``gloo`` group on the CPU whose mesh has ``space`` or
``model`` axes, for ``tests/test_torch_space.py``.

    python torch_space_worker.py <rank> <world> <port> <work_dir>

Joins the group, then for each run of ``<work_dir>/plan.json`` (a mesh and
its cases) lays ``make_mesh(**mesh, devices=["cpu"])`` and, per case
``(family, precision, shape)``, takes its rows of its data shard of the
global b4 batch in ``<work_dir>/inputs.npz`` (``parallel/mesh.py::
shard_batch``) and runs one train step of the family's seeded model under
that mesh, or (family ``pose_eval``) the HRNet eval step in float64. It
writes the loss, the stats, every gradient and BatchNorm statistic (or the
distances) to ``<work_dir>/<run>_<case>_rank<r>.npz``. Imports nothing of
JAX.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

import torch_mp_worker as mp  # noqa: E402

from mtg_card_image_segmentation_tpu_torch.parallel import (  # noqa: E402
    distributed,
    make_mesh,
    shard_batch,
)
from mtg_card_image_segmentation_tpu_torch.training.loop import (  # noqa: E402
    float64_casts,
    float64_copy,
    make_pose_eval_step,
)
from mtg_card_image_segmentation_tpu_torch.training.state import create_seg_state  # noqa: E402


def case_name(family: str, precision: str, shape) -> str:
    return f"{family}_{precision}_{shape[0]}x{shape[1]}"


def data_slice(mesh, x: np.ndarray) -> torch.Tensor:
    """This rank's data shard of a global batch (the layout's data index)."""
    lay = mesh.layout
    n = x.shape[0] // lay.data_count
    return torch.from_numpy(x[lay.data_index * n:(lay.data_index + 1) * n])


def pose_eval(mesh, x, y, shape):
    model = float64_copy(mp.model_of("hrnet")).eval()
    state = create_seg_state(model, mp.create_optimizer(mp.OptimizerConfig(**mp.SGD), 1, 10)[0])
    return make_pose_eval_step(shape, mesh)(state, x.double(), y.double())


def main() -> None:
    rank, world, port, work = (int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                               sys.argv[4])
    assert distributed.initialize(f"localhost:{port}", world, rank, device="cpu")
    inputs = np.load(os.path.join(work, "inputs.npz"))
    with open(os.path.join(work, "plan.json")) as f:
        plan = json.load(f)
    for run in plan:
        mesh = make_mesh(devices=["cpu"], **run["mesh"])
        assert mesh.layout is not None
        for family, precision, shape in run["cases"]:
            name = case_name(family, precision, shape)
            x, y = (data_slice(mesh, inputs[f"{name}/{k}"]) for k in ("x", "y"))
            (x, y), = shard_batch(mesh, x, y)
            if family == "pose_eval":
                with float64_casts():
                    stats, distances = pose_eval(mesh, x, y, shape)
                rec = {"stat/loss": stats["loss"].numpy(), "distances": distances.numpy()}
            else:
                state, stats = mp.one_step(family, precision, x, y, mesh)
                rec = mp.record(state, stats)
            np.savez(os.path.join(work, f"{run['name']}_{name}_rank{rank}.npz"), **rec)
    distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
