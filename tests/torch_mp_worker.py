"""One rank of a two-process ``gloo`` group on the CPU, for
``tests/test_torch_distributed.py``.

    python torch_mp_worker.py <rank> <port> <work_dir>

Joins the group through ``parallel/distributed.py::initialize``, then takes
its half of each global batch in ``<work_dir>/inputs.npz`` and runs one
data-parallel train step of the port's seg model (fp32 and float64), HRNet
(fp32 and float64) and YOLO12n-pose (fp32 and float64) from the seeded
weights the parent uses; it writes the loss, the stats, every gradient and
every BatchNorm statistic to ``<work_dir>/rank<r>_<case>.npz``. Then rank 0
writes the seg state as a checkpoint (``mp_ckpt/mp_model``), and every rank
loads the one the parent wrote alone (``sp_ckpt/sp_model``) and records its
parameters' checksum. Imports nothing of JAX. The test imports its
helpers (``model_of``, ``step_of``, ``record``) for the single-process
references.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

from mtg_card_image_segmentation_tpu_torch.config import OptimizerConfig  # noqa: E402
from mtg_card_image_segmentation_tpu_torch.models.hrnet import HRNetPose  # noqa: E402
from mtg_card_image_segmentation_tpu_torch.models.yolo12_pose import YOLO12Pose  # noqa: E402
from mtg_card_image_segmentation_tpu_torch.parallel import distributed, make_mesh  # noqa: E402
from mtg_card_image_segmentation_tpu_torch.training import checkpoint as ckpt  # noqa: E402
from mtg_card_image_segmentation_tpu_torch.training.loop import (  # noqa: E402
    float64_casts,
    float64_copy,
    make_pose_train_step,
    make_train_step,
)
from mtg_card_image_segmentation_tpu_torch.training.optim import create_optimizer  # noqa: E402
from mtg_card_image_segmentation_tpu_torch.training.state import create_seg_state  # noqa: E402
from mtg_card_image_segmentation_tpu_torch.training.yolo_loss import (  # noqa: E402
    make_yolo_train_step,
)
from mtg_card_image_segmentation_tpu_torch.utils.params import (  # noqa: E402
    flax_to_state_dict,
    init_flax_like,
    init_hrnet_flax_like,
    init_yolo_flax_like,
    trainable_from_flax,
)

SGD = dict(name="sgd", schedule="constant", warmup_epochs=0, learning_rate=0.05,
           weight_decay=1e-4)
HM = (16, 24)


def model_of(family: str) -> torch.nn.Module:
    """The family's train-mode float32 model from its seeded tree."""
    if family == "seg":
        return trainable_from_flax(*init_flax_like(0), dtype=torch.float32)
    if family == "hrnet":
        model = HRNetPose(heatmap_height=HM[0], heatmap_width=HM[1], dtype=torch.float32)
        tree = init_hrnet_flax_like(0)
    else:
        model, tree = YOLO12Pose(dtype=torch.float32), init_yolo_flax_like(0)
    model.load_state_dict(flax_to_state_dict(*tree), strict=True)
    return model.train()


def step_of(family, mesh):
    return {"seg": make_train_step, "hrnet": make_pose_train_step,
            "yolo": make_yolo_train_step}[family](mesh=mesh)


def fresh_state(family: str, float64: bool = False):
    """The family's seeded model under SGD at step 0 (float64: its float64
    copy, made inside ``float64_casts``)."""
    model = model_of(family)
    if float64:
        model = float64_copy(model).train()
    return create_seg_state(model, create_optimizer(OptimizerConfig(**SGD), 1, 10)[0])


def one_step(family: str, precision: str, x: torch.Tensor, y: torch.Tensor, mesh=None):
    """(state, stats) after one SGD train step of the family's fresh model
    on (x, y), in float32 or in float64 (the float64 pass of
    ``training/loop.py``)."""
    if precision == "fp32":
        return step_of(family, mesh)(fresh_state(family), x, y)
    with float64_casts():
        state = fresh_state(family, float64=True)
        y64 = y.double() if y.is_floating_point() else y
        return step_of(family, mesh)(state, x.double(), y64)


def record(state, stats) -> dict:
    out = {f"stat/{k}": v.detach().double().numpy() for k, v in stats.items()}
    out.update({f"grad/{n}": p.grad.double().numpy()
                for n, p in state.model.named_parameters()})
    out.update({f"buffer/{n}": b.double().numpy() for n, b in state.model.named_buffers()
                if "running" in n})
    out.update({f"param/{n}": p.detach().double().numpy()
                for n, p in state.model.named_parameters()})
    return out


def main() -> None:
    rank, port, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    assert distributed.initialize(f"localhost:{port}", 2, rank, device="cpu")
    assert distributed.process_count() == 2 and distributed.process_index() == rank
    mesh = make_mesh(devices=["cpu"])
    assert mesh.ranks == 2 and mesh.shape["data"] == 2
    inputs = np.load(os.path.join(work, "inputs.npz"))
    for family in ("seg", "hrnet", "yolo"):
        x, y = (inputs[f"{family}/{k}"] for k in ("x", "y"))
        lo, hi = rank * len(x) // 2, (rank + 1) * len(x) // 2
        x, y = torch.from_numpy(x[lo:hi]), torch.from_numpy(y[lo:hi])
        for precision in ("fp32", "float64"):
            state, stats = one_step(family, precision, x, y, mesh)
            if (family, precision) == ("seg", "fp32"):
                seg_state = state
            np.savez(os.path.join(work, f"rank{rank}_{family}_{precision}.npz"),
                     **record(state, stats))
    ckpt.save_checkpoint(os.path.join(work, "mp_ckpt"), "mp_model", seg_state, epoch=1)
    loaded = fresh_state("seg")
    ckpt.load_checkpoint(os.path.join(work, "sp_ckpt"), "sp_model", loaded)
    checksum = sum(float(p.detach().double().abs().sum()) for p in loaded.model.parameters())
    np.savez(os.path.join(work, f"rank{rank}_restore.npz"), checksum=checksum)
    distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
