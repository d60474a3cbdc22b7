"""The mesh's ``space`` and ``model`` axes over ``torch.distributed`` (the
port's ``parallel/space.py``), on the CPU.

``gloo`` ranks (``tests/torch_space_worker.py``), started as
``tests/test_torch_distributed.py`` starts them, run one SGD train step of
the seg model and of HRNet on their rows of their data shard of a global
b4 batch, from the seeded weights the single process uses:

- two ranks, ``(space=2)``: seg at 64x48 (the dilated k5 depthwise of
  blocks 12-14 needs 4 halo rows where each rank holds 2 of the s16 map)
  and HRNet at 96x64 (a 3-row s32 branch over 2 ranks);
- four ranks, ``(data=2, space=2)``, ``(space=2, model=2)`` and
  ``(space=4)`` (HRNet at 64x96 leaves two ranks without a row of the
  2-row s32 branch).

In float64 every loss, gradient tensor and BatchNorm statistic must be the
single-process b4 step's to 1e-12 (of each tensor's largest entry); the
``model=2`` replicas give the ``model=1`` step. The fp32 two-rank seg step
agrees with the JAX package's ``(data=1, space=2)`` step on the conftest's
virtual CPU devices, to ``tests/test_torch_distributed.py``'s tolerances.
The pose eval step's distances equal the unsharded ones. The row
partition, the grid order and the helpers' plain path are checked in this
process.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mtg_card_image_segmentation_tpu.config import OptimizerConfig as JaxOptimizerConfig
from mtg_card_image_segmentation_tpu.models import create_model as jax_create_model
from mtg_card_image_segmentation_tpu.parallel import make_mesh as jax_make_mesh
from mtg_card_image_segmentation_tpu.parallel import shard_batch as jax_shard_batch
from mtg_card_image_segmentation_tpu.training import loop as jax_loop
from mtg_card_image_segmentation_tpu.training.optim import (
    create_optimizer as jax_create_optimizer,
)
from mtg_card_image_segmentation_tpu.training.state import SegTrainState as JaxState

from mtg_card_image_segmentation_tpu_torch.ops import heatmap as hm
from mtg_card_image_segmentation_tpu_torch.ops import resize
from mtg_card_image_segmentation_tpu_torch.parallel import make_mesh, space
from mtg_card_image_segmentation_tpu_torch.parallel.space import bounds, grid_coords
from mtg_card_image_segmentation_tpu_torch.training.loop import float64_casts
from mtg_card_image_segmentation_tpu_torch.utils.params import init_flax_like, state_dict_to_flax

import torch_mp_worker as mp
import torch_space_worker as sw

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
GLOBAL_B = 4
TOL = 1e-12
ZERO = 1e-9  # a tensor below this share of the largest is zero in exact arithmetic
SEG, HR_UNEVEN, HR = (64, 48), (96, 64), (64, 96)
TWO = [{"name": "space2", "mesh": {"space": 2},
        "cases": [["seg", "float64", SEG], ["hrnet", "float64", HR_UNEVEN],
                  ["seg", "fp32", SEG], ["pose_eval", "float64", HR_UNEVEN]]}]
FOUR = [{"name": name, "mesh": mesh,
         "cases": [["seg", "float64", SEG], ["hrnet", "float64", HR]]}
        for name, mesh in (("data2_space2", {"data": 2, "space": 2}),
                           ("space2_model2", {"space": 2, "model": 2}),
                           ("space4", {"space": 4}))]
STEP_CASES = [(run["name"], world, fam, shape) for world, plan in ((2, TWO), (4, FOUR))
              for run in plan for fam, prec, shape in run["cases"]
              if prec == "float64" and fam != "pose_eval"]


def _inputs() -> dict:
    """The global b4 batches of every case: smooth images, seg masks where
    the red channel is positive, HRNet Gaussian corner targets."""
    rng = np.random.default_rng(3)
    out = {}
    for run in TWO + FOUR:
        for family, precision, (h, w) in run["cases"]:
            name = sw.case_name(family, precision, (h, w))
            if f"{name}/x" in out:
                continue
            x = _smooth(rng, h, w)
            if family == "seg":
                out[f"{name}/x"] = x * 2.0 - 1.0
                out[f"{name}/y"] = (out[f"{name}/x"][..., 0] > 0).astype(np.int32)
                continue
            corners = np.stack([rng.uniform(0, w - 1, (GLOBAL_B, 4)),
                                rng.uniform(0, h - 1, (GLOBAL_B, 4))], -1).astype(np.float32)
            out[f"{name}/x"] = x
            out[f"{name}/y"] = hm.gaussian_heatmaps_batch(
                hm.pixels_to_heatmap_coords(torch.from_numpy(corners), (h, w), mp.HM),
                *mp.HM).numpy()
    return out


def _smooth(rng, h, w) -> np.ndarray:
    base = torch.from_numpy(rng.random((GLOBAL_B, 3, h // 8, w // 8)).astype(np.float32))
    return torch.nn.functional.interpolate(base, size=(h, w), mode="bilinear",
                                           align_corners=False).permute(0, 2, 3, 1) \
        .contiguous().numpy()


def _launch(work: Path, world: int, plan: list) -> None:
    (work / "plan.json").write_text(json.dumps(plan))
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests" / "torch_space_worker.py"),
                               str(r), str(world), str(port), str(work)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The single-process b4 steps of every case, then the two-rank and the
    four-rank groups; their records."""
    work = tmp_path_factory.mktemp("space")
    inputs = _inputs()
    np.savez(work / "inputs.npz", **inputs)
    single = {}
    for plan in (TWO, FOUR):
        for r in plan:
            for family, precision, shape in r["cases"]:
                name = sw.case_name(family, precision, shape)
                if name in single:
                    continue
                x, y = (torch.from_numpy(inputs[f"{name}/{k}"]) for k in ("x", "y"))
                if family == "pose_eval":
                    with float64_casts():
                        stats, distances = sw.pose_eval(None, x, y, shape)
                    single[name] = {"stat/loss": stats["loss"].numpy(),
                                    "distances": distances.numpy()}
                else:
                    single[name] = mp.record(*mp.one_step(family, precision, x, y))
    _launch(work, 2, TWO)
    _launch(work, 4, FOUR)

    def ranks(run_name, world, name):
        return [dict(np.load(work / f"{run_name}_{name}_rank{r}.npz")) for r in range(world)]

    return {"inputs": inputs, "single": single, "ranks": ranks}


def _prefixed(rec: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in rec.items() if k.startswith(prefix)}


@pytest.mark.parametrize("run_name,world,family,shape", STEP_CASES,
                         ids=[f"{c[0]}-{c[2]}-{c[3][0]}x{c[3][1]}" for c in STEP_CASES])
def test_sharded_float64_step_equals_the_single_process_step(run, run_name, world, family,
                                                            shape):
    """Every rank holds the same loss, gradients and statistics, the
    single-process b4 step's to 1e-12: the loss relative, each gradient
    tensor and statistic of its largest entry (a tensor that is zero in
    exact arithmetic of the model's largest)."""
    name = sw.case_name(family, "float64", shape)
    want, got = run["single"][name], run["ranks"](run_name, world, name)
    for other in got[1:]:
        for k, v in got[0].items():
            np.testing.assert_array_equal(v, other[k], err_msg=f"ranks differ: {k}")
    got = got[0]
    loss = float(want["stat/loss"])
    assert abs(float(got["stat/loss"]) - loss) <= TOL * abs(loss)
    for prefix in ("grad/", "buffer/"):
        w, g = _prefixed(want, prefix), _prefixed(got, prefix)
        assert w and set(w) == set(g)
        top = max(float(np.abs(v).max()) for v in w.values())
        for k, v in w.items():
            vmax = float(np.abs(v).max())
            scale = top if vmax <= ZERO * top else vmax
            np.testing.assert_allclose(g[k], v, rtol=0, atol=TOL * scale, err_msg=k)


def test_seg_stats_are_the_global_batchs(run):
    """The seg step's IoU, dice and pixel accuracy over the row-split
    pixels are the single process's, on every rank."""
    name = sw.case_name("seg", "float64", SEG)
    want = run["single"][name]
    for rec in run["ranks"]("space2", 2, name) + run["ranks"]("space4", 4, name):
        for k in ("iou", "dice", "pixel_accuracy"):
            np.testing.assert_allclose(rec[f"stat/{k}"], want[f"stat/{k}"], rtol=1e-12,
                                       err_msg=k)


def test_model_replicas_give_the_model_1_step(run):
    """``(space=2, model=2)`` on four ranks: the replicas hold the same
    step, the ``(space=2)`` two-rank step's (whose BatchNorm statistics do
    not count a replica twice) to 1e-12."""
    name = sw.case_name("seg", "float64", SEG)
    replicated = run["ranks"]("space2_model2", 4, name)
    plain = run["ranks"]("space2", 2, name)[0]
    for k, v in plain.items():
        if k.startswith(("grad/", "buffer/", "stat/")):
            top = float(np.abs(v).max()) or 1.0
            for rec in replicated:
                np.testing.assert_allclose(rec[k], v, rtol=0, atol=TOL * top, err_msg=k)


def test_pose_eval_distances_equal_the_unsharded_ones(run):
    """The HRNet eval step under ``(space=2)`` gathers the heatmap rows and
    decodes them: its distances and loss are the single process's."""
    name = sw.case_name("pose_eval", "float64", HR_UNEVEN)
    want = run["single"][name]
    for rec in run["ranks"]("space2", 2, name):
        np.testing.assert_allclose(rec["distances"], want["distances"], rtol=0, atol=1e-9)
        np.testing.assert_allclose(rec["stat/loss"], want["stat/loss"], rtol=1e-12)


def test_two_rank_fp32_seg_step_agrees_with_the_jax_space_sharded_step(run):
    """JAX ``make_train_step(mesh=make_mesh(data=1, space=2))`` on the same
    b4 batch and weights: the loss to 1e-5 relative, the stats to 1e-6, the
    statistics to 1e-5 and the SGD-updated parameters to 1e-5 relative."""
    name = sw.case_name("seg", "fp32", SEG)
    inputs, got = run["inputs"], run["ranks"]("space2", 2, name)[0]
    mesh = jax_make_mesh(data=1, space=2, devices=jax.devices()[:2])
    model = jax_create_model("lraspp_mobilenet_v3_large", compute_dtype="float32")
    tx, _ = jax_create_optimizer(JaxOptimizerConfig(**mp.SGD), 1, 10)
    params, stats = (jax.tree.map(jnp.asarray, t) for t in init_flax_like(0))
    state = JaxState.create(apply_fn=model.apply, params=params, batch_stats=stats, tx=tx)
    imgs, masks = jax_shard_batch(mesh, inputs[f"{name}/x"], inputs[f"{name}/y"])
    new, jstats = jax_loop.make_train_step(mesh=mesh, donate=False)(state, imgs, masks)
    want = float(jstats["loss"])
    assert abs(float(got["stat/loss"]) - want) <= 1e-5 * abs(want)
    for k in ("iou", "dice", "pixel_accuracy"):
        np.testing.assert_allclose(got[f"stat/{k}"], np.asarray(jstats[k]), rtol=1e-6)
    params_got, stats_got = state_dict_to_flax(
        {**{n: torch.from_numpy(v) for n, v in _prefixed(got, "param/").items()},
         **{n: torch.from_numpy(v) for n, v in _prefixed(got, "buffer/").items()}})
    for tree_got, tree_want, atol in ((params_got, new.params, 1e-6),
                                      (stats_got, new.batch_stats, 1e-5)):
        a, b = _leaves(tree_got), _leaves(jax.tree.map(np.asarray, tree_want))
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=atol, err_msg=k)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_leaves(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


@pytest.mark.parametrize("n,parts", [(64, 2), (15, 2), (3, 2), (2, 4), (4, 2), (480, 2),
                                     (7, 3), (0, 2)])
def test_row_partition_is_even_and_follows_the_stride(n, parts):
    """``bounds`` covers the map in order, its shares differ by at most a
    row, and a map of ``n / s`` rows is split where the ``n``-row map's
    split lands divided by ``s``, rounded up (row ``o`` lies with row
    ``o * s``)."""
    b = bounds(n, parts)
    assert b[0] == 0 and b[-1] == n and all(x <= y for x, y in zip(b, b[1:]))
    sizes = np.diff(b)
    assert sizes.max() - sizes.min() <= 1
    for s in (2, 4, 8, 16, 32):
        if n % s == 0:
            assert bounds(n // s, parts) == [-(-x // s) for x in b]


def test_grid_coords_follow_the_jax_reshape_order():
    """Rank r's (hosts, data, space, model) indices are those of device r in
    ``np.arange(n).reshape(hosts, data, space, model)``, ``model``
    fastest."""
    shape = (2, 3, 2, 2)
    grid = np.arange(np.prod(shape)).reshape(shape)
    for r in range(grid.size):
        assert tuple(int(i) for i in np.argwhere(grid == r)[0]) == grid_coords(r, shape)


def test_space_helpers_are_the_plain_ops_without_a_layout():
    """Outside a layout (no mesh, or a mesh without one) each helper is its
    plain op, bit for bit, and a step refuses a space axis laid over one
    process's devices."""
    from mtg_card_image_segmentation_tpu_torch.training.loop import make_train_step

    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 6, 10, 8, generator=g)
    w = torch.randn(6, 6, 3, 3, generator=g)
    wt = torch.randn(6, 4, 4, 4, generator=g)
    nhwc = x.permute(0, 2, 3, 1)
    with space.use(make_mesh(devices=["cpu"])):
        assert space.layout() is None
        assert torch.equal(space.conv2d(x, w, None, 2, 2, 2, 1),
                           torch.nn.functional.conv2d(x, w, None, 2, 2, 2, 1))
        assert torch.equal(space.conv_transpose2d(x, wt, 2, 1),
                           torch.nn.functional.conv_transpose2d(x, wt, None, 2, 1))
        assert torch.equal(space.bilinear_resize(nhwc, 7, 5), resize.bilinear_resize(nhwc, 7, 5))
        assert torch.equal(space.nearest_resize(nhwc, 20, 16), resize.nearest_resize(nhwc, 20, 16))
        assert torch.equal(space.mean_hw(nhwc, torch.float32), nhwc.mean(dim=(1, 2)))
        assert space.shard_rows(nhwc) is nhwc and space.gather_rows(nhwc) is nhwc
    mesh = make_mesh(space=2, devices=["cpu", "cpu"])
    assert mesh.layout is None and mesh.shape["space"] == 2
    with pytest.raises(ValueError, match="one process per device"):
        make_train_step(mesh=mesh)
