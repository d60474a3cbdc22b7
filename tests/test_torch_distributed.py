"""Data-parallel training and batch-split serving of the port over
``torch.distributed`` (the counterpart of ``tests/test_distributed.py``),
on the CPU.

Two ``gloo`` processes (``tests/torch_mp_worker.py``), each with its half
(b2) of a global b4 batch, run one SGD train step of the full seg model at
64x48, HRNet at 64x96 and YOLO12n-pose at 64x64 from the same seeded
weights; each must give the single-process b4 step: the loss to 1e-6
relative in float32, and in float64 the loss, every gradient tensor (after
DDP's all-reduce) and every BatchNorm statistic to 1e-12; the float32
gradients and statistics lie no further from the float64 step than twice
the single process's (float32 rounding alone moves some seg gradients by
a few percent of a tensor's largest entry). The gradients are compared, not the
parameters after the step. The seg step also agrees with the JAX package's data-sharded step
(``make_mesh(data=2)`` over two of the conftest's CPU devices) to
``tests/test_torch_train.py``'s tolerances. Then ``process_shard``, the file
pipeline's per-rank orders against the JAX pipeline's, checkpoints across
topologies, batch-split serving over a two-device CPU mesh, and the mesh's
refusals.
"""

import os
import socket
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
from mtg_card_image_segmentation_tpu.parallel import distributed as jax_distributed
from mtg_card_image_segmentation_tpu.parallel import make_mesh as jax_make_mesh
from mtg_card_image_segmentation_tpu.parallel import shard_batch as jax_shard_batch
from mtg_card_image_segmentation_tpu.training import loop as jax_loop
from mtg_card_image_segmentation_tpu.training.optim import (
    create_optimizer as jax_create_optimizer,
)
from mtg_card_image_segmentation_tpu.training.state import SegTrainState as JaxState

from mtg_card_image_segmentation_tpu_torch.data import pipeline as pl
from mtg_card_image_segmentation_tpu_torch.ops import heatmap as hm
from mtg_card_image_segmentation_tpu_torch.parallel import distributed, is_trivial, make_mesh
from mtg_card_image_segmentation_tpu_torch.serving.pose_predictor import PosePredictor
from mtg_card_image_segmentation_tpu_torch.serving.predictor import SegPredictor
from mtg_card_image_segmentation_tpu_torch.training import checkpoint as ckpt
from mtg_card_image_segmentation_tpu_torch.utils.params import (
    init_flax_like,
    init_hrnet_flax_like,
    state_dict_to_flax,
)

import torch_mp_worker as worker

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
GLOBAL_B = 4
SHAPES = {"seg": (64, 48), "hrnet": (64, 96), "yolo": (64, 64)}
ZERO = 1e-9          # float64: a gradient tensor below this share of the largest is zero
FP32_FACTOR = 2.0    # float32 two-process distance from float64 / the single process's
CASES = [(f, p) for f in ("seg", "hrnet", "yolo") for p in ("fp32", "float64")]


def _smooth(rng, b, h, w):
    base = torch.from_numpy(rng.random((b, 3, h // 8, w // 8)).astype(np.float32))
    return torch.nn.functional.interpolate(base, size=(h, w), mode="bilinear",
                                           align_corners=False).permute(0, 2, 3, 1)


def _inputs() -> dict:
    """The global b4 batches: seg images with masks (red channel > its
    mean), HRNet [0,1] images with Gaussian corner targets, YOLO [0,1]
    images with one quadrilateral each."""
    rng = np.random.default_rng(0)
    out = {}
    h, w = SHAPES["seg"]
    x = _smooth(rng, GLOBAL_B, h, w) * 2.0 - 1.0
    out["seg/x"] = x.contiguous().numpy()
    out["seg/y"] = (out["seg/x"][..., 0] > 0).astype(np.int32)
    h, w = SHAPES["hrnet"]
    out["hrnet/x"] = _smooth(rng, GLOBAL_B, h, w).contiguous().numpy()
    corners = np.stack([rng.uniform(0, w - 1, (GLOBAL_B, 4)),
                        rng.uniform(0, h - 1, (GLOBAL_B, 4))], -1).astype(np.float32)
    out["hrnet/y"] = hm.gaussian_heatmaps_batch(
        hm.pixels_to_heatmap_coords(torch.from_numpy(corners), (h, w), worker.HM),
        *worker.HM).numpy()
    s = SHAPES["yolo"][0]
    out["yolo/x"] = _smooth(rng, GLOBAL_B, s, s).contiguous().numpy()
    ctr = rng.uniform(0.4 * s, 0.6 * s, (GLOBAL_B, 1, 2))
    half = rng.uniform(0.2 * s, 0.3 * s, (GLOBAL_B, 1, 2)) * np.array(
        [[[-1, -1], [1, -1], [1, 1], [-1, 1]]])
    out["yolo/y"] = (ctr + half).astype(np.float32)
    return out


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The single-process b4 steps (every case), the single-process
    checkpoint the workers restore, then the two workers; their records."""
    work = tmp_path_factory.mktemp("mp")
    inputs = _inputs()
    np.savez(work / "inputs.npz", **inputs)
    single = {}
    for family, precision in CASES:
        x, y = (torch.from_numpy(inputs[f"{family}/{k}"]) for k in ("x", "y"))
        state, stats = worker.one_step(family, precision, x, y)
        single[family, precision] = worker.record(state, stats)
        if (family, precision) == ("seg", "fp32"):
            ckpt.save_checkpoint(str(work / "sp_ckpt"), "sp_model", state, epoch=1)
            sp_checksum = sum(float(p.detach().double().abs().sum())
                              for p in state.model.parameters())
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests" / "torch_mp_worker.py"),
                               str(r), str(port), str(work)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    ranks = [{c: dict(np.load(work / f"rank{r}_{c[0]}_{c[1]}.npz")) for c in CASES}
             for r in range(2)]
    restores = [float(np.load(work / f"rank{r}_restore.npz")["checksum"]) for r in range(2)]
    return {"work": work, "inputs": inputs, "single": single, "ranks": ranks,
            "restores": restores, "sp_checksum": sp_checksum}


def _prefixed(rec: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in rec.items() if k.startswith(prefix)}


def _distance(rec: dict, ref: dict, prefix: str) -> float:
    """The worst tensor's max |rec - ref| over that tensor's largest |ref|,
    floored at 1e-5 of the largest entry of all: a gradient tensor that is
    zero in exact arithmetic is measured against the model's scale (the
    floor ``tests/test_torch_train.py`` takes for float32)."""
    a, b = _prefixed(rec, prefix), _prefixed(ref, prefix)
    assert b and set(a) == set(b)
    top = max(float(np.abs(v).max()) for v in b.values())
    return max(float(np.abs(a[k] - v).max()) / max(float(np.abs(v).max()), 1e-5 * top)
               for k, v in b.items())


@pytest.mark.parametrize("family,precision", CASES)
def test_two_process_step_equals_the_single_process_step(run, family, precision):
    """Both ranks hold the same loss, gradients and statistics. In float64
    they are the single-process b4 step's to 1e-12 (the loss relative, each
    gradient tensor of its largest entry, a tensor that is zero in exact
    arithmetic of the model's largest gradient, the statistics of 1 + their
    size). In float32 the loss is the single-process step's to 1e-6;
    gradients and statistics are held by their distance from the float64
    single-process step, at most twice the float32 single-process step's:
    at these sizes float32 rounding alone moves some gradient tensors (seg
    block 5's depthwise) by a few percent of their largest entry, on one
    process and on two alike, so no absolute float32 gate separates a
    right step from a wrong one there."""
    want = run["single"][family, precision]
    got, other = (r[family, precision] for r in run["ranks"])
    for k, v in got.items():
        np.testing.assert_array_equal(v, other[k], err_msg=f"ranks differ: {k}")
    loss = float(want["stat/loss"])
    tol = 1e-12 if precision == "float64" else 1e-6
    assert abs(float(got["stat/loss"]) - loss) <= tol * abs(loss)
    if precision == "float64":
        grads_want, grads_got = _prefixed(want, "grad/"), _prefixed(got, "grad/")
        assert set(grads_got) == set(grads_want)
        gmax = max(float(np.abs(g).max()) for g in grads_want.values())
        for k, g in grads_want.items():
            gk = float(np.abs(g).max())
            scale = gmax if gk <= ZERO * gmax else gk
            np.testing.assert_allclose(grads_got[k], g, rtol=0, atol=1e-12 * scale, err_msg=k)
        stats_want, stats_got = _prefixed(want, "buffer/"), _prefixed(got, "buffer/")
        assert stats_want and set(stats_got) == set(stats_want)
        for k, s in stats_want.items():
            np.testing.assert_allclose(stats_got[k], s, rtol=1e-12, atol=1e-12, err_msg=k)
        return
    exact = run["single"][family, "float64"]
    for prefix in ("grad/", "buffer/"):
        assert _distance(got, exact, prefix) <= FP32_FACTOR * _distance(want, exact, prefix), (
            prefix, _distance(got, exact, prefix), _distance(want, exact, prefix))


def test_seg_step_metrics_are_the_global_batchs(run):
    """The step's stats (IoU, dice, pixel accuracy) on every rank are the
    single-process b4 step's, not a rank's own half."""
    want = run["single"]["seg", "fp32"]
    for rank in run["ranks"]:
        got = rank["seg", "fp32"]
        for k in ("iou", "dice", "pixel_accuracy"):
            np.testing.assert_allclose(got[f"stat/{k}"], want[f"stat/{k}"], rtol=1e-6,
                                       err_msg=k)


def test_two_process_seg_step_agrees_with_the_jax_data_sharded_step(run):
    """JAX ``make_train_step(mesh=make_mesh(data=2))`` on the same b4 batch
    and weights: the loss to 1e-5 relative, the stats to 1e-6, the
    statistics to 1e-5 and the SGD-updated parameters to 1e-5 relative
    (``tests/test_torch_train.py``'s tolerances)."""
    inputs, got = run["inputs"], run["ranks"][0]["seg", "fp32"]
    mesh = jax_make_mesh(data=2, devices=jax.devices()[:2])
    model = jax_create_model("lraspp_mobilenet_v3_large", compute_dtype="float32")
    tx, _ = jax_create_optimizer(JaxOptimizerConfig(**worker.SGD), 1, 10)
    params, stats = (jax.tree.map(jnp.asarray, t) for t in init_flax_like(0))
    state = JaxState.create(apply_fn=model.apply, params=params, batch_stats=stats, tx=tx)
    imgs, masks = jax_shard_batch(mesh, inputs["seg/x"], inputs["seg/y"])
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
        a, b = worker_leaves(tree_got), worker_leaves(jax.tree.map(np.asarray, tree_want))
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=atol, err_msg=k)


def worker_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(worker_leaves(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def test_checkpoints_load_across_topologies(run):
    """Rank 0's checkpoint of the two-process step loads whole in this
    process and holds that step's parameters (the single-process step's to
    fp32 rounding); every rank loaded the single-process checkpoint whole."""
    params, batch_stats, meta = ckpt.load_params(str(run["work"] / "mp_ckpt"), "mp_model")
    assert meta["epoch"] == 1
    got = run["ranks"][0]["seg", "fp32"]
    sd = {n: torch.from_numpy(v) for n, v in _prefixed(got, "param/").items()}
    want = worker_leaves(state_dict_to_flax(sd)[0])
    loaded = worker_leaves(params)
    assert set(loaded) == set(want) and len(want) == 178
    for k, v in want.items():
        np.testing.assert_allclose(loaded[k], v, rtol=1e-6, atol=0, err_msg=k)
    assert worker_leaves(batch_stats)
    for checksum in run["restores"]:
        assert checksum == pytest.approx(run["sp_checksum"], rel=1e-12)


def test_process_shard_partitions_as_jax_does():
    items = list(range(10))
    parts = [distributed.process_shard(items, index=i, count=3) for i in range(3)]
    assert sorted(sum(parts, [])) == items and parts[0] == [0, 3, 6, 9]
    for i in range(3):
        assert parts[i] == jax_distributed.process_shard(items, index=i, count=3)
    assert distributed.process_shard(items) == items  # one process takes everything
    assert distributed.local_batch_size(32) == 32


class _Frames:
    """A dataset of 31 tiny frames whose pixels carry their index."""

    def __len__(self):
        return 31

    def load_raw(self, i):
        return np.full((2, 2, 3), i, np.uint8), np.full((2, 2), i % 2, np.uint8)


def test_file_pipeline_rank_orders_mirror_the_jax_pipeline(monkeypatch):
    """Under two ranks every rank counts the same steps (from the global
    count), decodes its own shard of the order in batches of 8, and the
    orders are those of the JAX pipeline per process; the ranks' images are
    disjoint. A multi-rank pipeline without drop_last is refused."""
    import mtg_card_image_segmentation_tpu.data.pipeline as jax_pl

    orders, steps = [], []
    for rank in (0, 1):
        monkeypatch.setattr(distributed, "process_count", lambda: 2)
        monkeypatch.setattr(distributed, "process_index", lambda r=rank: r)
        pipe = pl.FilePipeline(_Frames(), 16, 2, 2, shuffle=True, seed=5, device="cpu")
        steps.append(pipe.steps_per_epoch)
        got = [imgs[:, 0, 0, 0].tolist() for imgs, _, _ in pipe._host_batches()]
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        ref = jax_pl.FilePipeline.__new__(jax_pl.FilePipeline)
        ref.dataset, ref.batch_size, ref._local_bs = _Frames(), 16, 8
        ref.drop_last = ref.shuffle = True
        ref._rng = np.random.default_rng(5)
        assert got == [imgs[:, 0, 0, 0].tolist() for imgs, _, _ in ref._host_batches()]
        assert all(len(b) == 8 for b in got)
        orders.append(sum(got, []))
        monkeypatch.undo()
    assert steps[0] == steps[1] == 31 // 16
    assert not set(orders[0]) & set(orders[1])
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="drop_last"):
        pl.FilePipeline(_Frames(), 16, 2, 2, drop_last=False, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        pl.SyntheticPipeline(15, 8, 8, device="cpu")


def test_batch_split_serving_gives_the_unsplit_outputs():
    """SegPredictor and PosePredictor over a two-device CPU mesh: the masks
    and the corners of the unsplit predictor exactly; a batch that the
    devices do not divide raises."""
    mesh = make_mesh(devices=["cpu", "cpu"])
    assert mesh.size == 2 and mesh.ranks == 1
    h, w = SHAPES["seg"]
    weights = init_flax_like(0)
    imgs = np.random.default_rng(1).integers(0, 256, (4, h, w, 3), np.uint8)
    split = SegPredictor(*weights, h, w, mesh=mesh)
    assert len(split._replicas) == 2
    assert torch.equal(split.predict(imgs), SegPredictor(*weights, h, w, device="cpu")
                       .predict(imgs))
    with pytest.raises(ValueError, match="not divisible"):
        split.predict(imgs[:3])
    h, w = SHAPES["hrnet"]
    pose_w = init_hrnet_flax_like(0)
    imgs = np.random.default_rng(2).integers(0, 256, (4, h, w, 3), np.uint8)
    got = PosePredictor(*pose_w, h, w, worker.HM, mesh=mesh).predict(imgs)
    want = PosePredictor(*pose_w, h, w, worker.HM, device="cpu").predict(imgs)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_mesh_and_initialize_refuse_what_is_not_ported(monkeypatch):
    """The spatial and model axes raise and name the queue; a mesh that
    does not cover its shards raises; without torchrun's environment
    ``initialize`` joins nothing, a one-device mesh is trivial and a rank's
    batch is kept as it is; a step refuses a mesh laid for another
    world."""
    from mtg_card_image_segmentation_tpu_torch.training.loop import make_train_step

    for kw in ({"space": 2}, {"model": 2}):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue A"):
            make_mesh(devices=["cpu", "cpu"], **kw)
    with pytest.raises(ValueError, match="local devices"):
        make_mesh(data=3, devices=["cpu", "cpu"])
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize(device="cpu") is False
    assert not distributed.is_active() and distributed.process_count() == 1
    mesh = make_mesh(devices=["cpu"])
    assert is_trivial(None) and is_trivial(mesh)
    assert not is_trivial(make_mesh(devices=["cpu", "cpu"]))
    # under data parallelism a rank's slice is its part of the global batch
    imgs, masks = distributed.global_batch(mesh, np.ones((2, 4, 4, 3), np.float32),
                                           np.ones((2, 4, 4), np.int32))
    assert imgs.shape == (2, 4, 4, 3) and masks.dtype == torch.int32
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="ranks"):
        make_train_step(mesh=mesh)
