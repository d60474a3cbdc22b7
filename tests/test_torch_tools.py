"""The port's graft entry, profiling utilities, block profiler and
data-generation CLIs, on the CPU: ``graft_entry_torch.py`` against
``__graft_entry__.py`` on the same weights and its dry run on four gloo
ranks with CUDA hidden; ``utils/profiling.py::trace``;
``utils/params.py::model_size_mb`` against the JAX package's;
``tools/profile_blocks_torch.py``; ``generate_dataset_torch.py`` end to end
(layout, annotations, resume-skip); the two plot CLIs and ``train_seg_torch.py
--plot``."""

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

from mtg_card_image_segmentation_tpu.utils import params as jax_params

from mtg_card_image_segmentation_tpu_torch.utils import profiling
from mtg_card_image_segmentation_tpu_torch.utils.params import (
    init_flax_like,
    init_hrnet_flax_like,
    model_size_mb,
    trainable_from_flax,
)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import generate_dataset_torch  # noqa: E402
import generate_examples_torch  # noqa: E402
import graft_entry_torch  # noqa: E402
import profile_blocks_torch  # noqa: E402
import profile_pose_step_torch  # noqa: E402
import visualize_augmentations_torch  # noqa: E402

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(2)


# --------------------------------------------------------------------------
# graft entry
# --------------------------------------------------------------------------


def test_entry_agrees_with_the_jax_entry_on_the_same_weights(monkeypatch):
    """``entry("cpu")``'s forward against ``__graft_entry__.entry()``'s
    ``fn`` on the port's seeded weights (the JAX entry's ``model.init`` is
    handed them, which also spares its minute-long eager init) and one
    batch: (1, 320, 240, 2) logits, the bf16 pair within the JAX package's
    own bf16 agreement (0.998 of the argmax decisions, as bf16 vs fp32 at
    320x240) and 5 % of the largest logit."""
    import __graft_entry__ as jax_graft
    import mtg_card_image_segmentation_tpu.models as jax_models

    params, stats = init_flax_like(0)
    make = jax_models.create_model

    class Seeded:
        def __init__(self, model):
            self.apply = model.apply

        def init(self, rng, example, train):
            return {"params": params, "batch_stats": stats}

    monkeypatch.setattr(jax_models, "create_model", lambda *a, **k: Seeded(make(*a, **k)))
    fn, (model, example) = graft_entry_torch.entry(device="cpu")
    assert tuple(example.shape) == (1, 320, 240, 3) and not model.training
    x = np.random.default_rng(0).standard_normal((1, 320, 240, 3)).astype(np.float32)
    got = fn(model, torch.from_numpy(x)).float().numpy()
    jfn, (variables, jex) = jax_graft.entry()
    assert jex.shape == example.shape
    want = np.asarray(jax.jit(jfn)(variables, jnp.asarray(x)), np.float32)
    assert got.shape == want.shape == (1, 320, 240, 2)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.998
    assert float(np.abs(got - want).max()) <= 0.05 * float(np.abs(want).max())


def test_dryrun_multichip_4_passes_with_cuda_hidden():
    """``dryrun_multichip(4)`` in a fresh process that sees no CUDA device:
    its four gloo ranks, a (data=2, space=2) mesh, finish with finite losses
    and the mask shape, under their own timeout."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["CUDA_VISIBLE_DEVICES"] = ""
    p = subprocess.run([sys.executable, "-c",
                        "import graft_entry_torch as g; print(g.dryrun_multichip(4))"],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    assert p.stdout.strip().endswith("None")


# --------------------------------------------------------------------------
# profiling
# --------------------------------------------------------------------------


def test_trace_writes_a_chrome_trace_on_the_host(tmp_path):
    """``trace`` writes a chrome trace of the ops it saw."""
    with profiling.trace(str(tmp_path / "prof")):
        torch.randn(64, 64) @ torch.randn(64, 64)
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])


@pytest.mark.parametrize("family", ["seg", "hrnet"])
def test_model_size_mb_equals_jax_on_converted_weights(family):
    """A module built from a Flax tree has the tree's size in the JAX
    count (parameters and BatchNorm statistics, float32), and the tree
    itself counts the same in both functions."""
    from mtg_card_image_segmentation_tpu_torch.utils.params import hrnet_from_flax

    if family == "seg":
        tree = init_flax_like(0)
        model = trainable_from_flax(*tree)
    else:
        tree = init_hrnet_flax_like(0)
        model = hrnet_from_flax(*tree)
    variables = {"params": tree[0], "batch_stats": tree[1]}
    want = jax_params.model_size_mb(jax.tree.map(jnp.asarray, variables))
    assert model_size_mb(model) == pytest.approx(want, rel=1e-12)
    assert model_size_mb(variables) == pytest.approx(want, rel=1e-12)


def test_profile_blocks_times_every_cut_on_the_host():
    """The tool's default cuts at 64x64 b2 on the CPU: one row per cut in
    order, positive times, cumulative sums, the full-size uint8 mask."""
    rec = profile_blocks_torch.run(size=64, batch=2, iters=2, warmup=1, device="cpu")
    cuts = profile_blocks_torch.DEFAULT_CUTS.split(",")
    assert [r["cut"] for r in rec["stages"]] == cuts
    assert all(r["delta_ms"] > 0 for r in rec["stages"])
    assert rec["total_ms"] == pytest.approx(sum(r["delta_ms"] for r in rec["stages"]))
    assert rec["out_shape"] == [2, 64, 64] and rec["method"] == "host_clock_per_stage"
    with pytest.raises(ValueError, match="unknown cuts"):
        profile_blocks_torch.run(size=64, batch=1, iters=1, cuts="b99", device="cpu")


def test_profile_pose_step_times_generation_and_the_step_on_the_host():
    """tools/profile_pose_step_torch.py at a tiny size on the CPU, through
    its function's arguments: one row per batch with positive times, the
    combined rate batch / (generate + step) and a finite loss."""
    rec = profile_pose_step_torch.run(batches=(1, 2), steps=1, size=(64, 96),
                                      heatmap=(16, 24), device="cpu")
    assert rec["size"] == [64, 96] and rec["heatmap"] == [16, 24]
    assert [r["batch"] for r in rec["rows"]] == [1, 2]
    for r in rec["rows"]:
        assert r["datagen_ms"] > 0 and r["train_step_ms"] > 0 and r["loss_finite"]
        assert r["img_per_s_combined"] == pytest.approx(
            r["batch"] * 1e3 / (r["datagen_ms"] + r["train_step_ms"]))


# --------------------------------------------------------------------------
# data generation and the plot CLIs
# --------------------------------------------------------------------------


def _gen_args(root: Path, extra=()):
    return ["--device", "cpu", "--output", str(root / "ds"), "--train", "6", "--test", "3",
            "--height", "64", "--width", "48", "--batch", "4", *extra]


def test_generate_dataset_writes_the_layout_and_resumes(tmp_path):
    """At 64x48: the reference layout, renderer annotations within 2 px of
    the mask-derived corners (as a point cycle), the YOLO layout; a second
    run renders the same batches and rewrites no file."""
    from mtg_card_image_segmentation_tpu_torch.data.corners import find_card_corners

    res = generate_dataset_torch.main(_gen_args(tmp_path, ["--yolo-output",
                                                           str(tmp_path / "yolo")]))
    ds = tmp_path / "ds"
    assert res["written"] == 9 and res["skipped"] == 0
    for split, n in (("train", 6), ("test", 3)):
        imgs = sorted(os.listdir(ds / split / "images"))
        assert imgs == [f"synthetic_{i:06d}.jpg" for i in range(n)]
        assert sorted(os.listdir(ds / split / "masks")) == [i[:-4] + ".png" for i in imgs]
    ann = json.loads((ds / "corner_annotations.json").read_text())
    checked = 0
    for split, items in ann.items():
        for name, quad in items.items():
            mask = cv2.imread(str(ds / split / "masks" / (name[:-4] + ".png")),
                              cv2.IMREAD_GRAYSCALE)
            derived = find_card_corners(mask)
            if derived is None:
                continue
            q = np.asarray(quad, np.float32)
            err = min(float(np.abs(derived - np.roll(c, r, axis=0)).max())
                      for c in (q, q[::-1]) for r in range(4))
            assert err <= 2.0, (name, err)
            checked += 1
    assert checked >= 3
    assert (tmp_path / "yolo" / "data.yaml").is_file()
    stamps = {p: (p.stat().st_mtime_ns, p.read_bytes()) for p in ds.rglob("*.jpg")}
    again = generate_dataset_torch.main(_gen_args(tmp_path))
    assert again["written"] == 0 and again["skipped"] == 9
    assert {p: (p.stat().st_mtime_ns, p.read_bytes()) for p in ds.rglob("*.jpg")} == stamps
    assert json.loads((ds / "corner_annotations.json").read_text()) == ann


def test_generate_dataset_resumed_batches_render_the_same_files(tmp_path):
    """Deleting some outputs and rerunning writes them back byte for byte
    (each batch's generator is seeded from its start), and
    ``--derive-corners`` rewrites the annotations from the masks."""
    generate_dataset_torch.main(_gen_args(tmp_path))
    victims = [tmp_path / "ds" / "train" / "images" / "synthetic_000005.jpg",
               tmp_path / "ds" / "test" / "images" / "synthetic_000001.jpg"]
    before = [v.read_bytes() for v in victims]
    for v in victims:
        v.unlink()
    res = generate_dataset_torch.main(_gen_args(tmp_path, ["--derive-corners"]))
    assert res["written"] == 2 and res["skipped"] == 7
    assert [v.read_bytes() for v in victims] == before
    ann = json.loads((tmp_path / "ds" / "corner_annotations.json").read_text())
    assert ann == res["annotations"]


def test_plot_clis_compute_and_draw(tmp_path):
    """The augmentation grid and the example figures (with a prediction grid
    from a seeded checkpoint) computed on the host and drawn with
    matplotlib; the computation alone returns host arrays."""
    from mtg_card_image_segmentation_tpu_torch.training import checkpoint as ckpt
    from mtg_card_image_segmentation_tpu_torch.training.state import create_seg_state
    from mtg_card_image_segmentation_tpu_torch.training.optim import create_optimizer
    from mtg_card_image_segmentation_tpu_torch.config import OptimizerConfig

    rows = visualize_augmentations_torch.augmented_samples(2, 3, 64, 48, keypoints=True,
                                                           device="cpu")
    assert len(rows) == 2 and rows[0]["images"].shape == (3, 64, 48, 3)
    assert rows[0]["keypoints"][0].shape == (4, 2)
    out = visualize_augmentations_torch.main(["--device", "cpu", "--samples", "2",
                                              "--variants", "2", "--height", "64",
                                              "--width", "48",
                                              "--out", str(tmp_path / "g" / "grid.png")])
    assert os.path.getsize(out) > 0
    state = create_seg_state(trainable_from_flax(*init_flax_like(0), dtype=torch.float32),
                             create_optimizer(OptimizerConfig(), 1, 1)[0])
    ckpt.save_checkpoint(str(tmp_path / "ck"), "m", state, epoch=0)
    paths = generate_examples_torch.main(["--device", "cpu", "--samples", "3", "--height",
                                          "64", "--width", "48", "--out",
                                          str(tmp_path / "ex"), "--checkpoint",
                                          str(tmp_path / "ck" / "m")])
    assert [os.path.basename(p) for p in paths] == ["annotations.png", "dataset_stats.png",
                                                    "predictions.png"]
    assert all(os.path.getsize(p) > 0 for p in paths)
    stats = generate_examples_torch.dataset_statistics(n=16, device="cpu")
    assert stats["card"] + stats["negative"] == 16 and stats["area_fractions"].shape == (16,)


def test_train_seg_cli_writes_the_history_plot(tmp_path):
    import train_seg_torch

    sets = ["model.input_height=64", "model.input_width=48", "data.batch_size=2",
            "train.num_epochs=1", "train.steps_per_epoch=1",
            f"train.checkpoint_dir={tmp_path}/ck", f"train.log_dir={tmp_path}/logs"]
    hist = train_seg_torch.main(["--device", "cpu", "--plot", "--set", *sets])
    assert hist["train_loss"] and (tmp_path / "logs" / "training_history.png").is_file()
