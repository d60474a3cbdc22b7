"""The port's serving path (SegPredictor) against the JAX package's, on the
CPU, and the port's isolation from JAX.

On the CPU the predictor's kernel path runs the kernels' plain versions;
``chip_smoke.py`` holds the card's kernel path against this CPU path.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mtg_card_image_segmentation_tpu.serving import predictor as jax_pred

from mtg_card_image_segmentation_tpu_torch.export.fold_bn import fold_batch_norm
from mtg_card_image_segmentation_tpu_torch.serving import predictor as port_pred
from mtg_card_image_segmentation_tpu_torch.serving.predictor import SegPredictor
from mtg_card_image_segmentation_tpu_torch.utils.params import (
    from_flax,
    init_flax_like,
)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "mtg_card_image_segmentation_tpu_torch"
H, W, B = 64, 48, 2


@pytest.fixture(scope="module")
def weights():
    return init_flax_like(0)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(1).integers(0, 256, (B, H, W, 3), np.uint8)


def test_predictor_fp32_matches_jax_predictor(weights, images):
    """Full width, 64x48, b2, fp32: the port's kernel path (plain versions
    on the CPU) and its reference path against the JAX reference path,
    mask agreement >= 0.999 (the repo's deployment gate,
    serving/predictor.py:403)."""
    params, stats = weights
    jp = jax.tree.map(jnp.asarray, params)
    js = jax.tree.map(jnp.asarray, stats)
    theirs = np.asarray(jax_pred.SegPredictor(
        jp, js, H, W, use_pallas=False, dtype=jnp.float32, auto_layout=False,
    ).predict(images))
    for use_kernels in (True, False):
        ours = SegPredictor(params, stats, H, W, use_kernels=use_kernels,
                            dtype=torch.float32, device="cpu").predict(images)
        assert ours.dtype == torch.uint8 and tuple(ours.shape) == (B, H, W)
        assert set(np.unique(ours.numpy())) <= {0, 1}
        assert (ours.numpy() == theirs).mean() >= 0.999


def test_predictor_fp32_matches_jax_predictor_320x240(weights):
    """The same at the server's and the config's 320x240, b2: the kernel
    path and the reference path against the JAX reference path, mask
    agreement >= 0.999."""
    params, stats = weights
    imgs = np.random.default_rng(4).integers(0, 256, (B, 320, 240, 3), np.uint8)
    theirs = np.asarray(jax_pred.SegPredictor(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats), 320, 240,
        use_pallas=False, dtype=jnp.float32, auto_layout=False,
    ).predict(imgs))
    for use_kernels in (True, False):
        ours = SegPredictor(params, stats, 320, 240, use_kernels=use_kernels,
                            dtype=torch.float32, device="cpu").predict(imgs)
        assert tuple(ours.shape) == (B, 320, 240)
        assert (ours.numpy() == theirs).mean() >= 0.999


def test_score_map_fp32_matches_jax_composition(weights, images):
    """The fp32 stride-8 score map: port _fold_normalize_into_stem ->
    _fused_backbone (every block as its module) -> _head_score_s8 against
    the same JAX composition with fused_ids=(), 1e-4 relative to the map's
    largest value (the maps differ only in summation order)."""
    folded = port_pred._fold_normalize_into_stem(fold_batch_norm(*weights))
    x = images.astype(np.float32) - 255.0 * port_pred._IMAGENET_MEAN
    jt = jax.tree.map(jnp.asarray, folded)

    @jax.jit
    def jax_score(t, x):
        taps = jax_pred._fused_backbone(t["backbone"], x, jnp.float32, fused_ids=())
        return jax_pred._head_score_s8(t["head"], taps["low"], taps["high"], jnp.float32)

    want = np.asarray(jax_score(jt, jnp.asarray(x)))
    model = from_flax(folded, None, dtype=torch.float32)
    with torch.no_grad():
        taps = port_pred._fused_backbone(model.backbone, torch.from_numpy(x))
        got = port_pred._head_score_s8(model.head, taps["low"], taps["high"]).numpy()
    assert got.shape == want.shape == (B, H // 8, W // 8)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


def test_bf16_kernel_path_agrees_with_reference_path(weights, images):
    """bf16 on the CPU: the kernel path (tail chain and decode as plain
    versions) against the port's reference path. >= 0.99, the repo's floor
    for random-init weights, which sit near the decision boundary
    (tests/test_serving.py:141-165); the two paths round bf16 in different
    places."""
    params, stats = weights
    a = SegPredictor(params, stats, H, W, device="cpu")
    b = SegPredictor(params, stats, H, W, use_kernels=False, device="cpu")
    assert a.dtype == torch.bfloat16
    assert a.mask_agreement(b, images) >= 0.99


def test_fused_head_masks_equal_default_and_agree_with_jax(weights, images):
    """fused_head=True on the CPU (the head decode's plain version), fp32:
    masks equal to the default kernel path's (the same function, summed in
    another order: no pixel of these images sits within rounding of 0), and
    agreement >= 0.999 with the JAX reference path, the repo's deployment
    gate."""
    params, stats = weights
    base = SegPredictor(params, stats, H, W, dtype=torch.float32, device="cpu").predict(images)
    ours = SegPredictor(params, stats, H, W, dtype=torch.float32, device="cpu",
                        fused_head=True).predict(images)
    assert ours.dtype == torch.uint8 and tuple(ours.shape) == (B, H, W)
    assert torch.equal(ours, base)
    theirs = np.asarray(jax_pred.SegPredictor(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats), H, W,
        use_pallas=False, dtype=jnp.float32, auto_layout=False).predict(images))
    assert (ours.numpy() == theirs).mean() >= 0.999


@pytest.mark.parametrize("fused_head", [False, True])
def test_fused_stem_agrees_with_default_bf16(weights, images, fused_head):
    """fused_stem=True (the stem kernel's plain version), bf16, alone and
    with fused_head: agreement >= 0.99 with the default path, the repo's
    floor for random-init weights; the stem centers in bf16 by design, so
    its output differs from the stock stem's by up to a bf16 ulp."""
    params, stats = weights
    base = SegPredictor(params, stats, H, W, device="cpu")
    ours = SegPredictor(params, stats, H, W, device="cpu", fused_stem=True,
                        fused_head=fused_head)
    assert ours.dtype == torch.bfloat16
    assert ours.mask_agreement(base, images) >= 0.99


def test_default_path_masks_unchanged(weights, images):
    """The default path does not depend on the options' code: its masks
    equal the composition it is made of (centering, _fused_backbone with
    the tail chain, _head_score_s8, fused_mask_decode), called by hand, in
    fp32 and in bf16."""
    params, stats = weights
    for dtype in (torch.float32, torch.bfloat16):
        pred = SegPredictor(params, stats, H, W, dtype=dtype, device="cpu")
        assert not pred.fused_head and not pred.fused_stem
        with torch.inference_mode():
            x = (torch.from_numpy(images).float() - pred._center).to(dtype)
            taps = port_pred._fused_backbone(pred.model.backbone, x, pred._tail)
            score = port_pred._head_score_s8(pred.model.head, taps["low"], taps["high"],
                                             pred._head_vectors)
            want = port_pred.fused_mask_decode(score, H, W)
        assert torch.equal(pred.predict(images), want)


def test_options_are_checked(weights):
    """fused_stem needs sizes that are multiples of 8, and both options
    belong to the kernel path."""
    with pytest.raises(ValueError, match="multiples of 8"):
        SegPredictor(*weights, 60, 48, device="cpu", fused_stem=True)
    with pytest.raises(ValueError, match="use_kernels"):
        SegPredictor(*weights, H, W, device="cpu", use_kernels=False, fused_head=True)


def test_predictor_refuses_cpu_unless_asked(weights, monkeypatch):
    """No device means the card; without CUDA that raises instead of
    running on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SegPredictor(*weights, H, W)
    with pytest.raises(RuntimeError, match="CUDA"):
        SegPredictor(*weights, H, W, device="cuda")


def test_predictor_rejects_bad_images(weights):
    p = SegPredictor(*weights, H, W, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError):
        p.predict(np.zeros((1, H, W, 3), np.float32))


_JAX_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax|flax|optax|orbax|mtg_card_image_segmentation_tpu)(\s|\.|$)",
    re.M,
)


CLIS = ("train_seg_torch", "evaluate_seg_torch", "prune_seg_torch", "export_seg_torch",
        "seg_inference_torch", "pose_inference_torch", "train_pose_torch",
        "evaluate_pose_torch", "export_pose_torch", "generate_dataset_torch",
        "visualize_augmentations_torch", "generate_examples_torch", "graft_entry_torch")
TOOLS = ("stencil_floor_torch", "fp32_conv_accuracy_torch", "distributed_step_torch",
         "profile_blocks_torch", "profile_pose_step_torch", "half_conv_layout_torch",
         "make_slim_fixture_torch", "make_decode_fixtures_torch", "analyze_dead_channel_torch")


def test_port_sources_import_no_jax():
    """No port source, nor chip_smoke.py, nor the card's tools, nor the
    port's CLIs and graft entry import jax, flax, optax, orbax or the JAX package,
    name a module of it without ``_torch``, or import the Orbax converter
    (the one tool that needs JAX)."""
    outside = [REPO / "chip_smoke.py", *(REPO / "tools" / f"{t}.py" for t in TOOLS),
               *(REPO / f"{c}.py" for c in CLIS)]
    files = sorted(PORT.rglob("*.py")) + outside
    assert len(files) > 25
    names = {f.relative_to(PORT).as_posix() for f in files[:-len(outside)]}
    assert {"serving/server.py", "serving/imagecodec.py", "models/yolo12_pose.py",
            "compression/slim.py", "export/quantize.py", "training/checkpoint.py",
            "ops/kernels/stencil_floor.py", "config.py", "losses.py", "metrics.py",
            "utils/logging.py", "training/optim.py", "training/state.py",
            "training/loop.py", "training/trainer.py", "data/warp.py", "data/augment.py",
            "data/synthetic.py", "data/preprocess.py", "data/dataset.py",
            "data/pipeline.py", "data/__init__.py", "export/onnx_proto.py",
            "export/onnx_optimize.py", "export/onnx_export.py", "export/onnx_torch_runner.py",
            "evaluation/__init__.py", "evaluation/segmentation.py", "evaluation/worstk.py",
            "utils/plots.py", "compression/prune.py", "compression/__init__.py",
            "evaluation/pose.py", "training/pose_trainer.py",
            "serving/artifact_backend.py", "parallel/space.py", "data/aug_policies.py",
            "data/corners.py", "datagen/downloaders.py", "datagen/inpaint.py",
            "datagen/watchdog.py", "utils/profiling.py"} <= names
    for f in files:
        text = f.read_text()
        assert not _JAX_IMPORT.search(text), f
        # a dotted module path of the JAX package (file paths in comments,
        # "mtg_card_image_segmentation_tpu/...", only name the reference)
        assert not re.search(r"\bmtg_card_image_segmentation_tpu\.", text), f
        assert not re.search(r"^\s*(import|from)\s+\S*orbax_to_torch_checkpoint", text, re.M), f
        assert "import_module(\"orbax_to_torch" not in text, f


def test_port_imports_with_jax_blocked():
    """Every port module, chip_smoke.py, the card's tools
    (tools/stencil_floor_torch.py, tools/fp32_conv_accuracy_torch.py,
    tools/distributed_step_torch.py, tools/profile_blocks_torch.py, the
    layout map and the fixture and analysis tools), the
    port's CLIs and its graft entry (graft_entry_torch.py) import in a
    process where importing jax, flax, orbax, optax or the JAX package
    fails."""
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).replace(".__init__", "")
        for p in PORT.rglob("*.py")
    )
    code = (
        "import sys, importlib\n"
        "for m in ('jax', 'flax', 'orbax', 'optax', 'mtg_card_image_segmentation_tpu'):\n"
        "    sys.modules[m] = None\n"
        "sys.path.insert(0, 'tools')\n"
        f"for m in {mods + ['chip_smoke', *TOOLS, *CLIS]!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_chip_smoke_fails_without_a_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result where CUDA is
    absent, and also from a directory that holds nothing else of the
    repo."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd, script in ((REPO, REPO / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((REPO / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
