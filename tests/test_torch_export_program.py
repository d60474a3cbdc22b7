"""The port's ``torch.export`` artifact against the JAX package's StableHLO
artifact, on the CPU: for seg (64x48), HRNet (64x96, 16x24 heatmaps) and
YOLO12n-pose (64x64, folded), the same seeded weights go through JAX
``export/stablehlo.py::export_stablehlo`` and the port's
``export/torch_export.py::export_program``; both artifacts run from disk on
the same seeded input and agree in float32 to 1e-4 of the largest output
(YOLO: 1e-3 px on the pixel rows, 1e-5 on the probability rows). Then the
self-test and the sidecar, ``load_program`` on a package directory, a
truncated file (it raises, with no fallback), ``move_to_device_pass`` on
the YOLO program (whose anchor grid writes its device into the graph), and
the eager model after a trace.
"""

import json
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mtg_card_image_segmentation_tpu.export import fold_batch_norm as jax_fold
from mtg_card_image_segmentation_tpu.export.stablehlo import export_stablehlo
from mtg_card_image_segmentation_tpu.models import create_model as jax_create_model
from mtg_card_image_segmentation_tpu.models import yolo12_pose as jax_yolo
from mtg_card_image_segmentation_tpu.serving import artifact_backend as jax_backend

from mtg_card_image_segmentation_tpu_torch.export.fold_bn import fold_batch_norm
from mtg_card_image_segmentation_tpu_torch.export.torch_export import (
    FORMAT,
    NCHW,
    YoloOutput0,
    export_program,
)
from mtg_card_image_segmentation_tpu_torch.serving import artifact_backend
from mtg_card_image_segmentation_tpu_torch.utils.params import (
    from_flax,
    hrnet_from_flax,
    init_flax_like,
    init_hrnet_flax_like,
    init_yolo_flax_like,
    yolo_from_flax,
)

torch.set_num_threads(2)

HW = {"seg": (64, 48), "hrnet": (64, 96), "yolo": (64, 64)}
HM = (16, 24)
FAMILIES = ("seg", "hrnet", "yolo")


def _port_module(family):
    if family == "seg":
        return NCHW(from_flax(*init_flax_like(0), dtype=torch.float32))
    if family == "hrnet":
        return NCHW(hrnet_from_flax(*init_hrnet_flax_like(0), HM, dtype=torch.float32))
    return YoloOutput0(yolo_from_flax(fold_batch_norm(*init_yolo_flax_like(0)), None,
                                      dtype=torch.float32))


def _jax_fn(family):
    """The JAX export CLIs' functions (``export_seg.py``'s and
    ``export_pose.py``'s ``_nchw_fn``, ``export_yolo.py``'s
    ``_output0_fn``) on the same trees."""
    if family == "yolo":
        model = jax_yolo.YOLO12Pose(fold_bn=True, dtype=jnp.float32)
        folded = jax.tree.map(jnp.asarray, jax_fold(*init_yolo_flax_like(0)))

        def output0(x):
            boxes, scores, kpts = model.apply({"params": folded},
                                              jnp.transpose(x, (0, 2, 3, 1)), train=False)
            kk = jnp.transpose(kpts, (0, 2, 3, 1)).reshape(x.shape[0], -1, boxes.shape[1])
            return jnp.concatenate([jnp.moveaxis(boxes, 1, 2), jnp.moveaxis(scores, 1, 2), kk],
                                   axis=1)

        return output0
    if family == "seg":
        model = jax_create_model("lraspp_mobilenet_v3_large", compute_dtype="float32")
        tree = init_flax_like(0)
    else:
        model = jax_create_model("hrnet_pose", heatmap_height=HM[0], heatmap_width=HM[1],
                                 compute_dtype="float32")
        tree = init_hrnet_flax_like(0)
    variables = {"params": jax.tree.map(jnp.asarray, tree[0]),
                 "batch_stats": jax.tree.map(jnp.asarray, tree[1])}

    def nchw(x):
        out = model.apply(variables, jnp.transpose(x, (0, 2, 3, 1)), train=False)
        return jnp.transpose(out, (0, 3, 1, 2))

    return nchw


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Each family's package directory holding the port's program and the
    JAX package's StableHLO artifact, both exported at batch 1 from zeros,
    and the port's sidecar dicts."""
    root = tmp_path_factory.mktemp("programs")
    out = {}
    for family in FAMILIES:
        h, w = HW[family]
        d = root / family
        d.mkdir()
        info = export_program(_port_module(family), (torch.zeros(1, 3, h, w),),
                              str(d / artifact_backend.PROGRAM_NAMES[family]))
        with jax.default_matmul_precision("float32"):
            export_stablehlo(_jax_fn(family), (jnp.zeros((1, 3, h, w), jnp.float32),),
                             str(d / jax_backend.STABLEHLO_NAMES[family]))
        out[family] = (d, info)
    return out


def _probe(family):
    h, w = HW[family]
    return np.random.default_rng(7).random((1, 3, h, w)).astype(np.float32)


@pytest.mark.parametrize("family", FAMILIES)
def test_program_agrees_with_the_jax_stablehlo_artifact(artifacts, family):
    d, _ = artifacts[family]
    x = _probe(family)
    got = artifact_backend.load_program(str(d), family, "cpu")[0](x)
    want = jax_backend.load_stablehlo(str(d), family)[0](x)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    if family != "yolo":
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
        return
    n = got.shape[1]
    prob = [4] + [i for i in range(5, n) if (i - 5) % 3 == 2]
    px = [i for i in range(n) if i not in prob]
    assert np.abs(got[:, px] - want[:, px]).max() <= 1e-3
    assert np.abs(got[:, prob] - want[:, prob]).max() <= 1e-5


@pytest.mark.parametrize("family", FAMILIES)
def test_self_test_and_sidecar(artifacts, family):
    d, info = artifacts[family]
    path = d / artifact_backend.PROGRAM_NAMES[family]
    assert json.loads((d / (path.name + ".json")).read_text()) == info
    assert info["format"] == FORMAT and info["device"] == "cpu"
    assert info["self_test_pass"] and info["self_test_max_diff"] < 1e-5
    assert info["bytes"] == path.stat().st_size
    assert info["torch_version"] == torch.__version__
    h, w = HW[family]
    assert info["inputs"] == [f"float32[1, 3, {h}, {w}]"]
    want = {"seg": [1, 2, h, w], "hrnet": [1, 4, *HM], "yolo": [1, 17, 84]}[family]
    assert info["outputs"] == [f"float32{want}"]


def test_program_names_follow_the_jax_names():
    assert set(artifact_backend.PROGRAM_NAMES) == set(jax_backend.STABLEHLO_NAMES)
    for family, name in jax_backend.STABLEHLO_NAMES.items():
        assert artifact_backend.PROGRAM_NAMES[family] == name.replace(".stablehlo", ".pt2")


def test_a_truncated_program_raises_without_fallback(artifacts, tmp_path):
    """A package whose program is cut short raises, though its StableHLO
    artifact and a whole ``.pt2`` copy under another name sit beside it."""
    src, _ = artifacts["seg"]
    d = tmp_path / "pkg"
    shutil.copytree(src, d)
    name = artifact_backend.PROGRAM_NAMES["seg"]
    shutil.copyfile(d / name, d / "spare.pt2")
    blob = (d / name).read_bytes()
    (d / name).write_bytes(blob[: len(blob) // 2])
    with pytest.raises(Exception):
        artifact_backend.load_program(str(d), "seg", "cpu")
    fn, chosen = artifact_backend.load_program(str(d / "spare.pt2"), "seg", "cpu")
    assert chosen.endswith("spare.pt2") and fn(_probe("seg")).shape == (1, 2, *HW["seg"])


def test_yolo_program_moved_by_the_device_pass(artifacts):
    """The YOLO graph's anchor grid carries the export device in its
    ``arange`` nodes; ``move_to_device_pass`` to the CPU gives the same
    output as the loaded program and as the model."""
    from torch.export.passes import move_to_device_pass

    d, _ = artifacts["yolo"]
    program = torch.export.load(str(d / artifact_backend.PROGRAM_NAMES["yolo"]))
    devices = {n.kwargs["device"] for n in program.graph.nodes
               if n.op == "call_function" and "device" in n.kwargs}
    assert devices == {torch.device("cpu")}
    x = torch.from_numpy(_probe("yolo"))
    moved = move_to_device_pass(program, "cpu").module()
    with torch.no_grad():
        want = _port_module("yolo").eval()(x)
        assert torch.equal(moved(x), program.module()(x))
        assert torch.allclose(moved(x), want, rtol=0, atol=1e-4)


def test_the_eager_model_computes_after_a_trace(tmp_path):
    """A trace makes fake tensors; the bilinear resize's coordinate cache
    must not keep them (it did: the seg model's next eager call returned a
    FakeTensor)."""
    from mtg_card_image_segmentation_tpu_torch.ops import resize

    module = _port_module("seg").eval()
    x = torch.from_numpy(_probe("seg"))
    with torch.no_grad():
        before = module(x)
        resize._device_coords.cache_clear()  # the trace is the first to ask
        export_program(module, (torch.zeros(1, 3, *HW["seg"]),), str(tmp_path / "m.pt2"),
                       self_test=False)
        after = module(x)
    assert type(after) is torch.Tensor and torch.equal(before, after)
