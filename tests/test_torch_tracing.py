"""The port's spans (``utils/profiling.py``) on the CPU, at small sizes on
the kernels' plain versions: nothing is recorded without a profiler; under
one, ``SegPredictor`` and ``PosePredictor`` record their span trees (names,
layers, parents, children inside their parents, one root per call) and give
the same outputs as with no profiler; a span's ``launches`` counts the
launches made inside it; the buffer stays bounded; threads keep their own
trees."""

import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mtg_card_image_segmentation_tpu_torch.ops.kernels import _build
from mtg_card_image_segmentation_tpu_torch.serving.pose_predictor import PosePredictor
from mtg_card_image_segmentation_tpu_torch.serving.predictor import SegPredictor
from mtg_card_image_segmentation_tpu_torch.utils import profiling
from mtg_card_image_segmentation_tpu_torch.utils.params import (
    init_flax_like,
    init_hrnet_flax_like,
)

torch.set_num_threads(2)

B, H, W = 2, 64, 64
PH, PW, HM = 64, 96, (16, 24)


@pytest.fixture(scope="module")
def seg_weights():
    return init_flax_like(0)


@pytest.fixture(scope="module")
def pose_weights():
    return init_hrnet_flax_like(0)


def images(h, w, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (B, h, w, 3), np.uint8)


def recorded(fn):
    """``fn()``'s result under a CPU profiler, and the spans it recorded."""
    before = {r.id for r in profiling.spans()}
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, [r for r in profiling.spans() if r.id not in before]


def trees(recs):
    """Each root's (name, layer) and its children's, in start order, with
    every record's parent among the records and inside it."""
    by_id = {r.id: r for r in recs}
    kids = {}
    for r in recs:
        if r.parent is not None:
            parent = by_id[r.parent]
            assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns, (parent, r)
            kids.setdefault(r.parent, []).append(r)

    def node(r):
        return ((r.name, r.layer),
                [node(k) for k in sorted(kids.get(r.id, []), key=lambda k: k.start_ns)])

    roots = sorted((r for r in recs if r.parent is None), key=lambda r: r.start_ns)
    return [node(r) for r in roots]


SEG_OPTIONS = {
    "default": {},
    "fused_stem_and_head": {"fused_stem": True, "fused_head": True},
    "per_block_kernels": {"fused_blocks": tuple(range(15)), "fused_chain": False},
    "reference_path": {"use_kernels": False},
}


@pytest.mark.parametrize("option", sorted(SEG_OPTIONS))
def test_seg_predictor_records_its_span_tree(seg_weights, option):
    """One ``seg.predict`` root per call over the upload, the stem, each
    block that runs as its module and the head (the kernels' plain
    versions record no kernel span); the reference path is one stock
    span."""
    pred = SegPredictor(*seg_weights, H, W, device="cpu", **SEG_OPTIONS[option])
    x = images(H, W)
    _, recs = recorded(lambda: [pred.predict(x) for _ in range(2)])
    if option == "reference_path":
        inner = [(("seg.model", "stock"), [])]
    else:
        # the centering (or the stem kernel's call), then the stem conv;
        # head_conv, then the head's stock part
        stems = 1 if pred.fused_stem else 2
        modules = 15 - len(pred.kernel_blocks)
        inner = ([(("seg.stem", "stock"), [])] * stems
                 + [(("seg.block", "stock"), [])] * modules + [(("seg.head", "stock"), [])] * 2)
    want = (("seg.predict", "entry"), [(("seg.upload", "entry"), [])] + inner)
    assert trees(recs) == [want, want]
    assert all(r.launches == 0 for r in recs)


@pytest.mark.parametrize("use_kernels, refine", [(True, True), (False, False)])
def test_pose_predictor_records_its_span_tree(pose_weights, use_kernels, refine):
    """``pose.heatmaps`` over the upload, the stock normalize (only with
    ``use_kernels=False``), the backbone and the head; ``pose.decode`` over
    the peaks: two roots per ``predict``."""
    pred = PosePredictor(*pose_weights, PH, PW, heatmap_hw=HM, device="cpu",
                         use_kernels=use_kernels, refine=refine)
    _, recs = recorded(lambda: pred.predict(images(PH, PW)))
    normalize = [] if use_kernels else [(("pose.normalize", "stock"), [])]
    assert trees(recs) == [
        (("pose.heatmaps", "entry"), [(("pose.upload", "entry"), [])] + normalize
         + [(("pose.backbone", "stock"), []), (("pose.head", "stock"), [])]),
        (("pose.decode", "entry"), [(("pose.peaks", "stock"), [])]),
    ]


def test_no_span_is_recorded_without_a_profiler(seg_weights, pose_weights):
    before = profiling.spans()
    SegPredictor(*seg_weights, H, W, device="cpu").predict(images(H, W))
    PosePredictor(*pose_weights, PH, PW, heatmap_hw=HM, device="cpu").predict(images(PH, PW))
    assert profiling.spans() == before
    assert profiling._OPEN == [] and profiling._STACK.frames == []


def test_outputs_are_identical_with_spans_on_and_off(seg_weights, pose_weights):
    seg = SegPredictor(*seg_weights, H, W, device="cpu")
    pose = PosePredictor(*pose_weights, PH, PW, heatmap_hw=HM, device="cpu")
    xs, xp = images(H, W, seed=5), images(PH, PW, seed=6)
    off = (seg.predict(xs), pose.heatmaps(xp), *pose.predict(xp))
    on, recs = recorded(lambda: (seg.predict(xs), pose.heatmaps(xp), *pose.predict(xp)))
    assert recs
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and torch.equal(a, b)


OUTER = profiling.Span("test.outer", "entry")
STUB = profiling.Span("kernel.stub", "kernels")


def stub_kernel(launches: int) -> None:
    """A kernel wrapper's shape: its span around the launches it counts."""
    with STUB:
        for _ in range(launches):
            _build.count("stub")


def test_launches_count_the_launches_made_inside_a_span():
    def path():
        with OUTER:
            stub_kernel(3)
            _build.count("stub")
            stub_kernel(2)

    try:
        _, recs = recorded(path)
    finally:
        with _build._COUNT_LOCK:
            _build.LAUNCHES.pop("stub", None)
    stubs = [r for r in recs if r.name == "kernel.stub"]
    (outer,) = [r for r in recs if r.name == "test.outer"]
    assert [r.launches for r in stubs] == [3, 2]
    assert outer.launches == 6 and all(r.parent == outer.id for r in stubs)


def test_the_buffer_stays_bounded():
    def many():
        for _ in range(profiling.MAX_RECORDS + 10):
            with STUB:
                pass

    _, recs = recorded(many)
    kept = profiling.spans()
    assert len(kept) == profiling.MAX_RECORDS
    assert kept[-1].id == recs[-1].id and kept[0].id == recs[-1].id - profiling.MAX_RECORDS + 1


def test_an_unknown_layer_is_refused():
    with pytest.raises(ValueError, match="layer"):
        profiling.Span("x", "device")


def test_threads_keep_their_own_trees():
    """More threads than cores, a short switch interval: every record's
    parent is the span open around it on its own thread, and no count of
    open spans is lost."""
    n = 12
    outer = [profiling.Span(f"test.thread{i}", "entry") for i in range(n)]
    inner = [profiling.Span(f"test.inner{i}", "stock") for i in range(n)]
    barrier = threading.Barrier(n)

    def work(i):
        barrier.wait(timeout=30)
        for _ in range(200):
            with outer[i]:
                with inner[i]:
                    pass

    def run():
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _, recs = recorded(run)
    finally:
        sys.setswitchinterval(old)
    by_id = {r.id: r for r in recs}
    inners = [r for r in recs if r.name.startswith("test.inner")]
    assert len(inners) == n * 200 and len(recs) == 2 * len(inners)
    for r in inners:
        parent = by_id[r.parent]
        assert parent.name == r.name.replace("inner", "thread") and parent.parent is None
        assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns
    assert profiling._OPEN == []
