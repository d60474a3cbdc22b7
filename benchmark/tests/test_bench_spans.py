"""The readers of the port's spans (``program_spans.py`` and its seven
metrics) on made-up slices and records: the anchor that puts spans on the
slice's clock, self time of nested spans, the idle split by overlap (the
three layers and the harness's share add up to the slice's idle time),
clipping to the slice, and nothing to read where spans are missing."""

from types import SimpleNamespace

import pytest

import core
import program_spans
from mtg_card_image_segmentation_tpu_torch.utils.profiling import SpanRecord

PC0 = 5000.0  # perf_counter seconds at the slice's 0


def item(k, hand_us, ret_us):
    return core.Item(k, PC0 + hand_us * 1e-6, PC0 + ret_us * 1e-6, images=128, traced=True)


def slice_of(device, calls=((100, 400), (500, 800)), t1=1000.0):
    """A traced slice as ``Trace.read`` builds it: the program's calls
    first, in item order, then the harness's spans between them."""
    items = [item(k, s, e) for k, (s, e) in enumerate(calls)]
    host = [("in the program's call", s, e) for s, e in calls]
    host += [("in the harness, between calls", a[1], b[0]) for a, b in zip(calls, calls[1:])]
    return core.Trace(0.0, t1, list(device), host, items)


def ns(us):
    return round((PC0 * 1e6 + us) * 1e3)


def rec(sid, parent, name, layer, start_us, end_us, launches=0):
    return SpanRecord(sid, parent, name, layer, ns(start_us), ns(end_us), launches)


def batch(base, offset):
    """One seg call's tree at ``offset`` us: predict [10, 290] over upload
    [20, 50] (entry), stem [50, 100], a block [100, 140] (stock) and the
    chain [150, 200] (kernels, 12 launches); the block holds a kernel
    [110, 130] (1 launch)."""
    o = offset
    return [
        rec(base + 1, base, "seg.upload", "entry", o + 20, o + 50),
        rec(base + 2, base, "seg.stem", "stock", o + 50, o + 100),
        rec(base + 4, base + 3, "kernel.fused_inverted_residual", "kernels", o + 110, o + 130, 1),
        rec(base + 3, base, "seg.block", "stock", o + 100, o + 140, 1),
        rec(base + 5, base, "kernel.fused_tail_chain", "kernels", o + 150, o + 200, 12),
        rec(base, None, "seg.predict", "entry", o + 10, o + 290, 13),
    ]


RECS = batch(10, 100) + batch(20, 500)


def test_spans_are_put_on_the_slices_clock_by_the_first_calls_anchor():
    # items handed over at perf_counter PC0 + 300 and + 700 us, which the
    # slice puts at 250 and 650 us: a span stamped at PC0 + 310 us sits at 260
    tr = slice_of([("a", 0, 255), ("b", 265, 1150)], calls=((250, 550), (650, 950)),
                  t1=1150.0)
    tr.items = [item(0, 300, 600), item(1, 700, 1000)]
    got = program_spans.measure(tr, batch(10, 300) + batch(20, 700))
    assert got.batches == 2
    # the gap [255, 265]: 5 us before the root's start at 260, 5 us in its self time
    assert got.idle_us == pytest.approx({"entry": 5.0, "stock": 0.0, "kernels": 0.0})
    assert got.harness_idle_us == pytest.approx(5.0)


def test_self_time_takes_out_what_children_cover():
    got = program_spans.measure(slice_of([]), RECS)
    # per batch: predict 280 - (30 + 50 + 40 + 50) = 110, upload 30
    assert got.self_us["entry"] == pytest.approx(2 * (110 + 30))
    # stem 50, block 40 - 20
    assert got.self_us["stock"] == pytest.approx(2 * (50 + 20))
    # the block's kernel 20, the chain 50
    assert got.self_us["kernels"] == pytest.approx(2 * (20 + 50))
    assert got.host_ms("entry") == pytest.approx(0.140)
    assert got.launches == 26


def test_idle_is_split_by_overlap_and_adds_up_to_the_slice():
    # busy [0, 125], [250, 700], [760, 1000]
    device = [("a", 0, 125), ("b", 250, 700), ("c", 760, 1000)]
    tr = slice_of(device)
    got = program_spans.measure(tr, RECS)
    # gap [125, 250]: upload [125, 150] 25, stem 50, block [200, 210] and
    # [230, 240] 20, its kernel [210, 230] 20, predict [240, 250] 10;
    # gap [700, 760]: the second predict's self time [700, 790]
    assert got.idle_us["entry"] == pytest.approx(25 + 10 + 60)
    assert got.idle_us["stock"] == pytest.approx(50 + 20)
    assert got.idle_us["kernels"] == pytest.approx(20)
    assert got.harness_idle_us == pytest.approx(0, abs=1e-9)
    idle = (tr.t1 - tr.t0) - tr.busy_us()
    assert idle == pytest.approx(185)
    assert sum(got.idle_us.values()) + got.harness_idle_us == pytest.approx(idle, abs=1e-9)


def test_the_harness_keeps_the_idle_no_span_covers():
    tr = slice_of([("a", 0, 50), ("b", 950, 1000)])
    got = program_spans.measure(tr, RECS)
    # idle [50, 950]: the spans cover [110, 390] and [510, 790] (560 us);
    # the rest, 340 us, is the harness's
    assert sum(got.idle_us.values()) == pytest.approx(560)
    assert got.harness_idle_us == pytest.approx(900 - 560)
    assert sum(got.idle_us.values()) + got.harness_idle_us == pytest.approx(
        tr.t1 - tr.busy_us())


def test_spans_outside_the_slice_are_left_out():
    early = batch(40, -400)  # a call before the slice, as from a warm-up under a profiler
    late = batch(50, 1100)  # after its end
    got = program_spans.measure(slice_of([]), early + RECS + late)
    assert got.launches == 26 and got.self_us["kernels"] == pytest.approx(140)


@pytest.mark.parametrize("case", ["no_records", "root_missing", "root_outside_a_call",
                                  "other_roots"])
def test_nothing_to_read_where_spans_are_missing(case):
    tr = slice_of([])
    recs = {"no_records": [],
            "root_missing": batch(10, 100),
            "root_outside_a_call": RECS + [rec(99, None, "seg.predict", "entry", 420, 480)],
            "other_roots": batch(10, 100) + [rec(99, None, "pose.decode", "entry", 510, 790)],
            }[case]
    assert program_spans.measure(tr, recs) is None


NAMES = ["entry_host_ms.serve", "stock_host_ms.serve", "kernel_host_ms.serve",
         "entry_idle_ms.serve", "stock_idle_ms.serve", "kernel_idle_ms.serve",
         "kernel_launches.serve"]


def read(name, run):
    return core.load_module(f"metrics/{name}.py").read(run)


def test_the_readers_report_per_batch(monkeypatch):
    monkeypatch.setattr(program_spans, "records", lambda: RECS)
    device = [("a", 0, 125), ("b", 250, 700), ("c", 760, 1000)]
    run = SimpleNamespace(trace=slice_of(device))
    got = {n: read(n, run) for n in NAMES}
    assert got == pytest.approx({
        "entry_host_ms.serve": 0.140, "stock_host_ms.serve": 0.070,
        "kernel_host_ms.serve": 0.070, "entry_idle_ms.serve": 0.0475,
        "stock_idle_ms.serve": 0.035, "kernel_idle_ms.serve": 0.010,
        "kernel_launches.serve": 13.0})


def test_the_readers_report_nothing_from_a_program_without_spans(monkeypatch):
    monkeypatch.setattr(program_spans, "records", lambda: None)
    run = SimpleNamespace(trace=slice_of([("a", 0, 10)]))
    assert [read(n, run) for n in NAMES] == [None] * len(NAMES)
    assert all(read(n, SimpleNamespace(trace=None)) is None for n in NAMES)

