"""The metric arithmetic on made-up records: a rate over the whole window,
a p95 over every batch, idle as the union over the whole slice, the
roofline by the larger of bytes and operations, and the frozen work counts
at the kernels' main-path shapes against the bounds the port's table of
kernels gives (0.0106, 0.258 and 0.1056 ms)."""

from types import SimpleNamespace

import pytest

import core
from peaks import BF16_TENSOR_FLOPS, FP32_FLOPS, HBM_BYTES_PER_S, bound_s


def window(times, images=128, seconds=10.0):
    win = core.Window(t_start=0.0, t_end=seconds)
    for k, (hand, done) in enumerate(times):
        win.items.append(core.Item(k, hand, hand + 0.001, done, images))
    return SimpleNamespace(window=win, seconds=seconds, trace=None)


def metric(name):
    return core.load_module(f"metrics/{name}.py").read


def test_rate_counts_every_image_done_in_the_window_over_its_seconds():
    run = window([(0.1 * k, 0.1 * k + 0.05) for k in range(100)] + [(9.99, 10.2)])
    assert metric("serve_images_per_s")(run) == pytest.approx(100 * 128 / 10.0)


def test_p95_is_over_every_batch_not_a_median_of_chunks():
    # 95 batches of 10 ms, 5 of 100 ms: the tail is the slow ones' edge
    times = [(k * 0.2, k * 0.2 + (0.1 if k % 20 == 19 else 0.01)) for k in range(100)]
    got = metric("serve_batch_ms_p95")(window(times, seconds=30.0))
    ms = sorted(d - h for h, d in times)
    want = 1e3 * (ms[94] + 0.05 * (ms[95] - ms[94]))  # inclusive method at 95 of 100
    assert got == pytest.approx(want)
    assert 10.0 < got < 100.0


def trace(device, t0=0.0, t1=1000.0, items=4):
    its = [core.Item(k, 0, 0.002, 0.01, 128, True) for k in range(items)]
    return core.Trace(t0, t1, list(device), [("in the harness, between calls", t0, t1)], its)


def test_idle_is_the_union_over_the_whole_slice():
    # overlapping kernels 100-300 and 200-400, one more 600-700; host gaps
    # before, between and after count as idle
    tr = trace([("a", 100, 300), ("b", 200, 400), ("c", 600, 700)])
    run = SimpleNamespace(trace=tr)
    assert tr.busy_us() == 400
    assert metric("idle_share.serve")(run) == pytest.approx(60.0)
    assert [(round(a), round(b)) for a, b in tr.gaps()] == [(0, 100), (400, 600), (700, 1000)]


def test_breakdown_names_the_host_operation_under_each_gap():
    tr = trace([("k1", 100, 300), ("k2", 600, 700)])
    tr.host = [("in the harness, between calls", 0, 1000), ("in the program's call", 300, 650)]
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["k1", pytest.approx(200e-6)]
    gaps = dict((n, v) for n, v in bd["idle_gaps"])
    assert gaps["in the program's call"] == pytest.approx(300e-6)
    assert gaps["in the harness, between calls"] == pytest.approx(400e-6)


def test_roofline_takes_the_larger_of_bytes_and_operations():
    t, by = bound_s(3.35e12, tensor_flops=0.0, fp32_flops=67e12 / 2)
    assert (t, by) == (pytest.approx(1.0), "bytes")
    t, by = bound_s(1.0, tensor_flops=2 * BF16_TENSOR_FLOPS, fp32_flops=FP32_FLOPS)
    assert (t, by) == (pytest.approx(2.0), "operations")
    assert HBM_BYTES_PER_S == 3.35e12


def test_roofline_metric_is_bound_over_kernel_time_per_batch():
    cell = {"traffic_params": {"batch": 128, "height": 512, "width": 512}}
    cfg = core.load_json("configs/seg-mnv3l-lraspp.json")
    least, _ = bound_s(*core.load_module("work/fused_mask_decode.py").count(cell, cfg))
    # two batches, 40 us of the decode kernel each: share = least / 40 us
    tr = trace([("void mask_decode_kernel(float const*)", 0, 40),
                ("mask_decode_kernel", 100, 140), ("void other_kernel<1>()", 200, 900)], items=2)
    run = SimpleNamespace(trace=tr, cell=cell, cfg=cfg, work=core.load_module)
    got = core.load_module("metrics/fused_mask_decode_roofline.py").read(run)
    assert got == pytest.approx(100.0 * least / 40e-6)
    none = SimpleNamespace(trace=trace([("void other_kernel<1>()", 0, 10)]), cell=cell, cfg=cfg,
                           work=core.load_module)
    assert core.load_module("metrics/fused_mask_decode_roofline.py").read(none) is None


@pytest.mark.parametrize("work, shape, cfg, want_ms, by", [
    ("fused_mask_decode", (128, 512, 512), "seg-mnv3l-lraspp", 0.0106, "bytes"),
    ("fused_tail_chain", (128, 512, 512), "seg-mnv3l-lraspp", 0.258, "operations"),
    ("fused_normalize", (128, 480, 640), "pose-hrnet-w18s", 0.1056, "bytes"),
])
def test_work_counts_match_the_kernel_table(work, shape, cfg, want_ms, by):
    b, h, w = shape
    cell = {"traffic_params": {"batch": b, "height": h, "width": w}}
    t, got_by = bound_s(*core.load_module(f"work/{work}.py").count(cell, core.load_json(
        f"configs/{cfg}.json")))
    assert t * 1e3 == pytest.approx(want_ms, rel=5e-3)
    assert got_by == by


def test_library_time_leaves_out_the_ports_kernels_and_copies():
    own = sorted(core.port_kernel_names())
    assert {"mask_decode_kernel", "pw_gemm_kernel", "normalize_kernel"} <= set(own)
    tr = trace([("void mask_decode_kernel(float const*)", 0, 40), ("Memcpy HtoD (Pinned -> Device)", 40, 90),
                ("void cudnn::conv_kernel<3>()", 100, 400)], items=2)
    run = SimpleNamespace(trace=tr)
    assert core.load_module("metrics/library_ms.serve.py").read(run) == pytest.approx(0.15)
    assert core.load_module("metrics/upload_ms.serve.py").read(run) == pytest.approx(0.025)


def test_model_flops_count_every_conv():
    cfg = core.load_json("configs/seg-mnv3l-lraspp.json")
    f = core.load_module("work/seg-mnv3l-lraspp.py").forward_flops(cfg, 512, 512)
    # the stem alone: 2 * (256 * 256 outputs) * 16 channels * 27 taps
    assert f > 2 * 256 * 256 * 16 * 27
    assert f == core.load_module("work/seg-mnv3l-lraspp.py").forward_flops(cfg, 512, 512)
    g = core.load_module("work/seg-mnv3l-lraspp.py").forward_flops(cfg, 256, 256)
    assert f / g == pytest.approx(4.0, rel=0.02)


class ScriptedEvent:
    """A timing event whose completion the test sets: the card's clock is
    the list ``CARD`` of completion times, one per event in record order."""
    CARD: list = []

    def __init__(self):
        self.t = None

    def record(self):
        self.t = ScriptedEvent.CARD.pop(0)

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def test_completion_is_the_cards_time_not_the_clients_wait():
    """The client takes 30 ms a turn and waits for a batch only after
    handing over the next; the card finishes each batch 5 ms after its
    call returns. Each batch is stamped done at the card's time, mapped
    onto the host's clock from the first (base) event, not 30 ms later."""
    import time

    turn = 0.03

    def step(k):
        time.sleep(turn)
        return None, 128

    t0 = time.perf_counter()
    ScriptedEvent.CARD = [t0] + [t0 + 1.0 + k for k in range(100)]
    clock = core.CardClock(None, ScriptedEvent)
    assert clock.t_base == pytest.approx(t0, abs=0.05)
    # the base stands for the host time of its stamp; later events keep
    # their offsets from it
    ev = ScriptedEvent()
    ev.record()
    assert clock.done(ev) - clock.t_base == pytest.approx(1.0)

    # a window: the card finishes batch k 5 ms after its call returned
    calls = []

    class Card(ScriptedEvent):
        def record(self):
            self.t = time.perf_counter() + 0.005 if calls else time.perf_counter()
            calls.append(self.t)

    win = core.closed_loop(SimpleNamespace(), step, 0.3, 1, set(), event=Card)
    assert len(win.items) >= 5
    for item in win.items:
        assert item.t_done - item.t_ret == pytest.approx(0.005, abs=0.003)
        assert item.t_done - item.t_hand < 1.5 * turn

