"""``tools/half_conv_layout_torch.py`` on the CPU, at tiny sizes: the
capture of a path's half-precision conv calls, their merge over paths, the
measurement of one call in both layouts against float64, and the rule that
marks a combination wrong. On the card ``chip_smoke.py`` (phase ``tools``)
runs the tool over the port's paths at their real sizes."""

import sys
from pathlib import Path

import pytest
import torch

from mtg_card_image_segmentation_tpu_torch.serving.predictor import SegPredictor
from mtg_card_image_segmentation_tpu_torch.utils.params import init_flax_like

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

import half_conv_layout_torch as layout  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def weights():
    return init_flax_like(0)


def _u8(b, h, w):
    return torch.randint(0, 256, (b, h, w, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(0))


def test_capture_records_the_seg_models_convs(weights):
    """The bf16 stock-op seg path at 64x48 b2: the stem first (3 -> 16,
    3x3, stride 2), one depthwise per backbone block, every call of an
    NHWC map with more than one pixel run channels_last, and no float32
    call recorded (the float32 path records none)."""
    calls = layout.capture(lambda: SegPredictor(*weights, 64, 48, device="cpu",
                                                use_kernels=False).predict(_u8(2, 64, 48)))
    stem = calls[0]
    assert (stem["x"], stem["w"], stem["stride"], stem["padding"]) == (
        (2, 3, 64, 48), (16, 3, 3, 3), (2, 2), (1, 1))
    depthwise = [c for c in calls if c["groups"] > 1]
    assert len(depthwise) == 15 and all(c["groups"] == c["x"][1] for c in depthwise)
    assert {c["dilation"] for c in depthwise[12:]} == {(2, 2)}
    assert all(c["dtype"] == "bfloat16" for c in calls)
    assert all(c["layout"] == "channels_last" for c in calls if c["x"][2] * c["x"][3] > 1)
    assert layout.capture(lambda: SegPredictor(
        *weights, 64, 48, device="cpu", use_kernels=False,
        dtype=torch.float32).predict(_u8(2, 64, 48))) == []


def test_merge_keeps_one_case_per_call_with_its_paths(weights):
    """The same predictor captured as two paths gives each call once, with
    both paths and the layout it runs as."""
    fn = lambda: SegPredictor(*weights, 64, 48, device="cpu",  # noqa: E731
                              use_kernels=False).predict(_u8(2, 64, 48))
    one = layout.capture(fn)
    cases = layout.merge({"a": one, "b": layout.capture(fn)})
    assert len(cases) == len({layout._key(c) for c in one})
    for case in cases.values():
        assert case["paths"] == ["a", "b"] and set(case["executed"]) <= set(layout.LAYOUTS)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("call", [
    dict(transposed=False, x=(3, 24, 9, 7), w=(24, 1, 3, 3), bias=True, stride=(1, 1),
         padding=(1, 1), dilation=(1, 1), groups=24, output_padding=(0, 0)),
    dict(transposed=False, x=(1, 16, 12, 10), w=(24, 16, 5, 5), bias=False, stride=(2, 2),
         padding=(4, 4), dilation=(2, 2), groups=1, output_padding=(0, 0)),
    dict(transposed=True, x=(2, 8, 6, 5), w=(8, 4, 4, 4), bias=False, stride=(2, 2),
         padding=(1, 1), dilation=(1, 1), groups=1, output_padding=(0, 0)),
])
def test_measure_holds_a_right_conv_to_its_rounding(call, dtype):
    """A depthwise (bias, b3: images 0 and 2 held), a dilated strided dense
    conv (b1) and a transposed conv on the host in both layouts: the exact
    inputs leave only the output's rounding, so each row's error is at most
    the half type's unit roundoff, and the rule marks none wrong."""
    case = {**call, "dtype": dtype, "executed": {"channels_last": {"Mkldnn"}}}
    rows = layout.measure(case, "cpu")
    layout.judge(rows, dtype)
    assert [r["layout"] for r in rows] == list(layout.LAYOUTS)
    for r in rows:
        assert 0 <= r["rel_err"] <= layout.UNIT_ROUNDOFF[dtype] and not r["nan"]
        assert not r["wrong"]
    assert [r["executed"] for r in rows] == [False, True]


def test_judge_marks_nan_and_far_rows():
    """NaN is wrong in either layout; NCHW is wrong above 100x the larger of
    its channels_last error and the unit roundoff; channels_last above 100
    units of roundoff."""
    u = layout.UNIT_ROUNDOFF["float16"]

    def rows(nchw, cl, nan=False):
        r = [{"layout": "nchw", "rel_err": nchw, "nan": nan},
             {"layout": "channels_last", "rel_err": cl, "nan": False}]
        layout.judge(r, "float16")
        return [x["wrong"] for x in r]

    assert rows(u, u / 2) == [False, False]
    assert rows(99 * u, 0.0) == [False, False]
    assert rows(101 * u, 0.0) == [True, False]
    assert rows(150 * u, 2 * u) == [False, False]
    assert rows(0.0, 0.0, nan=True) == [True, False]
    assert rows(0.0, 101 * u) == [False, True]
    assert rows(float("nan"), 0.0) == [True, False]


def test_run_on_the_host_sums_the_map(weights):
    """``run`` over two tiny paths on the CPU: every distinct call measured
    in both layouts, the executed counts, and nothing wrong."""
    rec = layout.run("cpu", paths={
        "stock": lambda: SegPredictor(*weights, 64, 48, device="cpu",
                                      use_kernels=False).predict(_u8(2, 64, 48)),
        "kernels": lambda: SegPredictor(*weights, 64, 48, device="cpu").predict(_u8(1, 64, 48))})
    n = rec["distinct_calls"]
    assert set(rec["by_dtype_layout"]) == {"bfloat16/nchw", "bfloat16/channels_last"}
    assert all(s["calls"] == n for s in rec["by_dtype_layout"].values())
    assert sum(s["executed"] for s in rec["by_dtype_layout"].values()) >= n
    assert rec["wrong_executed"] == [] and rec["wrong_not_executed"] == []
    assert rec["device"] == "host CPU" and rec["nvidia_smi"] is None


def test_the_map_needs_the_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert layout.main([]) == 2
    assert "needs a CUDA card" in capsys.readouterr().err
