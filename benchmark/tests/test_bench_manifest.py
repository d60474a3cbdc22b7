"""``BENCHMARK.json`` against the benchmark's contract: names, units and
keys, every file that a name points to, and what each cell reports."""

import json
import re

import pytest

import core

MAN = core.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert len((core.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    assert MAN["paths"] == ["benchmark"]
    assert all(one_line(w) and not w.startswith("/") and ".." not in w for w in MAN["command"])


def test_names_are_unique_and_well_formed():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MAN[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group == "configs", e["name"]))
    assert len(names) == len(set(names))
    for e in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(e["unit"]), e["unit"]
        assert e["better"] in ("lower", "higher")


def test_configs_name_their_source_and_file():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        cfg = json.loads((core.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert c["reduced"] == cfg["reduced"] == []
        assert all(one_line(a) for a in cfg["assumed"])
        leaves = cfg["leaves"]["params"]
        assert sum(int(__import__("math").prod(s)) for _, s, *_ in leaves) == cfg["parameters"]
        assert (core.BENCH / "reference" / f"{c['name']}.py").exists()
        assert (core.BENCH / "work" / f"{c['name']}.py").exists()


def test_cells_point_at_their_files():
    cfgs = {c["name"] for c in MAN["configs"]}
    pairs = {(w["config"], w["traffic"]) for w in MAN["workloads"]}
    assert len(pairs) == len(MAN["workloads"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in cfgs and w["chips"] == 1 and one_line(w["why"])
        assert NAME.match(w["traffic"])
        cell = core.load_json(f"workloads/{w['name']}.json")
        assert {k: cell[k] for k in ("name", "config", "traffic", "chips", "why")} == w
        mix = core.load_json(f"traffic/{w['traffic']}.json")
        assert (core.BENCH / "generators" / f"{mix['generator']}.py").exists()
        assert (core.BENCH / "programs" / f"{cell['program']}.py").exists()
        assert cell["limits"] and all(v is not None for v in cell["limits"].values())


def test_metrics_have_readers_and_cells_report_enough():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert METRIC_KEYS | {"bound"} <= set(m) <= METRIC_KEYS | {"bound", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) == METRIC_KEYS | {"layer", "moves", "workloads"}
        assert m["moves"] in e2e and one_line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert (core.BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]
    for w in MAN["workloads"]:
        reported = {m["name"] for m in core.cell_metrics(MAN, w["name"], False)}
        assert "setup_s" in reported and len(reported) >= 2
        layer = core.cell_metrics(MAN, w["name"], True)
        assert layer
        for m in layer:  # each per-layer metric moves an end-to-end one of the cell
            assert m["moves"] in reported


@pytest.mark.parametrize("layer", sorted({m["layer"] for m in MAN["per_layer"]}))
def test_layers_are_named_one_way(layer):
    assert layer in ("Entry", "Stock backbone and head", "Kernels", "Train step", "Device")
