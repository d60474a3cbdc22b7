"""Run one cell of the benchmark of the PyTorch/CUDA port on this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's files are found by name (``benchmark/workloads/<cell>.json``,
its configuration, its traffic mix and the mix's generator, its program
and its reference). The run makes its
weights and inputs from ``--seed`` on the card, builds the port's entry for
the configuration, warms up the cell's own shapes (``setup_s``: from the
start of this process to the first timed batch, less the reference's own
seconds in it), measures for
``--seconds``, then judges what the timed path produced against the plain
reference. Untraced, it reports the cell's end-to-end metrics; with
``--trace 1`` a slice of the window runs under ``torch.profiler`` and it
reports the per-layer metrics. The last line of standard output is one
JSON object; the numbers that decide ``correct`` close standard error and
the result line.

It exits 2 without printing a result when no CUDA card is there (or fewer
than the cell asks for), and 1 when JAX, Flax, optax or the JAX package
was loaded (named on standard error).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="put the cell's control (the reference in the next lower precision) "
                         "in the program's place; its run has to read not correct")
    ap.add_argument("--fault", default="none",
                    help="plant a fault under the timed path (programs/faults.py); "
                         "its run has to read not correct")
    return ap.parse_args(argv)


def cache_dirs() -> None:
    """Every build cache at a fixed path inside the checkout (the port's
    nvcc builds go to its own ``build/kernels``)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)


def run_cell(args, device=None, t0: float = T0, overrides=None, cell=None) -> dict:
    """Set up, measure and judge one cell; returns the result object with
    its ``checks``. ``device``, ``overrides`` (a dict merged into the
    traffic mix's parameters; ``config_overrides`` into the configuration)
    and ``cell`` (in place of the cell's file) are for runs on the host in
    the tests."""
    import torch

    import core
    import weights

    cell = cell or core.load_json(f"workloads/{args.workload}.json")
    mix = core.load_json(f"traffic/{cell['traffic']}.json")
    cell = dict(cell, traffic_params={k: v for k, v in mix.items() if k != "generator"})
    if overrides:
        cell = dict(cell, traffic_params={**cell["traffic_params"], **overrides})
    cfg = core.load_json(f"configs/{cell['config']}.json")
    if "config_overrides" in (overrides or {}):
        cfg = {**cfg, **overrides["config_overrides"]}
    device = torch.device(device or "cuda")
    marks = [("start", t0), ("imports", time.perf_counter())]
    ctx = SimpleNamespace(
        mark=lambda name: marks.append((name, time.perf_counter())),
        torch=torch, cell=cell, cfg=cfg, seed=args.seed, device=device,
        control=bool(args.control), fault=args.fault, reference_s=0.0,
        generator=lambda stream: weights.generator(args.seed, device, stream),
        weights=lambda: weights.make_trees(cfg, args.seed, device))
    state = core.load_module(f"generators/{mix['generator']}.py").setup(ctx)
    setup_s = time.perf_counter() - t0 - ctx.reference_s
    ctx.mark("setup")
    event = None if device.type == "cuda" else core.HostEvent
    win = state.window(args.seconds, bool(args.trace), **({"event": event} if event else {}))
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    run = SimpleNamespace(cell=cell, cfg=cfg, seconds=args.seconds, setup_s=setup_s,
                          window=win, trace=win.trace, work=core.load_module)
    metrics = {}
    for m in core.cell_metrics(core.manifest(), args.workload, bool(args.trace)):
        value = core.load_module(f"metrics/{m['name']}.py").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    done = win.done()
    handed = [i for i in win.items if i.t_hand < win.t_end]
    numbers = state.judge(win)
    loaded = core.forbidden_modules(sys.modules)
    if loaded:
        raise SystemExit(f"run.py: the run loaded {', '.join(loaded)}")
    limits = cell["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    result = {
        "correct": all(c["limit"] is not None and c["value"] <= c["limit"]
                       for c in checks.values()),
        "attempted": len(handed),
        "failed": sum(1 for i in handed if i.t_done != i.t_done),
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": peak},
        "host": {"window_items": len(done), "gc": win.gc, "clock": win.clock,
                 "reference_in_setup_s": ctx.reference_s,
                 "items_per_second": [sum(1 for i in done if a <= i.t_done - win.t_start < a + 1)
                                      for a in range(int(args.seconds))],
                 "setup_parts_s": {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}},
    }
    if win.trace is not None:
        tr = win.trace
        result["device"]["busy_s"] = tr.busy_us() * 1e-6
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = parse(argv)
    cache_dirs()
    sys.path.insert(0, str(BENCH))
    sys.path.insert(0, str(ROOT))
    import torch

    import core

    chips = core.load_json(f"workloads/{args.workload}.json")["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: the cell needs {chips} CUDA card(s), this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(args)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
