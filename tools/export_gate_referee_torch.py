#!/usr/bin/env python
"""How far one probe's float32 export gate reading parts between the card
and the CPU, and what chip_smoke's float64 referee makes of each gate.

    python tools/export_gate_referee_torch.py [--checkpoints 4] \
        [--work DIR]                    (needs one CUDA card)

For each of ``--checkpoints`` fresh checkpoints, trained as chip_smoke's
``train_cli`` phase trains its dense one (``train_seg_torch.py``, 320x240
b32, synthetic, 2 epochs x 8 steps, then a resumed third epoch; the card's
training is not bit-reproducible, so each checkpoint differs), this runs
``export_seg_torch.py`` on the card and with ``--device cpu`` and prints,
as one JSON line per checkpoint and float32 gate (fp32, dynamic b1 and
b4): both CLIs' readings (max|graph - model| on the gate's probe), their
ratio, the old referee's verdict (card at most twice the CPU) and the
float64 referee's row and verdict (``chip_smoke.export_gate_float64``,
``export_gate_rounding_excused``). Every line carries the card's name and
power limit. Exits non-zero without a card. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _cli(script: str, args) -> str:
    out = subprocess.run([sys.executable, str(ROOT / script), *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    if out.returncode not in (0, 1):
        raise SystemExit(f"{script} exit {out.returncode}: {out.stderr[-2000:]}")
    return out.stdout


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--checkpoints", type=int, default=4)
    parser.add_argument("--work", help="directory for checkpoints and exports "
                        "(default: a temporary one, removed at the end)")
    args = parser.parse_args(argv)

    import torch

    from export_seg_torch import gate_probes
    from mtg_card_image_segmentation_tpu_torch.config import default_config
    from mtg_card_image_segmentation_tpu_torch.training.checkpoint import load_params
    from mtg_card_image_segmentation_tpu_torch.utils.params import from_flax
    from mtg_card_image_segmentation_tpu_torch.utils.platform import describe_card

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    card = describe_card()
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = default_config()
    h, w = cfg.model.input_height, cfg.model.input_width
    probes, atol = gate_probes(h, w), cfg.export.parity_atol_fp32

    tmp = None if args.work else tempfile.TemporaryDirectory()
    work = Path(args.work or tmp.name)
    for i in range(args.checkpoints):
        ck = work / f"ckpt_{i}"
        for epochs, extra in ((2, []), (3, ["--resume"])):
            _cli("train_seg_torch.py", ["--source", "synthetic", *extra, "--set",
                                        f"train.num_epochs={epochs}", "train.steps_per_epoch=8",
                                        "train.save_every_epochs=1",
                                        f"train.checkpoint_dir={ck}",
                                        f"train.log_dir={work / 'logs'}"])
        logs = {dev: _cli("export_seg_torch.py", ["--checkpoint", str(ck / "final_model"),
                                                  "--output-dir", str(work / f"export_{i}_{dev}"),
                                                  *(["--device", "cpu"] if dev == "cpu" else [])])
                for dev in ("card", "cpu")}
        readings = {dev: smoke.export_gate_readings(log) for dev, log in logs.items()}
        params, stats, _ = load_params(str(ck), "final_model")
        for g in smoke.REFEREED_GATES:
            t0 = time.perf_counter()
            row = smoke.export_gate_float64(
                torch, work / f"export_{i}_card" / smoke.SEG_GATE_GRAPH[g],
                lambda: from_flax(params, stats, dtype=torch.float32), probes[g])
            card_r, cpu_r = readings["card"][g], readings["cpu"][g]
            print(json.dumps({
                "checkpoint": i, "gate": g, "cli_reading_card": card_r,
                "cli_reading_cpu": cpu_r, "card_over_cpu": card_r / cpu_r,
                "old_rule_excuses": card_r <= smoke.REFEREE_FACTOR * cpu_r,
                "float64_referee_excuses": smoke.export_gate_rounding_excused(row, atol),
                "float64_referee": row, "referee_seconds": time.perf_counter() - t0,
                "card": card["name"], "nvidia_smi": card["nvidia_smi"]}), flush=True)
    if tmp:
        tmp.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
