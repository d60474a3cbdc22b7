#!/usr/bin/env python
"""Deterministic slim-serving fixture of the port (counterpart of
``tools/make_slim_fixture.py``): the slim serving number must be
reproducible from a fresh clone without a retrain.

Builds a seeded LR-ASPP MobileNetV3-Large train state (Flax's default
initial values drawn from a torch generator seeded with ``--seed``,
``utils/params.py::init_flax_defaults``), applies the removable
expansion-channel prune (``compression/slim.py``, default 30%, the slim
operating point) and writes a port checkpoint (``training/checkpoint.py``)
that the slim serving path loads through ``slim_seg_state``:

  python tools/make_slim_fixture_torch.py          # -> runs/slim_fixture_torch/checkpoints/slim_model
  python tools/profile_blocks_torch.py --checkpoint runs/slim_fixture_torch/checkpoints/slim_model --slim
  python tools/make_slim_fixture_torch.py --device cpu --output-dir /tmp/slim   # on the host

Serving throughput depends on tensor shapes, not on weight values, so the
seeded fixture serves at the speed of a trained slim checkpoint with the
same narrowed expansions; accuracy figures come from trained runs, not
from this fixture. Runs on the CUDA card; ``--device cpu`` runs on the
host. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def slim_fixture(params: Dict[str, Any], amount: float) -> Tuple[Dict[str, Any], Dict, int]:
    """(pruned params, dead channels per block, their count) of the
    Flax-layout ``params`` under ``expansion_channel_prune(params, amount)``."""
    from mtg_card_image_segmentation_tpu_torch.compression.slim import (
        dead_expansion_channels,
        expansion_channel_prune,
    )

    pruned, _ = expansion_channel_prune(params, amount)
    dead = dead_expansion_channels(pruned)
    return pruned, dead, sum(v.size for v in dead.values())


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--amount", type=float, default=0.3,
                        help="fraction of expansion channels to remove")
    parser.add_argument("--output-dir", default="runs/slim_fixture_torch/checkpoints")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from mtg_card_image_segmentation_tpu_torch.compression.slim import param_count
    from mtg_card_image_segmentation_tpu_torch.config import OptimizerConfig, default_config
    from mtg_card_image_segmentation_tpu_torch.models import registry
    from mtg_card_image_segmentation_tpu_torch.training import checkpoint as ckpt_lib
    from mtg_card_image_segmentation_tpu_torch.training.optim import create_optimizer
    from mtg_card_image_segmentation_tpu_torch.training.state import create_seg_state
    from mtg_card_image_segmentation_tpu_torch.utils.params import init_flax_defaults
    from mtg_card_image_segmentation_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    cfg = default_config()
    opt_def, _ = create_optimizer(OptimizerConfig(), num_epochs=1, steps_per_epoch=1)
    state = create_seg_state(init_flax_defaults(registry.from_config(cfg.model), args.seed),
                             opt_def, device)
    variables = state.variables()
    pruned, dead, n_dead = slim_fixture(variables["params"], args.amount)
    dense = param_count(variables["params"])
    print(f"expansion prune: {n_dead} channels zeroed removably across "
          f"{len(dead)} blocks ({dense:,} params dense)")
    state.load_variables(pruned, variables["batch_stats"])

    path = ckpt_lib.save_checkpoint(
        args.output_dir, "slim_model", state, epoch=0,
        config={"fixture": "make_slim_fixture", "amount": args.amount, "seed": args.seed},
    )
    print(f"slim fixture checkpoint -> {path}")
    print("measure: python tools/profile_blocks_torch.py --checkpoint "
          f"{os.path.join(args.output_dir, 'slim_model')} --slim")
    return {"path": path, "dead_channels": n_dead, "dead_blocks": sorted(dead),
            "dense_params": dense, "device": str(device)}


if __name__ == "__main__":
    main()
