#!/usr/bin/env python
"""Convert an Orbax checkpoint of the JAX package into the PyTorch port's
checkpoint format.

    python tools/orbax_to_torch_checkpoint.py <src_dir>/<name> <dst_dir> [--name <new_name>]

Reads ``params`` and ``batch_stats`` (no optimizer state) with the JAX
package's ``training.checkpoint.load_params`` and writes them with the
port's ``training.checkpoint.save_params``: one ``arrays.npz`` of
Flax-layout numpy trees plus the ``.meta.json`` sidecar, which is carried
over. The same trees serve every model family (segmentation, HRNet pose,
YOLO pose). This tool needs JAX and Orbax; the port itself never imports it.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def convert(src_dir: str, src_name: str, dst_dir: str, dst_name: str) -> str:
    """Returns the path of the written checkpoint."""
    import jax
    import numpy as np

    from mtg_card_image_segmentation_tpu.training import checkpoint as jax_ckpt
    from mtg_card_image_segmentation_tpu_torch.training import checkpoint as torch_ckpt

    params, batch_stats, meta = jax_ckpt.load_params(src_dir, src_name)
    to_numpy = lambda tree: jax.tree.map(lambda a: np.asarray(jax.device_get(a)), tree)
    return torch_ckpt.save_params(
        dst_dir, dst_name, to_numpy(params), to_numpy(batch_stats),
        epoch=meta.get("epoch", 0), best_metric=meta.get("best_metric"),
        history=meta.get("history"), config=meta.get("config"),
    )


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("source", help="<dir>/<name> of the Orbax checkpoint")
    parser.add_argument("destination", help="directory to write the checkpoint into")
    parser.add_argument("--name", default=None,
                        help="name of the written checkpoint (default: the source's)")
    args = parser.parse_args()
    src_dir, src_name = os.path.split(os.path.normpath(args.source))
    path = convert(src_dir or ".", src_name, args.destination, args.name or src_name)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
