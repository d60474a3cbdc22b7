#!/usr/bin/env python
"""Where the card's float32 error in the export's fp32 gate comes from.

    python tools/fp32_conv_accuracy_torch.py --dense CKPT_DIR/NAME \
        [--slim PRUNED_DIR/NAME]        (needs one CUDA card)

``export_seg_torch.py`` holds the exported float32 graph (BatchNorm folded)
against the source model (BatchNorm unfolded) at max|diff| < 1e-4 on its
probes (standard normal, seed 0: b1, then the dynamic graph at b1 and b4).
For each checkpoint (``--slim``: slimmed first, as ``--slim`` exports it)
and probe this prints, as one JSON line each:

- the gate's reading and each side's distance from the graph run in float64
  on the host, on the CPU and on the card under four cuDNN settings
  (default, deterministic, benchmark, cuDNN off), TF32 off throughout;
- per conv, resize and pooling node of the b1 graph: its relative error
  (max|d| over its float64 output's largest magnitude) from the float64
  node input, on the CPU, on the card with cuDNN and without it; the nodes
  with the largest card/CPU ratio and the sums over all nodes.

Every line carries the card's name and power limit. Exits non-zero without
a card. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

H, W = 320, 240
SETTINGS = {"default": {}, "deterministic": {"deterministic": True},
            "benchmark": {"benchmark": True}, "cudnn_off": {"enabled": False}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--dense", required=True, help="checkpoint DIR/NAME")
    parser.add_argument("--slim", help="expansion-pruned checkpoint DIR/NAME")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from mtg_card_image_segmentation_tpu_torch.compression.slim import slim_seg_state
    from mtg_card_image_segmentation_tpu_torch.export.fold_bn import fold_batch_norm
    from mtg_card_image_segmentation_tpu_torch.export.onnx_export import export_seg_model
    from mtg_card_image_segmentation_tpu_torch.export.onnx_optimize import optimize
    from mtg_card_image_segmentation_tpu_torch.export.onnx_torch_runner import (
        _run_node,
        make_runner,
    )
    from mtg_card_image_segmentation_tpu_torch.training.checkpoint import load_params
    from mtg_card_image_segmentation_tpu_torch.utils.params import from_flax
    from mtg_card_image_segmentation_tpu_torch.utils.platform import describe_card, no_tf32

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    card = describe_card()
    tag = {"card": card["nvidia_smi"], "torch": torch.__version__,
           "cudnn": torch.backends.cudnn.version()}

    def load(path):
        return load_params(*os.path.split(os.path.normpath(path)))[:2]

    cases = {"dense": load(args.dense)}
    if args.slim:
        cases["slim"] = slim_seg_state(*load(args.slim))[:2]
    rng = np.random.default_rng(0)
    probes = {"b1_static": rng.standard_normal((1, 3, H, W)).astype(np.float32),
              "b1_dynamic": rng.standard_normal((1, 3, H, W)).astype(np.float32),
              "b4_dynamic": rng.standard_normal((4, 3, H, W)).astype(np.float32)}

    def run64(graph, x):
        """The graph in float64 on the host, and each node's inputs and output."""
        host = {t.name: t.array for t in graph.initializers}
        env = {k: torch.from_numpy(np.ascontiguousarray(v).copy()) for k, v in host.items()}
        env = {k: v.double() if v.dtype == torch.float32 else v for k, v in env.items()}
        env["input"] = torch.from_numpy(x).double()
        trace = []
        with torch.inference_mode():
            for node in graph.nodes:
                env[node.outputs[0]] = _run_node(node, env, host)
                trace.append((node, {i: env[i] for i in node.inputs if i}, env[node.outputs[0]]))
        return env["output"].numpy(), host, trace

    def with_cudnn(flags, fn):
        kept = {k: getattr(torch.backends.cudnn, k) for k in ("deterministic", "benchmark",
                                                               "enabled")}
        for k, v in flags.items():
            setattr(torch.backends.cudnn, k, v)
        try:
            return fn()
        finally:
            for k, v in kept.items():
                setattr(torch.backends.cudnn, k, v)

    with no_tf32():
        for name, (params, stats) in cases.items():
            folded = fold_batch_norm(params, stats)
            static = export_seg_model(folded, (H, W))
            optimize(static)
            dynamic = export_seg_model(folded, (H, W), dynamic_batch=True)
            optimize(dynamic)
            models = {d: from_flax(params, stats, dtype=torch.float32).to(d)
                      for d in ("cpu", "cuda")}
            for probe, x in probes.items():
                graph = static if probe == "b1_static" else dynamic
                truth, host, trace = run64(graph, x)
                rows = {}
                for dev, setting in [("cpu", "host"), *(("cuda", s) for s in SETTINGS)]:
                    def forward(dev=dev):
                        got = make_runner(graph, dev)({"input": x})["output"]
                        with torch.inference_mode():
                            ref = models[dev](torch.from_numpy(
                                np.ascontiguousarray(x.transpose(0, 2, 3, 1))).to(dev))
                        return got, ref.cpu().numpy().transpose(0, 3, 1, 2)

                    got, ref = (forward() if dev == "cpu"
                                else with_cudnn(SETTINGS[setting], forward))
                    rows[f"{dev}:{setting}"] = {
                        "gate_graph_vs_model": float(np.abs(got - ref).max()),
                        "graph_vs_float64": float(np.abs(got - truth).max()),
                        "model_vs_float64": float(np.abs(ref - truth).max())}
                print(json.dumps({"case": name, "probe": probe,
                                  "logit_max_abs": float(np.abs(truth).max()),
                                  "rows": rows, **tag}))
                if probe != "b1_static":
                    continue
                nodes = []
                for node, ins, out64 in trace:
                    if node.op_type not in ("Conv", "Resize", "GlobalAveragePool"):
                        continue
                    scale = max(float(out64.abs().max()), 1e-12)
                    row = {"node": node.name, "op": node.op_type,
                           "group": int(node.attributes.get("group", 1)),
                           "input": list(next(iter(ins.values())).shape)}
                    for key, dev, flags in (("cpu", "cpu", {}), ("cudnn", "cuda", {}),
                                            ("cuda_native", "cuda", {"enabled": False})):
                        env = {i: (t.float() if t.dtype == torch.float64 else t).to(dev)
                               for i, t in ins.items()}

                        def one(env=env):
                            with torch.inference_mode():
                                return _run_node(node, env, host).double().cpu()

                        row[key] = float((with_cudnn(flags, one) - out64).abs().max()) / scale
                    nodes.append(row)
                nodes.sort(key=lambda r: -r["cudnn"] / max(r["cpu"], 1e-12))
                print(json.dumps({"case": name, "nodes": len(nodes),
                                  "worst_cudnn_over_cpu": nodes[:5],
                                  "sum_rel_err": {k: sum(r[k] for r in nodes)
                                                  for k in ("cpu", "cudnn", "cuda_native")},
                                  **tag}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
