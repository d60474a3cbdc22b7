"""ONNX graph optimization passes (reference: train/export.py:102-129 runs
onnxoptimizer over every exported model and ships the optimized copy).

The environment has no onnxoptimizer, so — like the writer
(onnx_proto.py) and the parity executor (onnx_torch_runner.py) — the
useful pass subset is implemented here directly on our parsed
:class:`onnx_proto.Model` (copy of the JAX package's
``export/onnx_optimize.py``: numpy passes):

- ``eliminate_identity``    — drop Identity nodes, rewire consumers
- ``eliminate_nop_cast``    — drop Cast nodes whose target dtype equals
                              the (statically known) input dtype; collapse
                              Cast->Cast chains
- ``fold_constants``        — numpy-evaluate nodes whose inputs are all
                              initializers (shape/arith subset)
- ``eliminate_dead_nodes``  — drop nodes no graph output depends on
- ``dedupe_initializers``   — share byte-identical initializers
- ``eliminate_unused_initializers``

All passes preserve graph semantics exactly (pure renames/precomputation;
no numeric rewrites), so the exporters' parity gates remain the ground
truth after optimization.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from mtg_card_image_segmentation_tpu_torch.export import onnx_proto as op

__all__ = ["optimize"]


def _consumers(model: op.Model) -> Dict[str, List[op.Node]]:
    out: Dict[str, List[op.Node]] = {}
    for node in model.nodes:
        for name in node.inputs:
            out.setdefault(name, []).append(node)
    return out


def _rename_input(model: op.Model, old: str, new: str) -> None:
    for node in model.nodes:
        node.inputs = [new if i == old else i for i in node.inputs]


def eliminate_identity(model: op.Model) -> int:
    """Remove Identity nodes. An Identity feeding a graph output is kept
    unless its input is an internal tensor (then the producer's output is
    renamed to the graph-output name)."""
    graph_inputs = {n for n, _, _ in model.inputs}
    graph_outputs = {n for n, _, _ in model.outputs}
    inits = {t.name for t in model.initializers}
    removed = 0
    changed = True
    while changed:
        changed = False
        for node in list(model.nodes):
            if node.op_type != "Identity":
                continue
            src, dst = node.inputs[0], node.outputs[0]
            if dst in graph_outputs:
                # only safe if src is produced by exactly one internal node
                # and is not itself a graph io/initializer/output
                if src in graph_inputs or src in inits or src in graph_outputs:
                    continue
                producers = [n for n in model.nodes if src in n.outputs]
                if len(producers) != 1:
                    continue
                p = producers[0]
                p.outputs = [dst if o == src else o for o in p.outputs]
                _rename_input(model, src, dst)
            else:
                _rename_input(model, dst, src)
            model.nodes.remove(node)
            removed += 1
            changed = True
    return removed


def _static_dtypes(model: op.Model) -> Dict[str, int]:
    """Tensor name -> ONNX elem_type where statically known."""
    known: Dict[str, int] = {}
    for name, elem, _ in model.inputs:
        known[name] = elem
    for t in model.initializers:
        known[t.name] = op.NP_TO_ONNX[t.array.dtype]
    for node in model.nodes:
        if node.op_type == "Cast":
            known[node.outputs[0]] = int(node.attributes["to"])
    return known


def eliminate_nop_cast(model: op.Model) -> int:
    """Drop Cast nodes that do not change dtype; collapse Cast->Cast pairs
    whose intermediate has a single consumer."""
    removed = 0
    changed = True
    while changed:
        changed = False
        known = _static_dtypes(model)
        graph_outputs = {n for n, _, _ in model.outputs}
        cons = _consumers(model)
        for node in list(model.nodes):
            if node.op_type != "Cast":
                continue
            src, dst = node.inputs[0], node.outputs[0]
            to = int(node.attributes["to"])
            if known.get(src) == to and dst not in graph_outputs:
                _rename_input(model, dst, src)
                model.nodes.remove(node)
                removed += 1
                changed = True
                continue
            # Cast(a->x) -> Cast(x->b), x consumed only by the second cast:
            # the chain is equivalent to Cast(a->b) only when the first cast
            # cannot lose information the second would re-expose — i.e. the
            # intermediate type is a superset of src or of the final type.
            producer = next(
                (n for n in model.nodes if n.op_type == "Cast" and src in n.outputs),
                None,
            )
            if (
                producer is not None
                and len(cons.get(src, [])) == 1
                and src not in graph_outputs
            ):
                inter = int(producer.attributes["to"])
                widening = {
                    (op.FLOAT16, op.FLOAT),  # f16 -> f32 is exact
                    (op.UINT8, op.FLOAT),
                    (op.UINT8, op.INT32),
                    # NOT (INT32, FLOAT): i32 -> f32 rounds above 2^24, so
                    # collapsing i32->f32->X would skip that rounding
                }
                if (known.get(producer.inputs[0]), inter) in widening:
                    node.inputs = [producer.inputs[0]]
                    model.nodes.remove(producer)
                    removed += 1
                    changed = True
    return removed


_FOLDABLE = {
    "Cast", "Reshape", "Transpose", "Concat", "Slice", "Unsqueeze",
    "Squeeze", "Mul", "Add", "Sub", "Div", "Sqrt", "Neg", "Shape",
}


def _fold_one(node: op.Node, vals: Dict[str, np.ndarray]) -> Optional[np.ndarray]:
    a = node.attributes
    x = [vals[i] for i in node.inputs]
    t = node.op_type
    if t == "Cast":
        return x[0].astype(op.ONNX_TO_NP[int(a["to"])])
    if t == "Reshape":
        return x[0].reshape([int(d) for d in x[1]])
    if t == "Transpose":
        return np.transpose(x[0], a.get("perm"))
    if t == "Concat":
        return np.concatenate(x, axis=int(a["axis"]))
    if t == "Slice":
        starts, ends = x[1].tolist(), x[2].tolist()
        axes = x[3].tolist() if len(x) > 3 else list(range(len(starts)))
        steps = x[4].tolist() if len(x) > 4 else [1] * len(starts)
        sl = [slice(None)] * x[0].ndim
        for s, e, ax, st in zip(starts, ends, axes, steps):
            sl[ax] = slice(s, e, st)
        return x[0][tuple(sl)]
    if t == "Unsqueeze":
        axes = x[1].tolist() if len(x) > 1 else list(a["axes"])
        y = x[0]
        for ax in sorted(axes):
            y = np.expand_dims(y, ax)
        return y
    if t == "Squeeze":
        axes = x[1].tolist() if len(x) > 1 else list(a.get("axes", []))
        return np.squeeze(x[0], tuple(axes) if axes else None)
    if t == "Shape":
        return np.asarray(x[0].shape, np.int64)
    if t in ("Mul", "Add", "Sub", "Div", "Sqrt", "Neg"):
        f = {
            "Mul": np.multiply, "Add": np.add, "Sub": np.subtract,
            "Div": np.divide, "Sqrt": np.sqrt, "Neg": np.negative,
        }[t]
        y = f(*x)
        return np.asarray(y, x[0].dtype)
    return None


def fold_constants(model: op.Model) -> int:
    """Precompute nodes whose inputs are all initializers (safe subset)."""
    vals = {t.name: t.array for t in model.initializers}
    graph_outputs = {n for n, _, _ in model.outputs}
    folded = 0
    changed = True
    while changed:
        changed = False
        for node in list(model.nodes):
            if (
                node.op_type not in _FOLDABLE
                or len(node.outputs) != 1
                or node.outputs[0] in graph_outputs
                or not node.inputs
                or not all(i in vals for i in node.inputs)
            ):
                continue
            try:
                y = _fold_one(node, vals)
            except Exception:
                y = None
            if y is None:
                continue
            name = node.outputs[0]
            vals[name] = y
            model.initializers.append(op.Tensor(name, np.ascontiguousarray(y)))
            model.nodes.remove(node)
            folded += 1
            changed = True
    return folded


def eliminate_dead_nodes(model: op.Model) -> int:
    """Drop nodes that no graph output transitively depends on."""
    needed = {n for n, _, _ in model.outputs}
    changed = True
    while changed:
        changed = False
        for node in model.nodes:
            if any(o in needed for o in node.outputs):
                new = set(node.inputs) - needed
                if new:
                    needed |= new
                    changed = True
    before = len(model.nodes)
    model.nodes = [n for n in model.nodes if any(o in needed for o in n.outputs)]
    return before - len(model.nodes)


def dedupe_initializers(model: op.Model) -> int:
    """Share byte-identical initializers under one name."""
    canon: Dict[Tuple, str] = {}
    remap: Dict[str, str] = {}
    kept: List[op.Tensor] = []
    for t in model.initializers:
        key = (t.array.dtype.str, t.array.shape, t.array.tobytes())
        if key in canon:
            remap[t.name] = canon[key]
        else:
            canon[key] = t.name
            kept.append(t)
    if remap:
        model.initializers = kept
        for node in model.nodes:
            node.inputs = [remap.get(i, i) for i in node.inputs]
    return len(remap)


def eliminate_unused_initializers(model: op.Model) -> int:
    used = {i for n in model.nodes for i in n.inputs}
    used |= {n for n, _, _ in model.outputs}
    before = len(model.initializers)
    model.initializers = [t for t in model.initializers if t.name in used]
    return before - len(model.initializers)


def optimize(model: op.Model) -> Dict[str, int]:
    """Run all passes to a fixed point; mutates ``model``, returns stats."""
    stats = {
        "identity_removed": 0, "nop_cast_removed": 0, "constants_folded": 0,
        "dead_nodes_removed": 0, "initializers_deduped": 0,
        "initializers_dropped": 0,
    }
    for _ in range(8):
        n = 0
        n += (d := eliminate_identity(model)); stats["identity_removed"] += d
        n += (d := eliminate_nop_cast(model)); stats["nop_cast_removed"] += d
        n += (d := fold_constants(model)); stats["constants_folded"] += d
        n += (d := eliminate_dead_nodes(model)); stats["dead_nodes_removed"] += d
        n += (d := dedupe_initializers(model)); stats["initializers_deduped"] += d
        n += (d := eliminate_unused_initializers(model))
        stats["initializers_dropped"] += d
        if n == 0:
            break
    return stats
