"""Minimal ONNX protobuf wire-format writer/reader (no onnx/protobuf deps;
copy of the JAX package's ``export/onnx_proto.py``, which is framework-free
but sits in a package that imports JAX).

The environment has no ``onnx`` package, so the export path
(reference train/export.py + onnx_fp16_converter.py) serializes ModelProto
by hand using the protobuf wire format (varints + length-delimited fields).
Only the message subset the exporter emits is supported; the reader parses
the same subset back for the parity executor (export/onnx_torch_runner.py).
The producer name stays the JAX package's, so both packages write the same
bytes for the same graph.

Field numbers follow onnx/onnx.proto3 (IR version 8):
  ModelProto:    ir_version=1, producer_name=2, producer_version=3,
                 model_version=5, doc_string=6, graph=7, opset_import=8
  GraphProto:    node=1, name=2, initializer=5, doc_string=10, input=11,
                 output=12, value_info=13
  NodeProto:     input=1, output=2, name=3, op_type=4, attribute=5
  AttributeProto:name=1, f=2, i=3, s=4, t=5, floats=7, ints=8, type=20
  TensorProto:   dims=1, data_type=2, name=8, raw_data=9
  ValueInfoProto:name=1, type=2 / TypeProto.tensor_type=1
  TypeProto.Tensor: elem_type=1, shape=2 / TensorShapeProto.dim=1
  Dimension:     dim_value=1, dim_param=2
  OperatorSetId: domain=1, version=2
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

# ONNX TensorProto data types
FLOAT = 1
UINT8 = 2
INT8 = 3
INT32 = 6
INT64 = 7
BOOL = 9
FLOAT16 = 10
DOUBLE = 11

NP_TO_ONNX = {
    np.dtype(np.float32): FLOAT,
    np.dtype(np.uint8): UINT8,
    np.dtype(np.int8): INT8,
    np.dtype(np.int32): INT32,
    np.dtype(np.int64): INT64,
    np.dtype(np.bool_): BOOL,
    np.dtype(np.float16): FLOAT16,
    np.dtype(np.float64): DOUBLE,
}
ONNX_TO_NP = {v: k for k, v in NP_TO_ONNX.items()}

# AttributeProto.AttributeType
ATTR_FLOAT = 1
ATTR_INT = 2
ATTR_STRING = 3
ATTR_TENSOR = 4
ATTR_FLOATS = 6
ATTR_INTS = 7


# ---------------------------------------------------------------------------
# wire-format primitives
# ---------------------------------------------------------------------------


def _varint(value: int) -> bytes:
    if value < 0:
        value += 1 << 64  # two's complement for negative int64
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field_num: int, wire_type: int) -> bytes:
    return _varint((field_num << 3) | wire_type)


def w_varint(field_num: int, value: int) -> bytes:
    return _tag(field_num, 0) + _varint(value)


def w_bytes(field_num: int, data: bytes) -> bytes:
    return _tag(field_num, 2) + _varint(len(data)) + data


def w_string(field_num: int, s: str) -> bytes:
    return w_bytes(field_num, s.encode("utf-8"))


def w_float(field_num: int, value: float) -> bytes:
    return _tag(field_num, 5) + struct.pack("<f", value)


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_num, wire_type, value, end_pos) over a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field_num, wire_type = key >> 3, key & 7
        if wire_type == 0:
            value, pos = _read_varint(buf, pos)
        elif wire_type == 2:
            length, pos = _read_varint(buf, pos)
            value = buf[pos : pos + length]
            pos += length
        elif wire_type == 5:
            value = struct.unpack("<f", buf[pos : pos + 4])[0]
            pos += 4
        elif wire_type == 1:
            value = struct.unpack("<d", buf[pos : pos + 8])[0]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire_type}")
        yield field_num, wire_type, value


def _signed(value: int) -> int:
    return value - (1 << 64) if value >= 1 << 63 else value


# ---------------------------------------------------------------------------
# message dataclasses
# ---------------------------------------------------------------------------


@dataclass
class Tensor:
    name: str
    array: np.ndarray

    def serialize(self) -> bytes:
        out = b""
        for d in self.array.shape:
            out += w_varint(1, d)
        out += w_varint(2, NP_TO_ONNX[self.array.dtype])
        out += w_string(8, self.name)
        out += w_bytes(9, np.ascontiguousarray(self.array).tobytes())
        return out

    @classmethod
    def parse(cls, buf: bytes) -> "Tensor":
        dims: List[int] = []
        dtype = FLOAT
        name = ""
        raw = b""
        for fn, wt, v in _iter_fields(buf):
            if fn == 1:
                dims.append(_signed(v))
            elif fn == 2:
                dtype = v
            elif fn == 8:
                name = v.decode()
            elif fn == 9:
                raw = v
        arr = np.frombuffer(raw, dtype=ONNX_TO_NP[dtype]).reshape(dims)
        return cls(name, arr)


@dataclass
class Attribute:
    name: str
    value: Union[float, int, str, List[int], List[float], Tensor]

    def serialize(self) -> bytes:
        out = w_string(1, self.name)
        v = self.value
        if isinstance(v, Tensor):
            out += w_bytes(5, v.serialize()) + w_varint(20, ATTR_TENSOR)
        elif isinstance(v, bool):
            out += w_varint(3, int(v)) + w_varint(20, ATTR_INT)
        elif isinstance(v, int):
            out += w_varint(3, v) + w_varint(20, ATTR_INT)
        elif isinstance(v, float):
            out += w_float(2, v) + w_varint(20, ATTR_FLOAT)
        elif isinstance(v, str):
            out += w_bytes(4, v.encode()) + w_varint(20, ATTR_STRING)
        elif isinstance(v, (list, tuple)) and v and isinstance(v[0], float):
            for f in v:
                out += w_float(7, f)
            out += w_varint(20, ATTR_FLOATS)
        elif isinstance(v, (list, tuple)):
            for i in v:
                out += w_varint(8, int(i))
            out += w_varint(20, ATTR_INTS)
        else:
            raise TypeError(f"unsupported attribute {self.name}={v!r}")
        return out

    @classmethod
    def parse(cls, buf: bytes) -> "Attribute":
        name = ""
        atype = None
        f = i = s = t = None
        floats: List[float] = []
        ints: List[int] = []
        for fn, wt, v in _iter_fields(buf):
            if fn == 1:
                name = v.decode()
            elif fn == 2:
                f = v
            elif fn == 3:
                i = _signed(v)
            elif fn == 4:
                s = v.decode()
            elif fn == 5:
                t = Tensor.parse(v)
            elif fn == 7:
                floats.append(v)
            elif fn == 8:
                ints.append(_signed(v))
            elif fn == 20:
                atype = v
        if atype == ATTR_FLOAT:
            return cls(name, f)
        if atype == ATTR_INT:
            return cls(name, i)
        if atype == ATTR_STRING:
            return cls(name, s)
        if atype == ATTR_TENSOR:
            return cls(name, t)
        if atype == ATTR_FLOATS:
            return cls(name, floats)
        if atype == ATTR_INTS:
            return cls(name, ints)
        raise ValueError(f"unparsed attribute {name} type {atype}")


@dataclass
class Node:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    name: str = ""
    attributes: Dict[str, Union[float, int, str, List[int], List[float], Tensor]] = field(
        default_factory=dict
    )

    def serialize(self) -> bytes:
        out = b""
        for inp in self.inputs:
            out += w_string(1, inp)
        for o in self.outputs:
            out += w_string(2, o)
        out += w_string(3, self.name or self.outputs[0])
        out += w_string(4, self.op_type)
        for k, v in self.attributes.items():
            out += w_bytes(5, Attribute(k, v).serialize())
        return out

    @classmethod
    def parse(cls, buf: bytes) -> "Node":
        inputs: List[str] = []
        outputs: List[str] = []
        name = ""
        op_type = ""
        attrs: Dict[str, object] = {}
        for fn, wt, v in _iter_fields(buf):
            if fn == 1:
                inputs.append(v.decode())
            elif fn == 2:
                outputs.append(v.decode())
            elif fn == 3:
                name = v.decode()
            elif fn == 4:
                op_type = v.decode()
            elif fn == 5:
                a = Attribute.parse(v)
                attrs[a.name] = a.value
        return cls(op_type, inputs, outputs, name, attrs)


def _value_info(name: str, elem_type: int, shape: Tuple[Optional[int], ...]) -> bytes:
    dims = b""
    for d in shape:
        if d is None:
            dims += w_bytes(1, w_string(2, "N"))
        else:
            dims += w_bytes(1, w_varint(1, d))
    tensor_type = w_varint(1, elem_type) + w_bytes(2, dims)
    type_proto = w_bytes(1, tensor_type)
    return w_string(1, name) + w_bytes(2, type_proto)


def _parse_value_info(buf: bytes) -> Tuple[str, int, Tuple[Optional[int], ...]]:
    name = ""
    elem = FLOAT
    shape: List[Optional[int]] = []
    for fn, wt, v in _iter_fields(buf):
        if fn == 1:
            name = v.decode()
        elif fn == 2:
            for fn2, _, v2 in _iter_fields(v):
                if fn2 == 1:  # tensor_type
                    for fn3, _, v3 in _iter_fields(v2):
                        if fn3 == 1:
                            elem = v3
                        elif fn3 == 2:  # shape
                            for fn4, _, v4 in _iter_fields(v3):
                                if fn4 == 1:  # dim
                                    dv: Optional[int] = None
                                    for fn5, _, v5 in _iter_fields(v4):
                                        if fn5 == 1:
                                            dv = _signed(v5)
                                    shape.append(dv)
    return name, elem, tuple(shape)


@dataclass
class Model:
    graph_name: str
    nodes: List[Node]
    initializers: List[Tensor]
    inputs: List[Tuple[str, int, Tuple[Optional[int], ...]]]
    outputs: List[Tuple[str, int, Tuple[Optional[int], ...]]]
    opset: int = 17
    producer: str = "mtg_card_image_segmentation_tpu"
    doc: str = ""

    def serialize(self) -> bytes:
        graph = b""
        for node in self.nodes:
            graph += w_bytes(1, node.serialize())
        graph += w_string(2, self.graph_name)
        for init in self.initializers:
            graph += w_bytes(5, init.serialize())
        if self.doc:
            graph += w_string(10, self.doc)
        for name, elem, shape in self.inputs:
            graph += w_bytes(11, _value_info(name, elem, shape))
        for name, elem, shape in self.outputs:
            graph += w_bytes(12, _value_info(name, elem, shape))

        opset = w_string(1, "") + w_varint(2, self.opset)
        out = w_varint(1, 8)  # ir_version
        out += w_string(2, self.producer)
        out += w_string(3, "0.1.0")
        out += w_bytes(7, graph)
        out += w_bytes(8, opset)
        return out

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.serialize())

    @classmethod
    def parse(cls, buf: bytes) -> "Model":
        nodes: List[Node] = []
        inits: List[Tensor] = []
        inputs = []
        outputs = []
        gname = ""
        opset = 17
        producer = ""
        for fn, wt, v in _iter_fields(buf):
            if fn == 7:  # graph
                for fn2, _, v2 in _iter_fields(v):
                    if fn2 == 1:
                        nodes.append(Node.parse(v2))
                    elif fn2 == 2:
                        gname = v2.decode()
                    elif fn2 == 5:
                        inits.append(Tensor.parse(v2))
                    elif fn2 == 11:
                        inputs.append(_parse_value_info(v2))
                    elif fn2 == 12:
                        outputs.append(_parse_value_info(v2))
            elif fn == 8:
                for fn2, _, v2 in _iter_fields(v):
                    if fn2 == 2:
                        opset = v2
            elif fn == 2:
                producer = v.decode()
        return cls(gname, nodes, inits, inputs, outputs, opset, producer)

    @classmethod
    def load(cls, path: str) -> "Model":
        with open(path, "rb") as f:
            return cls.parse(f.read())


def independent_checks(onnx_path: str) -> Dict[str, bool]:
    """Validation of a written file by a component not authored alongside
    this writer: Google's ``protoc`` re-parses the wire format against the
    repo's ``tools/onnx_schema.proto``, when it is on the path (the torch
    executor, the other independent half, runs every parity gate).
    Returns ``{"protoc_decode_pass": bool}``, or ``{}`` without protoc."""
    import os
    import shutil
    import subprocess

    out: Dict[str, bool] = {}
    if shutil.which("protoc"):
        schema_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  os.pardir, os.pardir, "tools")
        with open(onnx_path, "rb") as f:
            proc = subprocess.run(
                ["protoc", f"-I{os.path.normpath(schema_dir)}", "--decode=onnx.ModelProto",
                 "onnx_schema.proto"],
                stdin=f, capture_output=True, text=True, timeout=120,
            )
        out["protoc_decode_pass"] = proc.returncode == 0
        print(f"independent protoc decode: "
              f"{'PASS' if out['protoc_decode_pass'] else 'FAIL: ' + proc.stderr[:200]}")
    return out
