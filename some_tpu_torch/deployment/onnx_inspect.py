"""Minimal ONNX ModelProto reader, no ``onnx`` package required.

The port's own copy of ``some_tpu/deployment/onnx_inspect.py``: the
port imports nothing of the JAX package. Walks the protobuf wire format
directly to extract the structural facts the export pipeline guarantees
(opset, graph I/O names, dynamic-axis names, node op-type inventory), so
exported artifacts can be checked where the onnx toolchain is not
installed (reference counterpart: onnxsim's check pass in
export.py:96-106).

Only the fields used are decoded (onnx.proto field numbers, stable since
IR v3): ModelProto{graph=7, opset_import=8}, OperatorSetIdProto{domain=1,
version=2}, GraphProto{node=1, input=11, output=12}, NodeProto{op_type=4},
ValueInfoProto{name=1, type=2}, TypeProto{tensor_type=1},
Tensor{elem_type=1, shape=2}, TensorShapeProto{dim=1},
Dimension{dim_value=1, dim_param=2}.
"""
from __future__ import annotations

import pathlib
from collections import Counter
from typing import Dict, List, Tuple


def _varint(buf: bytes, i: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        byte = buf[i]
        i += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, i
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) triples of one message."""
    i = 0
    while i < len(buf):
        tag, i = _varint(buf, i)
        field, wire_type = tag >> 3, tag & 7
        if wire_type == 0:
            value, i = _varint(buf, i)
        elif wire_type == 1:
            value, i = buf[i:i + 8], i + 8
        elif wire_type == 2:
            length, i = _varint(buf, i)
            value, i = buf[i:i + length], i + length
        elif wire_type == 5:
            value, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"unsupported wire type {wire_type}")
        yield field, wire_type, value


def _value_info(buf: bytes) -> Tuple[str, List[object]]:
    """ValueInfoProto -> (name, [dim_value int | dim_param str, ...])."""
    name, dims = "", []
    for field, _, value in _fields(buf):
        if field == 1:
            name = value.decode()
        elif field == 2:  # TypeProto
            for f2, _, v2 in _fields(value):
                if f2 != 1:  # tensor_type
                    continue
                for f3, _, v3 in _fields(v2):
                    if f3 != 2:  # shape
                        continue
                    for f4, _, v4 in _fields(v3):
                        if f4 != 1:  # dim
                            continue
                        dim: object = None
                        for f5, _, v5 in _fields(v4):
                            if f5 == 1:
                                dim = int(v5)
                            elif f5 == 2:
                                dim = v5.decode()
                        dims.append(dim)
    return name, dims


def read_model_summary(path: pathlib.Path | str) -> Dict[str, object]:
    """Structural summary of a serialized ONNX model.

    Returns {"opset": int (default-domain), "op_types": Counter,
             "inputs"/"outputs": [(name, dims), ...]} where each dim is an
    int (static) or str (dynamic axis name).
    """
    data = pathlib.Path(path).read_bytes()
    opset = None
    op_types: Counter = Counter()
    inputs: List[Tuple[str, List[object]]] = []
    outputs: List[Tuple[str, List[object]]] = []
    for field, _, value in _fields(data):
        if field == 8:  # opset_import
            domain, version = b"", None
            for f2, _, v2 in _fields(value):
                if f2 == 1:
                    domain = v2
                elif f2 == 2:
                    version = int(v2)
            if domain == b"":
                opset = version
        elif field == 7:  # graph
            for f2, _, v2 in _fields(value):
                if f2 == 1:  # node
                    for f3, _, v3 in _fields(v2):
                        if f3 == 4:
                            op_types[v3.decode()] += 1
                elif f2 == 11:
                    inputs.append(_value_info(v2))
                elif f2 == 12:
                    outputs.append(_value_info(v2))
    return {"opset": opset, "op_types": op_types,
            "inputs": inputs, "outputs": outputs}
