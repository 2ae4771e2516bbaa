"""Numpy reference executor for exported ONNX artifacts.

The port's own copy of ``some_tpu/deployment/onnx_run.py``: the port
imports nothing of the JAX package. It parses the ModelProto wire format
directly (no onnx package) and evaluates the graph with numpy, covering
exactly the op set ``deployment/onnx_export.py`` emits
(tests/test_torch_onnx.py holds the op inventory). It is a VALIDATION tool
for artifact parity, not a serving path (the port does not depend on
onnxruntime); an op it does not know raises at once with the op type.

Reference counterpart: the reference validates its export by running
onnxsim's check pass (reference: export.py:96-106); executing the graph
against the eager torch module is a stronger check.

Wire-format field numbers (onnx.proto, stable since IR v3):
  ModelProto{graph=7}  GraphProto{node=1, initializer=5, input=11, output=12}
  NodeProto{input=1, output=2, op_type=4, attribute=5}
  AttributeProto{name=1, f=2, i=3, s=4, t=5, floats=7, ints=8}
  TensorProto{dims=1, data_type=2, float_data=4, int32_data=5, int64_data=7,
              name=8, raw_data=9}
"""
from __future__ import annotations

import math
import pathlib
from typing import Dict, List

import numpy as np

from some_tpu_torch.deployment.onnx_inspect import _fields, _varint

# TensorProto.DataType -> numpy
_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
           6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16,
           11: np.float64, 12: np.uint32, 13: np.uint64}


def _tensor(buf: bytes) -> np.ndarray:
    dims: List[int] = []
    data_type = 1
    raw = None
    float_data: List[float] = []
    int32_data: List[int] = []
    int64_data: List[int] = []
    for field, wire_type, value in _fields(buf):
        if field == 1:
            dims.append(int(value))
        elif field == 2:
            data_type = int(value)
        elif field == 4:
            if wire_type == 2:  # packed
                float_data.extend(np.frombuffer(value, np.float32))
            else:
                float_data.append(np.frombuffer(value, np.float32)[0])
        elif field == 5:
            if wire_type == 2:
                i = 0
                while i < len(value):
                    v, i = _varint(value, i)
                    int32_data.append(v)
            else:
                int32_data.append(int(value))
        elif field == 7:
            if wire_type == 2:
                i = 0
                while i < len(value):
                    v, i = _varint(value, i)
                    int64_data.append(v)
            else:
                int64_data.append(int(value))
        elif field == 9:
            raw = value
    dtype = _DTYPES[data_type]
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dtype)
    elif float_data:
        arr = np.asarray(float_data, dtype=dtype)
    elif int64_data:
        # protobuf varints are two's-complement encoded in 64 bits
        arr = np.asarray([v - (1 << 64) if v >= (1 << 63) else v
                          for v in int64_data], dtype=np.int64).astype(dtype)
    elif int32_data:
        # negative int32s are sign-extended to 64-bit varints per the
        # protobuf spec; tolerate non-conformant 32-bit encoders too
        arr = np.asarray([v - (1 << 64) if v >= (1 << 63) else
                          v - (1 << 32) if v >= (1 << 31) else v
                          for v in int32_data], dtype=np.int64).astype(dtype)
    else:
        arr = np.zeros(0, dtype=dtype)
    return arr.reshape(dims) if dims else arr.reshape(())


def _zigzag64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _attributes(buf: bytes) -> Dict[str, object]:
    attrs: Dict[str, object] = {}
    for field, _, value in _fields(buf):
        if field != 5:
            continue
        name = None
        out: object = None
        floats: List[float] = []
        ints: List[int] = []
        for f2, wt2, v2 in _fields(value):
            if f2 == 1:
                name = v2.decode()
            elif f2 == 2:  # float f
                out = float(np.frombuffer(v2, np.float32)[0])
            elif f2 == 3:  # int64 i
                out = _zigzag64(int(v2))
            elif f2 == 4:  # bytes s
                out = v2.decode(errors="replace")
            elif f2 == 5:  # tensor t
                out = _tensor(v2)
            elif f2 == 7:  # repeated float
                if wt2 == 2:
                    floats.extend(np.frombuffer(v2, np.float32))
                else:
                    floats.append(float(np.frombuffer(v2, np.float32)[0]))
            elif f2 == 8:  # repeated int64
                if wt2 == 2:
                    i = 0
                    while i < len(v2):
                        v, i = _varint(v2, i)
                        ints.append(_zigzag64(v))
                else:
                    ints.append(_zigzag64(int(v2)))
        if floats:
            out = floats
        if ints:
            out = ints
        if name is not None:
            attrs[name] = out
    return attrs


class Node:
    __slots__ = ("op_type", "inputs", "outputs", "attrs")

    def __init__(self, buf: bytes):
        self.inputs: List[str] = []
        self.outputs: List[str] = []
        self.op_type = ""
        for field, _, value in _fields(buf):
            if field == 1:
                self.inputs.append(value.decode())
            elif field == 2:
                self.outputs.append(value.decode())
            elif field == 4:
                self.op_type = value.decode()
        self.attrs = _attributes(buf)


def load_graph(path: pathlib.Path | str):
    """-> (nodes, initializers, input_names, output_names)."""
    data = pathlib.Path(path).read_bytes()
    nodes: List[Node] = []
    inits: Dict[str, np.ndarray] = {}
    graph_inputs: List[str] = []
    graph_outputs: List[str] = []
    for field, _, value in _fields(data):
        if field != 7:
            continue
        for f2, _, v2 in _fields(value):
            if f2 == 1:
                nodes.append(Node(v2))
            elif f2 == 5:
                name = ""
                for f3, _, v3 in _fields(v2):
                    if f3 == 8:
                        name = v3.decode()
                inits[name] = _tensor(v2)
            elif f2 in (11, 12):
                for f3, _, v3 in _fields(v2):
                    if f3 == 1:
                        (graph_inputs if f2 == 11
                         else graph_outputs).append(v3.decode())
    return nodes, inits, graph_inputs, graph_outputs


# ---- op library (numpy semantics for the exported op set) ----

def _conv(x, w, b, attrs):
    """1-D convolution [B,C,T] with groups/pads; the only form exported
    (pointwise + depthwise conformer convs; the mel frontend is STFT)."""
    if x.ndim != 3:
        raise NotImplementedError(f"Conv rank {x.ndim}")
    group = int(attrs.get("group", 1))
    pads = attrs.get("pads", [0, 0])
    strides = attrs.get("strides", [1])
    dilations = attrs.get("dilations", [1])
    if list(strides) != [1] or list(dilations) != [1]:
        raise NotImplementedError("Conv stride/dilation")
    x = np.pad(x, ((0, 0), (0, 0), (int(pads[0]), int(pads[1]))))
    B, C, T = x.shape
    co, ci_g, K = w.shape
    t_out = T - K + 1
    out = np.empty((B, co, t_out), dtype=np.float32)
    cg = co // group
    for g in range(group):
        xs = x[:, g * ci_g:(g + 1) * ci_g]                       # [B,ci_g,T]
        cols = np.stack([xs[:, :, k:k + t_out] for k in range(K)],
                        axis=2)                                  # [B,ci_g,K,t]
        wg = w[g * cg:(g + 1) * cg]                              # [cg,ci_g,K]
        out[:, g * cg:(g + 1) * cg] = np.einsum(
            "oik,bikt->bot", wg, cols, optimize=True)
    if b is not None:
        out += b[None, :, None]
    return out


def _stft(signal, frame_step, window, frame_length, attrs):
    """Onesided STFT (opset 17): output [B, frames, dft//2+1, 2]."""
    if int(attrs.get("onesided", 1)) != 1:
        raise NotImplementedError("two-sided STFT")
    frame_step = int(np.asarray(frame_step).reshape(()))
    if signal.ndim == 3:  # [B, T, 1]
        signal = signal[..., 0]
    if frame_length is None:
        frame_length = len(window)
    frame_length = int(np.asarray(frame_length).reshape(()))
    B, T = signal.shape
    n_frames = 1 + (T - frame_length) // frame_step
    idx = (np.arange(frame_length)[None, :]
           + frame_step * np.arange(n_frames)[:, None])
    frames = signal[:, idx]  # [B, frames, frame_length]
    if window is not None:
        frames = frames * window[None, None, :]
    spec = np.fft.rfft(frames, n=frame_length, axis=-1)
    return np.stack([spec.real, spec.imag], axis=-1).astype(np.float32)


def _slice(data, starts, ends, axes=None, steps=None):
    starts = np.asarray(starts).ravel()
    ends = np.asarray(ends).ravel()
    axes = (np.asarray(axes).ravel() if axes is not None
            else np.arange(len(starts)))
    steps = (np.asarray(steps).ravel() if steps is not None
             else np.ones(len(starts), np.int64))
    index = [slice(None)] * data.ndim
    for s, e, a, st in zip(starts, ends, axes, steps):
        a = int(a) % data.ndim
        s, e, st = int(s), int(e), int(st)
        # ONNX clamps INT_MAX/INT_MIN sentinels
        if st > 0:
            index[a] = slice(max(s, -data.shape[a]) if s < 0 else s,
                             min(e, data.shape[a]))
        else:
            index[a] = slice(s, None if e < -data.shape[a] else e, st)
    return data[tuple(index)]


def _reduce(fn, data, axes, keepdims):
    if axes is None or (hasattr(axes, "size") and axes.size == 0):
        axes_t = None
    else:
        axes_t = tuple(int(a) for a in np.asarray(axes).ravel())
    return fn(data, axis=axes_t, keepdims=bool(keepdims))


def _layer_norm(x, scale, bias, attrs):
    axis = int(attrs.get("axis", -1))
    eps = float(attrs.get("epsilon", 1e-5))
    mean = x.mean(axis=axis, keepdims=True)
    var = x.var(axis=axis, keepdims=True)
    y = (x - mean) / np.sqrt(var + eps)
    return y * scale + bias


def _pad_op(data, pads, value=None, attrs=None):
    mode = (attrs or {}).get("mode", "constant")
    pads = np.asarray(pads).ravel()
    n = data.ndim
    widths = [(int(pads[i]), int(pads[i + n])) for i in range(n)]
    if mode == "constant":
        cval = float(np.asarray(value).reshape(())) if value is not None else 0.0
        return np.pad(data, widths, constant_values=cval)
    if mode in ("reflect", "edge"):
        return np.pad(data, widths, mode=mode)
    raise NotImplementedError(f"Pad mode {mode}")


def run_graph(path: pathlib.Path | str, feeds: Dict[str, np.ndarray]
              ) -> List[np.ndarray]:
    """Execute the serialized graph on numpy inputs; returns graph outputs."""
    nodes, env, graph_inputs, graph_outputs = load_graph(path)
    for name in graph_inputs:
        if name not in env:
            env[name] = np.asarray(feeds[name])

    def get(name):
        return env[name] if name else None

    for node in nodes:
        op, attrs = node.op_type, node.attrs
        x = [get(n) for n in node.inputs]
        if op == "Constant":
            out = attrs["value"]
        elif op == "Identity":
            out = x[0]
        elif op == "Cast":
            out = x[0].astype(_DTYPES[int(attrs["to"])])
        elif op == "Shape":
            out = np.asarray(x[0].shape, np.int64)
        elif op == "Reshape":
            shape = [int(s) for s in np.asarray(x[1]).ravel()]
            shape = [x[0].shape[i] if s == 0 and not attrs.get("allowzero")
                     else s for i, s in enumerate(shape)]
            out = x[0].reshape(shape)
        elif op == "Transpose":
            out = np.transpose(x[0], attrs.get("perm"))
        elif op == "Unsqueeze":
            out = x[0]
            for a in sorted(int(v) for v in np.asarray(x[1]).ravel()):
                out = np.expand_dims(out, a)
        elif op == "Squeeze":
            axes = (tuple(int(v) for v in np.asarray(x[1]).ravel())
                    if len(x) > 1 and x[1] is not None else None)
            out = np.squeeze(x[0], axis=axes)
        elif op == "Concat":
            out = np.concatenate(x, axis=int(attrs["axis"]))
        elif op == "Split":
            axis = int(attrs.get("axis", 0))
            if len(x) > 1 and x[1] is not None:
                sizes = np.asarray(x[1]).ravel()
                splits = np.cumsum(sizes)[:-1]
                parts = np.split(x[0], splits, axis=axis)
            else:
                parts = np.array_split(x[0], len(node.outputs), axis=axis)
            for out_name, part in zip(node.outputs, parts):
                env[out_name] = part
            continue
        elif op == "Slice":
            out = _slice(x[0], x[1], x[2],
                         x[3] if len(x) > 3 else None,
                         x[4] if len(x) > 4 else None)
        elif op == "Gather":
            out = np.take(x[0], x[1].astype(np.int64),
                          axis=int(attrs.get("axis", 0)))
        elif op == "GatherElements":
            out = np.take_along_axis(x[0], x[1].astype(np.int64),
                                     axis=int(attrs.get("axis", 0)))
        elif op == "ScatterElements":
            axis = int(attrs.get("axis", 0))
            reduction = attrs.get("reduction", "none")
            out = x[0].copy()
            idx = x[1].astype(np.int64)
            if reduction == "none":
                np.put_along_axis(out, idx, x[2], axis=axis)
            else:
                ufunc = {"add": np.add, "mul": np.multiply,
                         "max": np.maximum, "min": np.minimum}[reduction]
                grids = list(np.indices(idx.shape))
                grids[axis] = idx
                ufunc.at(out, tuple(grids), x[2])
        elif op == "ConstantOfShape":
            value = attrs.get("value")
            fill = value.reshape(()) if value is not None else np.float32(0)
            out = np.full([int(s) for s in np.asarray(x[0]).ravel()],
                          fill, dtype=fill.dtype)
        elif op == "Add":
            out = x[0] + x[1]
        elif op == "Sub":
            out = x[0] - x[1]
        elif op == "Mul":
            out = x[0] * x[1]
        elif op == "Div":
            if np.issubdtype(x[0].dtype, np.integer) \
                    and np.issubdtype(np.asarray(x[1]).dtype, np.integer):
                out = (x[0] / x[1]).astype(x[0].dtype)  # ONNX int div truncates
            else:
                out = x[0] / x[1]
        elif op == "Mod":
            if int(attrs.get("fmod", 0)):
                out = np.fmod(x[0], x[1])
            else:
                out = np.mod(x[0], x[1])
        elif op == "Pow":
            out = np.power(x[0], x[1])
        elif op == "Sqrt":
            out = np.sqrt(x[0])
        elif op == "Log":
            out = np.log(x[0])
        elif op == "Round":
            out = np.round(x[0])  # both are round-half-even
        elif op == "Sigmoid":
            out = 1.0 / (1.0 + np.exp(-x[0]))
        elif op == "Softmax":
            axis = int(attrs.get("axis", -1))
            e = np.exp(x[0] - x[0].max(axis=axis, keepdims=True))
            out = e / e.sum(axis=axis, keepdims=True)
        elif op == "Clip":
            lo = x[1] if len(x) > 1 else None
            hi = x[2] if len(x) > 2 else None
            out = np.clip(x[0], lo, hi)
        elif op == "Not":
            out = ~x[0]
        elif op == "And":
            out = x[0] & x[1]
        elif op == "Where":
            out = np.where(x[0], x[1], x[2])
        elif op in ("Equal", "Greater", "GreaterOrEqual", "Less",
                    "LessOrEqual"):
            out = {"Equal": np.equal, "Greater": np.greater,
                   "GreaterOrEqual": np.greater_equal, "Less": np.less,
                   "LessOrEqual": np.less_equal}[op](x[0], x[1])
        elif op == "MatMul":
            out = np.matmul(x[0], x[1])
        elif op == "ArgMax":
            axis = int(attrs.get("axis", 0))
            out = np.argmax(x[0], axis=axis)
            if int(attrs.get("keepdims", 1)):
                out = np.expand_dims(out, axis)
            out = out.astype(np.int64)
        elif op == "ReduceMax":
            out = _reduce(np.max, x[0], attrs.get("axes"),
                          attrs.get("keepdims", 1))
        elif op == "ReduceSum":
            axes = x[1] if len(x) > 1 else attrs.get("axes")
            out = _reduce(np.sum, x[0], axes, attrs.get("keepdims", 1))
        elif op == "CumSum":
            axis = int(np.asarray(x[1]).reshape(()))
            if int(attrs.get("exclusive", 0)) or int(attrs.get("reverse", 0)):
                raise NotImplementedError("CumSum exclusive/reverse")
            out = np.cumsum(x[0], axis=axis)
        elif op == "LayerNormalization":
            out = _layer_norm(x[0], x[1], x[2] if len(x) > 2 else 0.0, attrs)
        elif op == "Conv":
            out = _conv(x[0], x[1], x[2] if len(x) > 2 else None, attrs)
        elif op == "Pad":
            out = _pad_op(x[0], x[1], x[2] if len(x) > 2 else None, attrs)
        elif op == "STFT":
            out = _stft(x[0], x[1], x[2] if len(x) > 2 else None,
                        x[3] if len(x) > 3 else None, attrs)
        elif op == "Expand":
            out = np.broadcast_to(
                x[0], np.broadcast_shapes(
                    x[0].shape,
                    tuple(int(s) for s in np.asarray(x[1]).ravel()))).copy()
        elif op == "Range":
            out = np.arange(np.asarray(x[0]).reshape(()),
                            np.asarray(x[1]).reshape(()),
                            np.asarray(x[2]).reshape(()))
        else:
            raise NotImplementedError(f"op {op}")
        env[node.outputs[0]] = np.asarray(out)

    return [env[name] for name in graph_outputs]
