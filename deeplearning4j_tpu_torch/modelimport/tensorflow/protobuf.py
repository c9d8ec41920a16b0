"""Minimal protobuf wire-format decoder for TensorFlow GraphDef.

Counterpart of ``deeplearning4j_tpu/modelimport/tensorflow/protobuf.py``
(numpy only, copied), reading through ``memoryview`` slices: a nested
message or a ``tensor_content`` payload is a view of the one buffer, not
a copy, so a full-width BERT-base GraphDef (~440 MB) is decoded without
copying its weights once per nesting level. Strings come out as ``str``
(names) or ``bytes`` (``s`` attrs), as in the JAX package. It covers the
message subset a frozen GraphDef uses: GraphDef, NodeDef, AttrValue,
TensorProto, TensorShapeProto, and the FunctionDef library.

Wire format: each field is a (field_number << 3 | wire_type) varint key
followed by a payload — varint (0), fixed64 (1), length-delimited (2),
fixed32 (5).
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _signed(v: int) -> int:
    """protobuf int64: negative values are 64-bit two's complement."""
    return v - (1 << 64) if v >= (1 << 63) else v


def decode_fields(buf) -> Dict[int, List[Tuple[int, object]]]:
    """Decode one message into {field_number: [(wire_type, raw), ...]};
    length-delimited payloads are ``memoryview`` slices of ``buf``."""
    buf = memoryview(buf)
    fields: Dict[int, List[Tuple[int, object]]] = {}
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _varint(buf, pos)
        fnum, wt = key >> 3, key & 7
        if wt == 0:
            val, pos = _varint(buf, pos)
        elif wt == 1:
            val = buf[pos:pos + 8]
            pos += 8
        elif wt == 2:
            ln, pos = _varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        fields.setdefault(fnum, []).append((wt, val))
    return fields


def _packed_varints(entries) -> List[int]:
    """A repeated varint field: packed (wire 2) or unpacked (wire 0)."""
    out: List[int] = []
    for wt, raw in entries:
        if wt == 0:
            out.append(_signed(raw))
        else:
            pos = 0
            while pos < len(raw):
                v, pos = _varint(raw, pos)
                out.append(_signed(v))
    return out


def _packed_floats(entries) -> List[float]:
    out: List[float] = []
    for wt, raw in entries:
        if wt == 5:
            out.append(struct.unpack("<f", raw)[0])
        else:
            out.extend(struct.unpack(f"<{len(raw) // 4}f", raw))
    return out


def _packed_doubles(entries) -> List[float]:
    out: List[float] = []
    for wt, raw in entries:
        if wt == 1:
            out.append(struct.unpack("<d", raw)[0])
        else:
            out.extend(struct.unpack(f"<{len(raw) // 8}d", raw))
    return out


# TF DataType enum -> numpy dtype (common subset)
TF_DTYPES: Dict[int, np.dtype] = {
    1: np.dtype(np.float32), 2: np.dtype(np.float64),
    3: np.dtype(np.int32), 4: np.dtype(np.uint8),
    5: np.dtype(np.int16), 6: np.dtype(np.int8),
    9: np.dtype(np.int64), 10: np.dtype(np.bool_),
    17: np.dtype(np.uint16), 19: np.dtype(np.float16),
    22: np.dtype(np.uint32), 23: np.dtype(np.uint64),
}


def tf_dtype_to_np(enum: int) -> np.dtype:
    if enum == 14:                       # DT_BFLOAT16
        import ml_dtypes
        return np.dtype(ml_dtypes.bfloat16)
    if enum == 7:                        # DT_STRING
        return np.dtype(object)
    if enum in TF_DTYPES:
        return TF_DTYPES[enum]
    raise ValueError(f"unsupported TF dtype enum {enum}")


def parse_shape(buf: bytes) -> Optional[Tuple[int, ...]]:
    """TensorShapeProto: dim=2 (Dim.size=1), unknown_rank=3."""
    f = decode_fields(buf)
    if 3 in f and f[3][0][1]:
        return None
    dims = []
    for _, dbuf in f.get(2, []):
        df = decode_fields(dbuf)
        # proto3 omits zero-valued fields: an absent size IS 0 (e.g.
        # the shape-[0] element_shape tensor of a scalar TensorList);
        # unknown dims are an explicit -1
        size = _signed(df[1][0][1]) if 1 in df else 0
        dims.append(size)
    return tuple(dims)


def parse_tensor(buf: bytes) -> np.ndarray:
    """TensorProto → numpy array."""
    f = decode_fields(buf)
    dtype_enum = f[1][0][1] if 1 in f else 1
    dtype = tf_dtype_to_np(dtype_enum)
    shape = parse_shape(f[2][0][1]) if 2 in f else ()
    shape = tuple(d for d in (shape or ()))
    count = int(np.prod(shape)) if shape else 1
    if 4 in f and len(f[4][0][1]):                 # tensor_content
        chunks = [raw for _, raw in f[4]]
        content = chunks[0] if len(chunks) == 1 else b"".join(chunks)
        arr = np.frombuffer(content, dtype=dtype)
        return arr.reshape(shape).copy()
    vals: Optional[np.ndarray] = None
    if dtype_enum in (1,) and 5 in f:              # float_val
        vals = np.asarray(_packed_floats(f[5]), np.float32)
    elif dtype_enum == 2 and 6 in f:               # double_val
        vals = np.asarray(_packed_doubles(f[6]), np.float64)
    elif dtype_enum in (3, 4, 5, 6, 17) and 7 in f:  # int_val
        vals = np.asarray(_packed_varints(f[7]), dtype)
    elif dtype_enum == 9 and 10 in f:              # int64_val
        vals = np.asarray(_packed_varints(f[10]), np.int64)
    elif dtype_enum == 10 and 11 in f:             # bool_val
        vals = np.asarray([bool(v) for v in _packed_varints(f[11])])
    elif dtype_enum in (14, 19) and 13 in f:       # half_val (bit patterns)
        bits = np.asarray(_packed_varints(f[13]), np.uint16)
        vals = bits.view(dtype)
    elif dtype_enum == 7 and 8 in f:               # string_val
        vals = np.asarray([bytes(raw) for _, raw in f[8]], object)
    if vals is None:
        return np.zeros(shape, dtype)
    if vals.size == 1 and count > 1:               # splat fill
        return np.full(shape, vals.reshape(-1)[0], dtype)
    return vals.reshape(shape)


class Attr:
    """One decoded AttrValue. ``kind`` in {s,i,f,b,type,shape,tensor,
    list,func,placeholder}; ``value`` is the python-native payload."""
    __slots__ = ("kind", "value")

    def __init__(self, kind: str, value):
        self.kind = kind
        self.value = value

    def __repr__(self):
        return f"Attr({self.kind}={self.value!r})"


def parse_attr(buf: bytes) -> Attr:
    f = decode_fields(buf)
    if 2 in f:
        return Attr("s", bytes(f[2][0][1]))
    if 3 in f:
        return Attr("i", _signed(f[3][0][1]))
    if 4 in f:
        return Attr("f", struct.unpack("<f", f[4][0][1])[0])
    if 5 in f:
        return Attr("b", bool(f[5][0][1]))
    if 6 in f:
        return Attr("type", f[6][0][1])
    if 7 in f:
        return Attr("shape", parse_shape(f[7][0][1]))
    if 8 in f:
        try:
            return Attr("tensor", parse_tensor(f[8][0][1]))
        except Exception as e:
            # e.g. DT_VARIANT consts (TensorArray/TensorList flow
            # state) or unknown-rank shapes: defer the failure so the
            # importer's unmapped-op precheck can report the real
            # problem first; touching the value raises then
            return Attr("tensor_error", e)
    if 10 in f:
        nf = decode_fields(f[10][0][1])
        name = nf[1][0][1].tobytes().decode() if 1 in nf else ""
        return Attr("func", name)
    if 1 in f:                                     # ListValue
        lf = decode_fields(f[1][0][1])
        if 2 in lf:
            return Attr("list", [bytes(raw) for _, raw in lf[2]])
        if 3 in lf:
            return Attr("list", _packed_varints(lf[3]))
        if 4 in lf:
            return Attr("list", _packed_floats(lf[4]))
        if 5 in lf:
            return Attr("list", [bool(v) for v in _packed_varints(lf[5])])
        if 6 in lf:
            return Attr("list", _packed_varints(lf[6]))
        if 7 in lf:
            return Attr("list", [parse_shape(raw) for _, raw in lf[7]])
        if 8 in lf:
            return Attr("list", [parse_tensor(raw) for _, raw in lf[8]])
        return Attr("list", [])
    return Attr("b", False)


class NodeDef:
    __slots__ = ("name", "op", "inputs", "attrs")

    def __init__(self, name: str, op: str, inputs: List[str],
                 attrs: Dict[str, Attr]):
        self.name = name
        self.op = op
        self.inputs = inputs
        self.attrs = attrs

    def attr(self, key: str, default=None):
        a = self.attrs.get(key)
        return a.value if a is not None else default

    def __repr__(self):
        return f"NodeDef({self.op} '{self.name}' <- {self.inputs})"


def parse_node(buf: bytes) -> NodeDef:
    f = decode_fields(buf)
    name = f[1][0][1].tobytes().decode() if 1 in f else ""
    op = f[2][0][1].tobytes().decode() if 2 in f else ""
    inputs = [raw.tobytes().decode() for _, raw in f.get(3, [])]
    attrs: Dict[str, Attr] = {}
    for _, entry in f.get(5, []):                  # map<string, AttrValue>
        ef = decode_fields(entry)
        key = ef[1][0][1].tobytes().decode() if 1 in ef else ""
        attrs[key] = parse_attr(ef[2][0][1]) if 2 in ef else Attr("b",
                                                                  False)
    return NodeDef(name, op, inputs, attrs)


def parse_graphdef(buf: bytes) -> List[NodeDef]:
    """GraphDef: node=1 (repeated NodeDef)."""
    f = decode_fields(buf)
    return [parse_node(raw) for _, raw in f.get(1, [])]


class FunctionDef:
    """One decoded tf.FunctionDef (the body/cond subgraphs of
    functional control flow: While/StatelessWhile/If)."""
    __slots__ = ("name", "input_args", "output_args", "nodes", "ret")

    def __init__(self, name, input_args, output_args, nodes, ret):
        self.name = name
        self.input_args = input_args    # [(arg_name, dtype_enum)]
        self.output_args = output_args  # [(arg_name, dtype_enum)]
        self.nodes = nodes              # [NodeDef]
        self.ret = ret                  # {output_arg_name: tensor_ref}

    def __repr__(self):
        return (f"FunctionDef('{self.name}' "
                f"{[a for a, _ in self.input_args]} -> "
                f"{[a for a, _ in self.output_args]}, "
                f"{len(self.nodes)} nodes)")


def _parse_arg_def(buf: bytes) -> Tuple[str, int]:
    """OpDef.ArgDef: name=1, type=3."""
    f = decode_fields(buf)
    name = f[1][0][1].tobytes().decode() if 1 in f else ""
    dtype = f[3][0][1] if 3 in f else 0
    return name, dtype


def parse_function_def(buf: bytes) -> FunctionDef:
    """FunctionDef: signature(OpDef)=1, node_def=3, ret(map)=4."""
    f = decode_fields(buf)
    name, in_args, out_args = "", [], []
    if 1 in f:                                     # OpDef
        sf = decode_fields(f[1][0][1])
        name = sf[1][0][1].tobytes().decode() if 1 in sf else ""
        in_args = [_parse_arg_def(raw) for _, raw in sf.get(2, [])]
        out_args = [_parse_arg_def(raw) for _, raw in sf.get(3, [])]
    nodes = [parse_node(raw) for _, raw in f.get(3, [])]
    ret: Dict[str, str] = {}
    for _, entry in f.get(4, []):                  # map<string,string>
        ef = decode_fields(entry)
        k = ef[1][0][1].tobytes().decode() if 1 in ef else ""
        v = ef[2][0][1].tobytes().decode() if 2 in ef else ""
        ret[k] = v
    return FunctionDef(name, in_args, out_args, nodes, ret)


def parse_graphdef_with_library(buf: bytes
                                ) -> Tuple[List[NodeDef],
                                           Dict[str, FunctionDef]]:
    """GraphDef: node=1, library(FunctionDefLibrary{function=1})=2."""
    f = decode_fields(buf)
    nodes = [parse_node(raw) for _, raw in f.get(1, [])]
    functions: Dict[str, FunctionDef] = {}
    for _, raw in f.get(2, []):
        lf = decode_fields(raw)
        for _, fraw in lf.get(1, []):
            fd = parse_function_def(fraw)
            functions[fd.name] = fd
    return nodes, functions
