"""A protobuf writer for the frozen GraphDefs of the fixtures
(``bert_graph``, ``lstm_graph``, ``resnet_graph``), with no TensorFlow:
varints and length-delimited fields over the messages a frozen graph
uses (GraphDef, NodeDef, AttrValue, TensorShapeProto, TensorProto with
its values in ``tensor_content``, FunctionDef's pieces).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

_DT_FLOAT, _DT_INT32 = 1, 3
_NP_ENUM = {np.dtype(np.float32): _DT_FLOAT, np.dtype(np.int32): _DT_INT32}
#: the GraphDef producer version TensorFlow 2 writes for such a graph
_PRODUCER = 2474


# -- protobuf wire format ----------------------------------------------------
def _varint(n: int) -> bytes:
    if n < 0:
        n += 1 << 64                       # int64: two's complement
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _ld(field: int, payload: bytes) -> bytes:
    """A length-delimited field."""
    return _key(field, 2) + _varint(len(payload)) + payload


def _shape_proto(dims: Sequence[int]) -> bytes:
    return b"".join(_ld(2, _key(1, 0) + _varint(int(d))) for d in dims)


def _tensor_proto(arr: np.ndarray) -> bytes:
    return (_key(1, 0) + _varint(_NP_ENUM[arr.dtype])
            + _ld(2, _shape_proto(arr.shape)) + _ld(4, arr.tobytes()))


def _attr_type(enum: int) -> bytes:
    return _key(6, 0) + _varint(enum)


def _attr_i(v: int) -> bytes:
    return _key(3, 0) + _varint(int(v))


def _attr_b(v: bool) -> bytes:
    return _key(5, 0) + _varint(int(bool(v)))


def _node(name: str, op: str, inputs: Sequence[str],
          attrs: Dict[str, bytes]) -> bytes:
    body = _ld(1, name.encode()) + _ld(2, op.encode())
    body += b"".join(_ld(3, i.encode()) for i in inputs)
    for k in sorted(attrs):
        body += _ld(5, _ld(1, k.encode()) + _ld(2, attrs[k]))
    return body


class _Graph:
    """Nodes in creation order, named as TensorFlow names them."""

    def __init__(self):
        self.nodes: List[bytes] = []
        self._used: set = set()
        #: the variable reads, which TensorFlow's NoOp depends on
        self.reads: List[str] = []

    def unique(self, base: str) -> str:
        name, i = base, 0
        while name in self._used:
            i += 1
            name = f"{base}_{i}"
        self._used.add(name)
        return name

    def add(self, name: str, op: str, inputs=(), **attrs) -> str:
        self._used.add(name)
        self.nodes.append(_node(name, op, list(inputs), attrs))
        return name

    def const(self, name: str, value, inputs=()) -> str:
        arr = np.asarray(value)
        return self.add(name, "Const", inputs,
                        dtype=_attr_type(_NP_ENUM[arr.dtype]),
                        value=_ld(8, _tensor_proto(arr)))

    def serialize(self) -> bytes:
        versions = _key(1, 0) + _varint(_PRODUCER)
        return b"".join(_ld(1, n) for n in self.nodes) + _ld(4, versions)


def _attr_s(v: bytes) -> bytes:
    return _ld(2, v)


def _attr_func(name: str) -> bytes:
    return _ld(10, _ld(1, name.encode()))


def _attr_shape(dims: Sequence[int]) -> bytes:
    return _ld(7, _shape_proto(dims))


def _attr_list(types: Sequence[int] = (), ints: Sequence[int] = (),
               shapes: Sequence[Sequence[int]] = (),
               strings: Sequence[bytes] = ()) -> bytes:
    body = b"".join(_ld(2, s) for s in strings)
    if ints:
        body += _ld(3, b"".join(_varint(int(i)) for i in ints))
    if types:
        body += _ld(6, b"".join(_varint(t) for t in types))
    body += b"".join(_ld(7, _shape_proto(s)) for s in shapes)
    return _ld(1, body)
