"""The Merger bridge's five proto3 messages, encoded and decoded by hand.

The counterpart of the JAX package's generated ``bridge/merger_pb2.py``
for the schema in ``merger.proto``: the same message and field names, and
``SerializeToString`` / ``FromString`` / ``ParseFromString`` giving and
taking the same bytes, with no ``google.protobuf`` (the machines the port
serves from need not have it).  What the codec does:

  * writes fields in tag order and omits proto3 zero values; a message
    field is written when it is set (even to an empty message), as
    protobuf's presence rule has it;
  * writes repeated uint64 packed, and reads them packed or unpacked;
  * skips unknown fields (varint, fixed64, length-delimited, groups,
    fixed32), and a known field of the wrong wire type likewise;
  * merges a message field that arrives twice, and keeps the last of a
    repeated scalar's values;
  * truncates a uint32 field to its low 32 bits on read, and refuses a
    value out of range on write (``ValueError``);
  * raises ``DecodeError`` (a ``ValueError``, with protobuf's message
    text) on truncated or malformed input.
"""

from __future__ import annotations

import operator
from typing import Dict, NamedTuple, Optional, Tuple

UINT32, UINT64, BOOL, STRING, MESSAGE = range(5)
_RANGE = {UINT32: (1 << 32) - 1, UINT64: (1 << 64) - 1}
_ZERO = {UINT32: 0, UINT64: 0, BOOL: False, STRING: ""}
_WIRE_VARINT, _WIRE_FIXED64, _WIRE_LEN, _WIRE_START, _WIRE_END, \
    _WIRE_FIXED32 = range(6)


class DecodeError(ValueError):
    """Bytes that do not parse as the message asked for."""


class _Malformed(Exception):
    """Raised inside the parser; the entry points turn it into
    ``DecodeError`` naming the top-level message."""


class Field(NamedTuple):
    number: int
    name: str
    kind: int
    repeated: bool = False
    message: Optional[type] = None


def _put_varint(out: bytearray, v: int) -> None:
    if v < 0x80:
        out.append(v)
        return
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _get_varint(buf: bytes, pos: int, end: int) -> Tuple[int, int]:
    if pos < end and buf[pos] < 0x80:
        return buf[pos], pos + 1
    out = 0
    for shift in range(0, 70, 7):
        if pos >= end:
            raise _Malformed("truncated varint")
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out & _RANGE[UINT64], pos
    raise _Malformed("varint longer than 10 bytes")


def _check_int(kind: int, v) -> int:
    v = operator.index(v)
    if not 0 <= v <= _RANGE[kind]:
        raise ValueError(f"Value out of range: {v}")
    return v


def _get_key(buf: bytes, pos: int, end: int) -> Tuple[int, int, int]:
    """(field number, wire type, position past the key)."""
    key, pos = _get_varint(buf, pos, end)
    if key > _RANGE[UINT32] or key >> 3 == 0:
        raise _Malformed(f"bad field key {key}")
    return key >> 3, key & 7, pos


def _skip(buf: bytes, pos: int, end: int, number: int, wire: int) -> int:
    """The position past one unknown field whose key was just read."""
    if wire == _WIRE_VARINT:
        return _get_varint(buf, pos, end)[1]
    if wire == _WIRE_FIXED64:
        pos += 8
    elif wire == _WIRE_FIXED32:
        pos += 4
    elif wire == _WIRE_LEN:
        n, pos = _get_varint(buf, pos, end)
        pos += n
    elif wire == _WIRE_START:
        while True:
            inner, inner_wire, pos = _get_key(buf, pos, end)
            if inner_wire == _WIRE_END:
                if inner != number:
                    raise _Malformed("mismatched end group")
                return pos
            pos = _skip(buf, pos, end, inner, inner_wire)
    else:  # an end group with no start, or wire types 6 and 7
        raise _Malformed(f"wire type {wire}")
    if pos > end:
        raise _Malformed("truncated field")
    return pos


class Message:
    """Base of the five messages: fields from the class's ``FIELDS``."""

    FULL_NAME = ""
    FIELDS: Tuple[Field, ...] = ()
    _BY_NAME: Dict[str, Field] = {}
    _BY_NUMBER: Dict[int, Field] = {}
    _DEFAULTS: Dict[str, object] = {}
    _REPEATED: Tuple[str, ...] = ()

    def __init__(self, **kwargs):
        values = dict(self._DEFAULTS)
        for name in self._REPEATED:
            values[name] = []
        object.__setattr__(self, "_values", values)
        for name, value in kwargs.items():
            setattr(self, name, value)

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        cls._BY_NAME = {f.name: f for f in cls.FIELDS}
        cls._BY_NUMBER = {f.number: f for f in cls.FIELDS}
        cls._DEFAULTS = {f.name: None if f.kind == MESSAGE else _ZERO[f.kind]
                         for f in cls.FIELDS if not f.repeated}
        cls._REPEATED = tuple(f.name for f in cls.FIELDS if f.repeated)

    def __getattr__(self, name):
        f = type(self)._BY_NAME.get(name)
        if f is None:
            raise AttributeError(name)
        v = self._values[name]
        if v is None:  # an unset message field reads as an empty one
            return f.message()
        return v

    def __setattr__(self, name, value):
        f = type(self)._BY_NAME.get(name)
        if f is None:
            raise AttributeError(f'Protocol message {type(self).__name__} '
                                 f'has no "{name}" field.')
        if f.repeated:
            value = list(value)
        elif f.kind == MESSAGE:
            if not isinstance(value, f.message):
                raise TypeError(f"field {name}: expected "
                                f"{f.message.__name__}, got "
                                f"{type(value).__name__}")
        elif f.kind == BOOL:
            value = bool(value)
        elif f.kind == STRING:
            if isinstance(value, bytes):
                value = value.decode("utf-8")
            if not isinstance(value, str):
                raise TypeError(f"field {name}: expected str, got "
                                f"{type(value).__name__}")
        else:
            value = _check_int(f.kind, value)
        self._values[name] = value

    def HasField(self, name: str) -> bool:  # noqa: N802 (protobuf's name)
        """Whether the message field ``name`` is set (proto3 scalars and
        repeated fields have no presence)."""
        f = type(self)._BY_NAME[name]
        if f.kind != MESSAGE or f.repeated:
            raise ValueError(f"field {name} has no presence")
        return self._values[name] is not None

    def __eq__(self, other) -> bool:
        return type(other) is type(self) and self._values == other._values

    def __repr__(self) -> str:
        set_fields = ", ".join(
            f"{k}={v!r}" for k, v in self._values.items()
            if v not in (None, [], "", 0, False))
        return f"{type(self).__name__}({set_fields})"

    # -- encoding ---------------------------------------------------------

    def SerializeToString(self) -> bytes:  # noqa: N802 (protobuf's name)
        out = bytearray()
        self._write(out)
        return bytes(out)

    def _write(self, out: bytearray) -> None:
        for f in self.FIELDS:
            v = self._values[f.name]
            if f.repeated:
                if not v:
                    continue
                if f.kind in _RANGE:  # packed
                    body = bytearray()
                    for x in v:
                        _put_varint(body, _check_int(f.kind, x))
                    _put_varint(out, f.number << 3 | _WIRE_LEN)
                    _put_varint(out, len(body))
                    out += body
                else:
                    for x in v:
                        self._write_len(out, f, x)
            elif f.kind == MESSAGE:
                if v is not None:
                    self._write_len(out, f, v)
            elif v != _ZERO[f.kind]:
                if f.kind == STRING:
                    self._write_len(out, f, v)
                else:
                    _put_varint(out, f.number << 3 | _WIRE_VARINT)
                    _put_varint(out, 1 if f.kind == BOOL
                                else _check_int(f.kind, v))

    @staticmethod
    def _write_len(out: bytearray, f: Field, v) -> None:
        if f.kind == MESSAGE:
            if not isinstance(v, f.message):
                raise TypeError(f"field {f.name}: expected "
                                f"{f.message.__name__}, got "
                                f"{type(v).__name__}")
            body = v.SerializeToString()
        else:
            body = v.encode("utf-8")
        _put_varint(out, f.number << 3 | _WIRE_LEN)
        _put_varint(out, len(body))
        out += body

    # -- decoding ---------------------------------------------------------

    @classmethod
    def FromString(cls, data: bytes):  # noqa: N802 (protobuf's name)
        msg = cls()
        msg.ParseFromString(data)
        return msg

    def ParseFromString(self, data: bytes) -> int:  # noqa: N802
        """Clear this message, then read ``data`` into it; returns the
        bytes read."""
        data = bytes(data)
        type(self).__init__(self)
        try:
            self._read(data, 0, len(data))
        except _Malformed as exc:
            raise DecodeError(f"Error parsing message with type "
                              f"'{self.FULL_NAME}'") from exc
        return len(data)

    def _read(self, buf: bytes, pos: int, end: int) -> None:
        values = self._values
        while pos < end:
            number, wire, pos = _get_key(buf, pos, end)
            f = self._BY_NUMBER.get(number)
            want = (_WIRE_LEN if f is None or f.kind in (STRING, MESSAGE)
                    else _WIRE_VARINT)
            packed = (f is not None and f.repeated and f.kind in _RANGE
                      and wire == _WIRE_LEN)
            if f is None or (wire != want and not packed):
                pos = _skip(buf, pos, end, number, wire)
                continue
            if wire == _WIRE_VARINT:
                v, pos = _get_varint(buf, pos, end)
                v = self._scalar(f, v)
                if f.repeated:
                    values[f.name].append(v)
                else:
                    values[f.name] = v
                continue
            n, pos = _get_varint(buf, pos, end)
            stop = pos + n
            if stop > end:
                raise _Malformed("truncated length-delimited field")
            if packed:
                while pos < stop:
                    v, pos = _get_varint(buf, pos, stop)
                    values[f.name].append(self._scalar(f, v))
            elif f.kind == STRING:
                try:
                    v = buf[pos:stop].decode("utf-8")
                except UnicodeDecodeError as exc:
                    raise _Malformed("invalid utf-8") from exc
                if f.repeated:
                    values[f.name].append(v)
                else:
                    values[f.name] = v
            else:
                if f.repeated:
                    sub = f.message()
                    values[f.name].append(sub)
                else:
                    sub = values[f.name]
                    if sub is None:  # a second occurrence merges
                        sub = values[f.name] = f.message()
                sub._read(buf, pos, stop)
            pos = stop

    @staticmethod
    def _scalar(f: Field, v: int):
        if f.kind == BOOL:
            return v != 0
        if f.kind == UINT32:
            return v & _RANGE[UINT32]
        return v


class Dot(Message):
    FULL_NAME = "crdtbridge.Dot"
    FIELDS = (Field(1, "actor", UINT32), Field(2, "counter", UINT64))


class Entry(Message):
    FULL_NAME = "crdtbridge.Entry"
    FIELDS = (Field(1, "key", STRING), Field(2, "dot", MESSAGE, message=Dot))


class ReplicaState(Message):
    FULL_NAME = "crdtbridge.ReplicaState"
    FIELDS = (Field(1, "actor", UINT32),
              Field(2, "version_vector", UINT64, repeated=True),
              Field(3, "entries", MESSAGE, repeated=True, message=Entry),
              Field(4, "deleted", MESSAGE, repeated=True, message=Entry),
              Field(5, "processed", UINT64, repeated=True))


class MergeRequest(Message):
    FULL_NAME = "crdtbridge.MergeRequest"
    FIELDS = (Field(1, "dst", MESSAGE, message=ReplicaState),
              Field(2, "src", MESSAGE, message=ReplicaState),
              Field(3, "delta", BOOL),
              Field(4, "delta_semantics", STRING),
              Field(5, "strict_reference_semantics", BOOL))


class MergeResponse(Message):
    FULL_NAME = "crdtbridge.MergeResponse"
    FIELDS = (Field(1, "merged", MESSAGE, message=ReplicaState),
              Field(2, "sorted_values", STRING, repeated=True),
              Field(3, "canonical", STRING),
              Field(4, "error", STRING))
