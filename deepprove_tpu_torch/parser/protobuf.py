"""Minimal protobuf wire-format reader (no generated code, no deps), a
copy of the JAX package's `parser/protobuf.py`.

ONNX models are protobuf files, and the wire format is simple enough to
read directly. Returns {field_number: [values]} maps; nested messages are
parsed lazily by the caller.
"""

from __future__ import annotations


def read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def parse_message(buf: bytes) -> dict[int, list]:
    """One pass over a serialized message; values are ints or bytes."""
    out: dict[int, list] = {}
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = read_varint(buf, pos)
        field = key >> 3
        wire = key & 7
        if wire == 0:
            val, pos = read_varint(buf, pos)
        elif wire == 1:
            val = buf[pos : pos + 8]
            pos += 8
        elif wire == 2:
            ln, pos = read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        out.setdefault(field, []).append(val)
    return out


def get_bytes(msg: dict, field: int) -> list[bytes]:
    return [v for v in msg.get(field, [])]


def get_ints(msg: dict, field: int) -> list[int]:
    out = []
    for v in msg.get(field, []):
        if isinstance(v, int):
            out.append(v)
        else:  # packed repeated varints
            pos = 0
            while pos < len(v):
                x, pos = read_varint(v, pos)
                out.append(x)
    return out


def zigzag_to_signed(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def to_signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v
