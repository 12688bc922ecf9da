"""Minimal protobuf wire-format codec for ONNX model files (a copy of
`mxnet_tpu/contrib/onnx/wire.py`, which is pure Python).

This environment ships no `onnx` package, so the importer reads the
protobuf wire format directly (the format is stable and self-describing at
the wire level; field numbers below follow the public onnx.proto3 schema).
The encoder half exists so tests can build fixture models without onnx
installed, and doubles as the start of an exporter.

Wire types: 0 = varint, 1 = 64-bit, 2 = length-delimited, 5 = 32-bit.
"""
from __future__ import annotations

import struct


# -- decoding ---------------------------------------------------------------

def read_uvarint(buf, pos):
    """Decode one base-128 varint; returns (value, next_pos)."""
    out = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def iter_fields(buf):
    """Yield (field_number, wire_type, raw) over a serialized message.

    raw is an int for wire types 0/1/5 and a memoryview for type 2.
    """
    view = memoryview(buf)
    pos = 0
    while pos < len(view):
        key, pos = read_uvarint(view, pos)
        num, wt = key >> 3, key & 7
        if wt == 0:
            val, pos = read_uvarint(view, pos)
        elif wt == 1:
            val = int.from_bytes(view[pos:pos + 8], "little")
            pos += 8
        elif wt == 2:
            size, pos = read_uvarint(view, pos)
            val = view[pos:pos + size]
            pos += size
        elif wt == 5:
            val = int.from_bytes(view[pos:pos + 4], "little")
            pos += 4
        else:
            raise ValueError("unsupported wire type %d (field %d)" % (wt, num))
        yield num, wt, val


def collect(buf):
    """Group a message's fields: {field_number: [(wire_type, raw), ...]}."""
    grouped = {}
    for num, wt, val in iter_fields(buf):
        grouped.setdefault(num, []).append((wt, val))
    return grouped


def ints(grouped, num):
    """All values of a repeated integer field, unpacking packed encoding."""
    out = []
    for wt, val in grouped.get(num, []):
        if wt == 0:
            out.append(val)
        elif wt == 2:  # packed
            pos = 0
            while pos < len(val):
                v, pos = read_uvarint(val, pos)
                out.append(v)
        else:
            raise ValueError("field %d: unexpected wire type %d" % (num, wt))
    return out


def signed(value, bits=64):
    """Reinterpret an unsigned varint as two's-complement."""
    if value >= 1 << (bits - 1):
        value -= 1 << bits
    return value


def floats(grouped, num):
    """All values of a repeated float field (packed or fixed32 entries)."""
    out = []
    for wt, val in grouped.get(num, []):
        if wt == 5:
            out.append(struct.unpack("<f", val.to_bytes(4, "little"))[0])
        elif wt == 2:
            out.extend(struct.unpack("<%df" % (len(val) // 4), val))
        else:
            raise ValueError("field %d: unexpected wire type %d" % (num, wt))
    return out


def first_bytes(grouped, num, default=b""):
    entries = grouped.get(num)
    return bytes(entries[0][1]) if entries else default


def first_str(grouped, num, default=""):
    return first_bytes(grouped, num, default.encode()).decode("utf-8")


def first_int(grouped, num, default=0):
    entries = grouped.get(num)
    return entries[0][1] if entries else default


def submessages(grouped, num):
    return [val for _, val in grouped.get(num, [])]


# -- encoding (fixture building / future export) ----------------------------

def uvarint(value):
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        out.append(b | (0x80 if value else 0))
        if not value:
            return bytes(out)


def field_varint(num, value):
    if value < 0:
        value += 1 << 64
    return uvarint(num << 3) + uvarint(value)


def field_bytes(num, payload):
    if isinstance(payload, str):
        payload = payload.encode("utf-8")
    return uvarint(num << 3 | 2) + uvarint(len(payload)) + bytes(payload)


def field_fixed32(num, value_f):
    return uvarint(num << 3 | 5) + struct.pack("<f", value_f)


def packed_varints(num, values):
    payload = b"".join(uvarint(v + (1 << 64) if v < 0 else v)
                       for v in values)
    return field_bytes(num, payload)
