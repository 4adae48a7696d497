"""The subset of MessagePack that a checkpoint index uses: maps, strings,
integers, floats, booleans, nil and arrays.

The packer writes what ``msgpack.packb`` writes for these values (the
smallest integer format, float64, str types, arrays for lists and tuples),
and the unpacker reads that back as ``msgpack.unpackb`` does (lists for
arrays, str for strings), so the index is byte-compatible with the
reference's without the ``msgpack`` package.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack_len(n: int, fix_base: int, fix_max: int, codes, out: bytearray):
    if n <= fix_max:
        out.append(fix_base | n)
    elif codes[0] is not None and n < 1 << 8:
        out += bytes((codes[0], n))
    elif n < 1 << 16:
        out += struct.pack(">BH", codes[1], n)
    elif n < 1 << 32:
        out += struct.pack(">BI", codes[2], n)
    else:
        raise ValueError(f"length {n} too large for MessagePack")


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xCB, obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 15, (None, 0xDC, 0xDD), out)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, (None, 0xDE, 0xDF), out)
        for key, val in obj.items():
            _pack(key, out)
            _pack(val, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xFF)
    elif n >= 0:
        for code, fmt, top in ((0xCC, ">BB", 1 << 8), (0xCD, ">BH", 1 << 16),
                               (0xCE, ">BI", 1 << 32),
                               (0xCF, ">BQ", 1 << 64)):
            if n < top:
                out += struct.pack(fmt, code, n)
                return
        raise ValueError(f"integer {n} too large for MessagePack")
    else:
        for code, fmt, low in ((0xD0, ">Bb", -(1 << 7)),
                               (0xD1, ">Bh", -(1 << 15)),
                               (0xD2, ">Bi", -(1 << 31)),
                               (0xD3, ">Bq", -(1 << 63))):
            if n >= low:
                out += struct.pack(fmt, code, n)
                return
        raise ValueError(f"integer {n} too small for MessagePack")


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
          0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
_STR = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_ARRAY = {0xDC: ">H", 0xDD: ">I"}
_MAP = {0xDE: ">H", 0xDF: ">I"}


def unpackb(data: bytes) -> Any:
    obj, pos = _unpack(memoryview(data), 0)
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} trailing bytes")
    return obj


def _read(buf, pos: int, fmt: str) -> Tuple[Any, int]:
    size = struct.calcsize(fmt)
    if pos + size > len(buf):
        raise ValueError("truncated MessagePack data")
    return struct.unpack_from(fmt, buf, pos)[0], pos + size


def _unpack(buf, pos: int) -> Tuple[Any, int]:
    if pos >= len(buf):
        raise ValueError("truncated MessagePack data")
    b = buf[pos]
    pos += 1
    if b < 0x80:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0xA0 <= b <= 0xBF or b in _STR:
        n, pos = (b & 0x1F, pos) if b <= 0xBF else _read(buf, pos, _STR[b])
        if pos + n > len(buf):
            raise ValueError("truncated MessagePack data")
        return bytes(buf[pos:pos + n]).decode("utf-8"), pos + n
    if 0x90 <= b <= 0x9F or b in _ARRAY:
        n, pos = (b & 0x0F, pos) if b <= 0x9F else _read(buf, pos, _ARRAY[b])
        items = []
        for _ in range(n):
            item, pos = _unpack(buf, pos)
            items.append(item)
        return items, pos
    if 0x80 <= b <= 0x8F or b in _MAP:
        n, pos = (b & 0x0F, pos) if b <= 0x8F else _read(buf, pos, _MAP[b])
        out = {}
        for _ in range(n):
            key, pos = _unpack(buf, pos)
            out[key], pos = _unpack(buf, pos)
        return out, pos
    if b == 0xC0:
        return None, pos
    if b in (0xC2, 0xC3):
        return b == 0xC3, pos
    if b in _FIXED:
        return _read(buf, pos, _FIXED[b])
    raise ValueError(f"MessagePack type 0x{b:02x} is outside the index's "
                     f"subset")
