"""The subset of MessagePack the checkpoint format uses, written and read
without the ``msgpack`` package: maps, str, bin, arrays and non-negative
integers.  ``packb`` encodes as ``msgpack.packb(..., use_bin_type=True)``
does (the smallest header for each length and value), so its bytes decode
with ``msgpack.unpackb`` and the other way round; any other type raises
``TypeError`` (encoding) or ``ValueError`` (decoding)."""

from __future__ import annotations

import struct


def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _header(n: int, small_tag: int | None, small_max: int, tags: tuple, out: bytearray):
    """A length header: ``small_tag | n`` when n <= small_max, else the
    8-, 16- or 32-bit form of ``tags`` (None where the type has none)."""
    if small_tag is not None and n <= small_max:
        out.append(small_tag | n)
    elif tags[0] is not None and n < 1 << 8:
        out += bytes((tags[0], n))
    elif n < 1 << 16:
        out.append(tags[1])
        out += struct.pack(">H", n)
    elif n < 1 << 32:
        out.append(tags[2])
        out += struct.pack(">I", n)
    else:
        raise ValueError(f"length {n} does not fit MessagePack")


def _pack(obj, out: bytearray) -> None:
    if isinstance(obj, bool) or obj is None:
        raise TypeError(f"not in the checkpoint subset: {obj!r}")
    if isinstance(obj, int):
        if obj < 0:
            raise TypeError(f"negative integer {obj} is not in the checkpoint subset")
        if obj < 0x80:
            out.append(obj)
        elif obj < 1 << 8:
            out += bytes((0xCC, obj))
        elif obj < 1 << 16:
            out.append(0xCD)
            out += struct.pack(">H", obj)
        elif obj < 1 << 32:
            out.append(0xCE)
            out += struct.pack(">I", obj)
        else:
            out.append(0xCF)
            out += struct.pack(">Q", obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _header(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        _header(len(b), None, -1, (0xC4, 0xC5, 0xC6), out)
        out += b
    elif isinstance(obj, (list, tuple)):
        _header(len(obj), 0x90, 15, (None, 0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _header(len(obj), 0x80, 15, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"not in the checkpoint subset: {type(obj).__name__}")


def unpackb(data) -> object:
    buf = memoryview(bytes(data))
    obj, end = _unpack(buf, 0)
    if end != len(buf):
        raise ValueError(f"{len(buf) - end} trailing bytes after the MessagePack object")
    return obj


_UINT = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q"}
_LEN = {0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
        0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
        0xDC: (">H", "array"), 0xDD: (">I", "array"),
        0xDE: (">H", "map"), 0xDF: (">I", "map")}


def _unpack(buf: memoryview, i: int):
    if i >= len(buf):
        raise ValueError("truncated MessagePack data")
    tag = buf[i]
    i += 1
    if tag < 0x80:
        return tag, i
    if 0x80 <= tag <= 0x8F:
        kind, n = "map", tag & 0x0F
    elif 0x90 <= tag <= 0x9F:
        kind, n = "array", tag & 0x0F
    elif 0xA0 <= tag <= 0xBF:
        kind, n = "str", tag & 0x1F
    elif tag in _UINT:
        fmt = _UINT[tag]
        size = struct.calcsize(fmt)
        return struct.unpack_from(fmt, buf, i)[0], i + size
    elif tag in _LEN:
        fmt, kind = _LEN[tag]
        n = struct.unpack_from(fmt, buf, i)[0]
        i += struct.calcsize(fmt)
    else:
        raise ValueError(f"MessagePack type 0x{tag:02x} is not in the checkpoint subset")
    if kind in ("str", "bin"):
        if i + n > len(buf):
            raise ValueError("truncated MessagePack data")
        raw = bytes(buf[i : i + n])
        return (raw.decode("utf-8") if kind == "str" else raw), i + n
    if kind == "array":
        out = []
        for _ in range(n):
            v, i = _unpack(buf, i)
            out.append(v)
        return out, i
    out = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        v, i = _unpack(buf, i)
        out[k] = v
    return out, i
