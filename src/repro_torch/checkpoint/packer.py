"""A MessagePack packer and unpacker for checkpoint manifests.

Covers the types a manifest holds (dict, list / tuple, str, bytes, int,
float, bool, None) and gives the bytes `msgpack.packb` gives with its
defaults (str as UTF-8 str, bytes as bin, floats as float64, each int in
its smallest encoding, maps in insertion order); `unpackb` reads what
`msgpack.packb` writes of those types (maps to dicts, arrays to lists, as
`msgpack.unpackb`'s defaults). So a manifest crosses between this store
and the reference's with no `msgpack` package on the machine.
"""
from __future__ import annotations

import struct


def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), out, fix=(0xA0, 32), tags=(0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _pack_len(len(raw), out, fix=None, tags=(0xC4, 0xC5, 0xC6))
        out += raw
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, fix=(0x90, 16), tags=(None, 0xDC, 0xDD))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, fix=(0x80, 16), tags=(None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__} into a manifest")


def _pack_len(n: int, out: bytearray, *, fix, tags) -> None:
    """A length header: the fix form below fix[1], else 8-, 16- or 32-bit
    (tags[0] None: no 8-bit form, as arrays and maps)."""
    if fix is not None and n < fix[1]:
        out.append(fix[0] | n)
    elif tags[0] is not None and n <= 0xFF:
        out += bytes((tags[0], n))
    elif n <= 0xFFFF:
        out += bytes((tags[1],)) + struct.pack(">H", n)
    elif n <= 0xFFFFFFFF:
        out += bytes((tags[2],)) + struct.pack(">I", n)
    else:
        raise ValueError(f"length {n} does not fit a manifest")


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80 or -32 <= n < 0:
        out += struct.pack(">b" if n < 0 else ">B", n)
    elif n >= 0:
        for tag, fmt, hi in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                             (0xCE, ">I", 0xFFFFFFFF),
                             (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if n <= hi:
                out += bytes((tag,)) + struct.pack(fmt, n)
                return
        raise OverflowError(f"integer {n} does not fit 64 bits")
    else:
        for tag, fmt, lo in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                             (0xD2, ">i", -0x80000000),
                             (0xD3, ">q", -0x8000000000000000)):
            if n >= lo:
                out += bytes((tag,)) + struct.pack(fmt, n)
                return
        raise OverflowError(f"integer {n} does not fit 64 bits")


_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
          0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LENGTH = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
           0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
           0xDC: (">H", "array"), 0xDD: (">I", "array"),
           0xDE: (">H", "map"), 0xDF: (">I", "map")}


def unpackb(data: bytes):
    obj, end = _unpack(memoryview(data), 0)
    if end != len(data):
        raise ValueError(f"{len(data) - end} trailing bytes after the "
                         f"manifest")
    return obj


def _unpack(buf: memoryview, i: int):
    tag = buf[i]
    i += 1
    if tag <= 0x7F:
        return tag, i
    if tag >= 0xE0:
        return tag - 0x100, i
    if 0x80 <= tag <= 0x8F:
        return _unpack_map(buf, i, tag & 0x0F)
    if 0x90 <= tag <= 0x9F:
        return _unpack_array(buf, i, tag & 0x0F)
    if 0xA0 <= tag <= 0xBF:
        n = tag & 0x1F
        return str(buf[i:i + n], "utf-8"), i + n
    if tag == 0xC0:
        return None, i
    if tag in (0xC2, 0xC3):
        return tag == 0xC3, i
    if tag in _FIXED:
        fmt = _FIXED[tag]
        (v,) = struct.unpack_from(fmt, buf, i)
        return v, i + struct.calcsize(fmt)
    if tag in _LENGTH:
        fmt, kind = _LENGTH[tag]
        (n,) = struct.unpack_from(fmt, buf, i)
        i += struct.calcsize(fmt)
        if kind == "bin":
            return bytes(buf[i:i + n]), i + n
        if kind == "str":
            return str(buf[i:i + n], "utf-8"), i + n
        if kind == "array":
            return _unpack_array(buf, i, n)
        return _unpack_map(buf, i, n)
    raise ValueError(f"manifest holds an unsupported msgpack type 0x{tag:02x}")


def _unpack_array(buf, i, n):
    out = []
    for _ in range(n):
        v, i = _unpack(buf, i)
        out.append(v)
    return out, i


def _unpack_map(buf, i, n):
    out = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        if not isinstance(k, (str, bytes)):
            raise ValueError(f"manifest map key of type {type(k).__name__}")
        v, i = _unpack(buf, i)
        out[k] = v
    return out, i
