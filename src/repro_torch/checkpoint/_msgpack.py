"""A small msgpack codec: the subset a checkpoint manifest or a mechanism
journal holds.

    data = packb({"step": 3, "keys": ["bank"], "extra": None})
    back = unpackb(data)

`packb` writes the bytes ``msgpack.packb`` writes with its defaults (the
smallest integer form, f64 floats, str8 for short strings, arrays for
lists and tuples, maps in insertion order), so a manifest written by the
port is byte for byte the reference's. `unpackb` reads what
``msgpack.packb`` writes: nil, bool, every int and float width, str, bin,
array and map, as ``msgpack.unpackb`` returns them (str keys and values,
lists for arrays). The port keeps this copy so that it does not need the
msgpack package on the card's machine.
"""
from __future__ import annotations

import struct
from typing import Any, List, Tuple


def _pack_int(v: int, out: List[bytes]) -> None:
    if 0 <= v < 0x80:
        out.append(struct.pack("B", v))
    elif -32 <= v < 0:
        out.append(struct.pack("b", v))
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < top:
                out.append(struct.pack("B", code) + struct.pack(fmt, v))
                return
        raise OverflowError(f"integer {v} does not fit in 64 bits")
    else:
        for code, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                               (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
            if v >= low:
                out.append(struct.pack("B", code) + struct.pack(fmt, v))
                return
        raise OverflowError(f"integer {v} does not fit in 64 bits")


def _pack_len(n: int, fix: int, fix_max: int, codes, out: List[bytes]) -> None:
    """The header of a str, bin, array or map of length n: the fix form
    below fix_max (when the type has one), else the smallest of `codes`
    ((code, struct format, limit), ...)."""
    if fix is not None and n < fix_max:
        out.append(struct.pack("B", fix | n))
        return
    for code, fmt, top in codes:
        if n < top:
            out.append(struct.pack("B", code) + struct.pack(fmt, n))
            return
    raise ValueError(f"length {n} is too large for msgpack")


_STR = ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32))
_BIN = ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16), (0xC6, ">I", 1 << 32))
_ARRAY = ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))
_MAP = ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 32, _STR, out)
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(len(data), None, 0, _BIN, out)
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, _ARRAY, out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, _MAP, out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} object")


def packb(obj: Any) -> bytes:
    """`obj` as msgpack bytes, equal to ``msgpack.packb(obj)``."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


# fixed-width forms: code -> (struct format, byte count)
_FIXED = {0xCA: (">f", 4), 0xCB: (">d", 8), 0xCC: (">B", 1), 0xCD: (">H", 2),
          0xCE: (">I", 4), 0xCF: (">Q", 8), 0xD0: (">b", 1), 0xD1: (">h", 2),
          0xD2: (">i", 4), 0xD3: (">q", 8)}
# length-prefixed forms: code -> (kind, struct format of the length, bytes)
_SIZED = {0xD9: ("str", ">B", 1), 0xDA: ("str", ">H", 2), 0xDB: ("str", ">I", 4),
          0xC4: ("bin", ">B", 1), 0xC5: ("bin", ">H", 2), 0xC6: ("bin", ">I", 4),
          0xDC: ("array", ">H", 2), 0xDD: ("array", ">I", 4),
          0xDE: ("map", ">H", 2), 0xDF: ("map", ">I", 4)}


def _take(data: bytes, pos: int, n: int) -> Tuple[bytes, int]:
    if pos + n > len(data):
        raise ValueError("truncated msgpack data")
    return data[pos:pos + n], pos + n


def _unpack(data: bytes, pos: int) -> Tuple[Any, int]:
    b, pos = _take(data, pos, 1)
    code = b[0]
    if code < 0x80:
        return code, pos
    if code >= 0xE0:
        return code - 0x100, pos
    if 0xA0 <= code <= 0xBF:
        raw, pos = _take(data, pos, code & 0x1F)
        return raw.decode("utf-8"), pos
    if 0x90 <= code <= 0x9F:
        return _unpack_seq(data, pos, code & 0x0F)
    if 0x80 <= code <= 0x8F:
        return _unpack_map(data, pos, code & 0x0F)
    if code == 0xC0:
        return None, pos
    if code in (0xC2, 0xC3):
        return code == 0xC3, pos
    if code in _FIXED:
        fmt, n = _FIXED[code]
        raw, pos = _take(data, pos, n)
        return struct.unpack(fmt, raw)[0], pos
    if code in _SIZED:
        kind, fmt, n = _SIZED[code]
        raw, pos = _take(data, pos, n)
        length = struct.unpack(fmt, raw)[0]
        if kind == "array":
            return _unpack_seq(data, pos, length)
        if kind == "map":
            return _unpack_map(data, pos, length)
        raw, pos = _take(data, pos, length)
        return (raw.decode("utf-8") if kind == "str" else raw), pos
    raise ValueError(f"msgpack type 0x{code:02x} is not one a manifest holds")


def _unpack_seq(data: bytes, pos: int, n: int) -> Tuple[list, int]:
    out = []
    for _ in range(n):
        v, pos = _unpack(data, pos)
        out.append(v)
    return out, pos


def _unpack_map(data: bytes, pos: int, n: int) -> Tuple[dict, int]:
    out = {}
    for _ in range(n):
        k, pos = _unpack(data, pos)
        if not isinstance(k, (str, bytes)):
            raise ValueError(f"map key of type {type(k).__name__}: msgpack.unpackb "
                             "accepts str and bytes keys only")
        v, pos = _unpack(data, pos)
        out[k] = v
    return out, pos


def unpackb(data: bytes) -> Any:
    """The object msgpack bytes encode, as ``msgpack.unpackb(data)``
    returns it."""
    obj, pos = _unpack(bytes(data), 0)
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} bytes of extra data after the msgpack object")
    return obj
