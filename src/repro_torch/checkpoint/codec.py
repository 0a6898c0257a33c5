"""The msgpack subset the checkpoint format uses, without ``msgpack``.

The JAX package writes its checkpoints with ``msgpack.packb`` and reads
them with ``msgpack.unpackb``; the card's machine has no ``msgpack``, so
the port encodes and decodes the subset the format holds itself: maps,
arrays (lists and tuples), str, bin and ints. :func:`packb` gives
``msgpack.packb(obj)``'s bytes (its defaults: ``use_bin_type=True``, the
smallest encoding of every header, maps in insertion order).

:func:`dump` writes the same bytes to a file as it walks the object: a
bin value is written from the buffer it is given, so a tensor's bytes go
from host memory straight to the file (no second host copy of a
multi-GB payload). :func:`unpackb` returns each bin value as a
``memoryview`` slice of the buffer it reads (no copy either), so a
caller that maps the file reads only the pages of the tensors it copies
out.
"""
from __future__ import annotations

import struct
from typing import Any, BinaryIO, Callable

_BINARY = (bytes, bytearray, memoryview)


def _header(n: int, fix_base: int, fix_limit: int, c8: int | None, c16: int, c32: int) -> bytes:
    """A length header: the fix form below ``fix_limit``, else the 8-bit
    (where msgpack has one), 16-bit or 32-bit form, the smallest that fits."""
    if n < fix_limit:
        return bytes((fix_base | n,))
    if c8 is not None and n <= 0xFF:
        return struct.pack(">BB", c8, n)
    if n <= 0xFFFF:
        return struct.pack(">BH", c16, n)
    if n <= 0xFFFFFFFF:
        return struct.pack(">BI", c32, n)
    raise ValueError(f"msgpack length {n} too large")


def _map_header(n: int) -> bytes:
    return _header(n, 0x80, 16, None, 0xDE, 0xDF)


def _array_header(n: int) -> bytes:
    return _header(n, 0x90, 16, None, 0xDC, 0xDD)


def _str_header(n: int) -> bytes:
    return _header(n, 0xA0, 32, 0xD9, 0xDA, 0xDB)


def _bin_header(n: int) -> bytes:
    return _header(n, 0, 0, 0xC4, 0xC5, 0xC6)


def _int(n: int) -> bytes:
    if n >= 0:
        if n < 0x80:
            return bytes((n,))
        for code, fmt, top in ((0xCC, ">BB", 0xFF), (0xCD, ">BH", 0xFFFF),
                               (0xCE, ">BI", 0xFFFFFFFF), (0xCF, ">BQ", 0xFFFFFFFFFFFFFFFF)):
            if n <= top:
                return struct.pack(fmt, code, n)
        raise ValueError(f"int {n} out of msgpack's range")
    if n >= -32:
        return struct.pack(">b", n)
    for code, fmt, low in ((0xD0, ">Bb", -0x80), (0xD1, ">Bh", -0x8000),
                           (0xD2, ">Bi", -0x80000000), (0xD3, ">Bq", -0x8000000000000000)):
        if n >= low:
            return struct.pack(fmt, code, n)
    raise ValueError(f"int {n} out of msgpack's range")


def _emit(obj: Any, write: Callable[[Any], Any]) -> None:
    if isinstance(obj, bool) or obj is None:
        raise TypeError(f"{obj!r}: not in the checkpoint format's msgpack subset")
    if isinstance(obj, int):
        write(_int(obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        write(_str_header(len(b)))
        write(b)
    elif isinstance(obj, _BINARY):
        mv = memoryview(obj).cast("B") if isinstance(obj, memoryview) else obj
        write(_bin_header(len(mv)))
        if len(mv):
            write(mv)
    elif isinstance(obj, dict):
        write(_map_header(len(obj)))
        for k, v in obj.items():
            _emit(k, write)
            _emit(v, write)
    elif isinstance(obj, (list, tuple)):
        write(_array_header(len(obj)))
        for v in obj:
            _emit(v, write)
    else:
        raise TypeError(f"{type(obj).__name__}: not in the checkpoint format's msgpack subset")


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj)``'s bytes for the subset."""
    parts: list = []
    _emit(obj, parts.append)
    return b"".join(bytes(p) if isinstance(p, memoryview) else p for p in parts)


def dump(obj: Any, f: BinaryIO) -> int:
    """Write ``packb(obj)``'s bytes to ``f`` as the object is walked; bin
    values go from their own buffers. Returns the bytes written."""
    n = 0

    def write(b):
        nonlocal n
        f.write(b)
        n += len(b) if not isinstance(b, memoryview) else b.nbytes

    _emit(obj, write)
    return n


def unpackb(buf) -> Any:
    """Decode one object of the subset (and nil / bools, which it never
    writes) from ``buf`` (bytes, or a memoryview of a mapped file). Bin
    values are ``memoryview`` slices of ``buf``; trailing bytes are an
    error, as in ``msgpack.unpackb``."""
    mv = memoryview(buf).cast("B")
    obj, end = _read(mv, 0)
    if end != len(mv):
        raise ValueError(f"{len(mv) - end} extra bytes after the msgpack object")
    return obj


_FIXED = {  # code -> (struct format, width)
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LEN = {  # code -> (kind, struct format, width)
    0xC4: ("bin", ">B", 1), 0xC5: ("bin", ">H", 2), 0xC6: ("bin", ">I", 4),
    0xD9: ("str", ">B", 1), 0xDA: ("str", ">H", 2), 0xDB: ("str", ">I", 4),
    0xDC: ("array", ">H", 2), 0xDD: ("array", ">I", 4),
    0xDE: ("map", ">H", 2), 0xDF: ("map", ">I", 4),
}


def _read(mv: memoryview, i: int):
    c = mv[i]
    i += 1
    if c < 0x80:
        return c, i
    if c >= 0xE0:
        return c - 0x100, i
    if 0x80 <= c <= 0x8F:
        kind, n = "map", c & 0x0F
    elif 0x90 <= c <= 0x9F:
        kind, n = "array", c & 0x0F
    elif 0xA0 <= c <= 0xBF:
        kind, n = "str", c & 0x1F
    elif c in _FIXED:
        fmt, w = _FIXED[c]
        return struct.unpack_from(fmt, mv, i)[0], i + w
    elif c in _LEN:
        kind, fmt, w = _LEN[c]
        n = struct.unpack_from(fmt, mv, i)[0]
        i += w
    elif c == 0xC0:
        return None, i
    elif c in (0xC2, 0xC3):
        return c == 0xC3, i
    else:
        raise ValueError(f"msgpack type 0x{c:02x} at byte {i - 1} is not in the checkpoint "
                         "format's subset")
    if kind == "str":
        return str(mv[i:i + n], "utf-8"), i + n
    if kind == "bin":
        return mv[i:i + n], i + n
    if kind == "array":
        out = []
        for _ in range(n):
            v, i = _read(mv, i)
            out.append(v)
        return out, i
    out = {}
    for _ in range(n):
        k, i = _read(mv, i)
        v, i = _read(mv, i)
        out[k] = v
    return out, i
