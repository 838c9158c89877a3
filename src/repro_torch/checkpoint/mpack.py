"""A small pure-Python MessagePack codec for checkpoint metadata (no
counterpart in ``repro``, which uses the ``msgpack`` package; the machine
with the card does not have it).

It covers the subset ``ckpt``'s ``meta`` uses: map, array, str, int,
float, bool and nil. ``packb`` writes the bytes ``msgpack.packb`` writes
for these types with its defaults (smallest int encoding, str8 allowed,
floats as float64, tuples as arrays), so a checkpoint saved by either
package is readable by the other; ``unpackb`` also reads float32, and
raises ``ValueError`` on anything truncated, trailing or outside the
subset.
"""
from __future__ import annotations

import struct


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
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        n = len(raw)
        if n < 32:
            out.append(0xA0 | n)
        elif n <= 0xFF:
            out += bytes((0xD9, n))
        elif n <= 0xFFFF:
            out.append(0xDA)
            out += struct.pack(">H", n)
        else:
            out.append(0xDB)
            out += struct.pack(">I", n)
        out += raw
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 0xDC, out)
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 0xDE, out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__} (the codec "
                        f"covers map, array, str, int, float, bool, nil)")


def _pack_len(n: int, fix: int, code16: int, out: bytearray) -> None:
    if n <= 0x0F:
        out.append(fix | n)
    elif n <= 0xFFFF:
        out.append(code16)
        out += struct.pack(">H", n)
    else:
        out.append(code16 + 1)
        out += struct.pack(">I", n)


def _pack_int(x: int, out: bytearray) -> None:
    if 0 <= x < 0x80:
        out.append(x)
    elif -0x20 <= x < 0:
        out += struct.pack(">b", x)
    elif 0 <= x <= 0xFF:
        out += bytes((0xCC, x))
    elif -0x80 <= x < 0:
        out += struct.pack(">Bb", 0xD0, x)
    elif 0 <= x <= 0xFFFF:
        out += struct.pack(">BH", 0xCD, x)
    elif -0x8000 <= x < 0:
        out += struct.pack(">Bh", 0xD1, x)
    elif 0 <= x <= 0xFFFFFFFF:
        out += struct.pack(">BI", 0xCE, x)
    elif -0x80000000 <= x < 0:
        out += struct.pack(">Bi", 0xD2, x)
    elif 0 <= x <= 0xFFFFFFFFFFFFFFFF:
        out += struct.pack(">BQ", 0xCF, x)
    elif -0x8000000000000000 <= x < 0:
        out += struct.pack(">Bq", 0xD3, x)
    else:
        raise OverflowError(f"int {x} does not fit 64 bits")


def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# fixed-width codes: (struct format, byte count)
_FIXED = {0xCA: (">f", 4), 0xCB: (">d", 8), 0xCC: (">B", 1),
          0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
          0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4),
          0xD3: (">q", 8)}


class _Reader:
    def __init__(self, raw: bytes):
        self.raw = raw
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.raw):
            raise ValueError(f"truncated msgpack data: need {n} bytes at "
                             f"offset {self.pos}, have "
                             f"{len(self.raw) - self.pos}")
        b = self.raw[self.pos:end]
        self.pos = end
        return b

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def obj(self):
        c = self.take(1)[0]
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0xA0 <= c <= 0xBF:
            return self.str(c & 0x1F)
        if 0x90 <= c <= 0x9F:
            return self.array(c & 0x0F)
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if c == 0xC0:
            return None
        if c in (0xC2, 0xC3):
            return c == 0xC3
        if c in _FIXED:
            return self.unpack(*_FIXED[c])
        if c in (0xD9, 0xDA, 0xDB):
            return self.str(self.unpack(*_LEN[c]))
        if c in (0xDC, 0xDD):
            return self.array(self.unpack(*_LEN[c]))
        if c in (0xDE, 0xDF):
            return self.map(self.unpack(*_LEN[c]))
        raise ValueError(f"msgpack type byte 0x{c:02x} at offset "
                         f"{self.pos - 1} is outside the supported subset")

    def str(self, n: int) -> str:
        return self.take(n).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            if not isinstance(k, str):
                raise ValueError(f"map key {k!r} is not a str")
            out[k] = self.obj()
        return out


_LEN = {0xD9: (">B", 1), 0xDA: (">H", 2), 0xDB: (">I", 4),
        0xDC: (">H", 2), 0xDD: (">I", 4), 0xDE: (">H", 2),
        0xDF: (">I", 4)}


def unpackb(raw: bytes):
    r = _Reader(bytes(raw))
    obj = r.obj()
    if r.pos != len(r.raw):
        raise ValueError(f"{len(r.raw) - r.pos} bytes of extra data after "
                         f"the msgpack object")
    return obj
