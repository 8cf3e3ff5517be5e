"""A small pure-Python MessagePack codec for the solver service and its
client (the machine with the card has no msgpack package).

`unpackb` reads what `msgpack.unpackb(data, raw=False)` reads with its
defaults: arrays become lists, str is UTF-8, bin becomes bytes, map keys
must be str or bytes (msgpack's strict_map_key), and trailing bytes are
an error. Extension types are refused. `packb` writes what
`msgpack.packb` writes for None, bool, int, float (as float 64), str,
bytes, lists, tuples and dicts, byte for byte.
"""

from __future__ import annotations

import struct


class MsgpackError(ValueError):
    pass


_FIXED = {  # type byte: (struct format, size)
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LENGTH = {1: ">B", 2: ">H", 4: ">I"}
# type byte: (kind, bytes of its length field)
_SIZED = {
    0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
    0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
    0xDC: ("array", 2), 0xDD: ("array", 4),
    0xDE: ("map", 2), 0xDF: ("map", 4),
}
_MAX_DEPTH = 512


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise MsgpackError("truncated MessagePack data")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def value(self, depth: int = 0):
        if depth > _MAX_DEPTH:
            raise MsgpackError("MessagePack data nested too deeply")
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, depth)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F, depth)
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in _FIXED:
            fmt, size = _FIXED[b]
            return struct.unpack(fmt, self.take(size))[0]
        if b in _SIZED:
            kind, size = _SIZED[b]
            n = struct.unpack(_LENGTH[size], self.take(size))[0]
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.text(n)
            if kind == "array":
                return self.array(n, depth)
            return self.map(n, depth)
        if b == 0xC1:
            raise MsgpackError("MessagePack type byte 0xc1 is never used")
        raise MsgpackError(f"MessagePack extension type 0x{b:02x} is not "
                           f"supported")

    def text(self, n: int) -> str:
        try:
            return str(self.take(n), "utf-8")
        except UnicodeDecodeError as exc:
            raise MsgpackError(f"MessagePack str is not UTF-8: {exc}") \
                from None

    def array(self, n: int, depth: int) -> list:
        return [self.value(depth + 1) for _ in range(n)]

    def map(self, n: int, depth: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value(depth + 1)
            if not isinstance(key, (str, bytes)):
                raise MsgpackError(
                    f"MessagePack map key {key!r:.40} is not str or bytes")
            out[key] = self.value(depth + 1)
        return out


def unpackb(data: bytes):
    reader = _Reader(bytes(data))
    out = reader.value()
    if reader.pos != len(reader.data):
        raise MsgpackError("extra bytes after the MessagePack object")
    return out


def _pack_length(out: bytearray, n: int, fix: int | None, fix_max: int,
                 codes: tuple) -> None:
    if fix is not None and n <= fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n <= 0xFF:
        out += struct.pack(">BB", codes[0], n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", codes[1], n)
    elif n <= 0xFFFFFFFF:
        out += struct.pack(">BI", codes[2], n)
    else:
        raise MsgpackError(f"object of length {n} is too large")


def _pack(obj, out: bytearray, depth: int) -> None:
    if depth > _MAX_DEPTH:
        raise MsgpackError("object nested too deeply")
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        if 0 <= obj <= 0x7F or -32 <= obj < 0:
            out += struct.pack(">b" if obj < 0 else ">B", obj)
        elif obj > 0:
            for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                   (0xCE, ">I", 0xFFFFFFFF),
                                   (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
                if obj <= top:
                    out.append(code)
                    out += struct.pack(fmt, obj)
                    return
            raise MsgpackError(f"integer {obj} is too large")
        else:
            for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                                   (0xD2, ">i", -0x80000000),
                                   (0xD3, ">q", -0x8000000000000000)):
                if obj >= low:
                    out.append(code)
                    out += struct.pack(fmt, obj)
                    return
            raise MsgpackError(f"integer {obj} is too small")
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xCB, obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_length(out, len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _pack_length(out, len(raw), None, -1, (0xC4, 0xC5, 0xC6))
        out += raw
    elif isinstance(obj, (list, tuple)):
        _pack_length(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for item in obj:
            _pack(item, out, depth + 1)
    elif isinstance(obj, dict):
        _pack_length(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for key, value in obj.items():
            _pack(key, out, depth + 1)
            _pack(value, out, depth + 1)
    else:
        raise MsgpackError(f"cannot pack {type(obj).__name__}")


def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out, 0)
    return bytes(out)
