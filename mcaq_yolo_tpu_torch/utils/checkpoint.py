"""
Reader and writer for flax's msgpack checkpoint format, in pure Python
(so the port needs neither `msgpack` nor `flax` at run time).

Format (flax.serialization.msgpack_serialize): a msgpack map tree whose
array leaves are ext type 1 holding msgpack([shape, dtype name, raw
C-order bytes]); numpy scalars are ext type 3 (same payload, 0-d), native
complex numbers ext type 2 ([real, imag]); arrays over 2^30 bytes are
split into {'__msgpack_chunked_array__': True, 'shape': {...}, 'chunks':
{...}} maps.  bfloat16 leaves (no numpy dtype) are read as float32.

`read_msgpack` / `write_msgpack` handle the whole tree; `load_checkpoint`
and `save_checkpoint` add the Predictor's `.json` meta beside the file.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


# ---------------------------------------------------------------------------
# msgpack decoding
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.obj() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return str(self.take(t & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if t in ints:
            return self.unpack(ints[t])
        lens = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if t in lens:
            return str(self.take(self.unpack(lens[t])), "utf-8")
        bins = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if t in bins:
            return bytes(self.take(self.unpack(bins[t])))
        if t in (0xDC, 0xDD):
            return [self.obj() for _ in range(self.unpack(">H" if t == 0xDC else ">I"))]
        if t in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if t == 0xDE else ">I"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in fixext:
            code = self.unpack(">b")
            return _ext_decode(code, bytes(self.take(fixext[t])))
        if t in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[t])
            code = self.unpack(">b")
            return _ext_decode(code, bytes(self.take(n)))
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def _unpackb(data: bytes) -> Any:
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after msgpack object")
    return out


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    shape, name, buf = _unpackb(data)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def _ext_decode(code: int, data: bytes) -> Any:
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    if code == _EXT_COMPLEX:
        re, im = _unpackb(data)
        return complex(re, im)
    raise ValueError(f"unsupported msgpack ext type {code}")


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_msgpack(data: bytes) -> Any:
    """flax.serialization.msgpack_restore, without msgpack or flax."""
    return _unchunk(_unpackb(data))


# ---------------------------------------------------------------------------
# msgpack encoding (the encodings msgpack-python chooses)
# ---------------------------------------------------------------------------


def _pack_len(out: bytearray, n: int, fix: Optional[int], fix_max: int, codes) -> None:
    if fix is not None and n <= fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n <= 0xFF:
        out += bytes([codes[0]]) + struct.pack(">B", n)
    elif n <= 0xFFFF:
        out += bytes([codes[1]]) + struct.pack(">H", n)
    else:
        out += bytes([codes[2]]) + struct.pack(">I", n)


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v <= 0x7F:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, lim in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2 ** 64 - 1)):
            if v <= lim:
                out += bytes([code]) + struct.pack(fmt, v)
                return
        raise OverflowError(v)
    else:
        for code, fmt, lim in ((0xD0, ">b", 2 ** 7), (0xD1, ">h", 2 ** 15),
                               (0xD2, ">i", 2 ** 31), (0xD3, ">q", 2 ** 63)):
            if v >= -lim:
                out += bytes([code]) + struct.pack(fmt, v)
                return
        raise OverflowError(v)


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(data)
    if n in fixext:
        out.append(fixext[n])
    else:
        _pack_len(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code) + data


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    out = bytearray()
    _pack(out, [list(arr.shape), arr.dtype.name, np.ascontiguousarray(arr).tobytes()])
    return bytes(out)


def _pack(out: bytearray, obj: Any) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_to_bytes(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(obj)))
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, complex):
        inner = bytearray()
        _pack(inner, [obj.real, obj.imag])
        _pack_ext(out, _EXT_COMPLEX, bytes(inner))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(out, len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _pack_len(out, len(raw), None, 0, (0xC4, 0xC5, 0xC6))
        out += raw
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def write_msgpack(tree: Any) -> bytes:
    """flax.serialization.msgpack_serialize for trees of dicts, lists,
    numpy arrays and Python scalars (arrays under 2^30 bytes)."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


# ---------------------------------------------------------------------------
# Checkpoint files
# ---------------------------------------------------------------------------


def save_checkpoint(path, variables: Dict, meta: Optional[Dict] = None) -> None:
    """Write a variable tree as a flax msgpack checkpoint, plus `path.json`
    meta when given (the keys the Predictor reads)."""
    path = Path(path)
    path.write_bytes(write_msgpack(variables))
    if meta is not None:
        Path(str(path) + ".json").write_text(json.dumps(meta, indent=2))


def load_checkpoint(path) -> Dict:
    """Read a flax msgpack checkpoint (any payload, e.g. with opt_state)."""
    return read_msgpack(Path(path).read_bytes())


def load_meta(path) -> Dict:
    """The `.json` meta beside a checkpoint, or {} when there is none."""
    p = Path(str(path) + ".json")
    return json.loads(p.read_text()) if p.exists() else {}
