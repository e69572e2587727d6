"""A small msgpack codec for the JAX package's checkpoint blobs.

The JAX package writes a model's variables with
`flax.serialization.msgpack_serialize`; the port writes and reads the same
bytes without msgpack or flax:

 - maps with str keys, written in sorted key order (flax maps the tree
   through `jax.tree_util`, which sorts dict keys), arrays (list or tuple),
   str, bin (bytes), int, float (as float64), bool and nil, each in the
   smallest encoding, as msgpack-python packs them with `use_bin_type=True`;
 - a numpy array as ext type 1, whose payload is itself msgpack:
   `(shape, dtype.name, C-order bytes)` (flax `serialization.py:_ndarray_to_bytes`);
 - a numpy scalar as ext type 3 with the payload of its 0-d array.

Arrays above 1 GiB (flax's chunked form) are not supported.
"""

import struct
from typing import Any, Tuple

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
_MAX_ARRAY_BYTES = 2**30


def _pack_int(out: bytearray, v: int):
    if 0 <= v < 128:
        out.append(v)
    elif 0 <= v < 2**8:
        out += b"\xcc" + struct.pack(">B", v)
    elif 0 <= v < 2**16:
        out += b"\xcd" + struct.pack(">H", v)
    elif 0 <= v < 2**32:
        out += b"\xce" + struct.pack(">I", v)
    elif 0 <= v < 2**64:
        out += b"\xcf" + struct.pack(">Q", v)
    elif -32 <= v < 0:
        out += struct.pack(">b", v)
    elif -(2**7) <= v < 0:
        out += b"\xd0" + struct.pack(">b", v)
    elif -(2**15) <= v < 0:
        out += b"\xd1" + struct.pack(">h", v)
    elif -(2**31) <= v < 0:
        out += b"\xd2" + struct.pack(">i", v)
    elif -(2**63) <= v < 0:
        out += b"\xd3" + struct.pack(">q", v)
    else:
        raise OverflowError(f"int {v} does not fit in 64 bits")


def _pack_len(out: bytearray, n: int, small: Tuple[int, int], codes: Tuple[int, int, int]):
    """A length header: fix form below `small[1]` (base small[0]), else 8/16/32-bit codes (0 where absent)."""
    base, limit = small
    if limit and n < limit:
        out.append(base | n)
    elif codes[0] and n < 2**8:
        out += bytes([codes[0]]) + struct.pack(">B", n)
    elif n < 2**16:
        out += bytes([codes[1]]) + struct.pack(">H", n)
    else:
        out += bytes([codes[2]]) + struct.pack(">I", n)


def _pack_ext(out: bytearray, code: int, data: bytes):
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(data)
    if n in fixed:
        out.append(fixed[n])
    elif n < 2**8:
        out += b"\xc7" + struct.pack(">B", n)
    elif n < 2**16:
        out += b"\xc8" + struct.pack(">H", n)
    else:
        out += b"\xc9" + struct.pack(">I", n)
    out += struct.pack(">b", code) + data


def ndarray_to_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialised")
    if arr.nbytes > _MAX_ARRAY_BYTES:
        raise ValueError(f"array of {arr.nbytes} bytes is above the 1 GiB that one msgpack leaf may hold")
    return packb((list(arr.shape), arr.dtype.name, arr.tobytes("C")))


def _pack(out: bytearray, obj: Any):
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif type(obj) is int:
        _pack_int(out, obj)
    elif type(obj) is float:
        out += b"\xcb" + struct.pack(">d", obj)
    elif type(obj) is str:
        b = obj.encode("utf-8")
        _pack_len(out, len(b), (0xA0, 32), (0xD9, 0xDA, 0xDB))
        out += b
    elif type(obj) in (bytes, bytearray):
        _pack_len(out, len(obj), (0, 0), (0xC4, 0xC5, 0xC6))
        out += obj
    elif type(obj) in (list, tuple):
        _pack_len(out, len(obj), (0x90, 16), (0, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif type(obj) is dict:
        _pack_len(out, len(obj), (0x80, 16), (0, 0xDE, 0xDF))
        for k in sorted(obj):
            if type(k) is not str:
                raise TypeError(f"map keys must be str, got {type(k).__name__}")
            _pack(out, k)
            _pack(out, obj[k])
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, ndarray_to_bytes(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, EXT_NPSCALAR, ndarray_to_bytes(np.asarray(obj)))
    else:
        raise TypeError(f"cannot serialise {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos : self.pos + n].tobytes()
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED_LEN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
              0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def ndarray_from_bytes(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = unpackb(data)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape, order="C").copy()


def _ext(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return ndarray_from_bytes(data)
    if code == EXT_NPSCALAR:
        return ndarray_from_bytes(data)[()]
    raise ValueError(f"msgpack ext type {code} is not supported")


def _read(r: _Reader):
    c = r.take(1)[0]
    if c <= 0x7F:
        return c
    if c >= 0xE0:
        return c - 0x100
    if 0x80 <= c <= 0x8F:
        return _read_map(r, c & 0x0F)
    if 0x90 <= c <= 0x9F:
        return [_read(r) for _ in range(c & 0x0F)]
    if 0xA0 <= c <= 0xBF:
        return r.take(c & 0x1F).decode("utf-8")
    if c == 0xC0:
        return None
    if c in (0xC2, 0xC3):
        return c == 0xC3
    if c in _NUMBERS:
        return r.unpack(_NUMBERS[c])
    if c in _FIXEXT:
        code = r.unpack(">b")
        return _ext(code, r.take(_FIXEXT[c]))
    if c in _FIXED_LEN:
        n = r.unpack(_FIXED_LEN[c])
        if c in (0xC4, 0xC5, 0xC6):
            return r.take(n)
        if c in (0xD9, 0xDA, 0xDB):
            return r.take(n).decode("utf-8")
        if c in (0xDC, 0xDD):
            return [_read(r) for _ in range(n)]
        if c in (0xDE, 0xDF):
            return _read_map(r, n)
        code = r.unpack(">b")
        return _ext(code, r.take(n))
    raise ValueError(f"msgpack type byte 0x{c:02x} is not supported")


def _read_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _read(r)
        out[k] = _read(r)
    return out


def unpackb(data: bytes) -> Any:
    r = _Reader(data)
    obj = _read(r)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes of msgpack data left over")
    return obj
