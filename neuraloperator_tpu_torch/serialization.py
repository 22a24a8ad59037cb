"""Read flax's msgpack checkpoints without the ``msgpack`` package.

The counterpart of ``flax.serialization.msgpack_restore``, which the JAX
package reaches through ``from_bytes`` when it loads a checkpoint
(``neuraloperator_tpu/training/training_state.py``). A checkpoint is one
msgpack value, as a rule a map of maps whose leaves are flax's ext types:

- code 1, an ndarray: the payload is itself msgpack, the array
  ``(shape, dtype name, raw bytes in C order)``;
- code 2, a Python complex: the payload packs ``(re, im)``;
- code 3, a numpy scalar: packed as a 0-d ndarray.

An ndarray leaf comes back as a numpy array over the checkpoint's own
bytes (no copy), except a ``bfloat16`` leaf, which numpy cannot hold: it
comes back as a ``torch.bfloat16`` tensor over the same bytes. Arrays that
flax split into chunks (maps holding ``"__msgpack_chunked_array__"``,
written for leaves over ``flax.serialization.MAX_CHUNK_SIZE``) are joined
again, as ``msgpack_restore`` does. Anything the format does not allow
raises ``ValueError`` naming its byte offset.
"""

import math
import struct
from pathlib import Path
from typing import Any

import numpy as np
import torch

__all__ = ["msgpack_restore", "read_msgpack"]

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"

# fixed-width scalars: first byte -> struct format
_SCALARS = {
    0xCA: ">f", 0xCB: ">d",
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
# variable-length headers: first byte -> (kind, struct format of the length)
_SIZED = {
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Decoder:
    """One msgpack value out of ``buf``; offsets are reported from ``base``.

    With ``raw`` (flax's ndarray payloads), str values stay bytes and a bin
    value is a ``memoryview`` slice of ``buf``; otherwise str is decoded as
    UTF-8 and bin copied into ``bytes``, as ``msgpack.unpackb(raw=False)``.
    """

    def __init__(self, buf: memoryview, base: int = 0, raw: bool = False):
        self.buf = buf
        self.base = base
        self.raw = raw
        self.pos = 0

    def fail(self, what: str, at: int) -> ValueError:
        return ValueError(f"msgpack: {what} at byte {self.base + at}")

    def take(self, n: int, at: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise self.fail(f"value of {n} bytes runs past the end", at)
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str, at: int):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt), at))[0]

    def whole(self) -> Any:
        value = self.value()
        if self.pos != len(self.buf):
            raise self.fail(f"{len(self.buf) - self.pos} bytes after the value", self.pos)
        return value

    def value(self) -> Any:
        at = self.pos
        b = self.take(1, at)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, at)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F, at)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _SCALARS:
            return self.unpack(_SCALARS[b], at)
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b], at)
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            n = self.unpack(fmt, at)
            if kind == "bin":
                data = self.take(n, at)
                return data if self.raw else bytes(data)
            if kind == "str":
                return self.str(n, at)
            if kind == "ext":
                return self.ext(n, at)
            if kind == "array":
                return [self.value() for _ in range(n)]
            return self.map(n, at)
        raise self.fail(f"byte 0x{b:02x} starts no msgpack value", at)

    def str(self, n: int, at: int):
        data = self.take(n, at)
        if self.raw:
            return bytes(data)
        try:
            return str(data, "utf-8")
        except UnicodeDecodeError:
            raise self.fail("a str that is not UTF-8", at) from None

    def map(self, n: int, at: int) -> dict:
        out = {}
        for _ in range(n):
            key_at = self.pos
            key = self.value()
            if not isinstance(key, (str, bytes)):
                raise self.fail(f"a map key of type {type(key).__name__}", key_at)
            out[key] = self.value()
        return out

    def ext(self, n: int, at: int):
        code = self.unpack(">b", at)
        start = self.pos
        payload = self.take(n, at)
        if code == _EXT_NDARRAY:
            return self.ndarray(payload, start)
        if code == _EXT_NPSCALAR:
            return self.ndarray(payload, start)[()]
        if code == _EXT_COMPLEX:
            parts = _Decoder(payload, self.base + start).whole()
            if not (isinstance(parts, list) and len(parts) == 2):
                raise self.fail("a complex ext that is not (re, im)", start)
            return complex(parts[0], parts[1])
        raise self.fail(f"ext type {code}, which flax does not write", at)

    def ndarray(self, payload: memoryview, start: int):
        """flax's ``_ndarray_from_bytes``, over ``payload`` without a copy."""
        tpl = _Decoder(payload, self.base + start, raw=True).whole()
        if not (isinstance(tpl, list) and len(tpl) == 3 and isinstance(tpl[0], list)
                and isinstance(tpl[2], (memoryview, bytes))):
            raise self.fail("an ndarray ext that is not (shape, dtype, bytes)", start)
        shape, name, data = tuple(tpl[0]), tpl[1].decode("ascii", "replace"), tpl[2]
        if name == "bfloat16":
            dtype, itemsize = torch.bfloat16, 2
        else:
            try:
                dtype = np.dtype(name)
            except TypeError:
                dtype = None
            if dtype is None or dtype.hasobject:
                raise self.fail(f"ndarray of dtype {name!r}", start)
            itemsize = dtype.itemsize
        if len(data) != math.prod(shape) * itemsize:
            raise self.fail(f"ndarray {shape} of {name} with {len(data)} bytes", start)
        if dtype is not torch.bfloat16:
            return np.frombuffer(data, dtype=dtype).reshape(shape)
        if not len(data):
            return torch.empty(shape, dtype=torch.bfloat16)
        if isinstance(data, bytes) or data.readonly:
            data = bytearray(data)  # torch.frombuffer wants a writable buffer
        return torch.frombuffer(data, dtype=torch.bfloat16).reshape(shape)


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_array_leaves_in_place(d):
    """As flax's function of this name: chunked maps back into arrays."""
    if isinstance(d, dict):
        if _CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict) and _CHUNKED in v:
                d[k] = _unchunk(v)
            elif isinstance(v, dict):
                _unchunk_array_leaves_in_place(v)
    return d


def msgpack_restore(encoded: bytes) -> Any:
    """The tree flax's ``msgpack_serialize`` (``to_bytes``) wrote into ``encoded``.

    The ndarray leaves are views of ``encoded``: keep it alive, and pass a
    writable buffer (``bytearray``) for writable arrays.
    """
    tree = _Decoder(memoryview(encoded).cast("B")).whole()
    return _unchunk_array_leaves_in_place(tree)


def read_msgpack(path) -> Any:
    """``msgpack_restore`` of a file, read once into one writable buffer."""
    path = Path(path)
    buf = bytearray(path.stat().st_size)
    with path.open("rb") as f:
        if f.readinto(buf) != len(buf):
            raise OSError(f"{path} changed size while it was read")
    return msgpack_restore(buf)
