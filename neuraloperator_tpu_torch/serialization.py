"""Read and write flax's msgpack checkpoints without the ``msgpack`` package.

The counterparts of ``flax.serialization.msgpack_restore`` and
``msgpack_serialize``, which the JAX package reaches through ``from_bytes``
and ``to_bytes`` when it loads and saves a checkpoint
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

The writer (:func:`msgpack_serialize`, :func:`write_msgpack`) gives the
bytes ``to_bytes`` gives for the same tree: maps in the tree's order, ints
and strs in msgpack's smallest form, floats as doubles, ndarray and tensor
leaves as ext code 1 (a ``bfloat16`` tensor as ``"bfloat16"``), numpy
scalars as ext code 3, and leaves over ``MAX_CHUNK_SIZE`` bytes split into
chunks as flax splits them. Each array's payload is written from one
contiguous CPU buffer, never element by element.
"""

import math
import os
import struct
import tempfile
from pathlib import Path
from typing import Any, List

import numpy as np
import torch

__all__ = ["MAX_CHUNK_SIZE", "msgpack_restore", "msgpack_serialize", "read_msgpack",
           "write_msgpack"]

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"
# flax.serialization.MAX_CHUNK_SIZE: leaves over this many bytes are chunked
MAX_CHUNK_SIZE = 2**30

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


# ---------------------------------------------------------------- writing


def _int_header(n: int) -> bytes:
    if 0 <= n < 128:
        return struct.pack(">B", n)
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for code, fmt, top in ((0xCC, ">B", 2**8), (0xCD, ">H", 2**16),
                               (0xCE, ">I", 2**32), (0xCF, ">Q", 2**64)):
            if n < top:
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for code, fmt, low in ((0xD0, ">b", -2**7), (0xD1, ">h", -2**15),
                               (0xD2, ">i", -2**31), (0xD3, ">q", -2**63)):
            if n >= low:
                return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"{n} does not fit msgpack's 64-bit integers")


def _sized_header(n: int, fix_base, fix_limit: int, codes) -> bytes:
    """The header of a str, bin, array or map of ``n`` entries or bytes."""
    if fix_base is not None and n < fix_limit:
        return bytes([fix_base | n])
    for code, fmt, top in codes:
        if n < top:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"a msgpack value of {n} entries or bytes")


_STR = (0xA0, 32, ((0xD9, ">B", 2**8), (0xDA, ">H", 2**16), (0xDB, ">I", 2**32)))
_BIN = (None, 0, ((0xC4, ">B", 2**8), (0xC5, ">H", 2**16), (0xC6, ">I", 2**32)))
_ARRAY = (0x90, 16, ((0xDC, ">H", 2**16), (0xDD, ">I", 2**32)))
_MAP = (0x80, 16, ((0xDE, ">H", 2**16), (0xDF, ">I", 2**32)))
_FIXEXT_CODES = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _str(s: str) -> bytes:
    data = s.encode("utf-8")
    return _sized_header(len(data), *_STR) + data


def _ext_header(code: int, n: int) -> bytes:
    if n in _FIXEXT_CODES:
        head = bytes([_FIXEXT_CODES[n]])
    else:
        head = _sized_header(n, None, 0, ((0xC7, ">B", 2**8), (0xC8, ">H", 2**16),
                                          (0xC9, ">I", 2**32)))
    return head + struct.pack(">b", code)


def _array_buffer(leaf):
    """(shape, dtype name, one contiguous uint8 CPU buffer) of an array leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            name, arr = "bfloat16", t.view(torch.int16).numpy()
        else:
            arr = t.numpy()
            name = arr.dtype.name
    else:
        arr = np.ascontiguousarray(leaf)
        name = arr.dtype.name
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes are not serialized")
    return tuple(leaf.shape), name, arr.reshape(-1).view(np.uint8)


def _nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return leaf.size * leaf.dtype.itemsize


def _chunked(leaf) -> dict:
    """flax's ``_chunk``: the leaf as a map of flat chunks of MAX_CHUNK_SIZE bytes."""
    itemsize = leaf.element_size() if isinstance(leaf, torch.Tensor) else leaf.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = leaf.reshape(-1)
    return {
        _CHUNKED: True,
        "shape": {str(i): int(d) for i, d in enumerate(leaf.shape)},
        "chunks": {str(i): flat[s:s + size]
                   for i, s in enumerate(range(0, flat.shape[0], size))},
    }


class _Encoder:
    """One msgpack value as a list of chunks (bytes and array buffers)."""

    def __init__(self):
        self.chunks: List = []

    def value(self, v, top: bool = False) -> None:
        if isinstance(v, (np.ndarray, torch.Tensor)):
            if top and _nbytes(v) > MAX_CHUNK_SIZE:
                return self.value(_chunked(v))
            return self.array(v, _EXT_NDARRAY)
        if isinstance(v, np.generic):
            return self.array(np.asarray(v), _EXT_NPSCALAR)
        if v is None:
            self.chunks.append(b"\xc0")
        elif v is True or v is False:
            self.chunks.append(b"\xc3" if v else b"\xc2")
        elif type(v) is int:
            self.chunks.append(_int_header(v))
        elif type(v) is float:
            self.chunks.append(b"\xcb" + struct.pack(">d", v))
        elif type(v) is str:
            self.chunks.append(_str(v))
        elif type(v) is bytes:
            self.chunks.append(_sized_header(len(v), *_BIN) + v)
        elif type(v) is list:
            self.chunks.append(_sized_header(len(v), *_ARRAY))
            for item in v:
                self.value(item)
        elif type(v) is dict:
            self.chunks.append(_sized_header(len(v), *_MAP))
            for key, item in v.items():
                if type(key) is not str:
                    raise TypeError(f"map key {key!r}: flax state dicts have str keys")
                self.chunks.append(_str(key))
                # flax chunks oversized arrays that are map values
                if isinstance(item, (np.ndarray, torch.Tensor)) and (
                        _nbytes(item) > MAX_CHUNK_SIZE):
                    item = _chunked(item)
                self.value(item)
        else:
            raise TypeError(f"cannot serialize a {type(v).__name__}")

    def array(self, leaf, code: int) -> None:
        shape, name, data = _array_buffer(leaf)
        head = _sized_header(len(shape), *_ARRAY) + b"".join(_int_header(d) for d in shape)
        head = b"\x93" + head + _str(name) + _sized_header(len(data), *_BIN)
        self.chunks.append(_ext_header(code, len(head) + len(data)) + head)
        self.chunks.append(memoryview(data))


def _encode(tree) -> list:
    enc = _Encoder()
    enc.value(tree, top=True)
    return enc.chunks


def msgpack_serialize(tree) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize`` gives for ``tree``: a
    state dict (maps with str keys) of arrays, tensors and Python scalars."""
    return b"".join(_encode(tree))


def write_msgpack(path, tree) -> None:
    """Write ``msgpack_serialize(tree)`` to ``path`` without joining it in
    memory; the file is written under a temporary name and renamed, so a
    crash mid-save leaves the previous file whole."""
    path = Path(path)
    chunks = _encode(tree)
    fd, tmp = tempfile.mkstemp(prefix=f".{path.name}.", dir=path.parent)
    try:
        with os.fdopen(fd, "wb") as f:
            for chunk in chunks:
                f.write(chunk)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise
