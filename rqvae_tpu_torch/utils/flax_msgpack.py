"""The byte layout of `flax.serialization` (to_bytes / msgpack_restore), read
and written in pure Python.

The JAX package's checkpoints (rqvae_tpu/utils/checkpoint.py) are msgpack
blobs of a nested dict whose array leaves are msgpack extension objects:

- type 1, an ndarray: the msgpack array (shape, dtype name, C-order bytes);
- type 2, a complex: the msgpack array (real, imag);
- type 3, a numpy scalar: an ndarray payload of shape ().

An array of more than MAX_CHUNK_SIZE bytes is written as a dict marked
'__msgpack_chunked_array__' holding its flat 'chunks' and its 'shape' (each
a dict keyed '0', '1', ...). This module decodes and encodes that layout
without `msgpack` or `flax`, which the card machine does not have.

Leaves come back as numpy arrays (scalars as numpy scalars), except
bfloat16, which numpy lacks: a bf16 array comes back as a torch.bfloat16
tensor (its bits read through a uint16 view), and a torch tensor of any
dtype is written as the ndarray flax would write for it.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE: arrays above it are chunked
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


# ---- decode ----


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw  # str objects come back as bytes (flax's ndarray payloads are read so)

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends inside an object")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        (v,) = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += struct.calcsize(fmt)
        return v

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        return _ext_unpack(code, bytes(self.take(n)))

    def obj(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xDC: ">H", 0xDD: ">I",
                   0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in lengths:
            n = self.unpack(lengths[b])
            if b <= 0xC6:
                return bytes(self.take(n))
            if b <= 0xC9:
                return self.ext(n)
            if b <= 0xDB:
                return self.str_(n)
            return self.array(n) if b <= 0xDD else self.map(n)
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xD4))
        raise ValueError(f"msgpack byte 0x{b:02x} at {self.pos - 1} is not a type this layout uses")


def _unpackb(data: bytes, raw: bool = False) -> Any:
    r = _Reader(data, raw)
    out = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes left after the msgpack object")
    return out


def _ndarray_from_bytes(data: bytes):
    shape, name, buffer = _unpackb(data, raw=True)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(buffer, dtype=np.uint16).reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape).copy()


def _ext_unpack(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_COMPLEX:
        re, im = _unpackb(data)
        return complex(re, im)
    if code == _EXT_NPSCALAR:
        arr = _ndarray_from_bytes(data)
        return arr if isinstance(arr, torch.Tensor) else arr[()]
    raise ValueError(f"msgpack extension type {code} is not one of flax's")


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_tree(d):
    if isinstance(d, dict):
        if _CHUNKED in d:
            return _unchunk(d)
        return {k: _unchunk_tree(v) for k, v in d.items()}
    return d


def msgpack_restore(data: bytes) -> Any:
    """The tree `flax.serialization.msgpack_restore` returns for these bytes:
    nested dicts with array leaves, chunked arrays joined."""
    return _unchunk_tree(_unpackb(bytes(data)))


# ---- encode ----


def _pack_len(out: bytearray, n: int, fix: Tuple[int, int], codes: Tuple[int, ...], fmts: Tuple[str, ...]) -> None:
    """A length header: the fix form below fix[1], else the smallest of codes."""
    if fix[1] and n < fix[1]:
        out.append(fix[0] | n)
        return
    for code, fmt in zip(codes, fmts):
        if n < 1 << (8 * struct.calcsize(fmt)):
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object of length {n} is too long")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
    elif v >= 0:
        for code, fmt in ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")):
            if v < 1 << (8 * struct.calcsize(fmt)):
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"integer {v} does not fit msgpack's 64 bits")
    else:
        for code, fmt in ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q")):
            if v >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"integer {v} does not fit msgpack's 64 bits")


def _pack_bytes(out: bytearray, b: bytes) -> None:
    _pack_len(out, len(b), (0, 0), (0xC4, 0xC5, 0xC6), (">B", ">H", ">I"))
    out += b


def _pack_str(out: bytearray, s: str) -> None:
    b = s.encode("utf-8")
    _pack_len(out, len(b), (0xA0, 32), (0xD9, 0xDA, 0xDB), (">B", ">H", ">I"))
    out += b


def _pack_ext(out: bytearray, code: int, payload: bytes) -> None:
    n = len(payload)
    if n in (1, 2, 4, 8, 16):
        out.append(0xD4 + n.bit_length() - 1)
    else:
        _pack_len(out, n, (0, 0), (0xC7, 0xC8, 0xC9), (">B", ">H", ">I"))
    out += struct.pack(">b", code)
    out += payload


def _as_numpy(x) -> Tuple[Tuple[int, ...], str, bytes]:
    """(shape, flax's dtype name, C-order bytes) of an array leaf."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return tuple(x.shape), "bfloat16", x.view(torch.uint16).numpy().tobytes()
        x = x.numpy()
    x = np.asarray(x)  # keeps shape () (np.ascontiguousarray would make it (1,))
    if x.dtype.hasobject or x.dtype.fields is not None:
        raise ValueError(f"arrays of dtype {x.dtype} are not serialized")
    return tuple(x.shape), x.dtype.name, x.tobytes("C")


def _ndarray_payload(x) -> bytes:
    shape, name, data = _as_numpy(x)
    out = bytearray()
    _pack_len(out, 3, (0x90, 16), (0xDC, 0xDD), (">H", ">I"))
    _pack_len(out, len(shape), (0x90, 16), (0xDC, 0xDD), (">H", ">I"))
    for s in shape:
        _pack_int(out, int(s))
    _pack_str(out, name)
    _pack_bytes(out, data)
    return bytes(out)


def _pack(out: bytearray, x) -> None:
    if x is None:
        out.append(0xC0)
    elif isinstance(x, bool):
        out.append(0xC3 if x else 0xC2)
    elif isinstance(x, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_payload(np.asarray(x)))
    elif isinstance(x, int):
        _pack_int(out, x)
    elif isinstance(x, float):
        out.append(0xCB)
        out += struct.pack(">d", x)
    elif isinstance(x, complex):
        payload = bytearray([0x92, 0xCB]) + struct.pack(">d", x.real) + bytes([0xCB]) + struct.pack(">d", x.imag)
        _pack_ext(out, _EXT_COMPLEX, bytes(payload))
    elif isinstance(x, str):
        _pack_str(out, x)
    elif isinstance(x, (bytes, bytearray)):
        _pack_bytes(out, bytes(x))
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_payload(x))
    elif isinstance(x, dict):
        _pack_len(out, len(x), (0x80, 16), (0xDE, 0xDF), (">H", ">I"))
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(x, list):
        _pack_len(out, len(x), (0x90, 16), (0xDC, 0xDD), (">H", ">I"))
        for v in x:
            _pack(out, v)
    else:
        raise TypeError(f"cannot serialize {type(x).__name__} (flax writes tuples as dicts keyed '0', '1', ...)")


def _chunk_tree(d):
    """The tree as flax packs it: every dict's keys sorted (flax's tree_map
    copy sorts them), then arrays above MAX_CHUNK_SIZE bytes split as flax
    splits them, into marker dicts in flax's insertion order."""
    if isinstance(d, dict):
        return {k: _chunk_tree(d[k]) for k in sorted(d)}
    if isinstance(d, (np.ndarray, torch.Tensor)):
        nbytes = d.numel() * d.element_size() if isinstance(d, torch.Tensor) else d.nbytes
        itemsize = d.element_size() if isinstance(d, torch.Tensor) else d.dtype.itemsize
        if nbytes > MAX_CHUNK_SIZE:
            step = max(1, int(MAX_CHUNK_SIZE / itemsize))
            flat = d.reshape(-1)
            chunks = [flat[i:i + step] for i in range(0, flat.shape[0], step)]
            return {_CHUNKED: True, "shape": {str(i): int(s) for i, s in enumerate(d.shape)},
                    "chunks": {str(i): c for i, c in enumerate(chunks)}}
    return d


def msgpack_serialize(tree) -> bytes:
    """The bytes `flax.serialization.msgpack_serialize` writes for `tree`
    (nested dicts with array, scalar, str and None leaves; empty dicts, such
    as optax's EmptyState, stay empty maps), which
    `flax.serialization.msgpack_restore` and `from_bytes` read. Keys are
    written in sorted order, as flax's copy of the tree sorts them."""
    out = bytearray()
    _pack(out, _chunk_tree(tree))
    return bytes(out)
