"""The port's own msgpack codec for flax's checkpoint format.

The JAX package writes its native checkpoints (``models/io.py``) and its
resumable-run state (``runtime/checkpoint.py``) with
``flax.serialization.msgpack_serialize`` and reads them with
``msgpack_restore``. That format is plain msgpack plus three conventions,
which this module reads and writes without flax, msgpack or ml_dtypes:

  * an array is ext type 1 holding a packed ``(shape, dtype name, C-order
    bytes)`` triple, a numpy scalar is ext type 3 holding the same triple of
    a 0-d array;
  * an array over ``MAX_CHUNK_SIZE`` bytes becomes a map
    ``{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...},
    "chunks": {"0": flat_chunk, ...}}``;
  * dtype names are numpy's, and ``"bfloat16"`` for bfloat16.

Decoding makes one pass over a ``memoryview`` of the whole buffer: array
payloads are not copied, each array is a view of the buffer
(``np.frombuffer``, or ``torch.frombuffer`` for bfloat16, which numpy
cannot hold without ml_dtypes). So bfloat16 leaves come back as
``torch.bfloat16`` tensors and every other array as a numpy array. Encoding
takes numpy arrays, numpy scalars and torch tensors (bfloat16 written with
the name ``"bfloat16"``), and writes large arrays to a file piece by piece,
without joining them into one bytes object.

    dumps(tree) -> bytes         loads(buffer) -> tree
    dump(tree, path)             load(path) -> tree
"""
from __future__ import annotations

import os
import struct
from typing import Any, List

import numpy as np
import torch

# flax.serialization.MAX_CHUNK_SIZE: arrays above it are written in chunks
MAX_CHUNK_SIZE = 2**30
EXT_NDARRAY, EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


# --- encoding -------------------------------------------------------------

def _array_parts(x):
    """(shape, dtype name, C-order bytes as a memoryview) of an array leaf."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return tuple(t.shape), "bfloat16", memoryview(t.view(torch.int16).numpy()).cast("B")
        x = t.numpy()
    a = np.asarray(x)
    if not a.flags.c_contiguous:  # (ascontiguousarray would make a 0-d array 1-d)
        a = a.copy(order="C")
    if a.dtype.hasobject or a.dtype.fields is not None:
        raise TypeError(f"object and structured dtypes cannot be serialized, got {a.dtype}")
    return a.shape, a.dtype.name, memoryview(a.reshape(-1).view(np.uint8))


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _chunk(x) -> dict:
    """flax's chunked form of an oversized array."""
    item = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    n = max(1, int(MAX_CHUNK_SIZE / item))
    flat = x.reshape(-1)
    count = x.numel() if isinstance(x, torch.Tensor) else x.size
    return {
        _CHUNKED: True,
        "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
        "chunks": {str(j): flat[lo : lo + n] for j, lo in enumerate(range(0, count, n))},
    }


class _Writer:
    """msgpack as a list of byte pieces; large payloads stay views."""

    def __init__(self):
        self.parts: List[Any] = []

    def raw(self, b) -> None:
        self.parts.append(b)

    def header(self, n: int, fix: int, fix_max: int, codes) -> None:
        if n <= fix_max:
            self.raw(bytes([fix | n]))
        elif codes[0] is not None and n <= 0xFF:
            self.raw(struct.pack(">BB", codes[0], n))
        elif n <= 0xFFFF:
            self.raw(struct.pack(">BH", codes[1], n))
        else:
            self.raw(struct.pack(">BI", codes[2], n))

    def int_(self, v: int) -> None:
        if 0 <= v <= 0x7F or -32 <= v < 0:
            self.raw(struct.pack(">b" if v < 0 else ">B", v))
        elif v > 0:
            for code, fmt, hi in ((0xCC, ">BB", 0xFF), (0xCD, ">BH", 0xFFFF), (0xCE, ">BI", 0xFFFFFFFF),
                                  (0xCF, ">BQ", 0xFFFFFFFFFFFFFFFF)):
                if v <= hi:
                    return self.raw(struct.pack(fmt, code, v))
            raise OverflowError(f"integer {v} does not fit msgpack")
        else:
            for code, fmt, lo in ((0xD0, ">Bb", -0x80), (0xD1, ">Bh", -0x8000), (0xD2, ">Bi", -0x80000000),
                                  (0xD3, ">Bq", -0x8000000000000000)):
                if v >= lo:
                    return self.raw(struct.pack(fmt, code, v))
            raise OverflowError(f"integer {v} does not fit msgpack")

    def str_(self, s: str) -> None:
        b = s.encode("utf-8")
        self.header(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        self.raw(b)

    def bin_(self, b) -> None:
        n = memoryview(b).nbytes
        self.header(n, 0, -1, (0xC4, 0xC5, 0xC6))
        self.raw(b)

    def ext(self, code: int, n: int) -> None:
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixed:
            self.raw(struct.pack(">Bb", fixed[n], code))
        elif n <= 0xFF:
            self.raw(struct.pack(">BBb", 0xC7, n, code))
        elif n <= 0xFFFF:
            self.raw(struct.pack(">BHb", 0xC8, n, code))
        else:
            self.raw(struct.pack(">BIb", 0xC9, n, code))

    def array_leaf(self, x, code: int) -> None:
        shape, name, data = _array_parts(x)
        inner = _Writer()
        inner.raw(b"\x93")  # (shape, dtype name, bytes)
        inner.header(len(shape), 0x90, 15, (None, 0xDC, 0xDD))
        for d in shape:
            inner.int_(int(d))
        inner.str_(name)
        inner.bin_(data)
        self.ext(code, sum(memoryview(p).nbytes for p in inner.parts))
        self.parts.extend(inner.parts)

    def obj(self, x) -> None:
        if x is None:
            self.raw(b"\xc0")
        elif x is True or x is False:
            self.raw(b"\xc3" if x else b"\xc2")
        elif type(x) is int:
            self.int_(x)
        elif type(x) is float:
            self.raw(struct.pack(">Bd", 0xCB, x))
        elif type(x) is str:
            self.str_(x)
        elif isinstance(x, (bytes, bytearray, memoryview)):
            self.bin_(x)
        elif isinstance(x, dict):
            self.header(len(x), 0x80, 15, (None, 0xDE, 0xDF))
            for k, v in x.items():
                self.obj(k)
                self.obj(v)
        elif isinstance(x, (list, tuple)):
            self.header(len(x), 0x90, 15, (None, 0xDC, 0xDD))
            for v in x:
                self.obj(v)
        elif isinstance(x, (np.ndarray, torch.Tensor)):
            if _nbytes(x) > MAX_CHUNK_SIZE:
                self.obj(_chunk(x))
            else:
                self.array_leaf(x, EXT_NDARRAY)
        elif isinstance(x, np.generic):
            self.array_leaf(np.asarray(x), EXT_NPSCALAR)
        else:
            raise TypeError(f"cannot serialize {type(x).__name__}")


def dumps(tree) -> bytes:
    """msgpack bytes of ``tree`` in flax's format."""
    w = _Writer()
    w.obj(tree)
    return b"".join(w.parts)


def dump(tree, path) -> int:
    """Write ``tree`` to ``path`` piece by piece; returns the bytes written."""
    w = _Writer()
    w.obj(tree)
    n = 0
    with open(path, "wb") as f:
        for p in w.parts:
            n += f.write(p)
    return n


# --- decoding -------------------------------------------------------------

def _array_from(shape, name: str, data: memoryview):
    shape = tuple(int(d) for d in shape)
    if name == "bfloat16":
        if data.nbytes == 0:
            return torch.empty(shape, dtype=torch.bfloat16)
        return torch.frombuffer(data, dtype=torch.bfloat16).reshape(shape)
    return np.frombuffer(data, dtype=np.dtype(name)).reshape(shape)


_CONSTANTS = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
# type byte -> (kind, struct format of its length); 0x8 a map, 0x9 an array
_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: (0x9, ">H"), 0xDD: (0x9, ">I"), 0xDE: (0x8, ">H"), 0xDF: (0x8, ">I")}


class _Reader:
    """One pass over ``buf``; ``view_bin`` returns bin payloads as views
    (inside an array's ext payload) instead of bytes."""

    def __init__(self, buf: memoryview, view_bin: bool = False):
        self.buf = buf
        self.pos = 0
        self.view_bin = view_bin

    def take(self, n: int) -> memoryview:
        lo = self.pos
        self.pos += n
        if self.pos > len(self.buf):
            raise ValueError("msgpack data ends early")
        return self.buf[lo : self.pos]

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not one that flax writes for arrays")
        shape, name, payload = _Reader(data, view_bin=True).obj()
        arr = _array_from(shape, name, payload)
        return arr if code == EXT_NDARRAY else arr[()]

    def obj(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0xBF:  # fixmap, fixarray, fixstr
            kind, n = (b >> 4, b & 0x0F) if b <= 0x9F else ("str", b & 0x1F)
        elif b in _CONSTANTS:
            return _CONSTANTS[b]
        elif b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        elif 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xD4))
        elif b in _SIZED:
            kind, fmt = _SIZED[b]
            n = self.unpack(fmt)
        else:
            raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")
        if kind == 0x8:
            return self.map(n)
        if kind == 0x9:
            return [self.obj() for _ in range(n)]
        if kind == "str":
            return str(self.take(n), "utf-8")
        if kind == "bin":
            data = self.take(n)
            return data if self.view_bin else bytes(data)
        return self.ext(n)

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def _unchunk(d: dict):
    shape = tuple(int(d["shape"][str(i)]) for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(j)] for j in range(len(d["chunks"]))]
    cat = torch.cat if isinstance(chunks[0], torch.Tensor) else np.concatenate
    return cat(chunks).reshape(shape)


def _unchunk_tree(x):
    if isinstance(x, dict):
        if _CHUNKED in x:
            return _unchunk(x)
        for k, v in x.items():
            if isinstance(v, dict):
                x[k] = _unchunk_tree(v)
    return x


def loads(data):
    """The tree that ``data`` (bytes, bytearray or memoryview) encodes.
    Arrays are views of a writable buffer: read-only input is copied once."""
    view = memoryview(data)
    if view.readonly:
        view = memoryview(bytearray(view))
    r = _Reader(view.cast("B"))
    tree = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes of trailing data after the msgpack object")
    return _unchunk_tree(tree)


def load(path):
    """The tree that the file ``path`` holds, read once into one buffer."""
    size = os.path.getsize(path)
    buf = bytearray(size)
    with open(path, "rb") as f:
        if f.readinto(buf) != size:
            raise ValueError(f"{path}: short read")
    return loads(buf)
