"""ctypes bindings and first-use build of the native artifact writer.

``artifact_writer.cpp`` is compiled by ``g++`` into ``build/native/`` beside
the package (listed in ``.gitignore``), under a name keyed by a hash of the
source and flags, and linked to zlib. There is no Python fallback: if the
build fails, ``load_library`` raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "artifact_writer.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "native"
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")
LIBS = ("-lz",)
# zlib level 1: encode speed over file size (the pixels are the same)
PNG_LEVEL = 1

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _build(lib_path: Path) -> None:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or c++) on PATH for the artifact writer")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    res = subprocess.run([cxx, *FLAGS, str(SRC), "-o", str(tmp), *LIBS], capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"the native artifact writer could not be built ({cxx} {SRC.name}):\n{res.stderr}")
    os.replace(tmp, lib_path)


def load_library() -> ctypes.CDLL:
    """The writer's library, built on first use; raises if it cannot be built."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        key = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS + LIBS).encode()).hexdigest()[:16]
        lib_path = BUILD_DIR / f"libartifact_writer_{key}.so"
        if not lib_path.exists():
            _build(lib_path)
        lib = ctypes.CDLL(str(lib_path))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.aw_create.restype = P
        lib.aw_create.argtypes = [I]
        lib.aw_destroy.argtypes = [P]
        lib.aw_submit_gray.argtypes = [P, ctypes.POINTER(ctypes.c_float), I, I, ctypes.c_char_p, I, I]
        lib.aw_submit_rgb8.argtypes = [P, ctypes.POINTER(ctypes.c_ubyte), I, I, ctypes.c_char_p, I]
        lib.aw_write_rgb8.restype = I
        lib.aw_write_rgb8.argtypes = [ctypes.POINTER(ctypes.c_ubyte), I, I, ctypes.c_char_p, I]
        lib.aw_encode_rgb8.restype = I
        lib.aw_encode_rgb8.argtypes = [ctypes.POINTER(ctypes.c_ubyte), I, I, I,
                                       ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)), ctypes.POINTER(ctypes.c_size_t)]
        lib.aw_free.argtypes = [ctypes.POINTER(ctypes.c_ubyte)]
        lib.aw_pending.restype = I
        lib.aw_pending.argtypes = [P]
        lib.aw_flush.restype = I
        lib.aw_flush.argtypes = [P]
        _lib = lib
        return _lib


def to_u8(image01: np.ndarray) -> np.ndarray:
    """An [H, W, 3] image as contiguous uint8: [0, 1] floats rounded as the
    JAX package's conversion through PIL rounds them (``round(clip(x, 0, 1)
    * 255)``), uint8 as it is."""
    a = np.asarray(image01)
    if a.ndim != 3 or a.shape[-1] != 3:
        raise ValueError(f"expected an [H, W, 3] image, got shape {a.shape}")
    if a.dtype != np.uint8:
        a = (np.clip(a.astype(np.float32), 0, 1) * 255).round().astype(np.uint8)
    return np.ascontiguousarray(a)


def write_png(rgb, path) -> bool:
    """Encode one [H, W, 3] image (uint8, or floats in [0, 1]) to ``path``
    now; False if the file could not be written."""
    lib = load_library()
    arr = to_u8(rgb)
    return bool(lib.aw_write_rgb8(arr.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), arr.shape[0], arr.shape[1],
                                  str(path).encode(), PNG_LEVEL))


def png_bytes(rgb) -> bytes:
    """One [H, W, 3] image (uint8, or floats in [0, 1]) encoded to PNG in
    memory: the bytes ``write_png`` writes for it."""
    lib = load_library()
    arr = to_u8(rgb)
    buf, n = ctypes.POINTER(ctypes.c_ubyte)(), ctypes.c_size_t()
    if not lib.aw_encode_rgb8(arr.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), arr.shape[0], arr.shape[1],
                              PNG_LEVEL, ctypes.byref(buf), ctypes.byref(n)):
        raise MemoryError(f"could not encode a {arr.shape} image to PNG")
    try:
        return ctypes.string_at(buf, n.value)
    finally:
        lib.aw_free(buf)


class AsyncArtifactWriter:
    """Thread-pooled native PNG writer (maps through viridis, RGB images).
    ``flush`` and ``close`` raise if a queued write failed."""

    def __init__(self, n_threads: int = 2):
        self._lib = load_library()
        self._handle = self._lib.aw_create(n_threads)

    @property
    def native(self) -> bool:
        """True while the writer's native pool is open (until ``close``)."""
        return self._handle is not None

    def submit_map(self, map2d: np.ndarray, path, viridis: bool = True) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        arr = np.ascontiguousarray(map2d, dtype=np.float32)
        if arr.ndim != 2 or arr.size == 0:
            raise ValueError(f"expected a non-empty [H, W] map, got shape {arr.shape}")
        self._lib.aw_submit_gray(self._handle, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), arr.shape[0],
                                 arr.shape[1], str(path).encode(), 1 if viridis else 0, PNG_LEVEL)

    def submit_image(self, image01: np.ndarray, path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        arr = to_u8(image01)
        self._lib.aw_submit_rgb8(self._handle, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), arr.shape[0],
                                 arr.shape[1], str(path).encode(), PNG_LEVEL)

    def pending(self) -> int:
        return self._lib.aw_pending(self._handle) if self._handle else 0

    def flush(self) -> None:
        """Wait for every queued write; raise if any of them failed."""
        if self._handle is not None:
            failed = self._lib.aw_flush(self._handle)
            if failed:
                raise OSError(f"the artifact writer failed to write {failed} file(s)")

    def close(self) -> None:
        if self._handle is not None:
            handle, self._handle = self._handle, None
            failed = self._lib.aw_flush(handle)
            self._lib.aw_destroy(handle)
            if failed:
                raise OSError(f"the artifact writer failed to write {failed} file(s)")

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
