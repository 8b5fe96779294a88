"""Build and load the package's CUDA kernels.

The sources in ``csrc/`` are compiled by ``nvcc`` for Hopper (``sm_90a``)
into one shared library with a plain C interface, loaded with ``ctypes``.
No PyTorch header is included, so a build takes seconds. The library goes
to ``build/kernels/`` beside the package (listed in ``.gitignore``) under a
name keyed by a hash of the sources and flags: the first call in a fresh
checkout builds it, later calls load it.

Every C entry point returns the ``cudaError_t`` of its launches; the
wrappers in ``ops/flash_attention.py`` and ``ops/attention_variants.py`` raise
when it is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
SOURCES = (
    "flash_self_fwd.cu", "flash_self_bwd.cu", "cross_attention_map.cu",
    "flash_self_fwd_v1.cu", "flash_self_bwd_w1.cu",
)
HEADERS = ("common.cuh", "hopper.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# name -> argtypes; every pointer and the stream are c_void_p
SIGNATURES = {
    # q, k, v, o, lse, bh, n, d, scale, stream
    "ga_flash_self_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _P),
    # q, k, v, o, lse, bh, n, d, scale, tile configuration, stream
    "ga_flash_self_fwd_config": (_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    # q, k, v, o, do, lse, delta, dq, dk, dv, bh, n, d, scale, stream
    "ga_flash_self_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P),
    # q, k, v, o, map, b, h, nq, nk, d, scale, stream
    "ga_cross_attention_map_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    # q, k, v, o, bh, n, d, scale, bf16_p, stream
    "ga_flash_self_fwd_v1": (_P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    # q, k, v, do, dq, dk, dv, bh, n, d, scale, stream
    "ga_flash_self_bwd_w1": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build, if it built
build_log: str = ""  # nvcc's output (-Xptxas -v: registers, shared memory, spills)


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _build(lib_path: Path) -> None:
    """One nvcc per source, all started together, then one link."""
    global build_seconds, build_log
    t0 = time.perf_counter()
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}"
    objs, procs = [], []
    for src in SOURCES:
        obj = BUILD_DIR / f"{Path(src).stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / src), "-o", str(obj)]
        procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        objs.append(obj)
    logs, failed = [], []
    for src, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {src}\n{out}")
        if p.returncode != 0:
            failed.append(src)
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")
    tmp = BUILD_DIR / f"{lib_path.name}.{tag}.tmp"
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp), *map(str, objs)],
        capture_output=True, text=True,
    )
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib_path)
    build_seconds = time.perf_counter() - t0


def load_library() -> ctypes.CDLL:
    """The kernels' library, built on first use; raises if it cannot be built."""
    global _lib
    with _lock:
        if _lib is None:
            lib_path = BUILD_DIR / f"libga_kernels_{source_hash()}.so"
            if not lib_path.exists():
                _build(lib_path)
            lib = ctypes.CDLL(str(lib_path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
