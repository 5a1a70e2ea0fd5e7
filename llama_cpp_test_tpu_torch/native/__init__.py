"""Host C++ for the loader, bound with ctypes.

ggufio.cpp: the threaded repack of Q8_0, Q4_0, Q4_1, Q4_K and Q6_K blocks
into the port's planes (quant/repack.py calls it first for those types).
g++ builds it at first use into _build/ next to this package (listed in
.gitignore), under a name that carries a hash of the source, so an
edited source is rebuilt. Several processes may build at once: each
writes a file of its own and renames it into place. A failed build
raises with g++'s output; there is no quiet fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading

import numpy as np

from ..gguf.constants import GGML_BLOCK_SIZES, GGMLType

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "ggufio.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
THREADS = min(8, os.cpu_count() or 1)

# the types ggufio.cpp repacks -> (plane kind, values a scale, has a min)
TYPES = {GGMLType.Q8_0: ("int8", 32, False), GGMLType.Q4_0: ("u4", 32, True),
         GGMLType.Q4_1: ("u4", 32, True), GGMLType.Q4_K: ("u4", 32, True),
         GGMLType.Q6_K: ("int8", 16, False)}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def lib_path(source: str, build_dir: str) -> str:
    """The library's path: its name hashes the source, the flags and the
    host's machine and C library, so a build directory copied to another
    host is not loaded there."""
    host = f"{platform.machine()} {platform.libc_ver()}"
    with open(source, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(CXX_FLAGS + [host]).encode())
    return os.path.join(build_dir, f"libggufio-{digest.hexdigest()[:12]}.so")


def build(source: str, build_dir: str) -> str:
    """Compile source into build_dir unless it is there; returns the
    library's path. Raises RuntimeError with g++'s output on failure."""
    out = lib_path(source, build_dir)
    if os.path.exists(out):
        return out
    os.makedirs(build_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".ggufio-", suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        p = subprocess.run(["g++", *CXX_FLAGS, source, "-o", tmp],
                           capture_output=True, text=True, timeout=300)
        if p.returncode != 0:
            raise RuntimeError(f"g++ failed to build {source} (rc "
                               f"{p.returncode}):\n{p.stdout}{p.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded ggufio library of SOURCE, built into BUILD_DIR first if
    needed."""
    with _lock:
        key = lib_path(SOURCE, BUILD_DIR)
        if key not in _libs:
            lib = ctypes.CDLL(build(SOURCE, BUILD_DIR))
            lib.ggufio_supports.argtypes = [ctypes.c_int]
            lib.ggufio_supports.restype = ctypes.c_int
            lib.ggufio_repack.argtypes = [
                ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int]
            lib.ggufio_repack.restype = ctypes.c_int
            _libs[key] = lib
        return _libs[key]


def _ptr(a):
    return None if a is None else a.ctypes.data_as(ctypes.c_void_p)


def native_planes(raw: np.ndarray, ggml_type: GGMLType, n: int, k: int,
                  n_padded: int, layout: str = "t"):
    """The planes of repack() for one of TYPES: (kind, group, qs, scale,
    min_ or None), laid out and typed as quant/repack._assemble lays them
    out (bf16 planes as uint16 bits for layout "t")."""
    kind, group, has_min = TYPES[ggml_type]
    pack = 2 if kind == "u4" else 1
    npk = n_padded // pack
    qdt = np.int8 if kind == "int8" else np.uint8
    qs = np.empty((k, npk) if layout == "t" else (npk, k), qdt)
    sdt = np.uint16 if layout == "t" else np.float32
    scale = np.empty((pack, k // group, npk), sdt)
    min_ = np.empty_like(scale) if has_min else None
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    blk, nbytes = GGML_BLOCK_SIZES[ggml_type]
    if k % blk or raw.size != n * (k // blk) * nbytes:
        raise ValueError(f"{raw.size} bytes are no {n} rows of {k} "
                         f"{ggml_type.name} values")
    rc = get_lib().ggufio_repack(
        int(ggml_type), _ptr(raw), n, n_padded, k, 0 if layout == "t" else 1,
        _ptr(qs), _ptr(scale), _ptr(min_), THREADS)
    if rc != 0:
        raise ValueError(f"ggufio_repack: type {ggml_type.name}, n {n}, "
                         f"n_padded {n_padded}, k {k}: error {rc}")
    return kind, group, qs, scale, min_
