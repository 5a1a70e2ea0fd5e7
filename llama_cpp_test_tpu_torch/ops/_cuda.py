"""Build and bind the hand-written Hopper kernels under csrc/.

Each csrc/<name>.cu has a plain C interface and is compiled by nvcc into
its own shared library for sm_90a, loaded with ctypes. The build runs at
first use, into _build/ next to this package (listed in .gitignore); the
file name carries a hash of the source and of every csrc/*.cuh header, so
an edited kernel is rebuilt.
build_all() compiles every source at once, one nvcc process each.

Every wrapper counts its launches in LAUNCHES, a plain dict of ints, and
raises when the launcher returns a nonzero cudaGetLastError().
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("qmm", "qmm_cache", "flash_prefill", "paged_attention", "gmm",
           "kbench", "pairprobe")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]

LAUNCHES: dict[str, int] = {
    "qmm_gemv": 0, "qmm_gemm": 0, "qmm_cache": 0, "flash_prefill": 0,
    "paged_decode": 0, "paged_decode_q8": 0, "gmm_gemv": 0, "gmm_gemm": 0,
    "kbench_f": 0, "kbench_g": 0, "kbench_h": 0, "kbench_e": 0,
    "pairs_qmm": 0}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (CUDA toolkit needed to build the "
                       "port's kernels)")


def _lib_path(name: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    h = hashlib.sha1()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in (src, *(os.path.join(CSRC, f) for f in headers)):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _compile_cmd(name: str, out: str) -> list[str]:
    return [_nvcc(), *NVCC_FLAGS, "-o", out, os.path.join(CSRC, f"{name}.cu")]


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every listed source in parallel (one nvcc each); returns
    name -> ptxas report. Raises with nvcc's output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        procs[name] = (out, subprocess.Popen(
            _compile_cmd(name, out + ".tmp"), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (out, p) in procs.items():
        text, _ = p.communicate()
        reports[name] = text
        if p.returncode != 0:
            failed.append(f"--- nvcc {name} (rc {p.returncode}) ---\n{text}")
        else:
            os.replace(out + ".tmp", out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def lib(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it if needed."""
    with _lock:
        if name not in _libs:
            path = _lib_path(name)
            if not os.path.exists(path):
                build_all((name,))
            _libs[name] = ctypes.CDLL(path)
        return _libs[name]


_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}


def bind(name: str, fn: str, sig: str):
    """ctypes function fn of library name. sig has one letter per argument:
    'p' pointer or stream (c_void_p, so 64-bit values are not cut), 'i'
    c_int, 'f' c_float. Every launcher returns cudaGetLastError() as int."""
    f = getattr(lib(name), fn)
    if f.argtypes is None:
        f.argtypes = [_CTYPES[c] for c in sig]
        f.restype = ctypes.c_int
    return f


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError {rc})")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)
