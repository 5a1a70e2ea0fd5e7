"""Repack GGUF packed blocks into flat weight planes.

Counterpart of llama_cpp_test_tpu/quant/repack.py, numpy path only, for
every block type the reference repacks: the legacy formats, the K-quants,
IQ4_NL/IQ4_XS, the codebook i-quants and TQ1_0/TQ2_0 (quant/iq_repack.py),
plus dense F32/F16/BF16. The plane layouts are the reference's, so planes
compare equal array for array:

layout "t" (matmul weights): K-major planes.
  qs     int8 [K, N], or packed along N: uint8 [K, N/pack] with sub-value
         h of byte b[k, j] in bits [h*bits, (h+1)*bits), holding
         q[k, h*N/pack + j] (nibbles: pack 2, crumbs: pack 4). Output column
         h*NPK + j of the packed product is sub-value h of plane column j.
  scale  bf16 [pack, K/group, N/pack] per-group effective scale.
  min_   optional, same layout: w = scale * q - min_.
  lut    optional float32 codebook (16 entries for 'u4lut', 4 for
         'u2lut'): w = scale * lut[q].
layout "rows" (embedding tables): qs [N/pack, K], f32 scales.

bf16 planes are kept on the host as numpy uint16 bit patterns
(round-to-nearest-even from float32); weights.py views them as
torch.bfloat16 on upload.

Q8_0, Q4_0, Q4_1, Q4_K and Q6_K go through the threaded C++ repack of
native/ggufio.cpp while NATIVE is set (the default): the same planes,
bit for bit, at several times the rate. The numpy path below is the
plain version it is held against, and the path of every other type.
"""
from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np

from .. import native
from ..gguf.constants import GGML_BLOCK_SIZES, GGMLType
from . import codecs
from .codecs import (KVALUES_IQ4NL, _k4_unpack_scale_min, _q3k_unpack_scales,
                     _read_f16, _unpack_qh32)
from .iq_repack import IQ_DECOMPOSERS

PACK = {"dense": 1, "int8": 1, "u4": 2, "u2": 4, "u4lut": 2, "u2lut": 4}
# repack() takes native/ggufio.cpp for the types it covers
# (native.TYPES); False keeps every type on the numpy path (the plain
# version)
NATIVE = True
BITS = {"u4": 4, "u2": 2, "u4lut": 4, "u2lut": 2}


def f32_to_bf16_bits(a: np.ndarray) -> np.ndarray:
    """float32 -> bf16 bit patterns (uint16), round to nearest even."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    r = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) >> 16
    return r.astype(np.uint16)


def bf16_bits_to_f32(a: np.ndarray) -> np.ndarray:
    return (np.ascontiguousarray(a, np.uint16).astype(np.uint32) << 16) \
        .view(np.float32)


@dataclasses.dataclass
class QTensor:
    """A quantized weight in plane layout. Logical matmul shape (N, K):
    y[m, n] = sum_k x[m, k] * w[n, k]. Planes are numpy arrays on the host
    (bf16 as uint16 bits) or torch tensors on a device (weights.py)."""

    kind: str  # 'dense' | 'int8' | 'u4' | 'u2' | 'u4lut' | 'u2lut'
    shape: tuple[int, int]  # (N, K) logical (N padded; see n_orig)
    n_orig: int
    group: int
    qs: Any
    scale: Any | None = None
    min_: Any | None = None
    lut: Any | None = None
    ggml_type: GGMLType | None = None
    layout: str = "t"  # 't' (K-major planes, matmul) | 'rows' (gather)
    # fused tensors (wqkv, gate|up): (npk_i, n_orig_i) per constituent, in
    # plane column order; None for plain tensors
    parts: tuple | None = None

    @property
    def pack(self) -> int:
        return PACK[self.kind]

    @property
    def npk(self) -> int:
        """Packed-plane width: padded N / pack."""
        return self.shape[0] // self.pack


# decomposition: packed GGUF bytes -> (q int [N,K], scale f32 [N,G], min|None)
# x = scale*q - min


def _blocks(raw: np.ndarray, t: GGMLType, n: int, k: int) -> np.ndarray:
    blk, nbytes = GGML_BLOCK_SIZES[t]
    return np.ascontiguousarray(raw, dtype=np.uint8).reshape(n * (k // blk), nbytes)


def _d_q4_0(b, n, k):
    d = _read_f16(b[:, 0:2])
    qs = b[:, 2:18]
    q = np.concatenate([qs & 0xF, qs >> 4], axis=1)
    s = d.reshape(n, k // 32)
    return q.reshape(n, k), s, 8.0 * s, 32


def _d_q4_1(b, n, k):
    d = _read_f16(b[:, 0:2])
    m = _read_f16(b[:, 2:4])
    qs = b[:, 4:20]
    q = np.concatenate([qs & 0xF, qs >> 4], axis=1)
    return q.reshape(n, k), d.reshape(n, k // 32), -m.reshape(n, k // 32), 32


def _d_q5_0(b, n, k):
    d = _read_f16(b[:, 0:2])
    qh = _unpack_qh32(b[:, 2:6])
    qs = b[:, 6:22]
    lo = np.concatenate([qs & 0xF, qs >> 4], axis=1)
    q = lo | (qh << 4)
    s = d.reshape(n, k // 32)
    return q.reshape(n, k), s, 16.0 * s, 32


def _d_q5_1(b, n, k):
    d = _read_f16(b[:, 0:2])
    m = _read_f16(b[:, 2:4])
    qh = _unpack_qh32(b[:, 4:8])
    qs = b[:, 8:24]
    q = np.concatenate([qs & 0xF, qs >> 4], axis=1) | (qh << 4)
    return q.reshape(n, k), d.reshape(n, k // 32), -m.reshape(n, k // 32), 32


def _d_q8_0(b, n, k):
    d = _read_f16(b[:, 0:2])
    q = b[:, 2:34].view(np.int8)
    return q.reshape(n, k), d.reshape(n, k // 32), None, 32


def _d_q2_k(b, n, k):
    nb = b.shape[0]
    scales = b[:, 0:16]
    qs = b[:, 16:80].reshape(nb, 2, 1, 32)
    d = _read_f16(b[:, 80:82])[:, None]
    dmin = _read_f16(b[:, 82:84])[:, None]
    shifts = np.arange(4, dtype=np.uint8).reshape(1, 1, 4, 1) * 2
    q = ((qs >> shifts) & 3).reshape(nb, 256)
    s = (d * (scales & 0xF)).astype(np.float32)
    m = (dmin * (scales >> 4)).astype(np.float32)
    return q.reshape(n, k), s.reshape(n, k // 16), m.reshape(n, k // 16), 16


def _d_q3_k(b, n, k):
    nb = b.shape[0]
    hm = b[:, 0:32]
    qs = b[:, 32:96].reshape(nb, 2, 1, 32)
    s6 = _q3k_unpack_scales(b[:, 96:108]).astype(np.int32) - 32
    d = _read_f16(b[:, 108:110])[:, None]
    shifts = np.arange(4, dtype=np.uint8).reshape(1, 1, 4, 1) * 2
    q2 = ((qs >> shifts) & 3).astype(np.int8)
    bit = np.arange(8, dtype=np.uint8).reshape(1, 2, 4, 1)
    hbit = ((hm[:, None, None, :] >> bit) & 1).astype(np.int8)
    q = (q2 + 4 * hbit - 4).reshape(nb, 256)  # signed [-4, 3]
    s = (d * s6.astype(np.float32)).astype(np.float32)
    return q.reshape(n, k), s.reshape(n, k // 16), None, 16


def _d_q4_k(b, n, k):
    nb = b.shape[0]
    d = _read_f16(b[:, 0:2])[:, None]
    dmin = _read_f16(b[:, 2:4])[:, None]
    sc, m = _k4_unpack_scale_min(b[:, 4:16])
    qs = b[:, 16:144].reshape(nb, 4, 32)
    q = np.stack([qs & 0xF, qs >> 4], axis=2).reshape(nb, 256)
    s = (d * sc).astype(np.float32)
    mm = (dmin * m).astype(np.float32)
    return q.reshape(n, k), s.reshape(n, k // 32), mm.reshape(n, k // 32), 32


def _d_q5_k(b, n, k):
    nb = b.shape[0]
    d = _read_f16(b[:, 0:2])[:, None]
    dmin = _read_f16(b[:, 2:4])[:, None]
    sc, m = _k4_unpack_scale_min(b[:, 4:16])
    qh = b[:, 16:48]
    qs = b[:, 48:176].reshape(nb, 4, 32)
    lo = np.stack([qs & 0xF, qs >> 4], axis=2).reshape(nb, 8, 32)
    gbit = np.arange(8, dtype=np.uint8).reshape(1, 8, 1)
    hi = ((qh[:, None, :] >> gbit) & 1).astype(np.uint8)
    q = (lo | (hi << 4)).reshape(nb, 256)
    s = (d * sc).astype(np.float32)
    mm = (dmin * m).astype(np.float32)
    return q.reshape(n, k), s.reshape(n, k // 32), mm.reshape(n, k // 32), 32


def _d_q6_k(b, n, k):
    nb = b.shape[0]
    ql = b[:, 0:128].reshape(nb, 2, 64)
    qh = b[:, 128:192].reshape(nb, 2, 32)
    s8 = b[:, 192:208].view(np.int8).astype(np.float32)
    d = _read_f16(b[:, 208:210])[:, None]
    q1 = (ql[:, :, 0:32] & 0xF) | (((qh >> 0) & 3) << 4)
    q2 = (ql[:, :, 32:64] & 0xF) | (((qh >> 2) & 3) << 4)
    q3 = (ql[:, :, 0:32] >> 4) | (((qh >> 4) & 3) << 4)
    q4 = (ql[:, :, 32:64] >> 4) | (((qh >> 6) & 3) << 4)
    q = (np.stack([q1, q2, q3, q4], axis=2).astype(np.int16) - 32).reshape(nb, 256)
    s = (d * s8).astype(np.float32)
    return q.reshape(n, k).astype(np.int8), s.reshape(n, k // 16), None, 16


def _d_iq4_nl(b, n, k):
    d = _read_f16(b[:, 0:2])
    qs = b[:, 2:18]
    q = np.concatenate([qs & 0xF, qs >> 4], axis=1)
    return q.reshape(n, k), d.reshape(n, k // 32), None, 32


def _d_iq4_xs(b, n, k):
    nb = b.shape[0]
    d = _read_f16(b[:, 0:2])
    sh = b[:, 2:4].copy().view(np.uint16)
    sl = b[:, 4:8]
    gi = np.arange(8)
    lo = (sl[:, gi // 2] >> (4 * (gi % 2))[None, :].astype(np.uint8)) & 0xF
    hi = (sh >> (2 * gi)[None, :].astype(np.uint16)) & 3
    ls = (lo.astype(np.int32) | (hi.astype(np.int32) << 4)) - 32
    qs = b[:, 8:136].reshape(nb, 8, 16)
    q = np.concatenate([qs & 0xF, qs >> 4], axis=2).reshape(nb, 256)
    s = (d[:, None] * ls).astype(np.float32)
    return q.reshape(n, k), s.reshape(n, k // 32), None, 32


_DECOMPOSERS = {
    GGMLType.Q4_0: ("u4", _d_q4_0),
    GGMLType.Q4_1: ("u4", _d_q4_1),
    GGMLType.Q5_0: ("int8", _d_q5_0),
    GGMLType.Q5_1: ("int8", _d_q5_1),
    GGMLType.Q8_0: ("int8", _d_q8_0),
    GGMLType.Q2_K: ("u2", _d_q2_k),
    GGMLType.Q3_K: ("int8", _d_q3_k),
    GGMLType.Q4_K: ("u4", _d_q4_k),
    GGMLType.Q5_K: ("int8", _d_q5_k),
    GGMLType.Q6_K: ("int8", _d_q6_k),
    GGMLType.IQ4_NL: ("u4lut", _d_iq4_nl),
    GGMLType.IQ4_XS: ("u4lut", _d_iq4_xs),
}

def _pack_n(q: np.ndarray, pack: int, bits: int) -> np.ndarray:
    """(N, K) unsigned ints -> (N/pack, K) bytes, value j in bits [j*bits, ...)."""
    n, k = q.shape
    parts = q.reshape(pack, n // pack, k)
    out = np.zeros((n // pack, k), dtype=np.uint8)

    def part(lo, hi):
        for h in range(pack):
            out[lo:hi] |= (parts[h, lo:hi].astype(np.uint8)
                           & ((1 << bits) - 1)) << (bits * h)

    _chunked(q.size, n // pack, part)
    return out


# a tensor of at least this many elements (a vocabulary-sized embedding or
# head) is repacked in row chunks on _POOL's threads: numpy releases the
# GIL in its loops, and these tensors are the long poles of a load. The
# pool is the repack's own (its workers never submit to it), so a
# repack called from the loader's threads cannot wait on itself.
PARALLEL_MIN = 1 << 26
CHUNKS = min(8, os.cpu_count() or 1)
_POOL = ThreadPoolExecutor(max_workers=CHUNKS)


def _spans(n: int, parts: int, align: int = 1) -> list[tuple[int, int]]:
    """[0, n) cut into at most `parts` spans whose bounds are multiples of
    align (the last one excepted)."""
    step = -(-n // parts)
    step += -step % align
    return [(lo, min(lo + step, n)) for lo in range(0, n, step)]


def _chunked(a_size: int, n: int, fn, align: int = 1) -> list:
    """fn(lo, hi) over row spans of [0, n), on _POOL when a_size (the
    tensor's elements) reaches PARALLEL_MIN, else in one call."""
    if a_size < PARALLEL_MIN or CHUNKS < 2:
        return [fn(0, n)]
    return list(_POOL.map(lambda span: fn(*span), _spans(n, CHUNKS, align)))


def _transpose(a: np.ndarray, slab: int = 512) -> np.ndarray:
    """a.T as a contiguous array, built from slabs of `slab` rows: each
    slab's transpose stays in cache, where numpy's element-wise copy of a
    whole byte plane walks memory with a stride of a row."""
    out = np.empty(a.shape[::-1], a.dtype)

    def part(lo, hi):
        for i in range(lo, hi, slab):
            out[:, i:min(i + slab, hi)] = a[i:min(i + slab, hi)].T

    _chunked(a.size, a.shape[0], part, slab)
    return out


def _pad_rows(a: np.ndarray, n_to: int) -> np.ndarray:
    if a.shape[0] == n_to:
        return a
    pad = np.zeros((n_to - a.shape[0],) + a.shape[1:], dtype=a.dtype)
    return np.concatenate([a, pad], axis=0)


def _to_group_major(s: np.ndarray, pack: int) -> np.ndarray:
    """[N, G] row-major scales -> [pack, G, N/pack] group-major planes."""
    n, g = s.shape
    return np.ascontiguousarray(
        s.reshape(pack, n // pack, g).transpose(0, 2, 1))


def _plane_f32(a) -> np.ndarray:
    """A host scale/min plane as float32 (bf16 planes arrive as uint16)."""
    a = np.asarray(a)
    return bf16_bits_to_f32(a) if a.dtype == np.uint16 else a.astype(np.float32)


def scale_row_view(qt: QTensor) -> np.ndarray:
    """Group-major planes back to [N, G] logical row order."""
    s = _plane_f32(qt.scale)
    pack, g, npk = s.shape
    return s.transpose(0, 2, 1).reshape(pack * npk, g)


def _assemble(kind: str, q: np.ndarray, s: np.ndarray, m, g: int,
              n: int, k: int, tile_n: int, layout: str, lut,
              ggml_type: GGMLType) -> QTensor:
    """Decomposed (q [N,K] ints, s/m [N,G]) -> QTensor in the given layout."""
    pack = PACK[kind]
    mult = pack * tile_n
    n_full = n + (-n % mult)
    q = _pad_rows(q, n_full)
    conv = f32_to_bf16_bits if layout == "t" else (lambda a: a)
    s = conv(_to_group_major(_pad_rows(s.astype(np.float32), n_full), pack))
    m = None if m is None else conv(_to_group_major(
        _pad_rows(m.astype(np.float32), n_full), pack))
    if kind == "int8":
        qs = q.astype(np.int8)
    else:
        qs = _pack_n(q, pack, BITS[kind])
    if layout == "t":
        qs = _transpose(qs)  # [K, NPK]
    return QTensor(kind, (n_full, k), n, g, qs, s, m, lut,
                   ggml_type=ggml_type, layout=layout)


def repack(raw: np.ndarray, ggml_type: GGMLType, n: int, k: int,
           tile_n: int = 256, layout: str = "t") -> QTensor:
    """Packed GGUF row-major bytes for an (N=n rows, K=k cols) weight ->
    plane layout. Rows padded so N/pack is a multiple of tile_n."""
    assert layout in ("t", "rows")
    if NATIVE and ggml_type in native.TYPES:
        pack = PACK[native.TYPES[ggml_type][0]]
        n_full = n + (-n % (pack * tile_n))
        kind, g, qs, s, m = native.native_planes(raw, ggml_type, n, k,
                                                 n_full, layout)
        return QTensor(kind, (n_full, k), n, g, qs, s, m,
                       ggml_type=ggml_type, layout=layout)
    if ggml_type == GGMLType.BF16 and layout == "t":
        # the bf16 bits as they are: widened to float32 and rounded back
        # they would come out the same
        w = _pad_rows(np.ascontiguousarray(raw).view(np.uint16).reshape(n, k),
                      n + (-n % tile_n))
        return QTensor("dense", w.shape, n, k, _transpose(w),
                       ggml_type=ggml_type, layout=layout)
    if ggml_type in (GGMLType.F32, GGMLType.F16, GGMLType.BF16):
        w = codecs.dequantize(np.ascontiguousarray(raw), ggml_type).reshape(n, k)
        n_pad = -n % tile_n
        w = _pad_rows(w.astype(np.float32), n + n_pad)
        if layout == "t":
            w = f32_to_bf16_bits(_transpose(w))  # [K, N]
        return QTensor("dense", (n + n_pad, k), n, k, w,
                       ggml_type=ggml_type, layout=layout)
    if ggml_type in IQ_DECOMPOSERS:
        # exact decomposition of the codebook i-quants and TQ into
        # u4lut / u2lut planes plus their LUT (quant/iq_repack.py)
        b = _blocks(raw, ggml_type, n, k)
        kind, q, s, m, g, lut = IQ_DECOMPOSERS[ggml_type](b, n, k)
        return _assemble(kind, q, s, m, g, n, k, tile_n, layout, lut,
                         ggml_type)
    if ggml_type not in _DECOMPOSERS:
        raise NotImplementedError(
            f"repack of {ggml_type.name}: this port takes F32/F16/BF16 and "
            "the block types " + ", ".join(
                t.name for t in sorted({*_DECOMPOSERS, *IQ_DECOMPOSERS}, key=int)))
    kind, fn = _DECOMPOSERS[ggml_type]
    b = _blocks(raw, ggml_type, n, k)
    per = b.shape[0] // n          # blocks a row
    parts = _chunked(n * k, n, lambda lo, hi: fn(b[lo * per:hi * per],
                                                 hi - lo, k))
    q, s, m, g = parts[0]
    if len(parts) > 1:
        cat = lambda i: np.concatenate([p[i] for p in parts])
        q, s, m = cat(0), cat(1), None if m is None else cat(2)
    lut = KVALUES_IQ4NL.copy() if kind == "u4lut" else None
    return _assemble(kind, q, s, m, g, n, k, tile_n, layout, lut, ggml_type)


def fuse_qtensors(parts: list[QTensor]) -> QTensor | None:
    """Concatenate repacked layout-'t' tensors along the plane-column axis
    so QKV / gate+up run one fused matmul. Constituent i's output is its
    packed columns sliced out of [M, pack, NPK_total] (ops/qmatmul.qmm_split).
    Returns None when the tensors can't fuse (mixed quant types)."""
    q0 = parts[0]
    if any(p.layout != "t" or p.kind != q0.kind or p.group != q0.group
           or p.ggml_type != q0.ggml_type
           or (p.min_ is None) != (q0.min_ is None)
           or p.shape[1] != q0.shape[1] or p.parts is not None
           for p in parts):
        return None
    if any((p.lut is None) != (q0.lut is None) or
           (p.lut is not None and not np.array_equal(p.lut, q0.lut))
           for p in parts):
        return None
    cat = lambda xs, ax: None if xs[0] is None else np.concatenate(
        [np.asarray(x) for x in xs], axis=ax)
    n_full = sum(p.shape[0] for p in parts)
    return QTensor(
        q0.kind, (n_full, q0.shape[1]), n_full, q0.group,
        cat([p.qs for p in parts], 1),
        cat([p.scale for p in parts], -1),
        cat([p.min_ for p in parts], -1),
        q0.lut, ggml_type=q0.ggml_type, layout="t",
        parts=tuple((p.npk, p.n_orig) for p in parts),
    )


def fuse_expert_qtensors(parts: list[QTensor]) -> QTensor | None:
    """fuse_qtensors for expert-stacked tensors (a leading E axis on every
    plane, models/llama._repack_3d): concatenates along the plane-column
    axis per expert, so one grouped pass computes gate|up
    (ops/gmm.gmm_apply_split slices it). None when the tensors can't fuse."""
    q0 = parts[0]
    if any(p.kind != q0.kind or p.group != q0.group
           or p.ggml_type != q0.ggml_type
           or (p.min_ is None) != (q0.min_ is None)
           or p.shape[1] != q0.shape[1] or p.parts is not None
           or np.asarray(p.qs).ndim != 3
           or np.asarray(p.qs).shape[0] != np.asarray(q0.qs).shape[0]
           for p in parts):
        return None
    if any((p.lut is None) != (q0.lut is None) or
           (p.lut is not None and not np.array_equal(p.lut, q0.lut))
           for p in parts):
        return None
    cat = lambda xs, ax: None if xs[0] is None else np.concatenate(
        [np.asarray(x) for x in xs], axis=ax)
    n_full = sum(p.shape[0] for p in parts)
    return QTensor(
        q0.kind, (n_full, q0.shape[1]), n_full, q0.group,
        cat([p.qs for p in parts], -1),
        cat([p.scale for p in parts], -1),
        cat([p.min_ for p in parts], -1),
        q0.lut, ggml_type=q0.ggml_type, layout="t",
        parts=tuple((p.npk, p.n_orig) for p in parts),
    )


def dequantize_qtensor_np(qt: QTensor) -> np.ndarray:
    """Reference decode of host planes back to float32, logical row-major
    [n_orig, K]."""
    if qt.kind == "dense":
        w = _plane_f32(qt.qs)
        if qt.layout == "t":
            w = w.T
        return w[: qt.n_orig]
    pack = qt.pack
    qs = np.asarray(qt.qs)
    if qt.layout == "t":
        qs = qs.T  # back to [NPK, K]
    if qt.kind == "int8":
        q = qs.astype(np.float32)
    else:
        bits = BITS[qt.kind]
        mask = (1 << bits) - 1
        q = np.concatenate(
            [((qs >> (bits * h)) & mask) for h in range(pack)], axis=0
        ).astype(np.float32)
    if qt.kind in ("u4lut", "u2lut"):
        q = np.asarray(qt.lut)[q.astype(np.int32)]
    s = np.repeat(scale_row_view(qt), qt.group, axis=1)
    w = s * q
    if qt.min_ is not None:
        mrow = _plane_f32(qt.min_)
        mrow = mrow.transpose(0, 2, 1).reshape(s.shape[0], -1)
        w = w - np.repeat(mrow, qt.group, axis=1)
    return w[: qt.n_orig]
