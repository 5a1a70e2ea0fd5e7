"""numpy codecs for the GGUF block formats.

Counterpart of llama_cpp_test_tpu/quant/codecs.py. Decoders: F32/F16/
BF16, the legacy formats (Q4_0, Q4_1, Q5_0, Q5_1, Q8_0), the K-quants
(Q2_K to Q6_K), the non-linear nibble formats (IQ4_NL, IQ4_XS), the
codebook i-quants (IQ2_XXS/XS/S, IQ3_XXS/S, IQ1_S/M) and the ternary TQ1_0/
TQ2_0. Encoders: the same types but the codebook i-quants, whose encoders
live in iq_quantize.py; quantize() reaches both. Byte layouts are
file-format facts; every codec works on all blocks of a tensor at once.
The encoders keep the reference's arithmetic step for step, so they write
the same bytes; the importance weights (an imatrix) travel as an argument
rather than through a module global, so that quantize() can encode the
row spans of a large tensor on a thread pool. The codebook grids are
format constants, shipped as data/iq_grids.npz.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..gguf.constants import GGML_BLOCK_SIZES, GGMLType


def _read_f16(raw: np.ndarray) -> np.ndarray:
    """uint8 (..., 2) -> float32 (...,)."""
    return np.ascontiguousarray(raw).view(np.float16).astype(np.float32)[..., 0]


def _unpack_qh32(raw4: np.ndarray) -> np.ndarray:
    """(nb, 4) bytes of a little-endian u32 bitfield -> (nb, 32) bits."""
    word = raw4.reshape(-1, 4).copy().view(np.uint32)
    return ((word >> np.arange(32, dtype=np.uint32)) & 1).astype(np.uint8)


def _k4_unpack_scale_min(raw12: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(nb, 12) -> 6-bit (scales, mins), each (nb, 8)."""
    a, b, c = raw12[:, 0:4], raw12[:, 4:8], raw12[:, 8:12]
    sc = np.concatenate([a & 63, (c & 0xF) | ((a >> 6) << 4)], axis=1)
    m = np.concatenate([b & 63, (c >> 4) | ((b >> 6) << 4)], axis=1)
    return sc, m


def _q3k_unpack_scales(raw12: np.ndarray) -> np.ndarray:
    """(nb, 12) -> (nb, 16) 6-bit values."""
    lo = np.concatenate([raw12[:, 0:8] & 0xF, raw12[:, 0:8] >> 4], axis=1)
    j = np.arange(16)
    hi = (raw12[:, 8 + (j % 4)] >> (2 * (j // 4))[None, :].astype(np.uint8)) & 3
    return lo | (hi << 4)


# ---------------------------------------------------------------------------
# encoder helpers


def _f16b(x: np.ndarray) -> np.ndarray:
    """float array (...,) -> fp16 little-endian bytes, shape (..., 2)."""
    h = np.ascontiguousarray(x.astype(np.float16))
    return h[..., None].view(np.uint8)


def _safe_inv(d: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(d != 0.0, 1.0 / d, 0.0)
    return inv.astype(np.float32)


def _max_by_abs(x: np.ndarray) -> np.ndarray:
    """Per-row element of the largest magnitude, sign kept (x[argmax |x|])."""
    idx = np.argmax(np.abs(x), axis=-1)
    return np.take_along_axis(x, idx[..., None], axis=-1)[..., 0]


def _pack_qh32(qhi: np.ndarray) -> np.ndarray:
    """(nb, 32) high bits -> (nb, 4) bytes of a little-endian u32 bitfield."""
    bits = (qhi.astype(np.uint32) & 1) << np.arange(32, dtype=np.uint32)
    word = bits.sum(axis=1, dtype=np.uint32)
    return word[:, None].view(np.uint8).reshape(-1, 4)


# ---------------------------------------------------------------------------
# legacy formats: 32 values per block

# Q4_0: {fp16 d; u8 qs[16]}; x = d*(q-8)
def q4_0_dequantize(raw: np.ndarray) -> np.ndarray:
    d = _read_f16(raw[:, 0:2])[:, None]
    qs = raw[:, 2:18]
    q = np.concatenate([qs & 0xF, qs >> 4], axis=1).astype(np.int8) - 8
    return d * q.astype(np.float32)


# Q4_1: {fp16 d, m; u8 qs[16]}; x = d*q + m
def q4_1_dequantize(raw: np.ndarray) -> np.ndarray:
    d = _read_f16(raw[:, 0:2])[:, None]
    m = _read_f16(raw[:, 2:4])[:, None]
    qs = raw[:, 4:20]
    q = np.concatenate([qs & 0xF, qs >> 4], axis=1).astype(np.float32)
    return d * q + m


# Q5_0: {fp16 d; u8 qh[4]; u8 qs[16]}; 5-bit, x = d*(q-16)
def q5_0_dequantize(raw: np.ndarray) -> np.ndarray:
    d = _read_f16(raw[:, 0:2])[:, None]
    qh = _unpack_qh32(raw[:, 2:6])
    qs = raw[:, 6:22]
    lo = np.concatenate([qs & 0xF, qs >> 4], axis=1)
    q = (lo | (qh << 4)).astype(np.int16) - 16
    return d * q.astype(np.float32)


# Q5_1: {fp16 d, m; u8 qh[4]; u8 qs[16]}; x = d*q + m
def q5_1_dequantize(raw: np.ndarray) -> np.ndarray:
    d = _read_f16(raw[:, 0:2])[:, None]
    m = _read_f16(raw[:, 2:4])[:, None]
    qh = _unpack_qh32(raw[:, 4:8])
    qs = raw[:, 8:24]
    lo = np.concatenate([qs & 0xF, qs >> 4], axis=1)
    q = (lo | (qh << 4)).astype(np.float32)
    return d * q + m


# Q8_0: {fp16 d; i8 qs[32]}; x = d*q
def q8_0_dequantize(raw: np.ndarray) -> np.ndarray:
    d = _read_f16(raw[:, 0:2])[:, None]
    q = raw[:, 2:34].view(np.int8).astype(np.float32)
    return d * q


# ---------------------------------------------------------------------------
# K-quants: 256-value super-blocks

# Q2_K: 16 groups of 16; 4-bit scale + 4-bit min per group
def q2_k_dequantize(raw: np.ndarray) -> np.ndarray:
    nb = raw.shape[0]
    scales = raw[:, 0:16]
    qs = raw[:, 16:80].reshape(nb, 2, 1, 32)
    d = _read_f16(raw[:, 80:82])[:, None]
    dmin = _read_f16(raw[:, 82:84])[:, None]
    shifts = np.arange(4, dtype=np.uint8).reshape(1, 1, 4, 1) * 2
    q = ((qs >> shifts) & 3).reshape(nb, 256).astype(np.float32)
    sc = (scales & 0xF).astype(np.float32)
    m = (scales >> 4).astype(np.float32)
    sg = np.repeat(d * sc, 16, axis=1)
    mg = np.repeat(dmin * m, 16, axis=1)
    return sg * q - mg


# Q3_K: 16 groups of 16; 6-bit signed scales; 3-bit signed values
def q3_k_dequantize(raw: np.ndarray) -> np.ndarray:
    nb = raw.shape[0]
    hm = raw[:, 0:32]
    qs = raw[:, 32:96].reshape(nb, 2, 1, 32)
    s6 = _q3k_unpack_scales(raw[:, 96:108]).astype(np.int32) - 32
    d = _read_f16(raw[:, 108:110])[:, None]
    shifts = np.arange(4, dtype=np.uint8).reshape(1, 1, 4, 1) * 2
    q2 = ((qs >> shifts) & 3).astype(np.int8)  # (nb, 2, 4, 32)
    bit = np.arange(8, dtype=np.uint8).reshape(1, 2, 4, 1)
    hbit = ((hm[:, None, None, :] >> bit) & 1).astype(np.int8)
    q = (q2 - 4 * (1 - hbit)).reshape(nb, 256).astype(np.float32)
    sg = np.repeat(d * s6.astype(np.float32), 16, axis=1)
    return sg * q


# Q4_K: 8 groups of 32; 6-bit scales + mins packed into 12 bytes
def q4_k_dequantize(raw: np.ndarray) -> np.ndarray:
    nb = raw.shape[0]
    d = _read_f16(raw[:, 0:2])[:, None]
    dmin = _read_f16(raw[:, 2:4])[:, None]
    sc, m = _k4_unpack_scale_min(raw[:, 4:16])
    qs = raw[:, 16:144].reshape(nb, 4, 32)
    q = np.stack([qs & 0xF, qs >> 4], axis=2).reshape(nb, 256).astype(np.float32)
    sg = np.repeat(d * sc.astype(np.float32), 32, axis=1)
    mg = np.repeat(dmin * m.astype(np.float32), 32, axis=1)
    return sg * q - mg


# Q5_K: Q4_K's scales plus one high bit per value
def q5_k_dequantize(raw: np.ndarray) -> np.ndarray:
    nb = raw.shape[0]
    d = _read_f16(raw[:, 0:2])[:, None]
    dmin = _read_f16(raw[:, 2:4])[:, None]
    sc, m = _k4_unpack_scale_min(raw[:, 4:16])
    qh = raw[:, 16:48]
    qs = raw[:, 48:176].reshape(nb, 4, 32)
    lo = np.stack([qs & 0xF, qs >> 4], axis=2).reshape(nb, 8, 32)
    gbit = np.arange(8, dtype=np.uint8).reshape(1, 8, 1)
    hi = ((qh[:, None, :] >> gbit) & 1).astype(np.uint8)
    q = (lo | (hi << 4)).reshape(nb, 256).astype(np.float32)
    sg = np.repeat(d * sc.astype(np.float32), 32, axis=1)
    mg = np.repeat(dmin * m.astype(np.float32), 32, axis=1)
    return sg * q - mg


# Q6_K: 16 groups of 16; int8 scales; 6-bit signed values
def q6_k_dequantize(raw: np.ndarray) -> np.ndarray:
    nb = raw.shape[0]
    ql = raw[:, 0:128].reshape(nb, 2, 64)
    qh = raw[:, 128:192].reshape(nb, 2, 32)
    s8 = raw[:, 192:208].view(np.int8).astype(np.float32)
    d = _read_f16(raw[:, 208:210])[:, None]
    q1 = (ql[:, :, 0:32] & 0xF) | (((qh >> 0) & 3) << 4)
    q2 = (ql[:, :, 32:64] & 0xF) | (((qh >> 2) & 3) << 4)
    q3 = (ql[:, :, 0:32] >> 4) | (((qh >> 4) & 3) << 4)
    q4 = (ql[:, :, 32:64] >> 4) | (((qh >> 6) & 3) << 4)
    q = np.stack([q1, q2, q3, q4], axis=2).astype(np.int16) - 32  # (nb,2,4,32)
    qf = q.reshape(nb, 256).astype(np.float32)
    sg = np.repeat(d * s8, 16, axis=1)
    return sg * qf


# ---------------------------------------------------------------------------
# IQ4_NL / IQ4_XS: non-linear 16-entry LUT nibbles

KVALUES_IQ4NL = np.array(
    [-127, -104, -83, -65, -49, -35, -22, -10, 1, 13, 25, 38, 53, 69, 89, 113],
    dtype=np.float32,
)


def iq4_nl_dequantize(raw: np.ndarray) -> np.ndarray:
    d = _read_f16(raw[:, 0:2])
    qs = raw[:, 2:18]
    q = np.concatenate([qs & 0xF, qs >> 4], axis=1)
    return d[:, None] * KVALUES_IQ4NL[q]


def iq4_xs_dequantize(raw: np.ndarray) -> np.ndarray:
    nb = raw.shape[0]
    d = _read_f16(raw[:, 0:2])
    sh = raw[:, 2:4].copy().view(np.uint16)
    sl = raw[:, 4:8]
    gi = np.arange(8)
    lo = (sl[:, gi // 2] >> (4 * (gi % 2))[None, :].astype(np.uint8)) & 0xF
    hi = (sh >> (2 * gi)[None, :].astype(np.uint16)) & 3
    ls = (lo.astype(np.int32) | (hi.astype(np.int32) << 4)) - 32
    qs = raw[:, 8:136].reshape(nb, 8, 16)
    q = np.concatenate([qs & 0xF, qs >> 4], axis=2)  # (nb, 8, 32)
    scale = d[:, None] * ls.astype(np.float32)
    return (scale[..., None] * KVALUES_IQ4NL[q]).reshape(nb, 256)


# ---------------------------------------------------------------------------
# Ternary (BitNet b1.58) TQ1_0 / TQ2_0


def _tq1_unpack(b: np.ndarray, n_levels: int) -> np.ndarray:
    """Packed bytes (nb, width) -> (nb, n_levels, width) trits {0,1,2}."""
    pow3 = (3 ** np.arange(n_levels, dtype=np.uint8))[None, :, None]
    # uint8 wrap-around shifts trit m into the top bits; *3 >> 8 extracts it
    scaled = (b[:, None, :] * pow3).astype(np.uint8)
    return ((scaled.astype(np.uint16) * 3) >> 8).astype(np.uint8)


def tq1_0_dequantize(raw: np.ndarray) -> np.ndarray:
    nb = raw.shape[0]
    d = _read_f16(raw[:, 52:54])[:, None]
    out = np.empty((nb, 256), dtype=np.float32)
    out[:, 0:160] = _tq1_unpack(raw[:, 0:32], 5).reshape(nb, 160)
    out[:, 160:240] = _tq1_unpack(raw[:, 32:48], 5).reshape(nb, 80)
    out[:, 240:256] = _tq1_unpack(raw[:, 48:52], 4).reshape(nb, 16)
    return (out - 1.0) * d


def tq2_0_dequantize(raw: np.ndarray) -> np.ndarray:
    nb = raw.shape[0]
    d = _read_f16(raw[:, 64:66])[:, None]
    qs = raw[:, 0:64].reshape(nb, 2, 1, 32)
    shifts = np.arange(4, dtype=np.uint8).reshape(1, 1, 4, 1) * 2
    q = ((qs >> shifts) & 3).reshape(nb, 256).astype(np.float32) - 1.0
    return q * d


# ---------------------------------------------------------------------------
# encoders: float blocks (nb, block) -> packed bytes (nb, block bytes).
# w, where given, is the importance of each value, shaped like x.


# Q4_0: d = x[argmax |x|] / -8, q = trunc(x / d + 8.5)
def q4_0_quantize(x: np.ndarray, w=None) -> np.ndarray:
    nb = x.shape[0]
    m = _max_by_abs(x)
    d = (m / -8.0).astype(np.float32)
    q = np.clip(np.trunc(x * _safe_inv(d)[:, None] + 8.5), 0, 15).astype(np.uint8)
    out = np.empty((nb, 18), dtype=np.uint8)
    out[:, 0:2] = _f16b(d)
    out[:, 2:18] = q[:, :16] | (q[:, 16:] << 4)
    return out


# Q4_1: d = (max - min) / 15, m = min
def q4_1_quantize(x: np.ndarray, w=None) -> np.ndarray:
    nb = x.shape[0]
    mn = x.min(axis=-1)
    mx = x.max(axis=-1)
    d = ((mx - mn) / 15.0).astype(np.float32)
    q = np.clip(np.trunc((x - mn[:, None]) * _safe_inv(d)[:, None] + 0.5), 0, 15).astype(np.uint8)
    out = np.empty((nb, 20), dtype=np.uint8)
    out[:, 0:2] = _f16b(d)
    out[:, 2:4] = _f16b(mn.astype(np.float32))
    out[:, 4:20] = q[:, :16] | (q[:, 16:] << 4)
    return out


def q5_0_quantize(x: np.ndarray, w=None) -> np.ndarray:
    nb = x.shape[0]
    m = _max_by_abs(x)
    d = (m / -16.0).astype(np.float32)
    q = np.clip(np.trunc(x * _safe_inv(d)[:, None] + 16.5), 0, 31).astype(np.uint8)
    out = np.empty((nb, 22), dtype=np.uint8)
    out[:, 0:2] = _f16b(d)
    out[:, 2:6] = _pack_qh32(q >> 4)
    out[:, 6:22] = (q[:, :16] & 0xF) | ((q[:, 16:] & 0xF) << 4)
    return out


def q5_1_quantize(x: np.ndarray, w=None) -> np.ndarray:
    nb = x.shape[0]
    mn = x.min(axis=-1)
    mx = x.max(axis=-1)
    d = ((mx - mn) / 31.0).astype(np.float32)
    q = np.clip(np.trunc((x - mn[:, None]) * _safe_inv(d)[:, None] + 0.5), 0, 31).astype(np.uint8)
    out = np.empty((nb, 24), dtype=np.uint8)
    out[:, 0:2] = _f16b(d)
    out[:, 2:4] = _f16b(mn.astype(np.float32))
    out[:, 4:8] = _pack_qh32(q >> 4)
    out[:, 8:24] = (q[:, :16] & 0xF) | ((q[:, 16:] & 0xF) << 4)
    return out


def q8_0_quantize(x: np.ndarray, w=None) -> np.ndarray:
    nb = x.shape[0]
    amax = np.abs(x).max(axis=-1)
    d = (amax / 127.0).astype(np.float32)
    q = np.rint(x * _safe_inv(d)[:, None]).astype(np.int8)
    out = np.empty((nb, 34), dtype=np.uint8)
    out[:, 0:2] = _f16b(d)
    out[:, 2:34] = q.view(np.uint8)
    return out


# The K-quants fit a scale (and a min) a group, fold them into the packed
# sub-scales and requantize. REFINE_ITERS alternating least-squares sweeps
# refine each group's fit (the reference's default); set_refine_iters(0)
# skips them (a greedier fit, the same format).
REFINE_ITERS = 2


def set_refine_iters(n: int) -> None:
    global REFINE_ITERS
    REFINE_ITERS = int(n)


def _group_scale_min(x: np.ndarray, nmax: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-group affine fit x ~= scale*q - min, q in [0, nmax], min >= 0."""
    mn = np.minimum(x.min(axis=-1), 0.0)
    mx = np.maximum(x.max(axis=-1), 0.0)
    scale = (mx - mn) / nmax
    return scale.astype(np.float32), (-mn).astype(np.float32)


def _ls_refine_affine(x, scale, mn, nmax, w=None, iters=None):
    """Alternating least squares of (scale, min) given the rounding; with
    importance weights w the fit minimizes the weighted error."""
    if iters is None:
        iters = REFINE_ITERS
    for _ in range(iters):
        q = np.clip(np.rint((x + mn[..., None]) * _safe_inv(scale)[..., None]), 0, nmax)
        # solve min_{s,m} sum w*(s*q - m - x)^2 per group
        if w is None:
            n = x.shape[-1]
            sq = q.sum(-1)
            sqq = (q * q).sum(-1)
            sx = x.sum(-1)
            sxq = (x * q).sum(-1)
        else:
            n = w.sum(-1)
            sq = (w * q).sum(-1)
            sqq = (w * q * q).sum(-1)
            sx = (w * x).sum(-1)
            sxq = (w * x * q).sum(-1)
        det = n * sqq - sq * sq
        with np.errstate(divide="ignore", invalid="ignore"):
            s_new = np.where(det > 0, (n * sxq - sq * sx) / det, scale)
            m_new = np.where(det > 0, -(sqq * sx - sq * sxq) / det, mn)
        ok = (s_new > 0) & (m_new >= 0)
        scale = np.where(ok, s_new, scale).astype(np.float32)
        mn = np.where(ok, m_new, mn).astype(np.float32)
    return scale, mn


def _signed_group_scale(x: np.ndarray, nmax: int, w=None, iters=None) -> np.ndarray:
    """Per-group symmetric fit x ~= scale*q, q in [-nmax-1, nmax]."""
    if iters is None:
        iters = REFINE_ITERS
    m = _max_by_abs(x)
    scale = (m / -(nmax + 1)).astype(np.float32)
    for _ in range(iters):
        q = np.clip(np.rint(x * _safe_inv(scale)[..., None]), -(nmax + 1), nmax)
        if w is None:
            sqq = (q * q).sum(-1)
            sxq = (x * q).sum(-1)
        else:
            sqq = (w * q * q).sum(-1)
            sxq = (w * x * q).sum(-1)
        with np.errstate(divide="ignore", invalid="ignore"):
            s_new = np.where(sqq > 0, sxq / sqq, scale)
        scale = s_new.astype(np.float32)
    return scale


def _groups(w, shape):
    return None if w is None else w.reshape(shape)


# Q2_K: 16 groups of 16; 4-bit scale + 4-bit min a group
def q2_k_quantize(x: np.ndarray, w=None) -> np.ndarray:
    nb = x.shape[0]
    g = x.reshape(nb, 16, 16)
    scale, mn = _group_scale_min(g, 3)
    scale, mn = _ls_refine_affine(g, scale, mn, 3, _groups(w, g.shape))
    smax = scale.max(axis=1)
    mmax = mn.max(axis=1)
    d = (smax / 15.0).astype(np.float32)
    dmin = (mmax / 15.0).astype(np.float32)
    d16 = d.astype(np.float16).astype(np.float32)
    dmin16 = dmin.astype(np.float16).astype(np.float32)
    sc = np.clip(np.rint(scale * _safe_inv(d)[:, None]), 0, 15).astype(np.uint8)
    m4 = np.clip(np.rint(mn * _safe_inv(dmin)[:, None]), 0, 15).astype(np.uint8)
    eff_s = d16[:, None, None] * sc[..., None]
    eff_m = dmin16[:, None, None] * m4[..., None]
    q = np.clip(np.rint((g + eff_m) * _safe_inv(eff_s)), 0, 3).astype(np.uint8)
    # packed in the decoder's order: (half, shift, byte l)
    qv = q.reshape(nb, 2, 4, 32)
    qs = np.zeros((nb, 2, 32), dtype=np.uint8)
    for shift in range(4):
        qs |= qv[:, :, shift, :] << (2 * shift)
    out = np.empty((nb, 84), dtype=np.uint8)
    out[:, 0:16] = sc | (m4 << 4)
    out[:, 16:80] = qs.reshape(nb, 64)
    out[:, 80:82] = _f16b(d)
    out[:, 82:84] = _f16b(dmin)
    return out


def _q3k_pack_scales(s6: np.ndarray) -> np.ndarray:
    """(nb, 16) values in [0, 63] -> (nb, 12) packed bytes."""
    nb = s6.shape[0]
    lo = s6 & 0xF
    hi = s6 >> 4
    out = np.zeros((nb, 12), dtype=np.uint8)
    out[:, 0:8] = lo[:, 0:8] | (lo[:, 8:16] << 4)
    for j in range(16):
        out[:, 8 + j % 4] |= (hi[:, j] & 3) << (2 * (j // 4))
    return out


# Q3_K: 16 groups of 16; 6-bit signed scales; 3-bit signed values
def q3_k_quantize(x: np.ndarray, w=None) -> np.ndarray:
    nb = x.shape[0]
    g = x.reshape(nb, 16, 16)
    scale = _signed_group_scale(g, 3, _groups(w, g.shape))
    smax = _max_by_abs(scale)
    d = (smax / -32.0).astype(np.float32)
    d16 = d.astype(np.float16).astype(np.float32)
    s6 = np.clip(np.rint(scale * _safe_inv(d)[:, None]), -32, 31).astype(np.int32)
    eff = d16[:, None, None] * s6[..., None].astype(np.float32)
    q = np.clip(np.rint(g * _safe_inv(eff)), -4, 3).astype(np.int8)
    qp = (q + 4).astype(np.uint8)  # [0, 7]: low 2 bits in qs, high bit in hmask
    qv = qp.reshape(nb, 2, 4, 32)  # (half, shift, l)
    qs = np.zeros((nb, 2, 32), dtype=np.uint8)
    hm = np.zeros((nb, 32), dtype=np.uint8)
    for half in range(2):
        for shift in range(4):
            qs[:, half] |= (qv[:, half, shift] & 3) << (2 * shift)
            hm |= (qv[:, half, shift] >> 2) << (half * 4 + shift)
    out = np.empty((nb, 110), dtype=np.uint8)
    out[:, 0:32] = hm
    out[:, 32:96] = qs.reshape(nb, 64)
    out[:, 96:108] = _q3k_pack_scales((s6 + 32).astype(np.uint8))
    out[:, 108:110] = _f16b(d)
    return out


def _k4_pack_scale_min(sc: np.ndarray, m: np.ndarray) -> np.ndarray:
    """(nb, 8) 6-bit scales + (nb, 8) 6-bit mins -> (nb, 12) packed."""
    nb = sc.shape[0]
    out = np.zeros((nb, 12), dtype=np.uint8)
    out[:, 0:4] = (sc[:, 0:4] & 63) | ((sc[:, 4:8] >> 4) << 6)
    out[:, 4:8] = (m[:, 0:4] & 63) | ((m[:, 4:8] >> 4) << 6)
    out[:, 8:12] = (sc[:, 4:8] & 0xF) | ((m[:, 4:8] & 0xF) << 4)
    return out


def _k4_fit(x: np.ndarray, nmax: int, w=None):
    """The Q4_K/Q5_K super-block fit -> d, dmin, sc6, m6, q."""
    nb = x.shape[0]
    g = x.reshape(nb, 8, 32)
    scale, mn = _group_scale_min(g, nmax)
    scale, mn = _ls_refine_affine(g, scale, mn, nmax, _groups(w, g.shape))
    d = (scale.max(axis=1) / 63.0).astype(np.float32)
    dmin = (mn.max(axis=1) / 63.0).astype(np.float32)
    d16 = d.astype(np.float16).astype(np.float32)
    dmin16 = dmin.astype(np.float16).astype(np.float32)
    sc6 = np.clip(np.rint(scale * _safe_inv(d)[:, None]), 0, 63).astype(np.uint8)
    m6 = np.clip(np.rint(mn * _safe_inv(dmin)[:, None]), 0, 63).astype(np.uint8)
    eff_s = d16[:, None, None] * sc6[..., None]
    eff_m = dmin16[:, None, None] * m6[..., None]
    q = np.clip(np.rint((g + eff_m) * _safe_inv(eff_s)), 0, nmax).astype(np.uint8)
    return d, dmin, sc6, m6, q


# Q4_K: 8 groups of 32; 6-bit scales + mins packed into 12 bytes
def q4_k_quantize(x: np.ndarray, w=None) -> np.ndarray:
    nb = x.shape[0]
    d, dmin, sc6, m6, q = _k4_fit(x, 15, w)
    out = np.empty((nb, 144), dtype=np.uint8)
    out[:, 0:2] = _f16b(d)
    out[:, 2:4] = _f16b(dmin)
    out[:, 4:16] = _k4_pack_scale_min(sc6, m6)
    qc = q.reshape(nb, 4, 2, 32)  # chunks of 64: (lo group, hi group)
    out[:, 16:144] = (qc[:, :, 0] | (qc[:, :, 1] << 4)).reshape(nb, 128)
    return out


# Q5_K: Q4_K's fit at 5 bits, the high bit of each value in qh
def q5_k_quantize(x: np.ndarray, w=None) -> np.ndarray:
    nb = x.shape[0]
    d, dmin, sc6, m6, q = _k4_fit(x, 31, w)
    out = np.empty((nb, 176), dtype=np.uint8)
    out[:, 0:2] = _f16b(d)
    out[:, 2:4] = _f16b(dmin)
    out[:, 4:16] = _k4_pack_scale_min(sc6, m6)
    qc = q.reshape(nb, 4, 2, 32)
    qh = np.zeros((nb, 32), dtype=np.uint8)
    for g in range(8):
        qh |= (q.reshape(nb, 8, 32)[:, g] >> 4) << g
    out[:, 16:48] = qh
    out[:, 48:176] = ((qc[:, :, 0] & 0xF) | ((qc[:, :, 1] & 0xF) << 4)).reshape(nb, 128)
    return out


# Q6_K: 16 groups of 16; int8 scales; 6-bit signed values
def q6_k_quantize(x: np.ndarray, w=None) -> np.ndarray:
    nb = x.shape[0]
    g = x.reshape(nb, 16, 16)
    scale = _signed_group_scale(g, 31, _groups(w, g.shape))
    smax = _max_by_abs(scale)
    d = (smax / -128.0).astype(np.float32)
    d16 = d.astype(np.float16).astype(np.float32)
    s8 = np.clip(np.rint(scale * _safe_inv(d)[:, None]), -128, 127).astype(np.int8)
    eff = d16[:, None, None] * s8[..., None].astype(np.float32)
    q = np.clip(np.rint(g * _safe_inv(eff)), -32, 31).astype(np.int8)
    qp = (q + 32).astype(np.uint8).reshape(nb, 256)
    # per 128-value half: q1=v[0:32] q2=v[32:64] q3=v[64:96] q4=v[96:128]
    v = qp.reshape(nb, 2, 4, 32)
    ql = np.empty((nb, 2, 64), dtype=np.uint8)
    ql[:, :, 0:32] = (v[:, :, 0] & 0xF) | ((v[:, :, 2] & 0xF) << 4)
    ql[:, :, 32:64] = (v[:, :, 1] & 0xF) | ((v[:, :, 3] & 0xF) << 4)
    qh = ((v[:, :, 0] >> 4) | ((v[:, :, 1] >> 4) << 2)
          | ((v[:, :, 2] >> 4) << 4) | ((v[:, :, 3] >> 4) << 6))
    out = np.empty((nb, 210), dtype=np.uint8)
    out[:, 0:128] = ql.reshape(nb, 128)
    out[:, 128:192] = qh.reshape(nb, 64)
    out[:, 192:208] = s8.view(np.uint8)
    out[:, 208:210] = _f16b(d)
    return out


def _iq4_nearest(xs: np.ndarray) -> np.ndarray:
    """The nearest LUT index of each scaled value."""
    return np.abs(xs[..., None] - KVALUES_IQ4NL).argmin(axis=-1).astype(np.uint8)


def _iq4_fit_scale(x: np.ndarray, init_d: np.ndarray, iters: int = 4):
    """Least-squares refinement of d so that x ~= d * LUT[q]."""
    d = init_d
    for _ in range(iters):
        q = _iq4_nearest(x * _safe_inv(d)[..., None])
        lw = KVALUES_IQ4NL[q]
        num = (x * lw).sum(-1)
        den = (lw * lw).sum(-1)
        d = np.where(den > 0, num / den, d).astype(np.float32)
    return d, _iq4_nearest(x * _safe_inv(d)[..., None])


# IQ4_NL: {fp16 d; 16 nibbles of LUT indices} per 32
def iq4_nl_quantize(x: np.ndarray, w=None) -> np.ndarray:
    nb = x.shape[0]
    m = _max_by_abs(x)
    d0 = (m / -127.0).astype(np.float32)
    d, q = _iq4_fit_scale(x, d0)
    d16 = d.astype(np.float16).astype(np.float32)
    q = _iq4_nearest(x * _safe_inv(d16)[..., None])
    out = np.empty((nb, 18), dtype=np.uint8)
    out[:, 0:2] = _f16b(d)
    out[:, 2:18] = q[:, :16] | (q[:, 16:] << 4)
    return out


# IQ4_XS: 8 groups of 32 with 6-bit scales (stored as ls + 32) under one d
def iq4_xs_quantize(x: np.ndarray, w=None) -> np.ndarray:
    nb = x.shape[0]
    g = x.reshape(nb, 8, 32)
    m = _max_by_abs(g)
    d0 = (m / -127.0).astype(np.float32)
    sg, _ = _iq4_fit_scale(g, d0)  # per-group scale
    smax = _max_by_abs(sg)
    d = (smax / -31.0).astype(np.float32)
    d16 = d.astype(np.float16).astype(np.float32)
    ls = np.clip(np.rint(sg * _safe_inv(d)[:, None]) + 32, 0, 63).astype(np.uint8)
    eff = d16[:, None] * (ls.astype(np.float32) - 32)
    q = _iq4_nearest(g * _safe_inv(eff)[..., None])
    out = np.zeros((nb, 136), dtype=np.uint8)
    out[:, 0:2] = _f16b(d)
    sh = np.zeros(nb, dtype=np.uint16)
    for gi in range(8):
        sh |= ((ls[:, gi] >> 4).astype(np.uint16)) << (2 * gi)
    out[:, 2:4] = sh[:, None].view(np.uint8).reshape(nb, 2)
    out[:, 4:8] = (ls[:, 0::2] & 0xF) | ((ls[:, 1::2] & 0xF) << 4)
    out[:, 8:136] = (q[:, :, 0:16] | (q[:, :, 16:32] << 4)).reshape(nb, 128)
    return out


def _tq1_pack(trits: np.ndarray, n_levels: int) -> np.ndarray:
    """(nb, n_levels, width) trits {0,1,2} -> packed bytes (nb, width):
    big-endian base 3, stripe 0 the most significant trit, encoded as
    ceil(acc * 256 / 243) so that _tq1_unpack's fixed point inverts it."""
    wts = (3 ** np.arange(4, 4 - n_levels, -1, dtype=np.uint16))[None, :, None]
    acc = (trits.astype(np.uint16) * wts).sum(axis=1)
    return ((acc * 256 + 242) // 243).astype(np.uint8)


def tq1_0_quantize(x: np.ndarray, w=None) -> np.ndarray:
    nb = x.shape[0]
    d = np.abs(x).max(axis=-1).astype(np.float32)
    q = (np.clip(np.rint(x * _safe_inv(d)[:, None]), -1, 1).astype(np.int8) + 1).astype(np.uint8)
    out = np.empty((nb, 54), dtype=np.uint8)
    out[:, 0:32] = _tq1_pack(q[:, 0:160].reshape(nb, 5, 32), 5)
    out[:, 32:48] = _tq1_pack(q[:, 160:240].reshape(nb, 5, 16), 5)
    out[:, 48:52] = _tq1_pack(q[:, 240:256].reshape(nb, 4, 4), 4)
    out[:, 52:54] = _f16b(d)
    return out


def tq2_0_quantize(x: np.ndarray, w=None) -> np.ndarray:
    nb = x.shape[0]
    d = np.abs(x).max(axis=-1).astype(np.float32)
    q = (np.clip(np.rint(x * _safe_inv(d)[:, None]), -1, 1).astype(np.int8) + 1).astype(np.uint8)
    v = q.reshape(nb, 2, 4, 32)  # 2 sub-blocks of 128, 4 crumbs a byte
    qs = np.zeros((nb, 2, 32), dtype=np.uint8)
    for j in range(4):
        qs |= v[:, :, j] << (2 * j)
    out = np.empty((nb, 66), dtype=np.uint8)
    out[:, 0:64] = qs.reshape(nb, 64)
    out[:, 64:66] = _f16b(d)
    return out


# ---------------------------------------------------------------------------
# i-quants with codebooks (IQ2_XXS/XS/S, IQ3_XXS/S, IQ1_S/M)

_IQ_GRIDS: dict[str, np.ndarray] | None = None


def _iq_grids() -> dict[str, np.ndarray]:
    global _IQ_GRIDS
    if _IQ_GRIDS is None:
        path = os.path.join(os.path.dirname(__file__), "data", "iq_grids.npz")
        _IQ_GRIDS = dict(np.load(path))
    return _IQ_GRIDS


def _ksigns(bits: np.ndarray, width: int) -> np.ndarray:
    """Expand a 7-bit sign field (+ parity as bit 8) into +-1 over `width`
    lanes: entry i of ggml's ksigns_iq2xs has sign bits i | parity(i) << 7;
    lane j is negative iff bit j is set."""
    b = bits.astype(np.uint8)
    par = b
    par = par ^ (par >> 4)
    par = par ^ (par >> 2)
    par = par ^ (par >> 1)
    full = b | ((par & 1) << 7)
    j = np.arange(width, dtype=np.uint8)
    neg = (full[..., None] >> j) & 1
    return 1.0 - 2.0 * neg.astype(np.float32)


def iq2_xxs_dequantize(raw: np.ndarray) -> np.ndarray:
    g = _iq_grids()["iq2xxs"]  # (256, 8)
    nb = raw.shape[0]
    d = _read_f16(raw[:, 0:2])
    q = raw[:, 2:66].copy().view(np.uint16).reshape(nb, 8, 4)
    aux32 = (q[:, :, 2].astype(np.uint32) | (q[:, :, 3].astype(np.uint32) << 16))
    idx = q[:, :, 0:2].copy().view(np.uint8).reshape(nb, 8, 4)
    db = d[:, None] * (0.5 + (aux32 >> 28).astype(np.float32)) * 0.25
    l = np.arange(4)
    signs = _ksigns((aux32[..., None] >> (7 * l)[None, None, :]).astype(np.uint8) & 127, 8)
    vals = g[idx].astype(np.float32)  # (nb, 8, 4, 8)
    out = db[..., None, None] * vals * signs
    return out.reshape(nb, 256)


def iq2_xs_dequantize(raw: np.ndarray) -> np.ndarray:
    g = _iq_grids()["iq2xs"]  # (512, 8)
    nb = raw.shape[0]
    d = _read_f16(raw[:, 0:2])
    q16 = raw[:, 2:66].copy().view(np.uint16).reshape(nb, 8, 4)
    scales = raw[:, 66:74]
    ls = np.stack([scales & 0xF, scales >> 4], axis=2).reshape(nb, 16).astype(np.float32)
    db = d[:, None] * (0.5 + ls) * 0.25  # (nb, 16) per group of 16
    vals = g[q16 & 511].astype(np.float32)  # (nb, 8, 4, 8)
    signs = _ksigns((q16 >> 9).astype(np.uint8), 8)
    out = (vals * signs).reshape(nb, 16, 16) * db[..., None]
    return out.reshape(nb, 256)


def iq2_s_dequantize(raw: np.ndarray) -> np.ndarray:
    # block_iq2_s: d, qs[64] (32 low index bytes, then 32 sign bytes),
    # qh[8] (2 high index bits per 8 values), scales[8]
    g = _iq_grids()["iq2s"]  # (1024, 8)
    nb = raw.shape[0]
    d = _read_f16(raw[:, 0:2])
    idx_lo = raw[:, 2:34]
    sign_b = raw[:, 34:66]
    qh = raw[:, 66:74]
    scales = raw[:, 74:82]
    ls = np.stack([scales & 0xF, scales >> 4], axis=2).reshape(nb, 16).astype(np.float32)
    db = d[:, None] * (0.5 + ls) * 0.25
    ib = np.arange(32)
    hi = (qh[:, ib // 4] >> (2 * (ib % 4))[None, :].astype(np.uint8)) & 3
    idx = idx_lo.astype(np.int32) | (hi.astype(np.int32) << 8)
    vals = g[idx].astype(np.float32)  # (nb, 32, 8)
    j = np.arange(8, dtype=np.uint8)
    neg = (sign_b[..., None] >> j) & 1
    sg = 1.0 - 2.0 * neg.astype(np.float32)
    out = (vals * sg).reshape(nb, 16, 16) * db[..., None]
    return out.reshape(nb, 256)


def iq3_xxs_dequantize(raw: np.ndarray) -> np.ndarray:
    g = _iq_grids()["iq3xxs"]  # (256, 4)
    nb = raw.shape[0]
    d = _read_f16(raw[:, 0:2])
    qs = raw[:, 2:66]  # 64 grid indices (4 values each)
    aux = raw[:, 66:98].copy().view(np.uint32).reshape(nb, 8)  # per 32 values
    db = d[:, None] * (0.5 + (aux >> 28).astype(np.float32)) * 0.5
    l = np.arange(4)
    signs = _ksigns((aux[..., None] >> (7 * l)[None, None, :]).astype(np.uint8) & 127, 8)
    idx = qs.reshape(nb, 8, 8)
    vals = g[idx].astype(np.float32).reshape(nb, 8, 4, 8)
    out = db[..., None, None] * vals * signs
    return out.reshape(nb, 256)


def iq3_s_dequantize(raw: np.ndarray) -> np.ndarray:
    g = _iq_grids()["iq3s"]  # (512, 4)
    nb = raw.shape[0]
    d = _read_f16(raw[:, 0:2])
    qs = raw[:, 2:66]  # low 8 index bits
    qh = raw[:, 66:74]  # high index bit, 8 per byte
    sign_b = raw[:, 74:106]
    scales = raw[:, 106:110]
    ls = np.stack([scales & 0xF, scales >> 4], axis=2).reshape(nb, 8).astype(np.float32)
    db = d[:, None] * (1 + 2 * ls)  # per 32 values
    ib = np.arange(64)
    hi = (qh[:, ib // 8] >> (ib % 8)[None, :].astype(np.uint8)) & 1
    idx = qs.astype(np.int32) | (hi.astype(np.int32) << 8)
    vals = g[idx].astype(np.float32).reshape(nb, 8, 8, 4)
    j = np.arange(8, dtype=np.uint8)
    neg = (sign_b[..., None] >> j) & 1
    sg = (1.0 - 2.0 * neg.astype(np.float32)).reshape(nb, 8, 4, 8)
    out = vals.reshape(nb, 8, 32) * sg.reshape(nb, 8, 32) * db[..., None]
    return out.reshape(nb, 256)


IQ1_DELTA = 0.125


def iq1_s_dequantize(raw: np.ndarray) -> np.ndarray:
    g = _iq_grids()["iq1s"]  # (2048, 8) in {-1, 0, 1}
    nb = raw.shape[0]
    d = _read_f16(raw[:, 0:2])
    qs = raw[:, 2:34]  # 32 low-8 indices
    qh = raw[:, 34:50].copy().view(np.uint16).reshape(nb, 8)  # per 32 values
    dl = d[:, None] * (2 * ((qh >> 12) & 7).astype(np.float32) + 1)
    delta = np.where((qh & 0x8000) != 0, -IQ1_DELTA, IQ1_DELTA).astype(np.float32)
    ib = np.arange(32)
    hi = (qh[:, ib // 4] >> (3 * (ib % 4))[None, :].astype(np.uint16)) & 7
    idx = qs.astype(np.int32) | (hi.astype(np.int32) << 8)
    vals = g[idx].astype(np.float32)  # (nb, 32, 8)
    out = (vals.reshape(nb, 8, 32) + delta[..., None]) * dl[..., None]
    return out.reshape(nb, 256)


def iq1_m_dequantize(raw: np.ndarray) -> np.ndarray:
    g = _iq_grids()["iq1s"]
    nb = raw.shape[0]
    qs = raw[:, 0:32]
    qh = raw[:, 32:48]  # 4 bits per 8 values
    sc = raw[:, 48:56].copy().view(np.uint16).reshape(nb, 4)
    # the fp16 d sits in the top 4 bits of each of the 4 scale words
    d_bits = (((sc >> 12).astype(np.uint16)) << np.array([0, 4, 8, 12], dtype=np.uint16)).sum(
        axis=1, dtype=np.uint16
    )
    d = d_bits[:, None].view(np.float16).astype(np.float32)[:, 0]
    ib = np.arange(32)
    hi = (qh[:, ib // 2] >> (4 * (ib % 2))[None, :].astype(np.uint8)) & 0xF
    idx = qs.astype(np.int32) | ((hi & 7).astype(np.int32) << 8)
    vals = g[idx].astype(np.float32)  # (nb, 32, 8), groups of 8
    delta = np.where((hi & 8) != 0, -IQ1_DELTA, IQ1_DELTA).astype(np.float32)
    # 3-bit scales, one per 16 values
    sh = np.arange(16)
    s3 = (sc[:, sh // 4] >> (3 * (sh % 4))[None, :].astype(np.uint16)) & 7
    dl = d[:, None] * (2 * s3.astype(np.float32) + 1)  # (nb, 16)
    out = (vals + delta[..., None]).reshape(nb, 16, 16) * dl[..., None]
    return out.reshape(nb, 256)


# ---------------------------------------------------------------------------
# registry

_DEQUANTIZERS = {
    GGMLType.Q4_0: q4_0_dequantize,
    GGMLType.Q4_1: q4_1_dequantize,
    GGMLType.Q5_0: q5_0_dequantize,
    GGMLType.Q5_1: q5_1_dequantize,
    GGMLType.Q8_0: q8_0_dequantize,
    GGMLType.Q2_K: q2_k_dequantize,
    GGMLType.Q3_K: q3_k_dequantize,
    GGMLType.Q4_K: q4_k_dequantize,
    GGMLType.Q5_K: q5_k_dequantize,
    GGMLType.Q6_K: q6_k_dequantize,
    GGMLType.IQ4_NL: iq4_nl_dequantize,
    GGMLType.IQ4_XS: iq4_xs_dequantize,
    GGMLType.IQ2_XXS: iq2_xxs_dequantize,
    GGMLType.IQ2_XS: iq2_xs_dequantize,
    GGMLType.IQ2_S: iq2_s_dequantize,
    GGMLType.IQ3_XXS: iq3_xxs_dequantize,
    GGMLType.IQ3_S: iq3_s_dequantize,
    GGMLType.IQ1_S: iq1_s_dequantize,
    GGMLType.IQ1_M: iq1_m_dequantize,
    GGMLType.TQ1_0: tq1_0_dequantize,
    GGMLType.TQ2_0: tq2_0_dequantize,
}


_QUANTIZERS = {
    GGMLType.Q4_0: q4_0_quantize,
    GGMLType.Q4_1: q4_1_quantize,
    GGMLType.Q5_0: q5_0_quantize,
    GGMLType.Q5_1: q5_1_quantize,
    GGMLType.Q8_0: q8_0_quantize,
    GGMLType.Q2_K: q2_k_quantize,
    GGMLType.Q3_K: q3_k_quantize,
    GGMLType.Q4_K: q4_k_quantize,
    GGMLType.Q5_K: q5_k_quantize,
    GGMLType.Q6_K: q6_k_quantize,
    GGMLType.IQ4_NL: iq4_nl_quantize,
    GGMLType.IQ4_XS: iq4_xs_quantize,
    GGMLType.TQ1_0: tq1_0_quantize,
    GGMLType.TQ2_0: tq2_0_quantize,
}


def supported_quantize_types() -> list[GGMLType]:
    """The block types of _QUANTIZERS; quantize() also takes F32/F16/BF16
    and the codebook i-quants of iq_quantize.IQ_QUANTIZERS."""
    return sorted(_QUANTIZERS, key=int)


def supported_dequantize_types() -> list[GGMLType]:
    return sorted(_DEQUANTIZERS, key=int)


# A tensor of at least PARALLEL_MIN values is encoded in row spans of
# about SPAN values on _POOL's threads (numpy releases the GIL in its
# loops, and a span's temporaries stay in cache). The encoders of
# _QUANTIZERS treat every block alone with elementwise steps and
# reductions along a block, so a span's bytes are those of the whole
# tensor's; the codebook encoders score blocks with matrix products,
# whose summation order may follow the row count, and run in one call.
PARALLEL_MIN = 1 << 20
SPAN = 1 << 18
_POOL = ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1))


def quantize(x: np.ndarray, ggml_type: GGMLType,
             weights: np.ndarray | None = None) -> np.ndarray:
    """Float rows (n, k) -> packed uint8 (n, row bytes). weights: the
    optional importance [k] of each column (an imatrix's sums of squared
    activations); the fits then minimize the weighted error."""
    if ggml_type == GGMLType.F32:
        return np.ascontiguousarray(x.astype(np.float32)).view(np.uint8)
    if ggml_type == GGMLType.F16:
        return np.ascontiguousarray(x.astype(np.float16)).view(np.uint8)
    if ggml_type == GGMLType.BF16:
        f32 = np.ascontiguousarray(x.astype(np.float32))
        return (f32.view(np.uint32) >> 16).astype(np.uint16).view(np.uint8)
    fn = _QUANTIZERS.get(ggml_type)
    spans = fn is not None
    if fn is None:
        from .iq_quantize import IQ_QUANTIZERS

        fn = IQ_QUANTIZERS.get(ggml_type)
    if fn is None:
        raise NotImplementedError(
            f"quantize to {ggml_type.name}: this port encodes F32/F16/BF16 "
            "and the block types " + ", ".join(
                t.name for t in supported_quantize_types()) +
            " and the codebook i-quants")
    x = np.asarray(x, dtype=np.float32)
    orig_rows = x.shape[:-1]
    k = x.shape[-1]
    blk, nbytes = GGML_BLOCK_SIZES[ggml_type]
    if k % blk:
        raise ValueError(f"row length {k} not divisible by block size {blk}")
    blocks = x.reshape(-1, blk)
    per = k // blk                      # blocks a row
    n = blocks.shape[0] // per
    wcol = None
    if weights is not None:
        wcol = np.asarray(weights, np.float32).reshape(k)
        wcol = np.maximum(wcol, wcol.mean() * 1e-3 + 1e-12)

    def run(lo: int, hi: int) -> np.ndarray:
        w = None if wcol is None else np.tile(wcol, hi - lo).reshape(-1, blk)
        return fn(blocks[lo * per:hi * per], w)

    if spans and x.size >= PARALLEL_MIN:
        step = max(1, SPAN // k)
        out = np.concatenate(list(_POOL.map(
            lambda lo: run(lo, min(lo + step, n)), range(0, n, step))))
    else:
        out = run(0, n)
    return out.reshape(*orig_rows, per * nbytes)


def dequantize(raw: np.ndarray, ggml_type: GGMLType) -> np.ndarray:
    """Packed bytes (flat or (n, row_bytes)) -> float32 flat-per-row."""
    raw = np.asarray(raw)
    if ggml_type == GGMLType.F32:
        return np.ascontiguousarray(raw).view(np.float32)
    if ggml_type == GGMLType.F16:
        return np.ascontiguousarray(raw).view(np.float16).astype(np.float32)
    if ggml_type == GGMLType.BF16:
        u16 = np.ascontiguousarray(raw).view(np.uint16).astype(np.uint32) << 16
        return u16.view(np.float32)
    fn = _DEQUANTIZERS.get(ggml_type)
    if fn is None:
        raise NotImplementedError(
            f"dequantize from {ggml_type.name}: this port decodes F32/F16/"
            "BF16 and the block types " +
            ", ".join(t.name for t in supported_dequantize_types()))
    blk, nbytes = GGML_BLOCK_SIZES[ggml_type]
    orig_rows = raw.shape[:-1] if raw.ndim > 1 else ()
    blocks = np.ascontiguousarray(raw, dtype=np.uint8).reshape(-1, nbytes)
    out = fn(blocks)
    if orig_rows:
        return out.reshape(*orig_rows, -1)
    return out.reshape(-1)
