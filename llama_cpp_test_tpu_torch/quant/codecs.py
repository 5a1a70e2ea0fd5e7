"""numpy decoders for the GGUF block formats.

Counterpart of llama_cpp_test_tpu/quant/codecs.py, decode only: F32/F16/
BF16, the legacy formats (Q4_0, Q4_1, Q5_0, Q5_1, Q8_0), the K-quants
(Q2_K to Q6_K), the non-linear nibble formats (IQ4_NL, IQ4_XS), the
codebook i-quants (IQ2_XXS/XS/S, IQ3_XXS/S, IQ1_S/M) and the ternary TQ1_0/
TQ2_0. Byte layouts are file-format facts; every decoder works on all
blocks of a tensor at once. The codebook grids are format constants,
shipped as data/iq_grids.npz.
"""
from __future__ import annotations

import os

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


def supported_dequantize_types() -> list[GGMLType]:
    return sorted(_DEQUANTIZERS, key=int)


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
