"""Codebook i-quants and ternary formats -> weight planes, exactly.

Counterpart of llama_cpp_test_tpu/quant/iq_repack.py. Every codebook's
value set is small:
    iq2xxs/iq2xs/iq2s grids: magnitudes {8, 25, 43}   (x signs)
    iq3xxs grid:             {4, 12, 20, 28, 36, 44, 52, 62}
    iq3s grid:               {1, 3, 5, 7, 9, 11, 13, 15}
    iq1s grid / TQ ternary:  {-1, 0, 1}
so each weight re-packs exactly into a 4-bit code over a 16-entry LUT
('u4lut') or a 2-bit code over a 4-entry LUT ('u2lut'), with the group
scale in a bf16 plane: x = scale * LUT[code]. The decomposers follow the
byte parsing of quant/codecs.py, and dequantizing the planes gives the
codec's values up to float32 multiply order.
"""
from __future__ import annotations

import numpy as np

from ..gguf.constants import GGMLType
from .codecs import _iq_grids, _ksigns, _read_f16, _tq1_unpack

# u4lut code = magnitude index | (sign << 3)
_LUT_IQ2 = np.array([8, 25, 43, 0, 0, 0, 0, 0,
                     -8, -25, -43, 0, 0, 0, 0, 0], np.float32)
_MAGS_IQ2 = np.array([8, 25, 43], np.uint8)
_LUT_IQ3XXS = np.array([4, 12, 20, 28, 36, 44, 52, 62,
                        -4, -12, -20, -28, -36, -44, -52, -62], np.float32)
_MAGS_IQ3XXS = np.array([4, 12, 20, 28, 36, 44, 52, 62], np.uint8)
_LUT_IQ3S = np.array([1, 3, 5, 7, 9, 11, 13, 15,
                      -1, -3, -5, -7, -9, -11, -13, -15], np.float32)
# iq1_m: 8*(v + delta) for v in {-1,0,1}, delta = +-0.125;
# code = (v+1) | (negdelta << 2)
_LUT_IQ1M = np.array([-7, 1, 9, 0, -9, -1, 7, 0,
                      0, 0, 0, 0, 0, 0, 0, 0], np.float32)


def _mag_code(mags: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Map magnitude bytes -> index in `table` (tiny linear scan)."""
    code = np.zeros(mags.shape, np.uint8)
    for i, v in enumerate(table):
        code[mags == v] = i
    return code


def _signed_code(vals: np.ndarray, signs: np.ndarray,
                 table: np.ndarray) -> np.ndarray:
    """(magnitude bytes, +-1 signs) -> u4lut codes mag | neg<<3."""
    return _mag_code(vals, table) | (((signs < 0).astype(np.uint8)) << 3)


def _d_iq2_xxs(b, n, k):
    g = _iq_grids()["iq2xxs"]
    nb = b.shape[0]
    d = _read_f16(b[:, 0:2])
    q = b[:, 2:66].copy().view(np.uint16).reshape(nb, 8, 4)
    aux32 = (q[:, :, 2].astype(np.uint32) |
             (q[:, :, 3].astype(np.uint32) << 16))
    idx = q[:, :, 0:2].copy().view(np.uint8).reshape(nb, 8, 4)
    db = d[:, None] * (0.5 + (aux32 >> 28).astype(np.float32)) * 0.25
    l = np.arange(4)
    signs = _ksigns(
        (aux32[..., None] >> (7 * l)[None, None, :]).astype(np.uint8) & 127,
        8)
    vals = g[idx]                                    # (nb, 8, 4, 8) uint8
    code = _signed_code(vals, signs, _MAGS_IQ2).reshape(nb, 256)
    return ("u4lut", code.reshape(n, k), db.reshape(n, k // 32), None, 32,
            _LUT_IQ2.copy())


def _d_iq2_xs(b, n, k):
    g = _iq_grids()["iq2xs"]
    nb = b.shape[0]
    d = _read_f16(b[:, 0:2])
    q16 = b[:, 2:66].copy().view(np.uint16).reshape(nb, 8, 4)
    scales = b[:, 66:74]
    ls = np.stack([scales & 0xF, scales >> 4], axis=2).reshape(nb, 16) \
        .astype(np.float32)
    db = d[:, None] * (0.5 + ls) * 0.25              # per 16
    vals = g[q16 & 511]                              # (nb, 8, 4, 8)
    signs = _ksigns((q16 >> 9).astype(np.uint8), 8)
    code = _signed_code(vals, signs, _MAGS_IQ2).reshape(nb, 256)
    return ("u4lut", code.reshape(n, k), db.reshape(n, k // 16), None, 16,
            _LUT_IQ2.copy())


def _d_iq2_s(b, n, k):
    g = _iq_grids()["iq2s"]
    nb = b.shape[0]
    d = _read_f16(b[:, 0:2])
    idx_lo = b[:, 2:34]
    sign_b = b[:, 34:66]
    qh = b[:, 66:74]
    scales = b[:, 74:82]
    ls = np.stack([scales & 0xF, scales >> 4], axis=2).reshape(nb, 16) \
        .astype(np.float32)
    db = d[:, None] * (0.5 + ls) * 0.25
    ib = np.arange(32)
    hi = (qh[:, ib // 4] >> (2 * (ib % 4))[None, :].astype(np.uint8)) & 3
    idx = idx_lo.astype(np.int32) | (hi.astype(np.int32) << 8)
    vals = g[idx]                                    # (nb, 32, 8)
    j = np.arange(8, dtype=np.uint8)
    neg = (sign_b[..., None] >> j) & 1
    sg = 1.0 - 2.0 * neg.astype(np.float32)
    code = _signed_code(vals, sg, _MAGS_IQ2).reshape(nb, 256)
    return ("u4lut", code.reshape(n, k), db.reshape(n, k // 16), None, 16,
            _LUT_IQ2.copy())


def _d_iq3_xxs(b, n, k):
    g = _iq_grids()["iq3xxs"]
    nb = b.shape[0]
    d = _read_f16(b[:, 0:2])
    qs = b[:, 2:66]
    aux = b[:, 66:98].copy().view(np.uint32).reshape(nb, 8)
    db = d[:, None] * (0.5 + (aux >> 28).astype(np.float32)) * 0.5
    l = np.arange(4)
    signs = _ksigns(
        (aux[..., None] >> (7 * l)[None, None, :]).astype(np.uint8) & 127, 8)
    idx = qs.reshape(nb, 8, 8)
    vals = g[idx].reshape(nb, 8, 4, 8)
    code = _signed_code(vals, signs, _MAGS_IQ3XXS).reshape(nb, 256)
    return ("u4lut", code.reshape(n, k), db.reshape(n, k // 32), None, 32,
            _LUT_IQ3XXS.copy())


def _d_iq3_s(b, n, k):
    g = _iq_grids()["iq3s"]
    nb = b.shape[0]
    d = _read_f16(b[:, 0:2])
    qs = b[:, 2:66]
    qh = b[:, 66:74]
    sign_b = b[:, 74:106]
    scales = b[:, 106:110]
    ls = np.stack([scales & 0xF, scales >> 4], axis=2).reshape(nb, 8) \
        .astype(np.float32)
    db = d[:, None] * (1 + 2 * ls)                   # per 32
    ib = np.arange(64)
    hi = (qh[:, ib // 8] >> (ib % 8)[None, :].astype(np.uint8)) & 1
    idx = qs.astype(np.int32) | (hi.astype(np.int32) << 8)
    vals = g[idx].reshape(nb, 8, 8, 4)
    j = np.arange(8, dtype=np.uint8)
    neg = (sign_b[..., None] >> j) & 1
    sg = (1.0 - 2.0 * neg.astype(np.float32)).reshape(nb, 8, 4, 8)
    code = _signed_code(vals.reshape(nb, 8, 32), sg.reshape(nb, 8, 32),
                        (_LUT_IQ3S[:8]).astype(np.uint8)).reshape(nb, 256)
    return ("u4lut", code.reshape(n, k), db.reshape(n, k // 32), None, 32,
            _LUT_IQ3S.copy())


# iq1_s / TQ: x = s_signed * LUT2[q]. Folding the +-0.125 delta into a MIN
# plane (x = s*q - m with m ~ s) cancels catastrophically once scale/min
# round to bf16, so instead the delta's SIGN folds into the scale sign with
# the code order reversed: dl*(v - 0.125) = (-dl) * ((-v) + 0.125).
_LUT_IQ1S = np.array([-0.875, 0.125, 1.125, 0.0], np.float32)
# code 3 is out of range for real ternary data; mirror the codec's q-1
_LUT_TERNARY = np.array([-1.0, 0.0, 1.0, 2.0], np.float32)


def _d_iq1_s(b, n, k):
    g = _iq_grids()["iq1s"]
    nb = b.shape[0]
    d = _read_f16(b[:, 0:2])
    qs = b[:, 2:34]
    qh = b[:, 34:50].copy().view(np.uint16).reshape(nb, 8)
    dl = d[:, None] * (2 * ((qh >> 12) & 7).astype(np.float32) + 1)
    negd = (qh & 0x8000) != 0                        # (nb, 8) per 32 vals
    ib = np.arange(32)
    hi = (qh[:, ib // 4] >> (3 * (ib % 4))[None, :].astype(np.uint16)) & 7
    idx = qs.astype(np.int32) | (hi.astype(np.int32) << 8)
    vals = g[idx].astype(np.int8).reshape(nb, 8, 32)  # in {-1, 0, 1}
    vals = np.where(negd[..., None], -vals, vals)
    q = (vals.reshape(nb, 256) + 1).astype(np.uint8)
    s = np.where(negd, -dl, dl)                      # (nb, 8) per 32
    return ("u2lut", q.reshape(n, k), s.reshape(n, k // 32), None, 32,
            _LUT_IQ1S.copy())


def _d_iq1_m(b, n, k):
    """x = dl*(v + delta) with dl per 16 and delta per 8 -> u4lut per 16:
    x = (dl/8) * LUT[(v+1) | negdelta<<2]."""
    g = _iq_grids()["iq1s"]
    nb = b.shape[0]
    qs = b[:, 0:32]
    qh = b[:, 32:48]
    sc = b[:, 48:56].copy().view(np.uint16).reshape(nb, 4)
    d_bits = (((sc >> 12).astype(np.uint16)) <<
              np.array([0, 4, 8, 12], dtype=np.uint16)).sum(
        axis=1, dtype=np.uint16)
    d = d_bits[:, None].view(np.float16).astype(np.float32)[:, 0]
    ib = np.arange(32)
    hi = (qh[:, ib // 2] >> (4 * (ib % 2))[None, :].astype(np.uint8)) & 0xF
    idx = qs.astype(np.int32) | ((hi & 7).astype(np.int32) << 8)
    vals = g[idx].astype(np.int8)                    # (nb, 32, 8)
    negd = ((hi & 8) != 0).astype(np.uint8)          # (nb, 32) per 8 vals
    code = ((vals + 1).astype(np.uint8) |
            (negd[..., None] << 2)).reshape(nb, 256)
    sh = np.arange(16)
    s3 = (sc[:, sh // 4] >> (3 * (sh % 4))[None, :].astype(np.uint16)) & 7
    dl = d[:, None] * (2 * s3.astype(np.float32) + 1) / 8.0  # per 16
    return ("u4lut", code.reshape(n, k), dl.reshape(n, k // 16), None, 16,
            _LUT_IQ1M.copy())


def _d_tq1_0(b, n, k):
    nb = b.shape[0]
    d = _read_f16(b[:, 52:54])
    q = np.empty((nb, 256), dtype=np.uint8)
    q[:, 0:160] = _tq1_unpack(b[:, 0:32], 5).reshape(nb, 160)
    q[:, 160:240] = _tq1_unpack(b[:, 32:48], 5).reshape(nb, 80)
    q[:, 240:256] = _tq1_unpack(b[:, 48:52], 4).reshape(nb, 16)
    s = d[:, None]                                   # per 256
    return ("u2lut", q.reshape(n, k), s.reshape(n, k // 256), None, 256,
            _LUT_TERNARY.copy())


def _d_tq2_0(b, n, k):
    nb = b.shape[0]
    d = _read_f16(b[:, 64:66])
    qs = b[:, 0:64].reshape(nb, 2, 1, 32)
    shifts = np.arange(4, dtype=np.uint8).reshape(1, 1, 4, 1) * 2
    q = ((qs >> shifts) & 3).reshape(nb, 256)
    s = d[:, None]
    return ("u2lut", q.reshape(n, k), s.reshape(n, k // 256), None, 256,
            _LUT_TERNARY.copy())


IQ_DECOMPOSERS = {
    GGMLType.IQ2_XXS: _d_iq2_xxs,
    GGMLType.IQ2_XS: _d_iq2_xs,
    GGMLType.IQ2_S: _d_iq2_s,
    GGMLType.IQ3_XXS: _d_iq3_xxs,
    GGMLType.IQ3_S: _d_iq3_s,
    GGMLType.IQ1_S: _d_iq1_s,
    GGMLType.IQ1_M: _d_iq1_m,
    GGMLType.TQ1_0: _d_tq1_0,
    GGMLType.TQ2_0: _d_tq2_0,
}
