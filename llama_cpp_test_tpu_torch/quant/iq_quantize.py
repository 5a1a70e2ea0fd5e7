"""Encoders of the codebook i-quants: IQ2_XXS, IQ2_XS, IQ2_S, IQ3_XXS,
IQ3_S, IQ1_S and IQ1_M.

Counterpart of llama_cpp_test_tpu/quant/iq_quantize.py, step for step,
so the bytes are the same. Every 8- (or 4-) value sub-block is scored
against the whole codebook with one weighted-distance matrix product
(the grids hold 256-2048 entries); scales alternate with the code choice
for a few least-squares refits, then fold into the format's packed
layout, the inverse of codecs.py's decoders.

Signs of iq2/iq3 follow the ksigns convention: a 7-bit field whose 8th
bit is its parity; where x's sign pattern has the wrong parity, the lane
of the least weighted magnitude flips.

qw, where given, is the importance of each value (an imatrix row) and
weights the distance; without it every value weighs 1.
"""
from __future__ import annotations

import numpy as np

from ..gguf.constants import GGMLType
from .codecs import IQ1_DELTA, _f16b, _iq_grids


def _parity_fix_signs(x: np.ndarray, w: np.ndarray):
    """x [n, 8] signed -> (absx, sign7 [n] uint8, sgn [n, 8] +-1).

    ksigns encodes 7 sign bits; bit j set => lane j negative; lane 7's sign
    is the parity of bits 0..6. If x's negativity pattern disagrees, flip
    the least-important lane."""
    neg = (x < 0)
    absx = np.abs(x)
    # the decoder takes lane 7's sign from the parity of lanes 0..6
    want = neg[:, :7].sum(axis=1) % 2
    bad = neg[:, 7] != want.astype(bool)
    imp = w * absx
    flip = np.argmin(imp, axis=1)
    rows = np.nonzero(bad)[0]
    neg[rows, flip[rows]] = ~neg[rows, flip[rows]]
    sign7 = np.zeros(len(x), np.uint8)
    for j in range(7):
        sign7 |= neg[:, j].astype(np.uint8) << j
    sgn = np.where(neg, -1.0, 1.0)
    return absx, sign7, sgn


def _best_codes(absx: np.ndarray, w: np.ndarray, grid: np.ndarray,
                s: np.ndarray) -> np.ndarray:
    """absx [n, L], w [n, L], grid [G, L] magnitudes, s [n] scales ->
    argmin_g sum_j w (absx - s*grid_g)^2  ->  [n] indices."""
    g = grid.astype(np.float64)                       # [G, L]
    # dist = const - 2 s (w*absx)@g.T + s^2 w@(g^2).T
    a = (w * absx) @ g.T                              # [n, G]
    b = w @ (g * g).T                                 # [n, G]
    d = -2.0 * s[:, None] * a + (s * s)[:, None] * b
    return np.argmin(d, axis=1)


def _refit_scale(absx, w, gv, lo=1e-8):
    """Least-squares per-row scale: sum w absx g / sum w g^2."""
    num = (w * absx * gv).sum(axis=1)
    den = (w * gv * gv).sum(axis=1)
    return np.where(den > lo, num / np.maximum(den, lo), 0.0)


def _prep(x: np.ndarray, qw):
    x = x.astype(np.float64)
    if qw is None:
        return x, np.ones_like(x)
    w = np.asarray(qw, np.float64)
    if w.shape != x.shape:
        w = np.broadcast_to(w.reshape(1, -1), x.shape).copy()
    else:
        w = w.copy()
    return x, w


def quantize_iq2_xxs(x: np.ndarray, qw=None) -> np.ndarray:
    """x [nb, 256] -> packed block_iq2_xxs bytes [nb, 66]."""
    grid = _iq_grids()["iq2xxs"].astype(np.float64)   # [256, 8]
    x, w = _prep(x, qw)
    nb = x.shape[0]
    x8 = x.reshape(nb * 32, 8)
    w8 = w.reshape(nb * 32, 8)
    absx, sign7, _ = _parity_fix_signs(x8, w8)
    # per-32 scale groups: [nb*8, 32]
    absg = absx.reshape(nb * 8, 32)
    wg = w8.reshape(nb * 8, 32)
    s = absg.max(axis=1) / 43.0
    codes = None
    for _ in range(3):
        codes = _best_codes(absx, w8, grid,
                            np.repeat(s, 4))          # per 8-blk
        gv = grid[codes].reshape(nb * 8, 32)
        s = _refit_scale(absg, wg, gv)
    # d per 256-block from the 8 group scales: s_g = d*(0.5+ls)/4, ls<=15
    sg = s.reshape(nb, 8)
    d = sg.max(axis=1) * 4.0 / 15.5
    d = np.maximum(d, 1e-12)
    ls = np.clip(np.round(4.0 * sg / d[:, None] - 0.5), 0, 15) \
        .astype(np.uint32)
    # final code pass with the quantized scales
    s_fin = (d[:, None] * (0.5 + ls) / 4.0).reshape(nb * 8)
    codes = _best_codes(absx, w8, grid, np.repeat(s_fin, 4)) \
        .astype(np.uint32).reshape(nb, 8, 4)
    sign7 = sign7.astype(np.uint32).reshape(nb, 8, 4)
    aux32 = (sign7[:, :, 0] | (sign7[:, :, 1] << 7) |
             (sign7[:, :, 2] << 14) | (sign7[:, :, 3] << 21) | (ls << 28))
    out = np.zeros((nb, 66), np.uint8)
    out[:, 0:2] = _f16b(d.astype(np.float32))
    q16 = np.zeros((nb, 8, 4), np.uint16)
    q16[:, :, 0] = (codes[:, :, 0] | (codes[:, :, 1] << 8)).astype(np.uint16)
    q16[:, :, 1] = (codes[:, :, 2] | (codes[:, :, 3] << 8)).astype(np.uint16)
    q16[:, :, 2] = (aux32 & 0xFFFF).astype(np.uint16)
    q16[:, :, 3] = (aux32 >> 16).astype(np.uint16)
    out[:, 2:66] = q16.reshape(nb, 32).view(np.uint8)
    return out


def quantize_iq2_xs(x: np.ndarray, qw=None) -> np.ndarray:
    """x [nb, 256] -> packed block_iq2_xs bytes [nb, 74]."""
    grid = _iq_grids()["iq2xs"].astype(np.float64)    # [512, 8]
    x, w = _prep(x, qw)
    nb = x.shape[0]
    x8 = x.reshape(nb * 32, 8)
    w8 = w.reshape(nb * 32, 8)
    absx, sign7, _ = _parity_fix_signs(x8, w8)
    absg = absx.reshape(nb * 16, 16)                  # scale per 16
    wg = w8.reshape(nb * 16, 16)
    s = absg.max(axis=1) / 43.0
    for _ in range(3):
        codes = _best_codes(absx, w8, grid, np.repeat(s, 2))
        gv = grid[codes].reshape(nb * 16, 16)
        s = _refit_scale(absg, wg, gv)
    sg = s.reshape(nb, 16)
    d = sg.max(axis=1) * 4.0 / 15.5
    d = np.maximum(d, 1e-12)
    ls = np.clip(np.round(4.0 * sg / d[:, None] - 0.5), 0, 15) \
        .astype(np.uint8)
    s_fin = (d[:, None] * (0.5 + ls) / 4.0).reshape(nb * 16)
    codes = _best_codes(absx, w8, grid, np.repeat(s_fin, 2)) \
        .astype(np.uint16).reshape(nb, 32)
    q16 = codes | (sign7.astype(np.uint16).reshape(nb, 32) << 9)
    out = np.zeros((nb, 74), np.uint8)
    out[:, 0:2] = _f16b(d.astype(np.float32))
    out[:, 2:66] = q16.view(np.uint8)
    out[:, 66:74] = (ls[:, 0::2] | (ls[:, 1::2] << 4))
    return out


def quantize_iq3_xxs(x: np.ndarray, qw=None) -> np.ndarray:
    """x [nb, 256] -> packed block_iq3_xxs bytes [nb, 98]."""
    grid = _iq_grids()["iq3xxs"].astype(np.float64)   # [256, 4]
    x, w = _prep(x, qw)
    nb = x.shape[0]
    x8 = x.reshape(nb * 32, 8)
    w8 = w.reshape(nb * 32, 8)
    _, sign7, _ = _parity_fix_signs(x8, w8)
    absx4 = np.abs(x).reshape(nb * 64, 4)
    w4 = w.reshape(nb * 64, 4)
    absg = np.abs(x).reshape(nb * 8, 32)              # scale per 32
    wg = w.reshape(nb * 8, 32)
    s = absg.max(axis=1) / 62.0
    for _ in range(3):
        codes = _best_codes(absx4, w4, grid, np.repeat(s, 8))
        gv = grid[codes].reshape(nb * 8, 32)
        s = _refit_scale(absg, wg, gv)
    sg = s.reshape(nb, 8)
    d = sg.max(axis=1) * 2.0 / 15.5                   # s = d*(0.5+ls)*0.5
    d = np.maximum(d, 1e-12)
    ls = np.clip(np.round(2.0 * sg / d[:, None] - 0.5), 0, 15) \
        .astype(np.uint32)
    s_fin = (d[:, None] * (0.5 + ls) * 0.5).reshape(nb * 8)
    codes = _best_codes(absx4, w4, grid, np.repeat(s_fin, 8)) \
        .astype(np.uint8).reshape(nb, 64)
    sign7 = sign7.astype(np.uint32).reshape(nb, 8, 4)
    aux32 = (sign7[:, :, 0] | (sign7[:, :, 1] << 7) |
             (sign7[:, :, 2] << 14) | (sign7[:, :, 3] << 21) | (ls << 28))
    out = np.zeros((nb, 98), np.uint8)
    out[:, 0:2] = _f16b(d.astype(np.float32))
    out[:, 2:66] = codes
    out[:, 66:98] = aux32.astype(np.uint32).reshape(nb, 8).view(np.uint8)
    return out


def quantize_iq1_s(x: np.ndarray, qw=None) -> np.ndarray:
    """x [nb, 256] -> packed block_iq1_s bytes [nb, 50].

    x ~ d*(2*ls+1)*(grid + delta), grid ternary [2048, 8], delta = +-0.125
    per 32-group, 3-bit ls per 32-group."""
    grid = _iq_grids()["iq1s"].astype(np.float64)     # [2048, 8] in -1/0/1
    x, w = _prep(x, qw)
    nb = x.shape[0]
    x8 = x.reshape(nb * 32, 8)                        # 4 per 32-group
    w8 = w.reshape(nb * 32, 8)
    xg = x.reshape(nb * 8, 32)
    wg = w.reshape(nb * 8, 32)
    best = None
    for dsign in (1.0, -1.0):
        delta = dsign * IQ1_DELTA
        s = np.abs(xg).max(axis=1) / (1.0 + IQ1_DELTA)
        for _ in range(3):
            gd = grid + delta                          # signed values
            # signed best-code: argmin sum w (x - s*gd)^2
            a = (w8 * x8) @ gd.T
            b = w8 @ (gd * gd).T
            srep = np.repeat(s, 4)
            dist = -2.0 * srep[:, None] * a + (srep ** 2)[:, None] * b
            codes = np.argmin(dist, axis=1)
            gv = gd[codes].reshape(nb * 8, 32)
            s = _refit_scale(xg, wg, gv)  # signed values: same LS form
        gv = gd[codes].reshape(nb * 8, 32)
        err = (wg * (xg - s[:, None] * gv) ** 2).sum(axis=1)
        pack = (codes.reshape(nb * 8, 4), s.copy(), err,
                np.full(nb * 8, dsign < 0))
        if best is None:
            best = pack
        else:
            take = err < best[2]
            best = (np.where(take[:, None], pack[0], best[0]),
                    np.where(take, pack[1], best[1]),
                    np.minimum(err, best[2]),
                    np.where(take, pack[3], best[3]))
    codes, s, _, negd = best
    sg = s.reshape(nb, 8)
    d = sg.max(axis=1) / 15.0                         # s = d*(2*ls+1), ls<=7
    d = np.maximum(d, 1e-12)
    ls = np.clip(np.round((sg / d[:, None] - 1.0) / 2.0), 0, 7) \
        .astype(np.uint16)
    codes = codes.reshape(nb, 8, 4).astype(np.uint16)
    negd = negd.reshape(nb, 8)
    out = np.zeros((nb, 50), np.uint8)
    out[:, 0:2] = _f16b(d.astype(np.float32))
    out[:, 2:34] = (codes & 0xFF).astype(np.uint8).reshape(nb, 32)
    hi = (codes >> 8).astype(np.uint16)               # 3 bits each
    qh = (hi[:, :, 0] | (hi[:, :, 1] << 3) | (hi[:, :, 2] << 6) |
          (hi[:, :, 3] << 9) | (ls << 12) |
          (negd.astype(np.uint16) << 15))
    out[:, 34:50] = qh.view(np.uint8)
    return out


def quantize_iq2_s(x: np.ndarray, qw=None) -> np.ndarray:
    """x [nb, 256] -> packed block_iq2_s bytes [nb, 82].

    Unlike xxs/xs this format stores FULL 8-bit sign bytes (no ksigns
    parity constraint), a 1024-entry grid with 2 high index bits packed
    separately, and 4-bit scales per 16."""
    grid = _iq_grids()["iq2s"].astype(np.float64)     # [1024, 8]
    x, w = _prep(x, qw)
    nb = x.shape[0]
    x8 = x.reshape(nb * 32, 8)
    w8 = w.reshape(nb * 32, 8)
    absx = np.abs(x8)
    neg = (x8 < 0)
    absg = absx.reshape(nb * 16, 16)
    wg = w8.reshape(nb * 16, 16)
    s = absg.max(axis=1) / 43.0
    for _ in range(3):
        codes = _best_codes(absx, w8, grid, np.repeat(s, 2))
        gv = grid[codes].reshape(nb * 16, 16)
        s = _refit_scale(absg, wg, gv)
    sg = s.reshape(nb, 16)
    d = np.maximum(sg.max(axis=1) * 4.0 / 15.5, 1e-12)
    ls = np.clip(np.round(4.0 * sg / d[:, None] - 0.5), 0, 15) \
        .astype(np.uint8)
    s_fin = (d[:, None] * (0.5 + ls) / 4.0).reshape(nb * 16)
    codes = _best_codes(absx, w8, grid, np.repeat(s_fin, 2)) \
        .astype(np.uint16).reshape(nb, 32)
    sign_b = np.zeros((nb * 32,), np.uint8)
    for j in range(8):
        sign_b |= neg[:, j].astype(np.uint8) << j
    sign_b = sign_b.reshape(nb, 32)
    out = np.zeros((nb, 82), np.uint8)
    out[:, 0:2] = _f16b(d.astype(np.float32))
    out[:, 2:34] = (codes & 0xFF).astype(np.uint8)
    out[:, 34:66] = sign_b
    hi = (codes >> 8).astype(np.uint8).reshape(nb, 8, 4)   # 2 bits each
    out[:, 66:74] = (hi[:, :, 0] | (hi[:, :, 1] << 2) |
                     (hi[:, :, 2] << 4) | (hi[:, :, 3] << 6))
    out[:, 74:82] = (ls[:, 0::2] | (ls[:, 1::2] << 4))
    return out


def quantize_iq3_s(x: np.ndarray, qw=None) -> np.ndarray:
    """x [nb, 256] -> packed block_iq3_s bytes [nb, 110].

    512-entry grid of 4 odd magnitudes, full sign bytes per 8 values,
    4-bit scales per 32 with db = d*(1 + 2*ls)."""
    grid = _iq_grids()["iq3s"].astype(np.float64)     # [512, 4]
    x, w = _prep(x, qw)
    nb = x.shape[0]
    absx4 = np.abs(x).reshape(nb * 64, 4)
    w4 = w.reshape(nb * 64, 4)
    neg = (x.reshape(nb * 32, 8) < 0)
    absg = np.abs(x).reshape(nb * 8, 32)
    wg = w.reshape(nb * 8, 32)
    s = absg.max(axis=1) / 15.0
    for _ in range(3):
        codes = _best_codes(absx4, w4, grid, np.repeat(s, 8))
        gv = grid[codes].reshape(nb * 8, 32)
        s = _refit_scale(absg, wg, gv)
    sg = s.reshape(nb, 8)
    d = np.maximum(sg.max(axis=1) / 31.0, 1e-12)      # s = d*(1+2*ls), ls<=15
    ls = np.clip(np.round((sg / d[:, None] - 1.0) / 2.0), 0, 15) \
        .astype(np.uint8)
    s_fin = (d[:, None] * (1.0 + 2.0 * ls)).reshape(nb * 8)
    codes = _best_codes(absx4, w4, grid, np.repeat(s_fin, 8)) \
        .astype(np.uint16).reshape(nb, 64)
    sign_b = np.zeros((nb * 32,), np.uint8)
    for j in range(8):
        sign_b |= neg[:, j].astype(np.uint8) << j
    out = np.zeros((nb, 110), np.uint8)
    out[:, 0:2] = _f16b(d.astype(np.float32))
    out[:, 2:66] = (codes & 0xFF).astype(np.uint8)
    hi = (codes >> 8).astype(np.uint8).reshape(nb, 8, 8)  # 1 bit each
    acc = np.zeros((nb, 8), np.uint8)
    for j in range(8):
        acc |= hi[:, :, j] << j
    out[:, 66:74] = acc
    out[:, 74:106] = sign_b.reshape(nb, 32)
    out[:, 106:110] = (ls[:, 0::2] | (ls[:, 1::2] << 4))
    return out


def quantize_iq1_m(x: np.ndarray, qw=None) -> np.ndarray:
    """x [nb, 256] -> packed block_iq1_m bytes [nb, 56].

    Ternary 2048-grid with per-8 delta sign, 3-bit scales per 16, and the
    fp16 super-scale smuggled through the top nibble of each of the four
    scale words (ggml-quants.c quantize_iq1_m / codecs.iq1_m_dequantize)."""
    grid = _iq_grids()["iq1s"].astype(np.float64)     # [2048, 8]
    x, w = _prep(x, qw)
    nb = x.shape[0]
    x8 = x.reshape(nb * 32, 8)
    w8 = w.reshape(nb * 32, 8)
    x16 = x.reshape(nb * 16, 16)
    w16 = w.reshape(nb * 16, 16)
    s = np.maximum(np.abs(x16).max(axis=1) / (1.0 + IQ1_DELTA), 1e-12)
    gd_pos = grid + IQ1_DELTA
    gd_neg = grid - IQ1_DELTA
    for _ in range(3):
        srep = np.repeat(s, 2)
        picks = []
        for gd in (gd_pos, gd_neg):
            a = (w8 * x8) @ gd.T
            b = w8 @ (gd * gd).T
            dist = -2.0 * srep[:, None] * a + (srep ** 2)[:, None] * b
            c = np.argmin(dist, axis=1)
            picks.append((c, dist[np.arange(len(c)), c]))
        negd = picks[1][1] < picks[0][1]
        codes = np.where(negd, picks[1][0], picks[0][0])
        gv = np.where(negd[:, None], gd_neg[codes], gd_pos[codes])
        s = _refit_scale(x16, w16, gv.reshape(nb * 16, 16))
        s = np.maximum(s, 1e-12)
    sg = s.reshape(nb, 16)
    d = np.maximum(sg.max(axis=1) / 15.0, 1e-12)      # dl = d*(2*ls+1), ls<=7
    # d is recovered from packed fp16 bits on decode: quantize it FIRST so
    # the ls fit uses the value the decoder will see
    d16 = d.astype(np.float16)
    d_bits = d16.view(np.uint16)
    dq = d16.astype(np.float64)
    ls = np.clip(np.round((sg / np.maximum(dq[:, None], 1e-12) - 1.0) / 2.0),
                 0, 7).astype(np.uint16)
    codes = codes.astype(np.uint16).reshape(nb, 32)
    negd = negd.reshape(nb, 32)
    out = np.zeros((nb, 56), np.uint8)
    out[:, 0:32] = (codes & 0xFF).astype(np.uint8)
    hi = (codes >> 8).astype(np.uint8)                # 3 bits per 8-blk
    nib = (hi | (negd.astype(np.uint8) << 3)).reshape(nb, 16, 2)
    out[:, 32:48] = nib[:, :, 0] | (nib[:, :, 1] << 4)
    sc = np.zeros((nb, 4), np.uint16)
    for sh in range(16):
        sc[:, sh // 4] |= (ls[:, sh] & 7) << (3 * (sh % 4))
    for i in range(4):
        sc[:, i] |= ((d_bits >> (4 * i)) & 0xF).astype(np.uint16) << 12
    out[:, 48:56] = sc.view(np.uint8)
    return out


IQ_QUANTIZERS = {
    GGMLType.IQ2_XXS: quantize_iq2_xxs,
    GGMLType.IQ2_XS: quantize_iq2_xs,
    GGMLType.IQ2_S: quantize_iq2_s,
    GGMLType.IQ3_XXS: quantize_iq3_xxs,
    GGMLType.IQ3_S: quantize_iq3_s,
    GGMLType.IQ1_S: quantize_iq1_s,
    GGMLType.IQ1_M: quantize_iq1_m,
}
