"""Fused dequant-matmul: y[M, N] = x[M, K] @ dequant(W)[N, K]^T.

Counterpart of llama_cpp_test_tpu/ops/qmatmul.py. Weights stay in their
packed layout-'t' planes (quant/repack.py) of any kind: int8, u4 nibbles,
u2 crumbs, or 4-/2-bit codes into a LUT (u4lut, u2lut). On a CUDA tensor,
`qmm` / `qmm_split` launch kernel K1 (csrc/qmm.cu): a GEMV for M <= 8
(decode) and a pipelined wgmma GEMM above (prefill). Both read the packed
planes directly and fold the affine min as (per-group x-sums) @ min, as
the TPU kernel _qmm_t_kernel does (the GEMM on the tensor cores). With
the "cache" variant, a prefill whose shape the reference's strip-cached
kernel takes runs kernel K5 (csrc/qmm_cache.cu) instead: the same Hopper
main loop at 256-row tiles, so each dequantized weight tile serves 256
rows (all of them up to M = 256), as the reference's strip serves every
row tile.
On a CPU tensor they take the plain version, `qmm_plain`, which follows the
reference's XLA path (_dequant_t + _qmm_xla_t): dequantize to bf16, then a
float32-accumulated product. PLAIN_MIN says how the plain versions round a
weight with a min: jointly, bf16(s*q - m), as that XLA path does
("joint", the default), or as the TPU kernels and K1, K4 and K5 do
("fold": bf16(s*q), then the per-group x-sums . min subtracted in f32).

The variant comes from LLAMA_TPU_QMM_VARIANT, as in the reference, or from
`variant=`. "f32", "bf16" and "pipe" are TPU instruction schedules of one
function and all mean K1 here; "cache" means K5 where `cache_route` says
the reference takes its cache kernel, K1 elsewhere. Any other value raises.

Output column order: the planes produce [M, pack, NPK]; logical column
h*NPK + j is sub-value h of plane column j. qmm_split slices each fused
constituent out of the packed axis before the reshape.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import torch

from ..quant.repack import BITS, PACK, QTensor
from . import _cuda

_KIND_ID = {"int8": 0, "u4": 1, "u2": 2, "u4lut": 3, "u2lut": 4}
VARIANTS = ("f32", "bf16", "pipe", "cache")
QMM_VARIANT = os.environ.get("LLAMA_TPU_QMM_VARIANT", "f32")
PLAIN_MINS = ("joint", "fold")
PLAIN_MIN = "joint"


# The GEMV's launch plan (qmm_gemv.cuh). The kernel's consumer threads and
# the outputs each holds a row are fixed in C (GEMV_CONSUMERS, gemv_no:
# 8 in the kernels built for at most 2 rows, 4 above); everything else is
# chosen here, and the C entry points check what they are given
# (gemv_plan_ok) and take any plan that passes.
GEMV_CONSUMERS = 128
GEMV_MAX_SPLITS = 8          # CTAs of a cluster (the portable maximum)
GEMV_BLOCKS_PER_SM = 3       # blocks the plan aims at, per SM
GEMV_RING_BYTES = 48 << 10   # plane bytes a block keeps in flight
GEMV_X_BYTES = 32 << 10      # staged x a block holds at once
GEMV_DENSE_GROUP = 8         # a dense stack's split granule, in K rows
GEMV_MAX_STAGE_ROWS = 256    # rows of a stage's TMA box
GEMV_MMA_MIN_ROWS = 4        # rows from which the tensor-core path runs
                             # (3 or more: the kernels build it for blocks
                             # of 4 and 8 rows)


class GemvPlan(NamedTuple):
    col_blocks: int      # column tiles of npk
    splits: int          # K ranges, one CTA each, one cluster
    cluster: int         # CTAs a cluster (= splits)
    rows_per_split: int  # K rows a split, whole groups
    row_groups: int      # consumer groups a block, each its own stages
    stage_rows: int      # K rows a ring stage: a multiple or a divisor of
                         # the group
    stages: int          # ring stages a block
    x_rows: int          # x rows staged at once (whole stages)
    mma: int             # rows (of a block) from which the products run
                         # on mma.sync, 16-row K steps within a group (0:
                         # always on the FMA pipe)

    def args(self) -> tuple:
        """The plan as the C entry points take it (after the stream)."""
        return (self.col_blocks, self.splits, self.rows_per_split,
                self.row_groups, self.stage_rows, self.stages, self.x_rows,
                self.mma)


def _gemv_mt(m: int) -> int:
    """The GEMV's row instantiation for m rows: 1, 2, 4 or 8."""
    return 1 if m <= 1 else 2 if m <= 2 else 4 if m <= 4 else 8


def gemv_lane(kind: str, m: int) -> tuple[int, int]:
    """(packed columns, plane bytes) a GEMV consumer thread takes a K row
    in the kernel built for m rows (qmm_gemv.cuh gemv_lane_cols and
    gemv_lane_bytes)."""
    no = 8 if _gemv_mt(m) <= 2 else 4
    if kind == "dense":
        return no, 2 * no
    return no // PACK[kind], no // PACK[kind]


def gemv_plan(k: int, group: int, npk: int, kind: str, m: int, sms: int,
              tiles: int = 1, has_min: bool = False) -> GemvPlan:
    """Launch plan of the GEMV (K1's qmm_gemv, K4's gmm_gemv) for x [m, K]
    against planes [K, npk] of `kind` at `group` on a card of `sms` SMs;
    `tiles`: the row tiles that run side by side (K4's live tiles);
    `has_min`: the planes carry a min (its rows ride in the ring too).

    Of the column tiles (row_groups 1, 2, 4: 128, 64 or 32 threads across
    the tile), the one that reaches GEMV_BLOCKS_PER_SM blocks an SM with
    the fewest splits of K (at most GEMV_MAX_SPLITS), else the most blocks. Splits hold whole
    groups and none is empty. A stage holds about GEMV_RING_BYTES / 4 of
    plane, scale and min bytes (/ 8 at row_groups 4, whose four consumer
    groups each want two stages in flight), in rows that are a multiple of
    the group or a divisor of it, so a stage holds whole groups or a whole
    share of one; stages a multiple of the row groups. A dense stack
    splits at GEMV_DENSE_GROUP-row granules."""
    if kind == "dense":
        group = GEMV_DENSE_GROUP
    lane_cols, lane = gemv_lane(kind, m)
    groups = k // group
    want = GEMV_BLOCKS_PER_SM * sms
    options = []
    for rg in (1, 2, 4):
        ct = GEMV_CONSUMERS // rg
        nbx = -(-npk // (ct * lane_cols))
        splits = max(1, min(GEMV_MAX_SPLITS, groups,
                            -(-want // (nbx * tiles))))
        blocks = nbx * splits * tiles
        # reaching `want` first, then the fewest splits (each split is one
        # more CTA staging x and summing in the cluster), then the widest
        # tile; short of `want`, the most blocks
        key = (blocks < want, splits if blocks >= want else -blocks, rg)
        options.append((key, rg, ct, nbx, splits))
    _, rg, ct, nbx, splits = min(options)
    per = -(-groups // splits)
    splits = -(-groups // per)
    rows = per * group
    row_bytes = ct * lane
    # bytes a K row brings: its plane row, and its share of the group's
    # scale (and min) rows
    sc_row = 0 if kind == "dense" else \
        PACK[kind] * ct * lane_cols * 2 * (2 if has_min else 1)
    want = max(4, 2 * rg)
    target = max(8, GEMV_RING_BYTES * group // (want * (row_bytes * group
                                                      + sc_row)))
    target = min(target, GEMV_MAX_STAGE_ROWS)
    if group <= target:
        kt = group * (target // group)
    elif group <= min(4 * target, GEMV_MAX_STAGE_ROWS):
        kt = group
    else:
        kt = max(d for d in range(1, target + 1) if group % d == 0)
    kt = min(kt, rows)
    stage = kt * row_bytes + max(1, kt // group) * sc_row
    # two stages a row group where 1.5 rings allow it; a multiple of the
    # row groups (a slot serves one row group: its mbarrier's parity
    # wait cannot tell a phase two ahead), up to the next where 1.5 rings
    # allow it, else down, and at least one a row group
    cap = min(8, 3 * GEMV_RING_BYTES // 2 // stage)
    stages = max(2, min(cap, max(2 * rg, GEMV_RING_BYTES // stage)))
    stages = -(-stages // rg) * rg if -(-stages // rg) * rg <= cap \
        else max(rg, stages // rg * rg)
    chunk = max(kt, GEMV_X_BYTES // (2 * _gemv_mt(m)) // kt * kt)
    x_rows = min(-(-rows // kt) * kt, chunk)
    mma = GEMV_MMA_MIN_ROWS if (kind != "dense" and min(group, kt) % 16 == 0
                                and kt % 16 == 0) else 0
    return GemvPlan(nbx, splits, splits, rows, rg, kt, stages, x_rows, mma)


def _variant(variant: str | None) -> str:
    v = variant or QMM_VARIANT
    if v not in VARIANTS:
        raise ValueError(f"qmm variant {v!r}: expected one of {VARIANTS}")
    return v


def _tile_m_for(m: int) -> int:
    """The reference's row tile (qmatmul._tile_m_for)."""
    return 8 if m <= 8 else 64 if m <= 64 else 256


def cache_route(m: int, k: int, group: int, has_min: bool) -> bool:
    """Whether the reference's "cache" variant runs its strip-cached kernel
    for M = m rows (qmatmul.py:418-425, on M padded to its row tile as the
    reference pads it): more than one 128-row tile, K <= 4096, K % 512 == 0,
    and (K / group) % 128 == 0 when there is a min. Elsewhere it takes the
    streamed kernel, as the port takes K1."""
    tile_m = _tile_m_for(m)
    m_pad = -(-m // tile_m) * tile_m
    return (m_pad // min(tile_m, 128) > 1 and k <= 4096 and k % 512 == 0
            and (not has_min or (k // group) % 128 == 0))


def _unpack(q32: torch.Tensor, kind: str, h: int) -> torch.Tensor:
    if kind == "int8":
        return q32
    bits = BITS[kind]
    return (q32 >> (bits * h)) & ((1 << bits) - 1)


def _dequant_t(qs, scale, min_, lut, *, kind: str, group: int,
               dtype=torch.bfloat16) -> torch.Tensor:
    """Planes -> dense [K, N] (columns h-major: n = h*NPK + j)."""
    if kind == "dense":
        return qs.to(dtype)
    pack = {"int8": 1, "u4": 2, "u2": 4, "u4lut": 2, "u2lut": 4}[kind]
    q32 = qs.to(torch.int32)
    q = torch.cat([_unpack(q32, kind, h) for h in range(pack)], dim=1)
    qf = lut.float()[q.long()] if kind in ("u4lut", "u2lut") else q.float()
    s = torch.cat([scale[h] for h in range(pack)], dim=-1)
    w = qf * torch.repeat_interleave(s.float(), group, dim=0)
    if min_ is not None:
        m = torch.cat([min_[h] for h in range(pack)], dim=-1)
        w = w - torch.repeat_interleave(m.float(), group, dim=0)
    return w.to(dtype)


def dequantize(qt: QTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Layout-'t' planes -> dense [K, N_padded]."""
    assert qt.layout == "t", "dequantize expects layout 't'"
    return _dequant_t(qt.qs, qt.scale, qt.min_, qt.lut, kind=qt.kind,
                      group=qt.group, dtype=dtype)


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 operands, float32 accumulation (XLA's preferred_element_type)."""
    return torch.matmul(x.to(torch.bfloat16).float(), w.float())


def _plain_product(x, qs, scale, min_, lut, *, kind: str, group: int,
                   rounding: str | None = None) -> torch.Tensor:
    """x [..., K] @ dequant(planes) in float32 (columns h-major), a min
    rounded as `rounding` says (None reads PLAIN_MIN)."""
    rounding = rounding or PLAIN_MIN
    if rounding not in PLAIN_MINS:
        raise ValueError(f"plain min rounding {rounding!r}: expected one of "
                         f"{PLAIN_MINS}")
    fold = min_ is not None and rounding == "fold"
    w = _dequant_t(qs, scale, None if fold else min_, lut, kind=kind,
                   group=group)
    y = _matmul_f32(x, w)
    if fold:
        xb = x.to(torch.bfloat16).float()
        xsum = xb.reshape(*xb.shape[:-1], -1, group).sum(-1)   # [..., K/group]
        y = y - xsum @ torch.cat(list(min_), dim=-1).float()
    return y


def plain_planes(x: torch.Tensor, qt: QTensor,
                 rounding: str | None = None) -> torch.Tensor:
    """Plain x [..., K] @ dequant(qt) -> [..., pack * NPK] float32."""
    assert qt.layout == "t", "plain_planes expects layout 't'"
    return _plain_product(x, qt.qs, qt.scale, qt.min_, qt.lut, kind=qt.kind,
                          group=qt.group, rounding=rounding)


def qmm_plain(x: torch.Tensor, qt: QTensor,
              out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of K1: x [..., K] -> [..., n_orig]."""
    return plain_planes(x, qt)[..., : qt.n_orig].to(out_dtype)


def _check_operands(x2: torch.Tensor, qt: QTensor, name: str) -> None:
    """Raise unless x2 and the planes are what K1 and K5 take."""
    kind = qt.kind
    if kind not in _KIND_ID:
        raise NotImplementedError(f"{name}: plane kind {kind!r} has no kernel")
    m, k = x2.shape
    npk = qt.npk
    req = _cuda.require
    req(x2.is_cuda and x2.dtype == torch.bfloat16 and x2.is_contiguous(),
        f"{name}: x must be a contiguous CUDA bf16 tensor")
    req(qt.qs.device == x2.device and tuple(qt.qs.shape) == (k, npk)
        and qt.qs.dtype == (torch.int8 if kind == "int8" else torch.uint8)
        and qt.qs.is_contiguous(),
        f"{name}: bad qs plane {tuple(qt.qs.shape)} {qt.qs.dtype}")
    for label, p in (("scale", qt.scale), ("min", qt.min_)):
        if p is not None:
            req(p.device == x2.device and p.dtype == torch.bfloat16
                and tuple(p.shape) == (qt.pack, k // qt.group, npk)
                and p.is_contiguous(),
                f"{name}: bad {label} plane {tuple(p.shape)} {p.dtype}")
    check_lut(qt, x2.device, name)
    req(k % qt.group == 0 and npk % 128 == 0 and k % 32 == 0,
        f"{name}: unsupported shape K={k} NPK={npk} group={qt.group}")


def check_lut(qt: QTensor, device: torch.device, name: str) -> None:
    """Raise unless a LUT kind's planes carry their f32 LUT on device and
    no min (kernels K1, K4 and K5 take it so)."""
    if qt.kind in ("u4lut", "u2lut"):
        lut = qt.lut
        _cuda.require(lut is not None and lut.device == device
                      and lut.dtype == torch.float32 and lut.is_contiguous()
                      and tuple(lut.shape) == (1 << BITS[qt.kind],),
                      f"{name}: {qt.kind} needs its f32 LUT on the device")
        _cuda.require(qt.min_ is None,
                      f"{name}: {qt.kind} planes carry no min")


def lut_ptr(qt: QTensor) -> int:
    """The LUT's device pointer for a LUT kind, else 0 (null)."""
    return qt.lut.data_ptr() if qt.kind in ("u4lut", "u2lut") else 0


def _check_tile_group(qt: QTensor, name: str) -> None:
    """Raise unless the prefill main loop (K1's GEMM, K5) takes the group:
    a multiple of 8, and with a min 8, 16, 32 or 64."""
    _cuda.require(qt.group % 8 == 0 and (
        qt.min_ is None or 64 % qt.group == 0),
                  f"{name}: group {qt.group} (it takes a multiple of 8; "
                  "with a min 8, 16, 32 or 64)")


def _qmm_planes_cuda(x2: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """K1 launch: [M, K] bf16 x planes -> [M, pack, NPK] float32."""
    _check_operands(x2, qt, "qmm")
    m, k = x2.shape
    if m > 8:
        _check_tile_group(qt, "qmm_gemm")
    out = torch.empty((m, qt.pack, qt.npk), dtype=torch.float32,
                      device=x2.device)
    if m == 0:
        return out
    args = (x2.data_ptr(), m, k, qt.qs.data_ptr(), qt.npk, _KIND_ID[qt.kind],
            qt.scale.data_ptr(),
            0 if qt.min_ is None else qt.min_.data_ptr(), lut_ptr(qt),
            qt.group, out.data_ptr(), _cuda.stream_ptr(x2.device))
    if m <= 8:
        name, fn = "qmm_gemv", _cuda.bind("qmm", "qmm_gemv", "piipiipppipp"
                                          "iiiiiiii")
        args += gemv_plan(k, qt.group, qt.npk, qt.kind, m,
                          _cuda.sm_count(x2.device),
                          has_min=qt.min_ is not None).args()
    else:
        name, fn = "qmm_gemm", _cuda.bind("qmm", "qmm_gemm", "piipiipppipp")
    _cuda.check(fn(*args), name)
    _cuda.LAUNCHES[name] += 1
    return out


def _qmm_cache_cuda(x2: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """K5 launch: [M, K] bf16 x planes -> [M, pack, NPK] float32. The
    kernel sums x's groups for the min itself."""
    _check_operands(x2, qt, "qmm_cache")
    m, k = x2.shape
    _cuda.require(0 < m and k <= 4096 and k % 128 == 0,
                  f"qmm_cache: unsupported M={m} K={k} (K <= 4096, K % 128 "
                  "== 0)")
    _check_tile_group(qt, "qmm_cache")
    out = torch.empty((m, qt.pack, qt.npk), dtype=torch.float32,
                      device=x2.device)
    fn = _cuda.bind("qmm_cache", "qmm_cache", "piipiipppipp")
    _cuda.check(fn(x2.data_ptr(), m, k, qt.qs.data_ptr(), qt.npk,
                   _KIND_ID[qt.kind], qt.scale.data_ptr(),
                   0 if qt.min_ is None else qt.min_.data_ptr(), lut_ptr(qt),
                   qt.group, out.data_ptr(), _cuda.stream_ptr(x2.device)),
                "qmm_cache")
    _cuda.LAUNCHES["qmm_cache"] += 1
    return out


def _planes(x2: torch.Tensor, qt: QTensor,
            variant: str | None = None) -> torch.Tensor:
    """[M, K] -> [M, pack, NPK] float32: by K1, or K5 on the cache route,
    on CUDA; plainly on the CPU."""
    variant = _variant(variant)
    if x2.device.type == "cpu":
        return plain_planes(x2, qt).reshape(x2.shape[0], qt.pack, qt.npk)
    x2 = x2.to(torch.bfloat16).contiguous()
    m, k = x2.shape
    if variant == "cache" and cache_route(m, k, qt.group, qt.min_ is not None):
        return _qmm_cache_cuda(x2, qt)
    return _qmm_planes_cuda(x2, qt)


def qmm(x: torch.Tensor, qt: QTensor, out_dtype=torch.float32,
        variant: str | None = None) -> torch.Tensor:
    """Fused dequant-matmul. x: [..., K]; returns [..., n_orig]. variant
    None reads QMM_VARIANT."""
    assert qt.layout == "t", "qmm expects layout 't' (matmul planes)"
    if qt.kind == "dense":
        # a plain product outside any kernel, as the reference leaves it
        return qmm_plain(x, qt, out_dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    y = _planes(x2, qt, variant).reshape(x2.shape[0], -1)[:, : qt.n_orig]
    return y.reshape(*lead, qt.n_orig).to(out_dtype)


def _split(y3: torch.Tensor, qt: QTensor, lead, out_dtype):
    m = y3.shape[0]
    outs, off = [], 0
    for npk_i, n_orig_i in qt.parts:
        yi = y3[:, :, off:off + npk_i].reshape(m, qt.pack * npk_i)
        outs.append(yi[:, :n_orig_i].reshape(*lead, n_orig_i).to(out_dtype))
        off += npk_i
    return outs


def qmm_split(x: torch.Tensor, qt: QTensor,
              out_dtype=torch.float32) -> list[torch.Tensor]:
    """Fused-projection matmul: one pass over a fuse_qtensors plane, sliced
    back into per-constituent outputs [..., n_orig_i], at QMM_VARIANT."""
    assert qt.parts is not None, "qmm_split needs a fused QTensor"
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if qt.kind == "dense":
        y3 = qmm_plain(x2, qt).reshape(x2.shape[0], 1, -1)
    else:
        y3 = _planes(x2, qt)
    return _split(y3, qt, lead, out_dtype)


def qmm_split_plain(x: torch.Tensor, qt: QTensor,
                    out_dtype=torch.float32) -> list[torch.Tensor]:
    """Plain version of qmm_split, on any device."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    y = plain_planes(x2, qt)
    return _split(y.reshape(x2.shape[0], qt.pack, qt.npk), qt, lead, out_dtype)


def qgather(ids: torch.Tensor, qt: QTensor,
            dtype=torch.bfloat16) -> torch.Tensor:
    """Dequantize gathered rows of a layout-'rows' table: ids [...] ->
    [..., K]. Row j of the logical weight lives in plane row j % npk at
    sub-value j // npk."""
    assert qt.layout == "rows", "qgather expects layout 'rows'"
    if qt.kind == "dense":
        return qt.qs[ids].to(dtype)
    npk = qt.qs.shape[0]
    ids = ids.long()
    sub = ids // npk
    row = ids % npk
    q = qt.qs[row].to(torch.int32)
    if qt.kind != "int8":
        bits = BITS[qt.kind]
        q = (q >> (bits * sub)[..., None]) & ((1 << bits) - 1)
    qf = qt.lut.float()[q.long()] if qt.kind in ("u4lut", "u2lut") \
        else q.float()
    s = torch.repeat_interleave(qt.scale.float()[sub, :, row], qt.group, dim=-1)
    w = s * qf
    if qt.min_ is not None:
        w = w - torch.repeat_interleave(qt.min_.float()[sub, :, row],
                                        qt.group, dim=-1)
    return w.to(dtype)
