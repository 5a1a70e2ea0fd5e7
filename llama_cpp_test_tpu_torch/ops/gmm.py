"""Grouped (ragged) quantized matmul over stacked expert planes: the MoE
FFN's MUL_MAT_ID.

Counterpart of llama_cpp_test_tpu/ops/gmm.py:

  1. `route_tokens` (torch ops): flatten the [M, top_k] routing
     assignments, stable-sort them by expert and pack each expert's rows
     into a tile_m-aligned segment of a scratch batch. Tile t belongs to
     one expert, tile_expert[t]; dead tail tiles are clamped to the last
     live expert. Every shape is static (num_tiles fixes Rp) and nothing
     is read back to the host.
  2. `gmm_apply` / `gmm_apply_split`: on a CUDA tensor, kernel K4
     (csrc/gmm.cu): `gmm_gemv` for tile_m 8 (decode), `gmm_gemm` for
     tile_m 64 (prefill). Each block reads its tile's expert id on the
     device and offsets the stacked planes by it, so a decode step reads
     only the routed experts. On a CPU tensor, or with plain=True, the
     plain version: dequantize each routed expert once and multiply its
     rows.
  3. `combine` (torch ops): weighted index_add_ of scratch rows back to
     their tokens (padding rows carry weight 0).

The kernel and the plain version both leave zeros in the scratch rows
that carry no assignment. The reference computes those rows from token 0
and weights them by 0; the combined result is the same.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..quant.repack import QTensor
from . import _cuda
from .qmatmul import _KIND_ID, _dequant_t, _matmul_f32, _split

TILE_GEMV = 8    # tile_m of the decode regime (R = M * top_k <= 256)
TILE_GEMM = 64   # tile_m of the prefill regime


class Routing(NamedTuple):
    """Static-shape routing plan for one MoE dispatch (device tensors)."""
    tok_idx: torch.Tensor      # [Rp] int32 source token per scratch row (pad: 0)
    weight: torch.Tensor       # [Rp] f32 combine weight (pad rows: 0)
    tile_expert: torch.Tensor  # [T] int32 local expert id per row tile
    tile_rows: torch.Tensor    # [T] int32 live rows per tile (dead tiles: 0)


def num_tiles(m: int, top_k: int, n_expert_local: int, tile_m: int) -> int:
    """Static row-tile budget: sum_e ceil(c_e/tile_m) <= R//tile_m + #experts
    with nonzero load (<= min(E_local, R))."""
    r = m * top_k
    return r // tile_m + min(n_expert_local, r) + (1 if r % tile_m else 0)


def route_tokens(topi: torch.Tensor, topv: torch.Tensor, *,
                 n_expert_local: int, expert_offset: int = 0,
                 tile_m: int) -> Routing:
    """Build the scratch-batch routing plan.

    topi/topv: [M, top_k] global expert ids / combine weights. Assignments
    outside [expert_offset, expert_offset + n_expert_local) are dropped
    (another shard computes them)."""
    m, ku = topi.shape
    r = m * ku
    e_loc = n_expert_local
    dev = topi.device
    fl_t = torch.arange(m, dtype=torch.int32, device=dev).repeat_interleave(ku)
    loc = topi.reshape(r).long() - expert_offset
    valid = (loc >= 0) & (loc < e_loc)
    # sort key: local expert id, invalid assignments pushed past every segment
    key = torch.where(valid, loc, torch.full_like(loc, e_loc))
    order = torch.argsort(key, stable=True)
    se = key[order]
    st = fl_t[order]
    sw = torch.where(valid, topv.reshape(r).float(),
                     torch.zeros((), device=dev))[order]
    counts = torch.bincount(key, minlength=e_loc + 1)[:e_loc]
    padded = (counts + tile_m - 1) // tile_m * tile_m
    seg_end = torch.cumsum(padded, 0)
    seg_start = seg_end - padded
    csum = torch.cumsum(counts, 0) - counts
    t_total = num_tiles(m, ku, e_loc, tile_m)
    rp = t_total * tile_m
    se_c = se.clamp(max=e_loc - 1)
    rank = torch.arange(r, device=dev) - csum[se_c]
    # dead assignments go to row rp of an rp + 1 buffer, sliced away (the
    # reference drops them with mode="drop"; torch refuses the index)
    dst = torch.where(se < e_loc, seg_start[se_c] + rank,
                      torch.full_like(se, rp))
    tok_idx = torch.zeros(rp + 1, dtype=torch.int32, device=dev) \
        .scatter_(0, dst, st)[:rp]
    weight = torch.zeros(rp + 1, dtype=torch.float32, device=dev) \
        .scatter_(0, dst, sw)[:rp]
    # tile -> local expert; dead tail tiles clamp to the last live tile's
    # expert
    tile_start = torch.arange(t_total, device=dev) * tile_m
    te = torch.searchsorted(seg_end, tile_start, right=True)
    live = tile_start < seg_end[-1]
    last = (live.sum() - 1).clamp(min=0)
    te = torch.where(live, te.clamp(max=e_loc - 1), te[last])
    rows = (seg_start[te] + counts[te] - tile_start).clamp(0, tile_m)
    rows = torch.where(live, rows, torch.zeros_like(rows))
    return Routing(tok_idx, weight, te.to(torch.int32), rows.to(torch.int32))


def combine(y: torch.Tensor, routing: Routing, m: int) -> torch.Tensor:
    """Scatter-add scratch rows back to tokens: [Rp, N] -> [M, N] f32."""
    contrib = y.float() * routing.weight[:, None]
    out = torch.zeros((m, y.shape[1]), dtype=torch.float32, device=y.device)
    return out.index_add_(0, routing.tok_idx.long(), contrib)


def _expert(a, e: int):
    return None if a is None else a[e]


def _planes_plain(xs: torch.Tensor, qt: QTensor, routing: Routing,
                  tile_m: int) -> torch.Tensor:
    """Plain version of K4: [Rp, K] -> [Rp, pack, NPK] f32. Each routed
    expert is dequantized once (per expert, never per row) and multiplies
    its live rows; rows without an assignment stay zero."""
    rp = xs.shape[0]
    y = torch.zeros((rp, qt.pack * qt.npk), dtype=torch.float32,
                    device=xs.device)
    rows_of: dict[int, list[torch.Tensor]] = {}
    for t, (e, n) in enumerate(zip(routing.tile_expert.tolist(),
                                   routing.tile_rows.tolist())):
        if n > 0:
            rows_of.setdefault(e, []).append(
                torch.arange(t * tile_m, t * tile_m + n, device=xs.device))
    for e, idx in rows_of.items():
        idx = torch.cat(idx)
        w = _dequant_t(qt.qs[e], _expert(qt.scale, e), _expert(qt.min_, e),
                       qt.lut, kind=qt.kind, group=qt.group)
        y[idx] = _matmul_f32(xs[idx], w)
    return y.reshape(rp, qt.pack, qt.npk)


def _planes_cuda(xs: torch.Tensor, qt: QTensor, routing: Routing,
                 tile_m: int) -> torch.Tensor:
    """K4 launch: [Rp, K] bf16 -> [Rp, pack, NPK] f32."""
    kind = qt.kind
    if kind not in ("int8", "u4"):
        raise NotImplementedError(
            f"gmm kind {kind!r} on CUDA: the port's kernel covers int8 and "
            "u4 planes (u2/u4lut/u2lut are listed in ROADMAP.md)")
    req = _cuda.require
    req(tile_m in (TILE_GEMV, TILE_GEMM),
        f"gmm: tile_m {tile_m} (the kernel takes {TILE_GEMV} or {TILE_GEMM})")
    rp, k = xs.shape
    t = rp // tile_m
    e, npk = qt.qs.shape[0], qt.npk
    req(xs.is_cuda and xs.dtype == torch.bfloat16 and xs.is_contiguous()
        and rp == t * tile_m, "gmm: xs must be contiguous CUDA bf16 [T*tile_m, K]")
    req(qt.qs.device == xs.device and tuple(qt.qs.shape) == (e, k, npk)
        and qt.qs.dtype == (torch.int8 if kind == "int8" else torch.uint8)
        and qt.qs.is_contiguous(),
        f"gmm: bad qs planes {tuple(qt.qs.shape)} {qt.qs.dtype}")
    for name, p in (("scale", qt.scale), ("min", qt.min_)):
        if p is not None:
            req(p.device == xs.device and p.dtype == torch.bfloat16
                and tuple(p.shape) == (e, qt.pack, k // qt.group, npk)
                and p.is_contiguous(),
                f"gmm: bad {name} planes {tuple(p.shape)} {p.dtype}")
    for name, a in (("tile_expert", routing.tile_expert),
                    ("tile_rows", routing.tile_rows)):
        req(a.device == xs.device and a.dtype == torch.int32
            and a.is_contiguous() and tuple(a.shape) == (t,),
            f"gmm: {name} must be contiguous int32 [{t}] on the device")
    if tile_m == TILE_GEMV:
        req(k % qt.group == 0 and npk % 128 == 0,
            f"gmm_gemv: unsupported K={k} NPK={npk} group={qt.group}")
        name = "gmm_gemv"
    else:
        req(k % 32 == 0 and 32 % qt.group == 0
            and npk % (128 // qt.pack) == 0,
            f"gmm_gemm: unsupported K={k} NPK={npk} group={qt.group}")
        name = "gmm_gemm"
    out = torch.empty((rp, qt.pack, npk), dtype=torch.float32, device=xs.device)
    fn = _cuda.bind("gmm", name, "piipiippippipp")
    rc = fn(xs.data_ptr(), t, k, qt.qs.data_ptr(), npk, _KIND_ID[kind],
            qt.scale.data_ptr(), 0 if qt.min_ is None else qt.min_.data_ptr(),
            qt.group, routing.tile_expert.data_ptr(),
            routing.tile_rows.data_ptr(), e, out.data_ptr(),
            _cuda.stream_ptr(xs.device))
    _cuda.check(rc, name)
    _cuda.LAUNCHES[name] += 1
    return out


def _planes(xs, qt, routing, tile_m, plain):
    if plain or xs.device.type == "cpu":
        return _planes_plain(xs, qt, routing, tile_m)
    return _planes_cuda(xs.to(torch.bfloat16).contiguous(), qt, routing,
                        tile_m)


def gmm_apply(xs: torch.Tensor, qt: QTensor, routing: Routing, tile_m: int,
              plain: bool = False) -> torch.Tensor:
    """Scratch-row grouped matmul: xs [Rp, K] already-gathered rows, row
    tile t against expert routing.tile_expert[t]. Returns [Rp, n_orig] f32,
    still in scratch-row order, so gate -> act -> down stay in scratch
    space and pay the gather and the scatter once per MoE block."""
    y3 = _planes(xs, qt, routing, tile_m, plain)
    return y3.reshape(y3.shape[0], -1)[:, : qt.n_orig]


def gmm_apply_split(xs: torch.Tensor, qt: QTensor, routing: Routing,
                    tile_m: int, plain: bool = False) -> list[torch.Tensor]:
    """gmm_apply over a fuse_expert_qtensors plane: one grouped pass for
    gate|up, sliced back into per-constituent [Rp, n_orig_i] outputs."""
    assert qt.parts is not None, "gmm_apply_split needs a fused QTensor"
    y3 = _planes(xs, qt, routing, tile_m, plain)
    return _split(y3, qt, (y3.shape[0],), torch.float32)


def gmm(x: torch.Tensor, qt: QTensor, routing: Routing, *,
        tile_m: int) -> torch.Tensor:
    """Grouped matmul: x [M, K] tokens, qt stacked expert planes, routing
    from route_tokens. Returns combined [M, n_orig] f32."""
    y = gmm_apply(x[routing.tok_idx.long()], qt, routing, tile_m)
    return combine(y, routing, x.shape[0])


def gmm_plain(x: torch.Tensor, qt: QTensor, routing: Routing, *,
              tile_m: int) -> torch.Tensor:
    """Plain version of `gmm`, on any device."""
    y = gmm_apply(x[routing.tok_idx.long()], qt, routing, tile_m, plain=True)
    return combine(y, routing, x.shape[0])
