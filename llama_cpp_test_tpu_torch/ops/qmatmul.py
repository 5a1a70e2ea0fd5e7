"""Fused dequant-matmul: y[M, N] = x[M, K] @ dequant(W)[N, K]^T.

Counterpart of llama_cpp_test_tpu/ops/qmatmul.py. Weights stay in their
packed layout-'t' planes (quant/repack.py) of any kind: int8, u4 nibbles,
u2 crumbs, or 4-/2-bit codes into a LUT (u4lut, u2lut). On a CUDA tensor,
`qmm` / `qmm_split` launch kernel K1 (csrc/qmm.cu): a GEMV for M <= 8
(decode) and a tiled tensor-core GEMM above (prefill). Both read the packed
planes directly, expand the bf16 group scales in registers, and fold the
affine min as (per-group x-sums) @ min, as the TPU kernel _qmm_t_kernel
does. With the "cache" variant, a prefill whose shape the reference's
strip-cached kernel takes runs kernel K5 (csrc/qmm_cache.cu) instead:
each full-K weight strip is dequantized once and reused by every row tile.
On a CPU tensor they take the plain version, `qmm_plain`, which follows the
reference's XLA path (_dequant_t + _qmm_xla_t): dequantize to bf16, then a
float32-accumulated product.

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

import torch

from ..quant.repack import BITS, QTensor
from . import _cuda

_KIND_ID = {"int8": 0, "u4": 1, "u2": 2, "u4lut": 3, "u2lut": 4}
VARIANTS = ("f32", "bf16", "pipe", "cache")
QMM_VARIANT = os.environ.get("LLAMA_TPU_QMM_VARIANT", "f32")


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


def qmm_plain(x: torch.Tensor, qt: QTensor,
              out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of K1: x [..., K] -> [..., n_orig]."""
    y = _matmul_f32(x, dequantize(qt))
    return y[..., : qt.n_orig].to(out_dtype)


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
    if kind in ("u4lut", "u2lut"):
        lut = qt.lut
        req(lut is not None and lut.device == x2.device
            and lut.dtype == torch.float32 and lut.is_contiguous()
            and tuple(lut.shape) == (1 << BITS[kind],),
            f"{name}: {kind} needs its f32 LUT on the device")
        req(qt.min_ is None, f"{name}: {kind} planes carry no min")
    req(k % qt.group == 0 and npk % 128 == 0 and k % 32 == 0,
        f"{name}: unsupported shape K={k} NPK={npk} group={qt.group}")


def _lut_ptr(qt: QTensor) -> int:
    return qt.lut.data_ptr() if qt.kind in ("u4lut", "u2lut") else 0


def _qmm_planes_cuda(x2: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """K1 launch: [M, K] bf16 x planes -> [M, pack, NPK] float32."""
    _check_operands(x2, qt, "qmm")
    m, k = x2.shape
    _cuda.require(qt.min_ is None or 32 % qt.group == 0 or m <= 8,
                  f"qmm_gemm: a min with group {qt.group} (it takes 16, 32)")
    out = torch.empty((m, qt.pack, qt.npk), dtype=torch.float32,
                      device=x2.device)
    if m == 0:
        return out
    name = "qmm_gemv" if m <= 8 else "qmm_gemm"
    fn = _cuda.bind("qmm", name, "piipiipppipp")
    _cuda.check(fn(x2.data_ptr(), m, k, qt.qs.data_ptr(), qt.npk,
                   _KIND_ID[qt.kind], qt.scale.data_ptr(),
                   0 if qt.min_ is None else qt.min_.data_ptr(), _lut_ptr(qt),
                   qt.group, out.data_ptr(), _cuda.stream_ptr(x2.device)),
                name)
    _cuda.LAUNCHES[name] += 1
    return out


def _qmm_cache_cuda(x2: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """K5 launch: [M, K] bf16 x planes -> [M, pack, NPK] float32. The
    per-group x-sums the min folds with are a torch op here, as the
    reference computes them in XLA."""
    _check_operands(x2, qt, "qmm_cache")
    m, k = x2.shape
    _cuda.require(0 < m and k <= 4096 and k % 128 == 0,
                  f"qmm_cache: unsupported M={m} K={k} (K <= 4096, K % 128 "
                  "== 0)")
    xsum = None
    if qt.min_ is not None:
        xsum = x2.float().reshape(m, k // qt.group, qt.group).sum(-1)
    out = torch.empty((m, qt.pack, qt.npk), dtype=torch.float32,
                      device=x2.device)
    fn = _cuda.bind("qmm_cache", "qmm_cache", "piipiipppippp")
    _cuda.check(fn(x2.data_ptr(), m, k, qt.qs.data_ptr(), qt.npk,
                   _KIND_ID[qt.kind], qt.scale.data_ptr(),
                   0 if qt.min_ is None else qt.min_.data_ptr(), _lut_ptr(qt),
                   qt.group, 0 if xsum is None else xsum.data_ptr(),
                   out.data_ptr(), _cuda.stream_ptr(x2.device)), "qmm_cache")
    _cuda.LAUNCHES["qmm_cache"] += 1
    return out


def _planes(x2: torch.Tensor, qt: QTensor,
            variant: str | None = None) -> torch.Tensor:
    """[M, K] -> [M, pack, NPK] float32: by K1, or K5 on the cache route,
    on CUDA; plainly on the CPU."""
    variant = _variant(variant)
    if x2.device.type == "cpu":
        y = _matmul_f32(x2, dequantize(qt))
        return y.reshape(x2.shape[0], qt.pack, qt.npk)
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
    y = _matmul_f32(x2, dequantize(qt))
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
