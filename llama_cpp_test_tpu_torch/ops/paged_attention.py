"""Paged attention for decode: one query per sequence over block tables.

Counterpart of llama_cpp_test_tpu/ops/paged_attention.py, over bf16 pages
and over q8_0 pages (int8 with per-slot f32 scales). On a CUDA tensor,
`paged_attention_decode` launches kernel K3 (csrc/paged_attention.cu),
`paged_decode` or, given scales, `paged_decode_q8`: flash-decoding split
across blocks. `split_plan` cuts each sequence's block table into ranges
of pages; one block per (16 query heads of a kv head, sequence, range)
runs an online softmax on mma.sync over those heads and leaves a partial
(m, l, acc) in an f32 workspace, and a second kernel merges the partials.
On a CPU tensor it takes `paged_attention_decode_plain`.

Layouts:
  q:            [B, H, D] bf16, pre-scaled by 1/sqrt(D) upstream
  k/v_pages:    [KV, NB, BS, D] bf16, or int8 with
  k/v_scale:    [KV, NB, BS] f32 (q8_0 pools)
  lengths:      [B] int32 tokens in cache per sequence
  page_indices: [B, NBmax] int32 physical block ids
"""
from __future__ import annotations

import torch

from . import _cuda

# the head dims K3 and K3-q8 are built for (csrc/paged_attention.cu; 100
# runs padded to 112 inside the kernel); any other raises on CUDA
HEAD_DIMS = (64, 80, 96, 100, 128, 192, 256)

# The plan's caps live here only: the kernel takes any split it is given
# (it stages a range's page ids in shared memory, 4 bytes each, and its
# merge holds three floats a range).
MAX_SPLITS = 64        # ranges a sequence's pages split into
MIN_SPLIT_KEYS = 64    # keys a range holds at least (one 64-key tile)
MAX_SPLIT_KEYS = 128   # keys a range holds at most, within MAX_SPLITS


def split_plan(b: int, kv: int, nbmax: int, bs: int, sms: int) -> tuple[int, int]:
    """(splits, pages a split) of K3 for B sequences, KV kv heads and block
    tables of nbmax pages of bs slots on a card of `sms` SMs: at least two
    blocks an SM over B * KV * splits, and ranges of at most MAX_SPLIT_KEYS
    keys (both 64-key tiles of a range in flight at once) unless that takes
    more than MAX_SPLITS ranges, each at least MIN_SPLIT_KEYS keys. From
    shapes alone: the lengths stay on the device, and a range past a
    sequence's length costs one empty partial. On an H100, ranges of at
    most two tiles beat about two blocks an SM of any length by up to 1.5x
    at B = 8 and tables of 64 pages, where half the ranges are empty."""
    most = max(1, MAX_SPLIT_KEYS // bs)
    want = min(MAX_SPLITS, max(1, -(-2 * sms // (b * kv)), -(-nbmax // most)))
    pages = max(-(-nbmax // want), -(-MIN_SPLIT_KEYS // bs), 1)
    return -(-nbmax // pages), pages


def _gather(pages, scale, idx):
    """[KV, NB, BS, D] pages at idx [B, NBmax] -> float32 [KV, B, S, D];
    q8 pages are dequantized and rounded to bf16, as gather_kv_q8 does."""
    kv, _, bs, d = pages.shape
    b = idx.shape[0]
    t = pages[:, idx].float()
    if scale is not None:
        t = (t * scale[:, idx][..., None]).to(torch.bfloat16).float()
    return t.reshape(kv, b, idx.shape[1] * bs, d)


def paged_attention_decode_plain(q, k_pages, v_pages, lengths, page_indices,
                                 soft_cap: float | None = None,
                                 k_scale=None, v_scale=None):
    """Plain version of K3: gather pages, masked softmax in float32."""
    kv, nb, bs, d = k_pages.shape
    b, h = q.shape[0], q.shape[1]
    g = h // kv
    idx = page_indices.long()
    s = idx.shape[1] * bs
    k = _gather(k_pages, k_scale, idx)
    v = _gather(v_pages, v_scale, idx)
    qf = q.float().reshape(b, kv, g, d)
    logits = torch.einsum("bkgd,kbsd->bkgs", qf, k)
    if soft_cap is not None:
        logits = torch.tanh(logits / soft_cap) * soft_cap
    mask = torch.arange(s, device=q.device)[None, :] < lengths.long()[:, None]
    logits = logits.masked_fill(~mask[:, None, None, :],
                                torch.finfo(torch.float32).min)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,kbsd->bkgd", p, v)
    return out.reshape(b, h, d).to(q.dtype)


def paged_attention_decode(q, k_pages, v_pages, lengths, page_indices,
                           soft_cap: float | None = None,
                           k_scale=None, v_scale=None) -> torch.Tensor:
    """Paged flash-decoding. q [B, H, D] pre-scaled -> [B, H, D]. With
    k_scale/v_scale the pages are q8_0 (int8)."""
    if q.device.type == "cpu":
        return paged_attention_decode_plain(q, k_pages, v_pages, lengths,
                                            page_indices, soft_cap,
                                            k_scale, v_scale)
    b, h, d = q.shape
    kv, nb, bs, dk = k_pages.shape
    nbmax = page_indices.shape[1]
    q8 = k_scale is not None
    req = _cuda.require
    req(q.dtype == torch.bfloat16 and q.is_contiguous(),
        "paged_attention_decode: q must be contiguous bf16")
    page_dtype = torch.int8 if q8 else torch.bfloat16
    for name, p in (("k_pages", k_pages), ("v_pages", v_pages)):
        req(p.device == q.device and p.dtype == page_dtype
            and p.is_contiguous() and tuple(p.shape) == (kv, nb, bs, d),
            f"paged_attention_decode: bad {name} {tuple(p.shape)} {p.dtype}")
    if q8:
        for name, p in (("k_scale", k_scale), ("v_scale", v_scale)):
            req(p is not None and p.device == q.device
                and p.dtype == torch.float32 and p.is_contiguous()
                and tuple(p.shape) == (kv, nb, bs),
                f"paged_attention_decode: {name} must be contiguous f32 "
                f"{(kv, nb, bs)}")
    for name, a, shape in (("lengths", lengths, (b,)),
                           ("page_indices", page_indices, (b, nbmax))):
        req(a.device == q.device and a.dtype == torch.int32
            and a.is_contiguous() and tuple(a.shape) == shape,
            f"paged_attention_decode: {name} must be contiguous int32 {shape}")
    g = h // kv
    req(h % kv == 0 and d in HEAD_DIMS,
        f"paged_attention_decode: unsupported H={h} KV={kv} D={d}")
    out = torch.empty_like(q)
    cap = float(soft_cap or 0.0)
    stream = _cuda.stream_ptr(q.device)
    splits, pages = split_plan(b, kv, nbmax, bs, _cuda.sm_count(q.device))
    # the split partials: acc [B, KV, splits, G, D], then (m, l)
    ws = torch.empty(b * kv * splits * g * (d + 2) if splits > 1 else 0,
                     dtype=torch.float32, device=q.device)
    dims = (b, h, kv, nb, bs, d, nbmax, splits, pages)
    ptrs = (out.data_ptr(), ws.data_ptr() if splits > 1 else 0)
    if q8:
        name = "paged_decode_q8"
        fn = _cuda.bind("paged_attention", name,
                        "ppppppp" "pp" "iiiiiiiii" "f" "p")
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                k_scale.data_ptr(), v_scale.data_ptr(), lengths.data_ptr(),
                page_indices.data_ptr(), *ptrs, *dims, cap, stream)
    else:
        name = "paged_decode"
        fn = _cuda.bind("paged_attention", name,
                        "ppppp" "pp" "iiiiiiiii" "f" "p")
        rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                lengths.data_ptr(), page_indices.data_ptr(), *ptrs, *dims,
                cap, stream)
    _cuda.check(rc, name)
    _cuda.LAUNCHES[name] += 1
    return out
