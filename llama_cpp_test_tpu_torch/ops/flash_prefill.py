"""Flash prefill attention over the paged KV cache.

Counterpart of llama_cpp_test_tpu/ops/flash_prefill.py. On a CUDA tensor,
`flash_prefill` launches kernel K2 (csrc/flash_prefill.cu): one block per
(sequence, kv head, 64 query rows t * G + g) walks the 64-key tiles its
tokens attend with an online softmax on the tensor cores (P rounded to
bf16 for P . V), reading page ids from the block table. On a CPU tensor
it takes `flash_prefill_plain` (full gather + masked softmax).

Semantics match the reference kernel: token (b, t) attends cache index s
iff s <= positions[b, t], s < kv_len[b], and (window == 0 or
s > positions[b, t] - window); logits optionally soft-capped.

Layout (runtime/kv_cache.KVPools):
  q:            [B, T, H, D] bf16, pre-scaled by the caller
  k/v_pages:    [KV, NB, BS, D] bf16
  positions:    [B, T] int32
  kv_len:       [B] int32
  page_indices: [B, NBmax] int32
"""
from __future__ import annotations

import torch

from . import _cuda
from .layers import attention

# the head dims K2 is built for (csrc/flash_prefill.cu; 100 runs padded to
# 112 inside the kernel); any other raises on CUDA
HEAD_DIMS = (64, 80, 96, 100, 128, 192, 256)


def gather_pages(pages: torch.Tensor, page_indices: torch.Tensor) -> torch.Tensor:
    """pages [KV, NB, BS, D] + table [B, NBmax] -> [B, NBmax*BS, KV, D]."""
    kv, nb, bs, d = pages.shape
    b, nbmax = page_indices.shape
    g = pages[:, page_indices.long()]              # [KV, B, NBmax, BS, D]
    return g.reshape(kv, b, nbmax * bs, d).permute(1, 2, 0, 3)


def prefill_mask(positions: torch.Tensor, kv_len: torch.Tensor, s: int,
                 window: int = 0) -> torch.Tensor:
    """[B, T, S] bool: causal, length and sliding-window mask."""
    sidx = torch.arange(s, device=positions.device)[None, None, :]
    pos = positions.long()[:, :, None]
    mask = (sidx <= pos) & (sidx < kv_len.long()[:, None, None])
    if window > 0:
        mask = mask & (sidx > pos - window)
    return mask


def flash_prefill_plain(q, k_pages, v_pages, positions, kv_len, page_indices,
                        *, window: int = 0, soft_cap: float = 0.0):
    """Plain version of K2 (q pre-scaled): gather every page, then masked
    softmax attention in float32."""
    k = gather_pages(k_pages, page_indices)
    v = gather_pages(v_pages, page_indices)
    mask = prefill_mask(positions, kv_len, k.shape[1], window)
    return attention(q, k, v, mask, 1.0, softcap=soft_cap)


def flash_prefill(q, k_pages, v_pages, positions, kv_len, page_indices,
                  *, window: int = 0, soft_cap: float = 0.0) -> torch.Tensor:
    """Paged flash prefill. q [B, T, H, D] pre-scaled -> [B, T, H, D]."""
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k_pages, v_pages, positions, kv_len,
                                   page_indices, window=window,
                                   soft_cap=soft_cap)
    b, t, h, d = q.shape
    kv, nb, bs, dk = k_pages.shape
    nbmax = page_indices.shape[1]
    req = _cuda.require
    req(q.dtype == torch.bfloat16 and q.is_contiguous(),
        "flash_prefill: q must be contiguous bf16")
    for name, p in (("k_pages", k_pages), ("v_pages", v_pages)):
        req(p.device == q.device and p.dtype == torch.bfloat16
            and p.is_contiguous() and tuple(p.shape) == (kv, nb, bs, d),
            f"flash_prefill: bad {name} {tuple(p.shape)} {p.dtype}")
    for name, a, shape in (("positions", positions, (b, t)),
                           ("kv_len", kv_len, (b,)),
                           ("page_indices", page_indices, (b, nbmax))):
        req(a.device == q.device and a.dtype == torch.int32
            and a.is_contiguous() and tuple(a.shape) == shape,
            f"flash_prefill: {name} must be contiguous int32 {shape}")
    req(h % kv == 0 and d in HEAD_DIMS and bs % 8 == 0 and bs <= 64,
        f"flash_prefill: unsupported H={h} KV={kv} D={d} BS={bs}")
    out = torch.empty_like(q)
    fn = _cuda.bind("flash_prefill", "flash_prefill",
                    "ppppppp" + "iiiiiiiii" + "f" + "p")
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            positions.data_ptr(), kv_len.data_ptr(), page_indices.data_ptr(),
            out.data_ptr(), b, t, h, kv, nb, bs, d, nbmax, int(window),
            float(soft_cap), _cuda.stream_ptr(q.device))
    _cuda.check(rc, "flash_prefill")
    _cuda.LAUNCHES["flash_prefill"] += 1
    return out
