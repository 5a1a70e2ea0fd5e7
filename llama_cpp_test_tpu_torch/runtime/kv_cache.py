"""Device-side paged KV cache: block pools + write/attend ops.

Counterpart of llama_cpp_test_tpu/runtime/kv_cache.py for bf16 and q8_0
pools.

  KVPools.k / .v: per-layer [n_kv_heads, num_blocks, block_size, head_dim]
  bf16 tensors, laid out so the decode kernel reads whole pages per kv head;
  or, for kv_type "q8_0" (the type_k/type_v analogue), int8 tensors with
  per-slot f32 scales in k_scale / v_scale [n_kv_heads, num_blocks,
  block_size] (absmax/127 per (head, token) slot, as the reference has it).

Writes scatter into the pools IN PLACE (the reference returns new arrays;
PyTorch updates the tensors it holds, which saves a copy of every pool per
step). Slot id = block * block_size + offset; the engine drops padding
tokens on the host before the scatter (write_kv takes only kept rows).

Attention dispatch: on CUDA, prefill goes to kernel K2 and decode to
kernel K3 (its q8 variant over q8_0 pools); on the CPU, or when the caller
asks for the plain path, both take the full-gather reference
(attend_prefill_plain / attend_decode_plain; gather_kv_q8 +
attend_gathered for q8_0). Prefill over q8_0 pools is the dequantizing
gather on every device, as in the reference, which has no kernel there.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.hparams import HParams
from ..ops import layers
from ..ops.flash_prefill import flash_prefill, gather_pages, prefill_mask
from ..ops.paged_attention import paged_attention_decode


@dataclasses.dataclass
class KVPools:
    k: list[torch.Tensor]
    v: list[torch.Tensor]
    k_scale: list[torch.Tensor] | None = None
    v_scale: list[torch.Tensor] | None = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def num_blocks(self) -> int:
        return self.k[0].shape[1]

    @property
    def block_size(self) -> int:
        return self.k[0].shape[2]


def new_kv_pools(hp: HParams, num_blocks: int, block_size: int = 32,
                 device: torch.device | str = "cpu",
                 kv_type: str = "bf16") -> KVPools:
    if kv_type not in ("bf16", "q8_0"):
        raise NotImplementedError(
            f"kv_type {kv_type!r}: this port carries bf16 and q8_0 KV pools")
    shape = (max(hp.n_head_kv, 1), num_blocks, block_size, hp.head_dim)
    dtype = torch.int8 if kv_type == "q8_0" else torch.bfloat16
    new = lambda s, dt: [torch.zeros(s, dtype=dt, device=device)
                         for _ in range(hp.n_layer)]
    if kv_type == "q8_0":
        return KVPools(new(shape, dtype), new(shape, dtype),
                       new(shape[:3], torch.float32),
                       new(shape[:3], torch.float32))
    return KVPools(new(shape, dtype), new(shape, dtype))


def write_kv(pool: torch.Tensor, new: torch.Tensor, rows: torch.Tensor,
             slots: torch.Tensor) -> None:
    """Scatter new [B, T, KV, D] into pool [KV, NB, BS, D] in place: flat
    token row rows[i] (of B*T) goes to global slot slots[i]."""
    kv, nb, bs, d = pool.shape
    flat = pool.view(kv, nb * bs, d)
    vals = new.reshape(-1, kv, d)[rows].transpose(0, 1)   # [KV, n, D]
    flat[:, slots] = vals.to(pool.dtype)


def quantize_q8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [..., D] -> (int8 [..., D], f32 scale [...]) with absmax/127
    scaling: one scale per (head, token) slot, deliberately coarser than
    llama.cpp's 32-element groups, exactly as the reference does."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    q = torch.round(xf / scale.clamp(min=1e-12)[..., None])
    return q.to(torch.int8), scale


def write_kv_q8(pool: torch.Tensor, pool_scale: torch.Tensor,
                new: torch.Tensor, rows: torch.Tensor,
                slots: torch.Tensor) -> None:
    """Quantizing scatter, in place: new [B, T, KV, D] rows `rows` ->
    int8 pool [KV, NB, BS, D] + scales [KV, NB, BS] at global `slots`."""
    kv, nb, bs, d = pool.shape
    q, scale = quantize_q8(new.reshape(-1, kv, d)[rows])   # [n, KV, D], [n, KV]
    pool.view(kv, nb * bs, d)[:, slots] = q.transpose(0, 1)
    pool_scale.view(kv, nb * bs)[:, slots] = scale.transpose(0, 1)


def gather_kv_q8(pool: torch.Tensor, pool_scale: torch.Tensor,
                 block_table: torch.Tensor) -> torch.Tensor:
    """Dequantizing gather -> [B, S=NBmax*BS, KV, D] bf16."""
    kv, nb, bs, d = pool.shape
    idx = block_table.long()
    deq = pool[:, idx].float() * pool_scale[:, idx][..., None]
    b = idx.shape[0]
    return deq.reshape(kv, b, -1, d).permute(1, 2, 0, 3).to(torch.bfloat16)


def gather_kv(pool: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """pool [KV, NB, BS, D] + table [B, NBmax] -> [B, S=NBmax*BS, KV, D]."""
    return gather_pages(pool, block_table)


def attend_gathered(q, k, v, positions, kv_len, scale: float,
                    window: int = 0, soft_cap: float = 0.0) -> torch.Tensor:
    """Masked attention over already-gathered KV [B, S, KV, D]."""
    mask = prefill_mask(positions, kv_len, k.shape[1], window)
    return layers.attention(q, k, v, mask, scale, softcap=soft_cap)


def attend_prefill_plain(q, k_pool, v_pool, block_table, positions, kv_len,
                         scale: float, window: int = 0,
                         soft_cap: float = 0.0) -> torch.Tensor:
    """Reference prefill attention: full-cache gather + masked softmax."""
    return attend_gathered(q, gather_kv(k_pool, block_table),
                           gather_kv(v_pool, block_table), positions, kv_len,
                           scale, window, soft_cap)


def attend_prefill(q, k_pool, v_pool, block_table, positions, kv_len,
                   scale: float, window: int = 0, soft_cap: float = 0.0,
                   plain: bool = False) -> torch.Tensor:
    """Attention for a prefill chunk whose KV (incl. any cached prefix) is
    already written to the pools. q: [B, T, H, D]; positions [B, T];
    kv_len [B] total tokens now in cache."""
    if plain or q.device.type == "cpu":
        return attend_prefill_plain(q, k_pool, v_pool, block_table,
                                    positions, kv_len, scale, window,
                                    soft_cap)
    qs = (q.float() * scale).to(q.dtype).contiguous()
    return flash_prefill(qs, k_pool, v_pool, positions, kv_len, block_table,
                         window=window, soft_cap=soft_cap)


def attend_decode_plain(q, k_pool, v_pool, block_table, kv_len, scale: float,
                        window: int = 0, soft_cap: float = 0.0) -> torch.Tensor:
    """Reference decode path (T == 1 per sequence): gather + masked softmax."""
    positions = (kv_len - 1)[:, None]
    return attend_prefill_plain(q, k_pool, v_pool, block_table, positions,
                                kv_len, scale, window, soft_cap)


def attend_decode(q, k_pool, v_pool, block_table, kv_len, scale: float,
                  window: int = 0, soft_cap: float = 0.0,
                  plain: bool = False) -> torch.Tensor:
    """Decode attention: q [B, 1, H, D] -> [B, 1, H, D]. Every bf16,
    window-0 decode on CUDA goes to kernel K3."""
    if plain or q.device.type == "cpu":
        return attend_decode_plain(q, k_pool, v_pool, block_table, kv_len,
                                   scale, window, soft_cap)
    if window > 0:
        raise NotImplementedError(
            "sliding-window decode on CUDA is not ported yet (ROADMAP.md)")
    qs = (q[:, 0].float() * scale).to(q.dtype).contiguous()
    out = paged_attention_decode(qs, k_pool, v_pool, kv_len, block_table,
                                 soft_cap=soft_cap if soft_cap > 0 else None)
    return out[:, None]


def attend_decode_q8(q, k_pool, k_scale, v_pool, v_scale, block_table, kv_len,
                     scale: float, window: int = 0, soft_cap: float = 0.0,
                     plain: bool = False) -> torch.Tensor:
    """Decode attention over q8_0 pools: q [B, 1, H, D] -> [B, 1, H, D].
    On CUDA, kernel K3's q8 variant dequantizes the int8 pages in registers
    (half the bytes of bf16 pages); the plain version is the dequantizing
    gather + masked softmax."""
    if plain or q.device.type == "cpu":
        k = gather_kv_q8(k_pool, k_scale, block_table)
        v = gather_kv_q8(v_pool, v_scale, block_table)
        return attend_gathered(q, k, v, (kv_len - 1)[:, None], kv_len, scale,
                               window, soft_cap)
    if window > 0:
        raise NotImplementedError(
            "sliding-window decode on CUDA is not ported yet (ROADMAP.md)")
    qs = (q[:, 0].float() * scale).to(torch.bfloat16).contiguous()
    out = paged_attention_decode(qs, k_pool, v_pool, kv_len, block_table,
                                 soft_cap=soft_cap if soft_cap > 0 else None,
                                 k_scale=k_scale, v_scale=v_scale)
    return out[:, None].to(q.dtype)
