"""Device-side paged KV cache: block pools + write/attend ops.

Counterpart of llama_cpp_test_tpu/runtime/kv_cache.py for bf16 and q8_0
pools.

  KVPools.k / .v: per-layer [n_kv_heads, num_blocks, block_size, head_dim]
  bf16 tensors, laid out so the decode kernel reads whole pages per kv head
  (n_kv_heads the layer's own: openelm and deci vary it, and a deci layer
  that does not attend gets a one-head pool it never writes);
  or, for kv_type "q8_0" (the type_k/type_v analogue), int8 tensors with
  per-slot f32 scales in k_scale / v_scale [n_kv_heads, num_blocks,
  block_size] (absmax/127 per (head, token) slot, as the reference has it).

The cache edits the engine's sequence operations need: COW block copies
(copy_blocks / apply_copies), one block's bytes out to the host and back
(gather_block / scatter_block, the host swap) and the K-shift that moves
cached tokens and re-rotates their K (apply_shift). Each helper takes
every layer at its own shape.

Writes scatter into the pools IN PLACE (the reference returns new arrays;
PyTorch updates the tensors it holds, which saves a copy of every pool per
step). Slot id = block * block_size + offset; the engine drops padding
tokens on the host before the scatter (write_kv takes only kept rows).

Attention dispatch: on CUDA, prefill goes to kernel K2 and decode to
kernel K3 (its q8 variant over q8_0 pools), a sliding-window decode and
every attention of an ALiBi file (alibi slopes given; symmetric with the
true query positions on jina-bert-v2) to the gather path as in the
reference, whose kernels have no bias input either; on the CPU,
or when the caller asks for the plain path, both take the full-gather
reference
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
    shapes = [(max(hp.n_head_kv_of(li), 1), num_blocks, block_size,
               hp.head_dim) for li in range(hp.n_layer)]
    dtype = torch.int8 if kv_type == "q8_0" else torch.bfloat16
    new = lambda dt, cut=4: [torch.zeros(s[:cut], dtype=dt, device=device)
                             for s in shapes]
    if kv_type == "q8_0":
        return KVPools(new(dtype), new(dtype), new(torch.float32, 3),
                       new(torch.float32, 3))
    return KVPools(new(dtype), new(dtype))


def kv_bytes_per_token(hp: HParams, kv_type: str = "bf16") -> int:
    """Bytes of K and V one token takes across every layer's pool (the
    reference's kv_bytes_per_token; a q8_0 slot adds its f32 scale)."""
    heads = sum(max(hp.n_head_kv_of(li), 1) for li in range(hp.n_layer))
    slot = hp.head_dim + 4 if kv_type == "q8_0" else 2 * hp.head_dim
    return 2 * heads * slot


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


def copy_blocks(pool: torch.Tensor, src: torch.Tensor,
                dst: torch.Tensor) -> None:
    """COW resolution, in place: pool[:, dst] = pool[:, src]
    (copyBlocks analogue). src/dst: [n_copies] block ids."""
    pool[:, dst] = pool[:, src]


def _pool_lists(pools: KVPools) -> list[list[torch.Tensor]]:
    lists = [pools.k, pools.v]
    if pools.quantized:
        lists += [pools.k_scale, pools.v_scale]
    return lists


def apply_copies(pools: KVPools, src: torch.Tensor, dst: torch.Tensor) -> None:
    """copy_blocks on every layer's K and V pool (and their q8_0 scales)."""
    for plist in _pool_lists(pools):
        for p in plist:
            copy_blocks(p, src, dst)


def gather_block(pools: KVPools, blk: int) -> tuple:
    """One physical block across all layers for host swap (swapBlocks
    swap-out): one flat tensor for K, one for V (and one for each q8_0
    scale list), every layer's [KV_l, BS, D] block in layer order, so
    layers of different KV head counts share a payload (the reference
    stacks them and raises there, ROADMAP §3 fault 18)."""
    return tuple(torch.cat([p[:, blk].reshape(-1) for p in plist])
                 for plist in _pool_lists(pools))


def scatter_block(pools: KVPools, data: tuple, blk: int) -> None:
    """Swap-in, in place: write a gather_block payload into block blk."""
    for plist, flat in zip(_pool_lists(pools), data):
        off = 0
        for p in plist:
            n = p[:, blk].numel()
            p[:, blk] = flat[off:off + n].view(p[:, blk].shape).to(p.device)
            off += n


def gather_seq(pools: KVPools, blocks: torch.Tensor, n: int) -> tuple:
    """The first n cached tokens of a sequence whose block ids are
    `blocks` [nb], across all layers, as float32 (k, v): per-layer lists
    of [KV_l, n, D]; a q8_0 pool is dequantized (plane * scale), the
    values its decode attends."""
    out = []
    for i, plist in enumerate((pools.k, pools.v)):
        per_layer = []
        for li, p in enumerate(plist):
            kv, _, bs, d = p.shape
            g = p[:, blocks].float()                      # [KV, nb, BS, D]
            if pools.quantized:
                sc = (pools.k_scale, pools.v_scale)[i][li][:, blocks]
                g = g * sc[..., None]
            per_layer.append(g.reshape(kv, -1, d)[:, :n])
        out.append(per_layer)
    return tuple(out)


def scatter_seq(pools: KVPools, k: list, v: list,
                slots: torch.Tensor) -> None:
    """Write float (k, v), per-layer lists of [KV_l, n, D], to global
    `slots` [n] of every layer, in place: bf16 pools round, q8_0 pools
    quantize again (write_kv_q8), so a gather_seq payload restores the
    planes and scales it was read from."""
    n = slots.shape[0]
    rows = torch.arange(n, device=slots.device)
    for li in range(len(pools.k)):
        for plist, vals, si in ((pools.k, k, 0), (pools.v, v, 1)):
            new = vals[li].transpose(0, 1)[None]           # [1, n, KV, D]
            if pools.quantized:
                sc = (pools.k_scale, pools.v_scale)[si][li]
                write_kv_q8(plist[li], sc, new, rows, slots)
            else:
                write_kv(plist[li], new, rows, slots)


def apply_shift(pools: KVPools, src: torch.Tensor, dst: torch.Tensor,
                delta: torch.Tensor, inv_freqs: list[torch.Tensor],
                rope_at: int = 0) -> None:
    """Move cached tokens between slots, re-rotating K by a per-token
    position delta, in place (the K-shift of context shift, prompt-cache
    reuse and Self-Extend; reference kv_cache.apply_shift). inv_freqs
    holds each layer's rope table (LlamaWeights.inv_freq_for), so the
    sliding-window layers rotate by their own (gemma3's local base).

    src/dst/delta: [n] slot ids and rope deltas. RoPE rotations add, so
    rotating the stored (already roped) K by delta re-bases it to position
    p + delta. The rotation is unscaled on purpose: stored K already
    carries mscale from its first rope. A layer whose table is None
    (cohere2's global layers, which take no rope) moves its K unrotated.
    rope_at is the first roped dim of a K row: an MLA K (deepseek2,
    minicpm3) is [nope | pe] and only its pe tail was roped, so only that
    tail turns (the reference turns the first rope_dim dims, ROADMAP §3
    fault 24). V moves without rotation. A q8_0 pool is dequantized, rotated and
    requantized in the reference's op order; every read happens before
    any write. Each layer moves at its own KV head count (the reference
    takes layer 0's for all, ROADMAP §3 fault 19)."""
    for li in range(len(pools.k)):
        kv, nb, bs, d = pools.k[li].shape
        kflat = pools.k[li].view(kv, nb * bs, d)
        vflat = pools.v[li].view(kv, nb * bs, d)
        kg = kflat[:, src].float()                       # [KV, n, D]
        if pools.quantized:
            ksflat = pools.k_scale[li].view(kv, nb * bs)
            vsflat = pools.v_scale[li].view(kv, nb * bs)
            kg = kg * ksflat[:, src, None]               # dequantize
        if inv_freqs[li] is not None:
            pe = kg[..., rope_at:].transpose(0, 1)[None]  # [1, n, KV, R]
            pe = layers.apply_rope(pe, delta[None], inv_freqs[li], 1.0)
            kg = torch.cat([kg[..., :rope_at], pe[0].transpose(0, 1)], -1)
        vg = vflat[:, src]
        if pools.quantized:
            kq, ksc = quantize_q8(kg)                    # requantize K
            vsc = vsflat[:, src]
            kflat[:, dst] = kq
            ksflat[:, dst] = ksc
            vsflat[:, dst] = vsc
        else:
            kflat[:, dst] = kg.to(kflat.dtype)
        vflat[:, dst] = vg


def gather_kv(pool: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """pool [KV, NB, BS, D] + table [B, NBmax] -> [B, S=NBmax*BS, KV, D]."""
    return gather_pages(pool, block_table)


def attend_gathered(q, k, v, positions, kv_len, scale: float,
                    window: int = 0, soft_cap: float = 0.0,
                    alibi=None, alibi_sym_pos=None) -> torch.Tensor:
    """Masked attention over already-gathered KV [B, S, KV, D]; alibi:
    optional [H] slopes, symmetric about alibi_sym_pos [B, T], the true
    query positions, where given (layers.attention)."""
    mask = prefill_mask(positions, kv_len, k.shape[1], window)
    return layers.attention(q, k, v, mask, scale, softcap=soft_cap,
                            alibi=alibi, alibi_sym_pos=alibi_sym_pos)


def attend_prefill_plain(q, k_pool, v_pool, block_table, positions, kv_len,
                         scale: float, window: int = 0,
                         soft_cap: float = 0.0, alibi=None,
                         alibi_sym_pos=None) -> torch.Tensor:
    """Reference prefill attention: full-cache gather + masked softmax."""
    return attend_gathered(q, gather_kv(k_pool, block_table),
                           gather_kv(v_pool, block_table), positions, kv_len,
                           scale, window, soft_cap, alibi, alibi_sym_pos)


def attend_prefill(q, k_pool, v_pool, block_table, positions, kv_len,
                   scale: float, window: int = 0, soft_cap: float = 0.0,
                   plain: bool = False, alibi=None,
                   alibi_sym_pos=None) -> torch.Tensor:
    """Attention for a prefill chunk whose KV (incl. any cached prefix) is
    already written to the pools. q: [B, T, H, D]; positions [B, T] (the
    mask's: kv_len - 1 on every row of a non-causal chunk); kv_len [B]
    total tokens now in cache. With ALiBi slopes it takes the gather path
    on every device, as the reference does."""
    if plain or q.device.type == "cpu" or alibi is not None:
        return attend_prefill_plain(q, k_pool, v_pool, block_table,
                                    positions, kv_len, scale, window,
                                    soft_cap, alibi, alibi_sym_pos)
    qs = (q.float() * scale).to(q.dtype).contiguous()
    return flash_prefill(qs, k_pool, v_pool, positions, kv_len, block_table,
                         window=window, soft_cap=soft_cap)


def attend_decode_plain(q, k_pool, v_pool, block_table, kv_len, scale: float,
                        window: int = 0, soft_cap: float = 0.0,
                        alibi=None) -> torch.Tensor:
    """Reference decode path (T == 1 per sequence): gather + masked softmax."""
    positions = (kv_len - 1)[:, None]
    return attend_prefill_plain(q, k_pool, v_pool, block_table, positions,
                                kv_len, scale, window, soft_cap, alibi)


def attend_decode(q, k_pool, v_pool, block_table, kv_len, scale: float,
                  window: int = 0, soft_cap: float = 0.0,
                  plain: bool = False, alibi=None) -> torch.Tensor:
    """Decode attention: q [B, 1, H, D] -> [B, 1, H, D]. A bf16 decode
    without a window goes to kernel K3 on CUDA; a sliding window or ALiBi
    slopes take the gather path on every device, as the reference sends
    either to its gather (kv_cache.attend_decode there)."""
    if plain or window > 0 or q.device.type == "cpu" or alibi is not None:
        return attend_decode_plain(q, k_pool, v_pool, block_table, kv_len,
                                   scale, window, soft_cap, alibi)
    qs = (q[:, 0].float() * scale).to(q.dtype).contiguous()
    out = paged_attention_decode(qs, k_pool, v_pool, kv_len, block_table,
                                 soft_cap=soft_cap if soft_cap > 0 else None)
    return out[:, None]


def attend_decode_q8(q, k_pool, k_scale, v_pool, v_scale, block_table, kv_len,
                     scale: float, window: int = 0, soft_cap: float = 0.0,
                     plain: bool = False, alibi=None) -> torch.Tensor:
    """Decode attention over q8_0 pools: q [B, 1, H, D] -> [B, 1, H, D].
    On CUDA, kernel K3's q8 variant dequantizes the int8 pages in registers
    (half the bytes of bf16 pages); the plain version is the dequantizing
    gather + masked softmax, which a sliding window or ALiBi slopes take on
    every device, as in the reference."""
    if plain or window > 0 or q.device.type == "cpu" or alibi is not None:
        k = gather_kv_q8(k_pool, k_scale, block_table)
        v = gather_kv_q8(v_pool, v_scale, block_table)
        return attend_gathered(q, k, v, (kv_len - 1)[:, None], kv_len, scale,
                               window, soft_cap, alibi)
    qs = (q[:, 0].float() * scale).to(torch.bfloat16).contiguous()
    out = paged_attention_decode(qs, k_pool, v_pool, kv_len, block_table,
                                 soft_cap=soft_cap if soft_cap > 0 else None,
                                 k_scale=k_scale, v_scale=v_scale)
    return out[:, None].to(q.dtype)
