"""Device-side sampling for windowed decode loops.

Counterpart of llama_cpp_test_tpu/runtime/device_sampling.py in torch ops.
The host SamplerChain (runtime/sampling.py) mirrors llama-sampling.cpp
exactly but costs a device->host logits download per token. This module
runs the COMMON chain (penalties -> top-k -> top-p -> min-p -> temperature
-> dist, the default ordering of llama_sampler_chain_default_params) on
the device, so the engine runs N decode+sample steps per window and syncs
once a window.

Approximation vs the host chain, as in the reference: candidates are
pre-truncated to the top K_MAX = 256 logits (after penalties). Rows
needing samplers outside this set (typical/XTC/mirostat/DRY/grammar/
logit-bias/dynatemp) are ineligible; the scheduler samples those on the
host (Scheduler._decode_all).

The reference reads two knobs from the environment; the port takes their
defaults as constants: candidate selection "auto" (exact top-k up to a
64k vocab, segment winners above) and Gumbel noise "hash". The reference's
"threefry" noise needs jax.random and is not ported.

Every top-k here breaks ties by the lower index first, as jax.lax.top_k
does (torch.topk leaves tie order unspecified, and it differs on CUDA):
values and indices are packed into one int64 key whose order is total.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import upload

K_MAX = 256       # candidate truncation after penalties
HIST_LEN = 128    # penalty history ring length (>= default penalty_last_n 64)
_N_SEG = 512      # segments of the large-vocab candidate selector
_SEG_ABOVE = 65536  # "auto": exact top-k up to this vocab, segments above


@dataclasses.dataclass
class DeviceSamplerParams:
    """Per-row sampler parameters, all [B] tensors."""
    temp: torch.Tensor          # f32; <= 0 means greedy
    top_k: torch.Tensor         # i32; <= 0 means disabled (K_MAX candidates)
    top_p: torch.Tensor         # f32; >= 1 disables
    min_p: torch.Tensor         # f32; <= 0 disables
    penalty_last_n: torch.Tensor   # i32; 0 disables penalties for the row
    penalty_repeat: torch.Tensor   # f32 (1.0 = off)
    penalty_freq: torch.Tensor     # f32 (0.0 = off)
    penalty_present: torch.Tensor  # f32 (0.0 = off)
    seed: torch.Tensor             # i32 per-row RNG seed (SamplerParams.seed)

    @classmethod
    def from_rows(cls, rows: list, pad_to: int,
                  device: torch.device | str = "cpu") -> "DeviceSamplerParams":
        """rows: list of SamplerParams; padded rows sample greedily."""
        device = torch.device(device)

        def arr(get, default, dtype):
            v = [get(r) for r in rows] + [default] * (pad_to - len(rows))
            return upload(np.asarray(v, dtype), device)
        return cls(
            temp=arr(lambda r: r.temp, 0.0, np.float32),
            top_k=arr(lambda r: r.top_k, 1, np.int32),
            top_p=arr(lambda r: r.top_p, 1.0, np.float32),
            min_p=arr(lambda r: r.min_p, 0.0, np.float32),
            penalty_last_n=arr(lambda r: max(0, min(r.penalty_last_n,
                                                    HIST_LEN)), 0, np.int32),
            penalty_repeat=arr(lambda r: r.penalty_repeat, 1.0, np.float32),
            penalty_freq=arr(lambda r: r.penalty_freq, 0.0, np.float32),
            penalty_present=arr(lambda r: r.penalty_present, 0.0, np.float32),
            seed=arr(lambda r: r.seed & 0x7FFFFFFF, 0, np.int32),
        )


def ineligible_reasons(p) -> list[str]:
    """Why a SamplerParams chain is NOT exactly expressible on device: each
    entry names the sampler that forces the per-token host path."""
    reasons = []
    if p.typ_p < 1.0:
        reasons.append("typical_p")
    if p.xtc_probability > 0.0:
        reasons.append("xtc")
    if p.top_n_sigma > 0.0:
        reasons.append("top_n_sigma")
    if p.mirostat != 0:
        reasons.append("mirostat")
    if p.dry_multiplier > 0.0:
        reasons.append("dry")
    if p.logit_bias:
        reasons.append("logit_bias")
    if p.grammar:
        reasons.append("grammar")
    if p.dynatemp_range > 0.0:
        reasons.append("dynatemp")
    if p.penalty_last_n > HIST_LEN:
        reasons.append(f"penalty_last_n>{HIST_LEN}")
    if p.penalty_repeat < 1.0 or p.penalty_freq < 0.0 or \
            p.penalty_present < 0.0:
        # the candidate-only penalties are exact only for penalties that
        # LOWER logits
        reasons.append("negative/boosting penalties")
    if not (0 < p.top_k <= K_MAX - HIST_LEN):
        # penalized displacements (<= HIST_LEN) must keep the top-k window
        # inside the K_MAX candidate set
        reasons.append(f"top_k not in (0, {K_MAX - HIST_LEN}]")
    return reasons


# candidate count for the slow-path top-K download (scheduler
# _decode_host_step_candidates): top_k plus a full penalty ring still fit
HOST_CANDIDATES_K = 256


def host_candidates_eligible(p) -> bool:
    """Host-chain rows that can sample from a device top-K download instead
    of full-vocab logits: every pre-top_k chain element touches only tokens
    inside the downloaded top-K (penalties demote at most penalty_last_n
    tokens). Not DRY or logit_bias (they may promote any token), mirostat
    (needs the whole distribution) or top_k <= 0."""
    pen = p.penalty_last_n if (p.penalty_repeat != 1.0 or
                               p.penalty_freq != 0.0 or
                               p.penalty_present != 0.0) else 0
    return (0 < p.top_k and p.top_k + pen <= HOST_CANDIDATES_K and
            p.dry_multiplier == 0.0 and not p.logit_bias and
            p.mirostat == 0)


def eligible(p) -> bool:
    """True when a SamplerParams chain is expressible on device. Vocabs up
    to 64k take exact top-k and match the host chain token for token;
    larger vocabs take the segmented selector (greedy stays exact)."""
    return not ineligible_reasons(p)


_SORT_MAX = 4096   # rows up to this length sort in one in-place CUDA kernel


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """jax.lax.top_k over the last axis of f32 x [B, N]: the k largest
    values in descending order, ties by the lower index first. Returns
    (vals [B, k] f32, ids [B, k] int64).

    Each value and its index form one int64 key (order-preserving f32
    bits above, N-1-index below), so keys are distinct and their order is
    jax's. The keys are sorted in chunks of at most _SORT_MAX, each
    chunk's best k kept, until one chunk is left: torch.sort of such rows
    runs in one in-place kernel on CUDA, where torch.topk of a long row
    zeroes its counters with memsets."""
    bits = x.float().contiguous().view(torch.int32).long()
    # f32 bits -> an integer of the same order (negatives flip magnitude)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    b, n = x.shape
    rev = (n - 1) - torch.arange(n, device=x.device)
    keys = ordered * (1 << 32) + rev
    while keys.shape[1] > _SORT_MAX:
        chunks = -(-keys.shape[1] // _SORT_MAX)
        pad = chunks * _SORT_MAX - keys.shape[1]
        keys = torch.nn.functional.pad(keys, (0, pad),
                                       value=torch.iinfo(torch.int64).min)
        keys = torch.sort(keys.reshape(b * chunks, _SORT_MAX), dim=-1,
                          descending=True).values[:, :k].reshape(b, -1)
    keys = torch.sort(keys, dim=-1, descending=True).values[:, :k]
    ids = (n - 1) - (keys & 0xFFFFFFFF)
    return torch.gather(x, -1, ids), ids


def apply_penalties(logits: torch.Tensor, hist: torch.Tensor,
                    hist_valid: torch.Tensor,
                    p: DeviceSamplerParams) -> torch.Tensor:
    """Repeat/frequency/presence penalties over the history ring, FULL
    vocab (llama_sampler_penalties semantics; the small-vocab path).

    logits [B, V] f32; hist [B, HIST_LEN] (-1 = empty slot); hist_valid
    [B, HIST_LEN] bool (within the row's penalty_last_n)."""
    b, v = logits.shape
    on = (p.penalty_last_n > 0) & (
        (p.penalty_repeat != 1.0) | (p.penalty_freq != 0.0) |
        (p.penalty_present != 0.0))
    idx = torch.where(hist_valid & (hist >= 0), hist.long(), v)  # v = dump
    counts = torch.zeros((b, v + 1), dtype=torch.float32,
                         device=logits.device)
    counts.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.float32))
    counts = counts[:, :v]
    present = counts > 0
    rep = torch.where(on, p.penalty_repeat, 1.0)[:, None]
    penalized = torch.where(logits > 0, logits / rep, logits * rep)
    out = torch.where(present, penalized, logits)
    out = out - counts * torch.where(on, p.penalty_freq, 0.0)[:, None]
    out = out - present * torch.where(on, p.penalty_present, 0.0)[:, None]
    return out


def _penalize_candidates(vals, cand_ids, hist, hist_valid, p):
    """Penalties on a candidate set: counts by comparing candidate ids
    against the history ring (no [B, V] scatter). vals/cand_ids [B, N];
    hist [B, HIST_LEN]. Returns penalized vals."""
    on = (p.penalty_last_n > 0) & (
        (p.penalty_repeat != 1.0) | (p.penalty_freq != 0.0) |
        (p.penalty_present != 0.0))
    h = torch.where(hist_valid & (hist >= 0), hist.long(), -1)
    counts = ((cand_ids[:, :, None] == h[:, None, :]) &
              (h[:, None, :] >= 0)).sum(dim=2).float()     # [B, N]
    present = counts > 0
    rep = torch.where(on, p.penalty_repeat, 1.0)[:, None]
    penalized = torch.where(vals > 0, vals / rep, vals * rep)
    out = torch.where(present, penalized, vals)
    out = out - counts * torch.where(on, p.penalty_freq, 0.0)[:, None]
    out = out - present * torch.where(on, p.penalty_present, 0.0)[:, None]
    return out


def _segmented_top_candidates(logits, k_max):
    """[B, V] -> (vals, ids) of k_max candidates via segment winners: V is
    padded with -inf to _N_SEG segments, each segment's max (first index
    on ties) competes in an exact top-k."""
    b, v = logits.shape
    vpad = -(-v // _N_SEG) * _N_SEG
    seg = vpad // _N_SEG
    x = torch.nn.functional.pad(logits, (0, vpad - v),
                                value=float("-inf")).reshape(b, _N_SEG, seg)
    seg_max, seg_arg = torch.max(x, dim=2)             # [B, NSEG]
    seg_ids = torch.arange(_N_SEG, device=logits.device)[None, :] * seg \
        + seg_arg
    vals, order = top_k(seg_max, k_max)                # small sort
    ids = torch.gather(seg_ids, 1, order)
    return vals, ids


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32) held in int64, in two 16-bit
    halves of c so no product leaves int64's range."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def key_data(seed: int) -> tuple[int, int]:
    """The uint32 pair of jax.random.key_data(jax.random.PRNGKey(seed)) for
    the default threefry key with 64-bit types off (JAX's default): the
    seed taken modulo 2**32, behind a zero word."""
    return 0, int(seed) & _M32


def _hash_gumbel(key, seed, pos, b, k_max):
    """Deterministic per-(key, seed, pos, rank) Gumbel noise [B, k_max] by
    the reference's murmur3 fmix32 over uint32 lanes, done in int64 masked
    to 32 bits. key: the (hi, lo) pair of key_data."""
    k0, k1 = key
    base = k0 ^ ((k1 * 0x9E3779B9) & _M32)
    dev = seed.device
    x = (_mul32(seed.long()[:, None] & _M32, 0x85EBCA6B)
         ^ _mul32(pos.long()[:, None] & _M32, 0xC2B2AE35)
         ^ torch.arange(k_max, device=dev)[None, :] ^ base)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    # uniform in (0, 1): 24 mantissa-safe bits, +1e-8 to avoid exactly 0
    u = (x >> 8).float() * (1.0 / 16777216.0) + 1e-8
    return -torch.log(-torch.log(u))


def sample_tokens(logits: torch.Tensor, p: DeviceSamplerParams,
                  hist: torch.Tensor, key: tuple[int, int],
                  pos: torch.Tensor | None = None) -> torch.Tensor:
    """One sampling step: [B, V] f32 logits -> [B] int64 tokens.

    hist: [B, HIST_LEN] recent tokens, most recent LAST (-1 pads).
    key: key_data(seed) of the window. pos: optional [B] sample positions;
    a row's Gumbel noise is a function of (key, row seed, pos), so a
    request with a fixed seed reproduces its output wherever it sits in
    the batch or the window."""
    b, v = logits.shape
    dev = logits.device
    ring_pos = torch.arange(HIST_LEN, device=dev)[None, :]
    hist_valid = ring_pos >= (HIST_LEN - p.penalty_last_n[:, None])
    k_max = min(K_MAX, v)

    if v > 2 * k_max:
        # penalties on the raw top-k_max CANDIDATES only (exact for
        # lowering penalties with top_k <= K_MAX - HIST_LEN, the
        # eligibility gate), then the candidates re-ranked exactly
        if v <= _SEG_ABOVE:
            rvals, rids = top_k(logits, k_max)
        else:
            rvals, rids = _segmented_top_candidates(logits, k_max)
        cand_vals = _penalize_candidates(rvals, rids, hist, hist_valid, p)
        vals, order = top_k(cand_vals, k_max)
        ids = torch.gather(rids, 1, order)
    else:
        logits = apply_penalties(logits, hist, hist_valid, p)
        vals, ids = top_k(logits, k_max)          # sorted desc [B, k_max]
    greedy_tok = ids[:, 0]

    # top-k: threshold at the per-row kth value
    k = torch.clamp(torch.where(p.top_k <= 0, k_max, p.top_k), 1, k_max)
    rank = torch.arange(k_max, device=dev)[None, :]
    ninf = float("-inf")
    vals = vals.masked_fill(rank >= k[:, None], ninf)

    # softmax over the candidate set (for top-p / min-p)
    probs = torch.softmax(vals, dim=-1)

    # top-p: keep while the exclusive prefix sum is below top_p
    cum = torch.cumsum(probs, dim=-1)
    keep_p = ((cum - probs) < p.top_p[:, None]) | (rank == 0)
    vals = vals.masked_fill(~keep_p, ninf)

    # min-p: relative to the max prob (candidates are sorted)
    keep_m = (probs >= (p.min_p[:, None] * probs[:, 0:1])) | (rank == 0)
    vals = vals.masked_fill(~keep_m, ninf)

    # temperature + categorical via Gumbel-max; temp <= 0 -> greedy
    temp = torch.clamp(p.temp, min=1e-6)[:, None]
    if pos is None:
        pos = torch.zeros((b,), dtype=torch.int32, device=dev)
    g = _hash_gumbel(key, p.seed, pos, b, k_max)
    scores = vals / temp + g
    choice = torch.argmax(scores, dim=-1)
    picked = torch.gather(ids, 1, choice[:, None])[:, 0]
    # temp <= 0: exact greedy (rank 0 after penalties)
    return torch.where(p.temp > 0, picked, greedy_tok)


def push_history(hist: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """Append tok [B] to the ring (most recent last)."""
    return torch.cat([hist[:, 1:], tok.to(hist.dtype)[:, None]], dim=1)


def make_history(token_lists: list, pad_to: int) -> np.ndarray:
    """Host helper: [B, HIST_LEN] ring from per-row recent-token lists."""
    h = np.full((pad_to, HIST_LEN), -1, np.int32)
    for i, toks in enumerate(token_lists):
        tail = toks[-HIST_LEN:]
        if tail:
            h[i, HIST_LEN - len(tail):] = tail
    return h
