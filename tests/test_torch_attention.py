"""Port conformance of the paged attention ops (llama_cpp_test_tpu_torch
ops/flash_prefill, ops/paged_attention, runtime/kv_cache) against the JAX
package's Pallas kernels in interpret mode and its XLA references.

On CPU tensors the port's kernel wrappers take their plain versions; the
inputs are made with numpy from a seed and cast to bf16 on both sides.
Gate: NMSE < 2e-4 (tests/test_paged_attention.py:44,
tests/test_flash_prefill.py:47).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from llama_cpp_test_tpu.ops import paged_attention as pa
from llama_cpp_test_tpu.ops.flash_prefill import flash_prefill
from llama_cpp_test_tpu.runtime import kv_cache
from llama_cpp_test_tpu_torch.ops import flash_prefill as pfp
from llama_cpp_test_tpu_torch.ops import paged_attention as ppa
from llama_cpp_test_tpu_torch.runtime import kv_cache as pkv

GATE = 2e-4


def nmse(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(((a - b) ** 2).mean() / ((a * a).mean() + 1e-12))


def both(a: np.ndarray, dtype="bf16"):
    """The same numpy array as (jax, torch) arrays."""
    if dtype == "bf16":
        return (jnp.asarray(a, jnp.bfloat16),
                torch.from_numpy(np.ascontiguousarray(a, np.float32))
                .to(torch.bfloat16))
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      x.astype(jnp.float32))


def prefill_case(seed=0, b=2, t=16, h=8, kv=2, d=64, nb=12, bs=8, lens=None,
                 nbmax=6):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, t, h, d)) * 0.3).astype(np.float32)
    kp = rng.standard_normal((kv, nb, bs, d)).astype(np.float32)
    vp = rng.standard_normal((kv, nb, bs, d)).astype(np.float32)
    bt = rng.permutation(nb)[: b * nbmax].reshape(b, nbmax).astype(np.int32)
    lens = [t, t - 3] if lens is None else lens
    kv_len = np.asarray(lens[:b], np.int32)
    pos = np.stack([np.arange(l - t, l) for l in lens[:b]]).astype(np.int32)
    return q, kp, vp, np.maximum(pos, 0), kv_len, bt


@pytest.mark.parametrize("h,kv,d", [(8, 2, 64), (4, 4, 64), (32, 4, 64),
                                    (8, 2, 128), (8, 4, 256), (4, 1, 256),
                                    (4, 4, 80), (8, 2, 96), (4, 4, 100),
                                    (8, 2, 100)],
                         ids=["G4", "G1", "G8", "G4-D128", "G2-D256",
                              "G4-D256", "G1-D80", "G4-D96", "G1-D100",
                              "G4-D100"])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (5, 0.0), (0, 30.0),
                                        (5, 50.0)])
def test_flash_prefill_matches_pallas(window, cap, h, kv, d):
    """Mixed lengths per sequence, GQA G in {1, 2, 4, 8} (8: TinyLlama's
    layout, 2 and 4 at D = 256: Gemma-2's and Gemma-3's, 1 at D = 80:
    Phi-2's, 1 at D = 100: BitNet-3B's), D in {64, 80, 96, 100, 128, 256},
    window and softcap, and both at once (Gemma-2's local layers)."""
    q, kp, vp, pos, kl, bt = prefill_case(h=h, kv=kv, d=d)
    scale = 0.125
    (jq, tq), (jk, tk), (jv, tv) = both(q * scale), both(kp), both(vp)
    ints = [both(a, "i32") for a in (pos, kl, bt)]
    ref = flash_prefill(jq, jk, jv, *[j for j, _ in ints], window=window,
                        soft_cap=cap, interpret=True)
    got = pfp.flash_prefill(tq, tk, tv, *[t for _, t in ints], window=window,
                            soft_cap=cap)
    assert got.shape == tuple(ref.shape) and got.dtype == torch.bfloat16
    assert nmse(f32(ref), f32(got)) < GATE, nmse(f32(ref), f32(got))


def test_flash_prefill_cached_prefix():
    """Second chunk of a longer sequence: positions past a cached prefix,
    kv_len > chunk length; the dispatcher pre-scales q like the reference."""
    q, kp, vp, _, _, bt = prefill_case(seed=3, b=2, t=8)
    pos = np.asarray([[24 + i for i in range(8)], [10 + i for i in range(8)]],
                     np.int32)
    kl = np.asarray([32, 18], np.int32)
    scale = 0.2
    (jq, tq), (jk, tk), (jv, tv) = both(q), both(kp), both(vp)
    ints = [both(a, "i32") for a in (bt, pos, kl)]
    (jbt, tbt), (jpos, tpos), (jkl, tkl) = ints
    ref = flash_prefill((jq.astype(jnp.float32) * scale).astype(jnp.bfloat16),
                        jk, jv, jpos, jkl, jbt, interpret=True)
    got = pkv.attend_prefill(tq, tk, tv, tbt, tpos, tkl, scale)
    assert nmse(f32(ref), f32(got)) < GATE
    xla = kv_cache.attend_prefill_xla(jq, jk, jv, jbt, jpos, jkl, scale)
    assert nmse(f32(xla), f32(got)) < 1e-6


def decode_case(b=3, kv=2, g=4, d=64, nb=16, bs=16, nbmax=4, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, kv * g, d)) * 0.3).astype(np.float32)
    kp = (rng.standard_normal((kv, nb, bs, d)) * 0.3).astype(np.float32)
    vp = (rng.standard_normal((kv, nb, bs, d)) * 0.3).astype(np.float32)
    pages = np.stack([rng.permutation(nb)[:nbmax] for _ in range(b)]) \
        .astype(np.int32)
    lengths = rng.integers(1, nbmax * bs + 1, size=b).astype(np.int32)
    return q, kp, vp, lengths, pages


@pytest.mark.parametrize("g,lengths,cap,d", [
    (4, None, None, 64), (1, None, None, 64), (4, [1, 2, 5], None, 64),
    (4, None, 30.0, 64), (2, None, 50.0, 256), (4, [1, 2, 5], None, 256),
    (1, None, None, 80), (4, [1, 2, 5], None, 96), (1, None, None, 100),
    (4, None, 30.0, 100)],
    ids=["G4", "G1", "short", "softcap", "G2-softcap-D256", "short-D256",
         "G1-D80", "short-D96", "G1-D100", "softcap-D100"])
def test_paged_decode_matches_pallas(g, lengths, cap, d):
    q, kp, vp, lens, pages = decode_case(g=g, kv=2 if g == 4 else 4, seed=g,
                                         d=d)
    if lengths is not None:
        lens = np.asarray(lengths, np.int32)
    (jq, tq), (jk, tk), (jv, tv) = both(q), both(kp), both(vp)
    (jl, tl), (jp, tp) = both(lens, "i32"), both(pages, "i32")
    ref = pa.paged_attention_decode(jq, jk, jv, jl, jp, soft_cap=cap,
                                    interpret=True)
    got = ppa.paged_attention_decode(tq, tk, tv, tl, tp, soft_cap=cap)
    assert got.shape == tuple(ref.shape)
    assert nmse(f32(ref), f32(got)) < GATE, nmse(f32(ref), f32(got))
    xla = pa.paged_attention_decode_xla(jq, jk, jv, jl, jp, soft_cap=cap)
    assert nmse(f32(xla), f32(got)) < 1e-6


@pytest.mark.parametrize("lengths", [[37 * 16 + 5], [1, 16, 37 * 16 + 5]],
                         ids=["B1", "B3-1-BS-37BS+5"])
@pytest.mark.parametrize("g,kv,d", [(8, 4, 64), (4, 2, 128), (4, 1, 256),
                                    (1, 4, 80), (1, 4, 96), (1, 4, 100)],
                         ids=["G8", "G4-D128", "G4-D256", "G1-D80",
                              "G1-D96", "G1-D100"])
def test_paged_decode_long_and_short_match_pallas(lengths, g, kv, d):
    """The plain version K3 is held against, at B = 1 and at B = 3 with
    lengths 1, BS and 37 BS + 5 (one sequence spanning many of K3's page
    ranges beside two shorter than one), against the Pallas kernel in
    interpret mode; gate 2e-4 as above."""
    b, bs, nbmax = len(lengths), 16, 40
    q, kp, vp, _, pages = decode_case(b=b, kv=kv, g=g, d=d, nb=b * nbmax + 2,
                                      bs=bs, nbmax=nbmax, seed=len(lengths) + d)
    lens = np.asarray(lengths, np.int32)
    (jq, tq), (jk, tk), (jv, tv) = both(q), both(kp), both(vp)
    (jl, tl), (jp, tp) = both(lens, "i32"), both(pages, "i32")
    ref = pa.paged_attention_decode(jq, jk, jv, jl, jp, interpret=True)
    got = ppa.paged_attention_decode_plain(tq, tk, tv, tl, tp)
    assert got.shape == tuple(ref.shape)
    assert nmse(f32(ref), f32(got)) < GATE, nmse(f32(ref), f32(got))


@pytest.mark.parametrize("b,kv,nbmax,bs", [
    (1, 4, 64, 16), (8, 4, 32, 16), (1, 8, 256, 16), (3, 2, 40, 16),
    (8, 8, 64, 16), (64, 8, 64, 16), (1, 1, 1, 8), (2, 4, 100, 64),
    (64, 8, 8192, 16)])
def test_split_plan_covers_every_page(b, kv, nbmax, bs):
    """K3's page ranges cover the block table, hold at least 64 keys (or
    the whole table) and number at most 64; they hold at most 128 keys
    unless 64 ranges would not cover the table; and they give at least one
    block an SM where the key floor and the range cap allow two, and more
    than two an SM (plus one a sequence and kv head) only to keep ranges
    at most 128 keys."""
    sms = 132
    splits, pages = ppa.split_plan(b, kv, nbmax, bs, sms)
    assert 1 <= splits <= ppa.MAX_SPLITS
    assert splits * pages >= nbmax > (splits - 1) * pages
    assert pages * bs >= ppa.MIN_SPLIT_KEYS or splits == 1
    assert pages <= max(1, ppa.MAX_SPLIT_KEYS // bs) or splits == ppa.MAX_SPLITS
    blocks = b * kv * splits
    # the most ranges the 64-key floor and the 64-range cap allow
    most = min(ppa.MAX_SPLITS, -(-nbmax // -(-ppa.MIN_SPLIT_KEYS // bs)))
    assert 2 * blocks >= min(2 * sms, b * kv * most)
    # past two an SM, one range fewer would hold more than 128 keys
    assert blocks <= 2 * sms + b * kv or \
        -(-nbmax // (splits - 1)) * bs > ppa.MAX_SPLIT_KEYS


def test_attend_decode_matches_reference():
    """The decode dispatcher (q [B, 1, H, D], logits scaled) against the
    reference's XLA decode path."""
    q, kp, vp, lens, pages = decode_case(seed=7)
    scale = 0.125
    (jq, tq), (jk, tk), (jv, tv) = both(q[:, None]), both(kp), both(vp)
    (jl, tl), (jp, tp) = both(lens, "i32"), both(pages, "i32")
    ref = kv_cache.attend_decode_xla(jq, jk, jv, jp, jl, scale)
    got = pkv.attend_decode(tq, tk, tv, tp, tl, scale)
    assert got.shape == tuple(ref.shape)
    assert nmse(f32(ref), f32(got)) < 1e-6


@pytest.mark.parametrize("style,g,d", [("bloom", 1, 64), ("mpt", 3, 64),
                                       ("bloom", 3, 100)])
def test_alibi_attention_matches_reference(style, g, d):
    """The ALiBi bias through the dispatchers (prefill over a cached
    prefix, decode, and the q8_0 decode) against the reference's XLA
    paths, which every ALiBi layer takes there: slope_h * kv_index added
    after the softcap, before the mask; 6 heads take the non-power-of-two
    slope orders."""
    from llama_cpp_test_tpu.ops import layers as jlayers
    from llama_cpp_test_tpu_torch.ops import layers as players

    q, kp, vp, lens, pages = decode_case(g=g, kv=2, d=d, seed=11)
    h, scale, cap = 2 * g, 0.125, 30.0
    sl = jlayers.alibi_slopes(h, 8.0, style=style)
    np.testing.assert_array_equal(sl, players.alibi_slopes(h, 8.0, style))
    js, ts = jnp.asarray(sl), torch.from_numpy(sl)
    (jq, tq), (jk, tk), (jv, tv) = both(q[:, None]), both(kp), both(vp)
    (jl, tl), (jp, tp) = both(lens, "i32"), both(pages, "i32")
    ref = kv_cache.attend_decode_xla(jq, jk, jv, jp, jl, scale, 0, cap,
                                     alibi=js)
    got = pkv.attend_decode(tq, tk, tv, tp, tl, scale, 0, cap, alibi=ts)
    assert nmse(f32(ref), f32(got)) < 1e-6
    plain = pkv.attend_decode(tq, tk, tv, tp, tl, scale, 0, cap)
    assert nmse(f32(plain), f32(got)) > 1e-4
    kq, ks = kv_cache.quantize_q8(jk)
    vq, vs = kv_cache.quantize_q8(jv)
    t = lambda a: torch.from_numpy(np.array(a))
    ref8 = kv_cache.attend_gathered(
        jq, kv_cache.gather_kv_q8(kq, ks, jp), kv_cache.gather_kv_q8(vq, vs, jp),
        (jl - 1)[:, None], jl, scale, 0, cap, alibi=js)
    got8 = pkv.attend_decode_q8(tq, t(kq), t(ks), t(vq), t(vs), tp, tl, scale,
                                0, cap, alibi=ts)
    assert nmse(f32(ref8), f32(got8)) < 1e-6
    pos = np.stack([np.arange(n - 5, n) for n in np.maximum(lens, 5)])
    pos = pos.astype(np.int32)
    kl = np.maximum(lens, 5).astype(np.int32)
    jq5, tq5 = both(np.repeat(q[:, None], 5, axis=1))
    (jpos, tpos), (jkl, tkl) = both(pos, "i32"), both(kl, "i32")
    ref = kv_cache.attend_prefill_xla(jq5, jk, jv, jp, jpos, jkl, scale, 4,
                                      cap, alibi=js)
    got = pkv.attend_prefill(tq5, tk, tv, tp, tpos, tkl, scale, 4, cap,
                             alibi=ts)
    assert nmse(f32(ref), f32(got)) < 1e-6


def test_write_kv_matches_reference_and_drops_padding():
    """Kept rows land in the same slots as in the reference. Padding rows
    (slot -1) are dropped. The reference's scatter normalizes -1 to the
    pool's LAST slot before mode="drop" and writes a padding row there
    (ROADMAP.md queue 3); the port leaves that slot alone."""
    rng = np.random.default_rng(9)
    kv, nb, bs, d = 2, 4, 8, 16
    pool = rng.standard_normal((kv, nb, bs, d)).astype(np.float32)
    new = rng.standard_normal((2, 3, kv, d)).astype(np.float32)
    slots = np.asarray([[5, 6, -1], [17, -1, 30]], np.int32)
    ref = f32(kv_cache.write_kv(jnp.asarray(pool, jnp.bfloat16),
                                jnp.asarray(new, jnp.bfloat16),
                                jnp.asarray(slots)))
    tpool = torch.from_numpy(pool).to(torch.bfloat16)
    before = f32(tpool).copy()
    flat = slots.reshape(-1)
    keep = np.nonzero(flat >= 0)[0]
    pkv.write_kv(tpool, torch.from_numpy(new).to(torch.bfloat16),
                 torch.from_numpy(keep),
                 torch.from_numpy(flat[keep].astype(np.int64)))
    got = f32(tpool)
    np.testing.assert_array_equal(got[:, :-1], ref[:, :-1])
    np.testing.assert_array_equal(got[:, -1, :-1], ref[:, -1, :-1])
    np.testing.assert_array_equal(got[:, -1, -1], before[:, -1, -1])
    assert not np.array_equal(ref[:, -1, -1], before[:, -1, -1])
