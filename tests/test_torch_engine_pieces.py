"""The engine pieces the scheduler calls (llama_cpp_test_tpu_torch/
runtime/engine.py Context, over kv_cache's COW copies, host swap and
K-shift) against the JAX Context, on the tiny Q8_0 fixture
(tests/test_engine.make_tiny_gguf) over bf16 and q8_0 pools: fork with
copy-on-write, truncate, shift_context, compact_reuse, self_extend,
prefill_batch, the candidate downloads and decode_window(_async) with a
carried chain. Logits and the sequences' cached K/V are held to NMSE <=
2e-3 of the jitted JAX engine; tokens (greedy and seeded) must equal the
JAX engine run op by op (jax.disable_jit()), whose bf16 roundings the
port keeps (ROADMAP §3). The host swap must round-trip blocks bit-exact."""
import jax
import numpy as np
import pytest
import torch

from test_engine import make_tiny_gguf

from llama_cpp_test_tpu.runtime import engine as jengine
from llama_cpp_test_tpu.runtime.sampling import SamplerParams as JParams
from llama_cpp_test_tpu_torch.runtime import engine as pengine
from llama_cpp_test_tpu_torch.runtime import kv_cache
from llama_cpp_test_tpu_torch.runtime.errors import DecodeAborted
from llama_cpp_test_tpu_torch.runtime.sampling import SamplerParams as PParams

GATE = 2e-3
PROMPT = [3, 17, 42, 9, 150, 7, 23, 88, 5, 61, 100, 4, 33, 71, 12, 200,
          19, 54, 8, 240, 27, 66, 91, 13]


def nmse(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(((a - b) ** 2).mean() / ((a * a).mean() + 1e-12))


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ep") / "q8.gguf")
    make_tiny_gguf(path)
    return jengine.Model(path), pengine.Model(path, device="cpu")


def contexts(models, kv="bf16", **kw):
    kw = {"n_ctx": 64, "n_seq_max": 4, "block_size": 8, **kw}
    return (jengine.Context(models[0], kv_type=kv, **kw),
            pengine.Context(models[1], kv_type=kv, **kw))


def _host(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a).astype(np.float32)


def cached_kv(ctx, s):
    """The sequence's cached K and V over every layer, dequantized,
    [2, L, KV, n_cached, D]."""
    blocks = list(s.table.resident_blocks())
    p = ctx.pools
    out = []
    for pools, scales in ((p.k, p.k_scale), (p.v, p.v_scale)):
        layers = []
        for li in range(len(pools)):
            x = _host(pools[li])[:, blocks]            # [KV, nb, BS, D]
            if scales is not None:
                x = x * _host(scales[li])[:, blocks][..., None]
            kvh, nb, bs, d = x.shape
            layers.append(x.reshape(kvh, nb * bs, d)[:, : s.n_cached])
        out.append(layers)
    return np.asarray(out)


def assert_close(jctx, pctx, js, ps, jl, pl):
    assert nmse(jl, pl) < GATE, nmse(jl, pl)
    assert js.tokens == ps.tokens and js.n_cached == ps.n_cached
    assert list(js.table.blocks) == list(ps.table.blocks)
    assert nmse(cached_kv(jctx, js), cached_kv(pctx, ps)) < GATE


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
def test_fork_copy_on_write_matches_reference(models, kv):
    jctx, pctx = contexts(models, kv)
    js, ps = jctx.new_seq(), pctx.new_seq()
    jctx.prefill(js, PROMPT[:10])
    pctx.prefill(ps, PROMPT[:10])
    jc, pc = jctx.fork_seq(js), pctx.fork_seq(ps)
    assert pc.table.blocks == ps.table.blocks      # shared until a write
    for jt, pt in ((5, 5), (9, 9)):
        jl = jctx.decode([js, jc], [jt, 200 - jt])
        pl = pctx.decode([ps, pc], [pt, 200 - pt])
        assert_close(jctx, pctx, js, ps, jl[0], pl[0])
        assert_close(jctx, pctx, jc, pc, jl[1], pl[1])
    assert pc.table.blocks[-1] != ps.table.blocks[-1]   # the copy happened
    assert pc.table.blocks[0] == ps.table.blocks[0]     # the full block stays
    assert not pc.table.pending_copies and not ps.table.pending_copies


def test_truncate_then_decode_matches_reference(models):
    jctx, pctx = contexts(models)
    js, ps = jctx.new_seq(), pctx.new_seq()
    jctx.prefill(js, PROMPT[:14])
    pctx.prefill(ps, PROMPT[:14])
    jctx.truncate_seq(js, 7)
    pctx.truncate_seq(ps, 7)
    assert ps.table.blocks == js.table.blocks
    jl = jctx.prefill(js, PROMPT[14:18])
    pl = pctx.prefill(ps, PROMPT[14:18])
    assert_close(jctx, pctx, js, ps, jl, pl)
    with pytest.raises(ValueError):
        pctx.truncate_seq(ps, 40)


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
def test_shift_context_matches_reference(models, kv):
    jctx, pctx = contexts(models, kv)
    js, ps = jctx.new_seq(), pctx.new_seq()
    jctx.prefill(js, PROMPT[:20])
    pctx.prefill(ps, PROMPT[:20])
    # a fork shares the blocks the shift rewrites: they are un-shared first
    jf, pf = jctx.fork_seq(js), pctx.fork_seq(ps)
    jctx.shift_context(js, 3, 6)
    pctx.shift_context(ps, 3, 6)
    for t in (5, 77, 130):
        jl, pl = jctx.decode([js], [t])[0], pctx.decode([ps], [t])[0]
        assert_close(jctx, pctx, js, ps, jl, pl)
    # the fork still holds the unshifted cache
    jl, pl = jctx.decode([jf], [5])[0], pctx.decode([pf], [5])[0]
    assert_close(jctx, pctx, jf, pf, jl, pl)


def test_compact_reuse_matches_reference(models):
    jctx, pctx = contexts(models)
    js, ps = jctx.new_seq(), pctx.new_seq()
    jctx.prefill(js, PROMPT[:22])
    pctx.prefill(ps, PROMPT[:22])
    # the cached tokens 4..8 are gone from the new prompt: 9..17 shift down
    new = PROMPT[:4] + PROMPT[9:18] + [99, 98]
    n = jctx.compact_reuse(js, new, 4, max_keep=len(new) - 1)
    assert pctx.compact_reuse(ps, new, 4, max_keep=len(new) - 1) == n
    assert n == 13
    jl, pl = jctx.prefill(js, new[n:]), pctx.prefill(ps, new[n:])
    assert_close(jctx, pctx, js, ps, jl, pl)


def test_self_extend_matches_reference(models):
    jctx, pctx = contexts(models)
    js, ps = jctx.new_seq(), pctx.new_seq()
    jctx.prefill(js, PROMPT[:17])
    pctx.prefill(ps, PROMPT[:17])
    jctx.self_extend(js, 4, 2)
    pctx.self_extend(ps, 4, 2)
    assert ps.pos_offset == js.pos_offset < 0
    jl, pl = jctx.decode([js], [11])[0], pctx.decode([ps], [11])[0]
    assert_close(jctx, pctx, js, ps, jl, pl)
    jl, pl = jctx.prefill(js, PROMPT[17:21]), pctx.prefill(ps, PROMPT[17:21])
    assert_close(jctx, pctx, js, ps, jl, pl)
    with pytest.raises(NotImplementedError):
        pctx.decode_window([ps], [1], [None], 2)


def test_prefill_batch_matches_reference(models):
    jctx, pctx = contexts(models)
    jseqs = [jctx.new_seq() for _ in range(3)]
    pseqs = [pctx.new_seq() for _ in range(3)]
    for i in range(3):
        jctx.prefill(jseqs[i], PROMPT[i: i + 5 + 2 * i])
        pctx.prefill(pseqs[i], PROMPT[i: i + 5 + 2 * i])
    rows = [PROMPT[10:13], PROMPT[5:6], PROMPT[12:19]]
    jl, pl = jctx.prefill_batch(jseqs, rows), pctx.prefill_batch(pseqs, rows)
    for i in range(3):
        assert pl[i].shape == jl[i].shape == (len(rows[i]), 288)
        assert_close(jctx, pctx, jseqs[i], pseqs[i], jl[i], pl[i])


# the tests run op by op share their shapes (n_ctx 32: tables of 4 blocks,
# prompts of at most 8 tokens, decode rows 1 or 4), so JAX builds each op
# once
OP_BY_OP = dict(n_ctx=32, n_seq_max=4)


def test_candidate_downloads_match_reference_op_by_op(models):
    jctx, pctx = contexts(models, **OP_BY_OP)
    with jax.disable_jit():
        js = jctx.new_seq()
        jv, ji = jctx.prefill(js, PROMPT[:7], top_k=16)
        jv2, ji2 = jctx.decode([js], [int(ji[0])], top_k=16)
    ps = pctx.new_seq()
    pv, pi = pctx.prefill(ps, PROMPT[:7], top_k=16)
    np.testing.assert_array_equal(pi, ji)
    assert nmse(jv, pv) < 1e-10
    pv2, pi2 = pctx.decode([ps], [int(pi[0])], top_k=16)
    assert pi2.shape == (1, 16) and pi2.dtype == np.int32
    np.testing.assert_array_equal(pi2, ji2)
    assert nmse(jv2, pv2) < 1e-10


WINDOW_ROWS = [dict(temp=0.0),
               dict(temp=0.8, top_k=40, top_p=0.95, min_p=0.05,
                    penalty_repeat=1.1, seed=5),
               dict(temp=1.2, top_k=20, seed=9)]


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
def test_decode_window_chain_matches_reference_op_by_op(models, kv):
    """Three rows (greedy, two seeded) through a window of 4 and a window
    of 4 chained on the device, against the JAX windows run op by op;
    then the greedy row against the port's per-token decode."""
    jctx, pctx = contexts(models, kv, **OP_BY_OP)
    jseqs = [jctx.new_seq() for _ in WINDOW_ROWS]
    pseqs = [pctx.new_seq() for _ in WINDOW_ROWS]
    first = [int(np.argmax(pctx.prefill(pseqs[i], PROMPT[i: i + 6 + i])))
             for i in range(3)]
    with jax.disable_jit():
        for i in range(3):
            jctx.prefill(jseqs[i], PROMPT[i: i + 6 + i])
        h = jctx.decode_window_async(jseqs, first,
                                     [JParams(**r) for r in WINDOW_ROWS], 4,
                                     seed=3)
        h2 = jctx.decode_window_async(jseqs, n_steps=4, carry=h)
        want = np.concatenate([h.fetch(), h2.fetch()])
    ph = pctx.decode_window_async(pseqs, first,
                                  [PParams(**r) for r in WINDOW_ROWS], 4,
                                  seed=3)
    ph2 = pctx.decode_window_async(pseqs, n_steps=4, carry=ph)
    with pytest.raises(RuntimeError):
        ph2.fetch()                       # a chain is fetched in order
    got = np.concatenate([ph.fetch(), ph2.fetch()])
    np.testing.assert_array_equal(got, want)
    for js, ps in zip(jseqs, pseqs):
        assert ps.tokens == js.tokens and ps.n_cached == js.n_cached
        assert nmse(cached_kv(jctx, js), cached_kv(pctx, ps)) < GATE
    # the greedy row by per-token decode on a fresh context
    _, qctx = contexts(models, kv, **OP_BY_OP)
    q = qctx.new_seq()
    tok = int(np.argmax(qctx.prefill(q, PROMPT[:6])))
    steps = []
    for _ in range(8):
        tok = int(np.argmax(qctx.decode([q], [tok])[0]))
        steps.append(tok)
    assert steps == got[:, 0].tolist()


def test_draft_window_matches_reference_op_by_op(models):
    jctx, pctx = contexts(models, **OP_BY_OP)
    js, ps = jctx.new_seq(), pctx.new_seq()
    pctx.prefill(ps, PROMPT[:7])
    with jax.disable_jit():
        jctx.prefill(js, PROMPT[:7])
        jt, jp = jctx.draft_window([js], [5], 5)
    pt, pp = pctx.draft_window([ps], [5], 5)
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_allclose(pp, jp, rtol=1e-4)
    assert ps.tokens == js.tokens


def test_generate_shifts_past_n_ctx_as_reference_op_by_op(models):
    jctx, pctx = contexts(models, **OP_BY_OP)
    with jax.disable_jit():
        want = list(jengine.generate(jctx, PROMPT[:5], 40, n_keep=1))
    got = list(pengine.generate(pctx, PROMPT[:5], 40, n_keep=1))
    assert len(got) == 40 and got == want
    with pytest.raises(ValueError, match="n_ctx"):
        list(pengine.generate(pctx, PROMPT[:5], 40, ctx_shift=False))


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
def test_host_swap_round_trips_blocks_bit_exact(models, kv):
    """A block read to the host and written to another block holds the
    same bits; a sequence whose blocks were evicted to the host and swapped
    back decodes the same logits, to the bit, as one never evicted."""
    _, ref = contexts(models, kv)
    r = ref.new_seq()
    ref.prefill(r, PROMPT[:16])
    want = ref.decode([r], [5])[0]
    _, ctx = contexts(models, kv, num_blocks=4)
    a = ctx.new_seq()
    ctx.prefill(a, PROMPT[:16])                  # blocks 0-1 of 4
    blk = a.table.blocks[0]
    data = ctx._read_block(blk)
    assert all(t.device.type == "cpu" for t in data)
    b = ctx.new_seq()
    ctx.prefill(b, PROMPT[8:24])                 # fills the pool
    c = ctx.new_seq()
    ctx.prefill(c, PROMPT[:8])                   # evicts a's LRU block
    assert ctx.mgr.swap.n_swapped_out >= 1
    assert any(not isinstance(x, int) for x in a.table.blocks)
    got = ctx.decode([a], [5])[0]                # swaps a back in
    assert ctx.mgr.swap.n_swapped_in >= 1
    np.testing.assert_array_equal(got, want)
    # round trip of one block's payload into another block
    spare = [x for x in range(4) if x not in a.table.blocks][0]
    kv_cache.scatter_block(ctx.pools, data, spare)
    again = kv_cache.gather_block(ctx.pools, spare)
    for x, y in zip(data, again):
        assert torch.equal(x, y)


def test_abort_callback_raises(models):
    _, pctx = contexts(models)
    s = pctx.new_seq()
    pctx.abort_callback = lambda: True
    with pytest.raises(DecodeAborted):
        pctx.prefill(s, PROMPT[:4])
    pctx.abort_callback = None
    pctx.prefill(s, PROMPT[:4])


def test_kv_overrides_match_reference(models):
    path = models[1].path
    ov = {"*.rope.freq_base": 5000.0, "llama.context_length": 128}
    j = jengine.Model(path, kv_overrides=dict(ov))
    p = pengine.Model(path, device="cpu", kv_overrides=dict(ov))
    assert p.hp.rope_freq_base == j.hp.rope_freq_base == 5000.0
    np.testing.assert_array_equal(p.weights.rope_inv_freq.numpy(),
                                  np.asarray(j.weights.rope_inv_freq))
    assert p.tokenizer.encode("hello world") == \
        j.tokenizer.encode("hello world")


def test_block_table_covers_n_ctx(models):
    """With a block size that does not divide n_ctx, a sequence of n_ctx
    tokens still attends over all of them: the port's table holds
    ceil(n_ctx / block_size) blocks, so it decodes as a context whose
    n_ctx is a multiple (the reference floors the width and drops the last
    block from attention, ROADMAP §3)."""
    _, full = contexts(models, n_ctx=32, block_size=16)
    _, cut = contexts(models, n_ctx=24, block_size=16)
    assert cut.nbmax == 2
    outs = []
    for ctx in (full, cut):
        s = ctx.new_seq()
        ctx.prefill(s, PROMPT[:20])
        outs.append([ctx.decode([s], [t])[0] for t in (5, 6, 7)])
        win = ctx.decode_window([s], [8], [None], 1)
        outs[-1].append(win)
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_fork_keeps_the_self_extend_offset(models):
    """A fork of a self-extended sequence ropes its next token where the
    parent does (the reference's fork_seq leaves pos_offset at 0,
    ROADMAP §3): both decode the same token to the same logits."""
    _, ctx = contexts(models)
    s = ctx.new_seq()
    ctx.prefill(s, PROMPT[:17])
    ctx.self_extend(s, 4, 2)
    child = ctx.fork_seq(s)
    assert child.pos_offset == s.pos_offset < 0
    a, b = ctx.decode([s, child], [11, 11])
    np.testing.assert_array_equal(a, b)
