"""The port's continuous-batching scheduler (llama_cpp_test_tpu_torch/
runtime/scheduler.py over the port's Context) against the JAX Scheduler:
the scenarios of tests/test_scheduler.py and tests/test_ctx_shift.py run
through both, on the tiny Q8_0 fixture, must give the same tokens, finish
reasons, prefilled-token counts and path counters. Scenarios that sample
stochastically run the JAX engine op by op (jax.disable_jit()), whose
bf16 roundings the port keeps; the greedy ones run it jitted."""
import contextlib
import types

import jax
import pytest
import torch

from test_engine import make_tiny_gguf

import llama_cpp_test_tpu.runtime.device_sampling as jds
import llama_cpp_test_tpu_torch.runtime.device_sampling as pds
from llama_cpp_test_tpu.runtime import engine as jengine
from llama_cpp_test_tpu.runtime import sampling as jsampling
from llama_cpp_test_tpu.runtime import scheduler as jscheduler
from llama_cpp_test_tpu_torch.runtime import engine as pengine
from llama_cpp_test_tpu_torch.runtime import sampling as psampling
from llama_cpp_test_tpu_torch.runtime import scheduler as pscheduler


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist every
    worker's OpenMP pool takes all cores, and the small steps these
    scenarios run by the hundred spin against each other (a 13 s module
    took minutes beside five other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("s") / "tiny.gguf")
    make_tiny_gguf(path)
    j = types.SimpleNamespace(eng=jengine, sch=jscheduler, smp=jsampling,
                              ds=jds, model=jengine.Model(path))
    p = types.SimpleNamespace(eng=pengine, sch=pscheduler, smp=psampling,
                              ds=pds, model=pengine.Model(path, device="cpu"))
    return j, p


def make(m, n_slots=4, n_ctx=64, **kw):
    ctx = m.eng.Context(m.model, n_ctx=n_ctx, n_seq_max=n_slots, block_size=8)
    return m.sch.Scheduler(ctx, n_slots=n_slots, chunk_size=16, **kw)


def req(m, prompt, n, **kw):
    sp = kw.pop("sampling", None) or m.smp.SamplerParams(temp=0.0)
    return m.sch.GenRequest(list(prompt), max_tokens=n, sampling=sp,
                            ignore_eos=True, **kw)


def out(r):
    return (r.finish_reason, list(r.output_tokens))


def concurrent(m):
    s = make(m, n_slots=4)
    rs = [s.submit(req(m, [3, 17, 42 + i], 6)) for i in range(6)]
    s.run()
    return [out(r) for r in rs]


def prefix_reuse(m):
    s = make(m, n_slots=1)
    r1 = s.submit(req(m, [3, 17, 42, 9, 5], 4))
    s.run()
    before = s.n_prompt_tokens
    r2 = s.submit(req(m, [3, 17, 42, 9, 5], 4))
    s.run()
    return out(r1), out(r2), s.n_prompt_tokens - before


def stop_string(m):
    s = make(m)
    probe = s.submit(req(m, [3, 17, 42], 4))
    s.run()
    piece = m.model.tokenizer.token_to_piece(probe.output_tokens[1])
    r = s.submit(req(m, [3, 17, 42], 8, stop_strings=[piece]))
    s.run()
    return out(probe), piece, out(r)


def chunk_capped(m):
    ctx = m.eng.Context(m.model, n_ctx=1024, n_seq_max=2, block_size=8,
                        num_blocks=256)
    s = m.sch.Scheduler(ctx, n_slots=2, chunk_size=512, decode_window=1)
    r1 = s.submit(req(m, [3, 17, 42], 8))
    s.step()
    r2 = s.submit(req(m, list(range(3, 3 + 300)), 4))
    steps = 0
    while s.slots[1].state.name != "GENERATING" and steps < 10:
        s.step()
        steps += 1
    s.run()
    return steps, out(r1), out(r2)


def cache_reuse(m):
    first = [3, 17, 42, 9, 105, 77, 12, 54, 33, 21, 44, 61]
    second = first[:4] + first[6:]
    res = []
    for n in (0, 2):
        ctx = m.eng.Context(m.model, n_ctx=64, n_seq_max=2, block_size=8)
        s = m.sch.Scheduler(ctx, n_slots=1, chunk_size=16, cache_reuse=n)
        s.submit(req(m, first, 3))
        s.run()
        before = s.n_prompt_tokens
        r = s.submit(req(m, second, 3))
        s.run()
        res.append((s.n_prompt_tokens - before, out(r)))
    return res


def mixed_eligibility(m):
    ctx = m.eng.Context(m.model, n_ctx=128, n_seq_max=4, block_size=8)
    s = m.sch.Scheduler(ctx, n_slots=3, chunk_size=16, decode_window=4)
    rs = [s.submit(req(m, [3, 17, 42], 12)), s.submit(req(m, [9, 4], 12)),
          s.submit(req(m, [7, 1, 2], 4, sampling=m.smp.SamplerParams(
              temp=0.7, mirostat=2, seed=3)))]
    s.run()
    mt = s.metrics()
    return [out(r) for r in rs], mt["gen_tokens_fast_path"], \
        mt["gen_tokens_slow_path"]


def grammar_candidates(m):
    res = []
    for k in (m.ds.HOST_CANDIDATES_K, 4):
        old, m.ds.HOST_CANDIDATES_K = m.ds.HOST_CANDIDATES_K, k
        try:
            s = make(m, n_slots=1)
            r = s.submit(req(m, [3, 17], 3, sampling=m.smp.SamplerParams(
                temp=0.7, top_k=20 if k > 4 else 2, seed=5,
                grammar="root ::= [0-9]+")))
            s.run()
        finally:
            m.ds.HOST_CANDIDATES_K = old
        mt = s.metrics()
        res.append((out(r), mt["gen_tokens_candidate_path"],
                    mt["candidate_path_fallbacks"]))
    return res


def seeded_windows(m):
    """Two seeded rows and a greedy one through device windows, chained."""
    ctx = m.eng.Context(m.model, n_ctx=64, n_seq_max=4, block_size=8)
    s = m.sch.Scheduler(ctx, n_slots=3, chunk_size=16, decode_window=4)
    sp = [m.smp.SamplerParams(temp=0.8, top_k=40, top_p=0.95, min_p=0.05,
                              penalty_repeat=1.1, seed=7),
          m.smp.SamplerParams(temp=1.1, top_k=10, seed=8),
          m.smp.SamplerParams(temp=0.0)]
    rs = [s.submit(req(m, [3, 17 + i, 42], 9, sampling=p))
          for i, p in enumerate(sp)]
    s.run()
    mt = s.metrics()
    return [out(r) for r in rs], mt["gen_tokens_fast_path"], \
        mt["windows_chained"]


def context_shift(m):
    ctx = m.eng.Context(m.model, n_ctx=32, n_seq_max=2, block_size=8)
    s = m.sch.Scheduler(ctx, n_slots=1, chunk_size=16)
    r = s.submit(req(m, [3, 17, 42], 48))
    s.run()
    return out(r)


# name -> (scenario, run the JAX side op by op)
SCENARIOS = {
    "concurrent": (concurrent, False),
    "prefix_reuse": (prefix_reuse, False),
    "stop_string": (stop_string, False),
    "chunk_capped": (chunk_capped, False),
    "cache_reuse": (cache_reuse, False),
    "mixed_eligibility": (mixed_eligibility, True),
    "grammar_candidates": (grammar_candidates, True),
    "seeded_windows": (seeded_windows, True),
    "context_shift": (context_shift, False),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_reference(sides, name):
    fn, op_by_op = SCENARIOS[name]
    j, p = sides
    with jax.disable_jit() if op_by_op else contextlib.nullcontext():
        want = fn(j)
    assert fn(p) == want


def test_draft_ctx_serves(sides):
    """A Scheduler with a draft Context serves and drafts
    (tests/test_torch_speculative.py holds it against the JAX one)."""
    _, p = sides
    ctx = p.eng.Context(p.model, n_ctx=64, n_seq_max=1, block_size=8)
    draft = p.eng.Context(p.model, n_ctx=64, n_seq_max=1, block_size=8)
    s = p.sch.Scheduler(ctx, draft_ctx=draft, p_draft_min=0.0)
    r = s.submit(req(p, [3, 17, 42], 6))
    s.run()
    assert r.finish_reason == "length" and len(r.output_tokens) == 6
    assert s.slots[0].n_drafted > 0


def test_one_slot_readmits_what_its_cache_holds(sides):
    """Reference fault 7: admission counts only the pool's free blocks, so
    a request needing more blocks than are free waits for ever behind the
    idle cache of the one slot that would serve it (the JAX scheduler).
    The port counts that slot's own cache, which assignment truncates to
    the reused prefix, and serves the request with a fresh scheduler's
    tokens."""
    j, p = sides
    prompt = list(range(3, 43))   # 5 of the pool's 8 blocks

    def run(m, steps, warm=True):
        ctx = m.eng.Context(m.model, n_ctx=64, n_seq_max=1, block_size=8)
        s = m.sch.Scheduler(ctx, n_slots=1, chunk_size=64)
        if warm:
            s.submit(req(m, prompt, 1))
            s.run()
        r = s.submit(req(m, prompt, 8))   # needs 6 blocks, 3 are free
        for _ in range(steps):
            if not s.has_work():
                break
            s.step()
        return r

    stuck = run(j, 30)
    assert stuck.finish_reason is None and not stuck.output_tokens
    got = run(p, 100)
    assert out(got) == out(run(p, 100, warm=False))
    assert got.finish_reason == "length"


def alone(m, prompt, n):
    s = make(m, n_slots=2)
    r = s.submit(req(m, prompt, n))
    s.run()
    return r


def test_long_max_tokens_does_not_block_the_queue(sides):
    """Reference fault 28: admission asks for the blocks of prompt +
    max_tokens, so a request whose max_tokens outruns the whole pool is
    never admitted and holds every request behind it in the queue (the
    JAX scheduler). A slot never holds more than n_ctx tokens, so the
    port caps the ask at the block table's width: both requests finish,
    the long one through context shifts."""
    j, p = sides

    def pair(m):
        s = make(m, n_slots=2)          # 16 blocks of 8; 500 tokens ask 63
        return s, s.submit(req(m, [3, 17, 42], 500)), \
            s.submit(req(m, [9, 4, 7, 22], 6))

    s, long, short = pair(j)
    for _ in range(200):
        s.step()
    assert long.finish_reason is None and short.finish_reason is None
    assert len(s.queue) == 2
    s, long, short = pair(p)
    s.run()
    assert (long.finish_reason, len(long.output_tokens)) == ("length", 500)
    assert out(short) == out(alone(p, [9, 4, 7, 22], 6))


def test_prompt_longer_than_n_ctx_is_refused_at_submit(sides):
    """Reference fault 27: the port's Scheduler refuses a prompt longer
    than n_ctx when it is submitted, naming n_ctx, and serves the next
    request; the JAX Scheduler takes it."""
    _, p = sides
    s = make(p, n_slots=2)
    with pytest.raises(ValueError, match="n_ctx=64"):
        s.submit(req(p, list(range(3, 83)), 4))
    r = s.submit(req(p, [3, 17, 42], 4))
    s.run()
    assert r.finish_reason == "length" and len(r.output_tokens) == 4
