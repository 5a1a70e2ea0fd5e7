"""Speculative decoding in the port (llama_cpp_test_tpu_torch/runtime/
speculative.py and the Scheduler's draft path) against the JAX package:
the scenarios of tests/test_speculative.py and
tests/test_server_speculative.py run through both on the tiny Q8_0
fixture (target seed 0, an imperfect draft of seed 1). Greedy output must
equal the port's non-speculative output exactly (the plain path on the
CPU does not depend on the batch's rows) and the JAX decoder's tokens,
with the same draft and acceptance counters. The sampled scenario runs
the JAX engine op by op, whose bf16 roundings the port keeps."""
import asyncio
import dataclasses
import types

import jax
import pytest
import torch

from test_engine import make_tiny_gguf

from llama_cpp_test_tpu.runtime import engine as jengine
from llama_cpp_test_tpu.runtime import sampling as jsampling
from llama_cpp_test_tpu.runtime import scheduler as jscheduler
from llama_cpp_test_tpu.runtime import speculative as jspec
from llama_cpp_test_tpu_torch.runtime import engine as pengine
from llama_cpp_test_tpu_torch.runtime import sampling as psampling
from llama_cpp_test_tpu_torch.runtime import scheduler as pscheduler
from llama_cpp_test_tpu_torch.runtime import speculative as pspec

PROMPT = [3, 17, 42, 9]


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
    d = tmp_path_factory.mktemp("spec")
    target, draft = str(d / "target.gguf"), str(d / "draft.gguf")
    make_tiny_gguf(target, seed=0)
    make_tiny_gguf(draft, seed=1)   # other weights: an imperfect draft
    j = types.SimpleNamespace(
        eng=jengine, spec=jspec, sch=jscheduler, smp=jsampling,
        target=jengine.Model(target), draft=jengine.Model(draft))
    p = types.SimpleNamespace(
        eng=pengine, spec=pspec, sch=pscheduler, smp=psampling,
        target=pengine.Model(target, device="cpu"),
        draft=pengine.Model(draft, device="cpu"), path=target)
    return j, p


def ctx(m, model, n_seq_max=1, **kw):
    return m.eng.Context(model, n_ctx=128, n_seq_max=n_seq_max, **kw)


def greedy(m, n):
    return list(m.eng.generate(ctx(m, m.target, block_size=8), PROMPT, n))


def speculative(m, draft, n_draft, n):
    dec = m.spec.SpeculativeDecoder(
        ctx(m, m.target, block_size=8), ctx(m, draft, block_size=8),
        m.spec.SpecParams(n_draft=n_draft, p_min=0.0))
    return dec.generate(PROMPT, n), dataclasses.astuple(dec.stats)


@pytest.mark.parametrize("n_draft", [1, 4, 8])
def test_speculative_exactness_imperfect_draft(sides, n_draft):
    j, p = sides
    out, stats = speculative(p, p.draft, n_draft, 16)
    assert out == greedy(p, 16)
    assert (out, stats) == speculative(j, j.draft, n_draft, 16)


def test_speculative_perfect_draft_accepts(sides):
    """Draft == target: acceptance near 1, fewer target calls than
    tokens."""
    j, p = sides
    out, stats = speculative(p, p.target, 6, 24)
    assert out == greedy(p, 24)
    with jax.disable_jit():   # jitted XLA flips a near tie at token 17
        assert (out, stats) == speculative(j, j.target, 6, 24)
    calls, drafted, accepted = stats
    assert accepted / drafted > 0.95 and calls < len(out)


def test_tree_speculative_matches_greedy(sides):
    """Tree speculation (n_seq_dft branches) is lossless against plain
    greedy and splits where the JAX decoder splits."""
    j, p = sides

    def tree(m):
        dec = m.spec.TreeSpeculativeDecoder(
            ctx(m, m.target), ctx(m, m.target, n_seq_max=8),
            m.spec.TreeSpecParams(n_draft=4, n_seq_dft=3, p_split=0.05))
        got = dec.generate(PROMPT, 20)
        return got, dataclasses.astuple(dec.stats), dec.n_splits

    got, stats, splits = tree(p)
    assert got == list(p.eng.generate(ctx(p, p.target), PROMPT, 20))
    with jax.disable_jit():   # jitted XLA flips a near tie at token 17
        assert (got, stats, splits) == tree(j)
    assert stats[2] >= 10 and stats[2] / stats[1] > 0.2


def run_sched(m, prompts, draft=False, max_tokens=20, temp=0.0):
    c = ctx(m, m.target, n_seq_max=4, block_size=8)
    dc = ctx(m, m.target, n_seq_max=4, block_size=8) if draft else None
    sched = m.sch.Scheduler(c, n_slots=2, draft_ctx=dc, n_draft=4,
                            p_draft_min=0.0)
    reqs = [sched.submit(m.sch.GenRequest(
        prompt_tokens=q, max_tokens=max_tokens,
        sampling=m.smp.SamplerParams(temp=temp, seed=7))) for q in prompts]
    sched.run()
    counters = [(s.n_drafted, s.n_draft_accepted) for s in sched.slots]
    return sched, [(r.finish_reason, r.output_tokens) for r in reqs], counters


def test_speculative_matches_plain_greedy(sides):
    j, p = sides
    prompts = [[3, 17, 42, 5], [9, 1, 2, 7, 8]]
    _, plain, _ = run_sched(p, prompts)
    _, spec, counters = run_sched(p, prompts, draft=True)
    assert spec == plain
    assert (spec, counters) == run_sched(j, prompts, draft=True)[1:]
    drafted = sum(d for d, _ in counters)
    assert drafted > 0 and sum(a for _, a in counters) / drafted > 0.9


def test_speculative_frees_draft_blocks(sides):
    _, p = sides
    sched, _, _ = run_sched(p, [[3, 17, 42]], draft=True, max_tokens=8)
    assert all(s.draft_seq is None for s in sched.slots)
    assert sched.draft_ctx.mgr.num_free() == sched.draft_ctx.num_blocks


def test_speculative_with_sampled_chain(sides):
    """A seeded stochastic chain through sample-and-accept: every emitted
    token is sampled from the target's verification logits by the slot's
    own chain, so the tokens and counters equal the JAX scheduler's."""
    j, p = sides
    _, spec, counters = run_sched(p, [[3, 17, 42, 5]], draft=True, temp=0.8)
    with jax.disable_jit():
        want = run_sched(j, [[3, 17, 42, 5]], draft=True, temp=0.8)[1:]
    assert (spec, counters) == want
    assert spec[0][0] in ("stop", "length") and spec[0][1]
    assert sum(d for d, _ in counters) > 0


def test_server_boot_with_draft(sides):
    """LlamaServer(-md) boots on the port and serves a greedy completion
    equal to the server without a draft."""
    pytest.importorskip("aiohttp")
    from aiohttp.test_utils import TestClient, TestServer

    from llama_cpp_test_tpu_torch.server.app import LlamaServer

    _, p = sides

    def serve(**kw):
        srv = LlamaServer(p.path, n_ctx=64, n_slots=2, device="cpu", **kw)
        srv.engine.start()
        loop = asyncio.new_event_loop()

        async def go():
            c = TestClient(TestServer(srv.make_app()))
            await c.start_server()
            try:
                r = await asyncio.wait_for(c.post("/completion", json={
                    "prompt": [3, 17, 42], "n_predict": 8,
                    "temperature": 0.0}), 60)
                return r.status, await r.json()
            finally:
                await c.close()

        try:
            return srv, loop.run_until_complete(go())
        finally:
            srv.engine.stop()
            loop.close()
            assert not srv.engine.thread.is_alive()

    srv, (status, body) = serve(draft_model_path=p.path, n_draft=4,
                                p_draft_min=0.0)
    assert status == 200 and body["usage"]["completion_tokens"] > 0
    assert sum(s.n_drafted for s in srv.sched.slots) > 0
    assert body["choices"][0]["text"] == \
        serve()[1][1]["choices"][0]["text"]
