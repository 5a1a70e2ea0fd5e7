"""Mamba and the recurrent state pool of the port (llama_cpp_test_tpu_torch
models/mamba.py, runtime/recurrent.py, the Scheduler's capability flags,
the recurrent branches of cli/main.py and server/app.py) against the
JAX package, on CPU, in one process, from numpy seeds.

The fixture is tests/test_mamba's HF checkpoint (width 64, d_inner 128,
d_state 16, d_conv 4, 2 layers, vocab 256 of <tN> tokens) converted once
by the reference's converter (F32), and a copy without output.weight
and the conv and dt biases (a tied head, zero biases).

Checks: all-position prefill logits and the state after it within NMSE
1e-8 of the JAX _forward_tokens; step-by-step decode equal to one
prefill; greedy tokens equal; port_mamba_from_reference equal to the
port's loader bit for bit; RecurrentContext.prefill at n = 1, 5, 9 and
17 (bucket middles) against the reference's masked _rec_prefill, and
its batched decode at B = 1, 3 and 5 on reused rows against _rec_decode;
shift_context as bookkeeping; truncate_seq refused; the Scheduler's
greedy tokens (one sequence, chunked prefill, concurrent, past n_ctx)
equal to the reference Scheduler's over its RecurrentContext; the server
over HTTP (/props, /completion, a streamed chat, /embeddings and slot
save answering 400, a draft model or LoRA refused); cli.main's printout
equal to the JAX CLI's, and its paged-only options refused; the paged
Model refusing each recurrent arch by its class; check_arch still
refusing t5 naming its model class; and a paged Context still taking the candidate
prefill, the host-candidates decode, prefix reuse and decode windows.
"""
import asyncio
import io
import json
import sys

import numpy as np
import pytest
import torch

from test_engine import make_tiny_gguf
from test_mamba import _mamba_ws, _write_hf

from llama_cpp_test_tpu.cli.main import main as jmain
from llama_cpp_test_tpu.models import mamba as jmamba
from llama_cpp_test_tpu.runtime import recurrent as jrec
from llama_cpp_test_tpu.runtime.sampling import SamplerParams as JParams
from llama_cpp_test_tpu.runtime.scheduler import (GenRequest as JRequest,
                                                  Scheduler as JScheduler)
from llama_cpp_test_tpu.tools.convert_hf import convert
from llama_cpp_test_tpu_torch.cli.main import main as pmain
from llama_cpp_test_tpu_torch.gguf.reader import GGUFReader as PReader
from llama_cpp_test_tpu_torch.gguf.writer import GGUFWriter as PWriter
from llama_cpp_test_tpu_torch.models import mamba as pmamba
from llama_cpp_test_tpu_torch.models import registry as pregistry
from llama_cpp_test_tpu_torch.runtime import engine as pengine
from llama_cpp_test_tpu_torch.runtime import recurrent as prec
from llama_cpp_test_tpu_torch.runtime import scheduler as psched
from llama_cpp_test_tpu_torch.runtime.sampling import SamplerParams
from llama_cpp_test_tpu_torch.weights import port_mamba_from_reference

GATE = 1e-8                      # f32 logits and states against the JAX run
PROMPT = [3, 17, 42, 9, 150, 7]
V = 256


def nmse(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(((a - b) ** 2).mean() / ((b * b).mean() + 1e-30))


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mamba")
    out = str(tmp / "mamba.gguf")
    convert(_write_hf(tmp, _mamba_ws(np.random.default_rng(401))), out,
            dtype="F32")
    return out


@pytest.fixture(scope="module")
def jm(path):
    return jmamba.MambaModel(path)


@pytest.fixture(scope="module")
def pm(path):
    return pmamba.MambaModel(path, device="cpu")


def _states_match(pstates, jstates) -> None:
    for a, b in zip(pstates, jstates):
        assert a.shape[1:] == b.shape
        assert nmse(a[0].numpy(), np.asarray(b)) < GATE


def test_mamba_prefill_logits_and_state_match_reference(jm, pm):
    jctx, pctx = jmamba.MambaContext(jm), pmamba.MambaContext(pm)
    want = jctx.prefill(PROMPT, all_logits=True)
    got = pctx.prefill(PROMPT, all_logits=True)
    assert got.shape == want.shape == (len(PROMPT), V)
    assert nmse(got, want) < GATE
    _states_match(pctx.states, jctx.states)


def test_mamba_stepwise_decode_equals_prefill(pm):
    full = pmamba.MambaContext(pm)
    lf = full.prefill(PROMPT)
    step = pmamba.MambaContext(pm)
    step.prefill(PROMPT[:1])
    for t in PROMPT[1:-1]:
        step.decode(t)
    np.testing.assert_allclose(step.decode(PROMPT[-1]), lf, rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(step.states, full.states):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_mamba_greedy_tokens_match_reference(jm, pm):
    want = list(jmamba.generate(jmamba.MambaContext(jm), PROMPT, 8))
    got = list(pmamba.generate(pmamba.MambaContext(pm), PROMPT, 8))
    assert got == want


def test_port_mamba_from_reference_equals_loader(jm, pm):
    fm = port_mamba_from_reference(jm, device="cpu")
    assert fm.hp == pm.hp and fm.tokenizer is None
    a, b = fm.weights, pm.weights
    for f in ("tok_embd", "output_norm", "output"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for la, lb in zip(a.layers, b.layers):
        for k, x in vars(la).items():
            assert x.dtype == torch.float32 and torch.equal(
                x, getattr(lb, k)), k


def _without(src: str, dst: str, drop) -> str:
    """A copy of GGUF src without the tensors drop(name) selects."""
    r = PReader(src)
    w = PWriter(dst)
    for k, v in r.metadata.items():
        if k not in ("GGUF.version", "general.alignment"):
            w.add_kv(k, v)
    for name, info in r.tensors.items():
        if not drop(name):
            w.add_tensor(name, np.array(r.tensor_bytes(name)),
                         ggml_type=info.ggml_type,
                         raw_ggml_shape=info.shape)
    w.write()
    return dst


def test_mamba_tied_head_and_absent_biases(path, tmp_path):
    """A file without output.weight ties the head to the embedding; absent
    conv and dt biases are zeros: logits as the reference's."""
    p = _without(path, str(tmp_path / "tied.gguf"), lambda n: n == (
        "output.weight") or n.endswith(("ssm_conv1d.bias", "ssm_dt.bias")))
    jt, pt = jmamba.MambaModel(p), pmamba.MambaModel(p, device="cpu")
    assert pt.weights.output is pt.weights.tok_embd
    assert pt.weights.layers[0].conv_b is None
    ws = pmamba._layer_ws(pt.weights.layers[0])
    assert not ws[3].any() and not ws[6].any()
    want = jmamba.MambaContext(jt).prefill(PROMPT, all_logits=True)
    got = pmamba.MambaContext(pt).prefill(PROMPT, all_logits=True)
    assert nmse(got, want) < GATE


@pytest.fixture(scope="module")
def pools(jm, pm):
    return (jrec.RecurrentContext(jm, n_ctx=128, n_seq_max=6),
            prec.RecurrentContext(pm, n_ctx=128, n_seq_max=6))


@pytest.mark.parametrize("n", [1, 5, 9, 17])
def test_pool_prefill_matches_reference(pools, n):
    """The loop over n tokens equals the reference's scan over the n-token
    bucket's padding (masked steps keep the state and the last x)."""
    jctx, pctx = pools
    toks = [int(t) for t in np.random.default_rng(n).integers(1, V, n)]
    js, ps = jctx.new_seq(), pctx.new_seq()
    assert js.row == ps.row
    got, want = pctx.prefill(ps, toks), jctx.prefill(js, toks)
    assert nmse(got, want) < GATE
    for pj, pp in zip(jctx.pool, pctx.pool):
        assert nmse(pp[ps.row].numpy(), np.asarray(pj[js.row])) < GATE
    assert ps.n_cached == n and ps.tokens == toks
    with pytest.raises(NotImplementedError):
        pctx.prefill(ps, toks, all_logits=True)
    jctx.free_seq(js)
    pctx.free_seq(ps)


@pytest.mark.parametrize("b", [1, 3, 5])
def test_pool_decode_matches_reference(pools, b):
    """A batched step over b rows (one freed and taken again, the batch
    out of row order) against the reference's padded _rec_decode."""
    jctx, pctx = pools
    rng = np.random.default_rng(10 + b)
    js, ps = [], []
    for i in range(b + 1):
        toks = [int(t) for t in rng.integers(1, V, 3 + i)]
        js.append(jctx.new_seq())
        ps.append(pctx.new_seq())
        jctx.prefill(js[-1], toks)
        pctx.prefill(ps[-1], toks)
    jctx.free_seq(js.pop(0))
    pctx.free_seq(ps.pop(0))
    for step in range(2):
        order = list(range(b))[::-1]
        toks = [int(t) for t in rng.integers(1, V, b)]
        want = jctx.decode([js[i] for i in order], toks)
        got = pctx.decode([ps[i] for i in order], toks)
        assert got.shape == (b, V)
        assert nmse(got, want) < GATE
    for pj, pp in zip(jctx.pool, pctx.pool):
        for s in ps:
            assert nmse(pp[s.row].numpy(), np.asarray(pj[s.row])) < GATE
    for ctx, seqs in ((jctx, js), (pctx, ps)):
        for s in seqs:
            ctx.free_seq(s)


def test_shift_context_is_bookkeeping(pm):
    ctx = prec.RecurrentContext(pm, n_ctx=64, n_seq_max=2)
    s = ctx.new_seq()
    ctx.prefill(s, PROMPT)
    before = [p[s.row].clone() for p in ctx.pool]
    ctx.shift_context(s, 1, 3)
    assert s.tokens == PROMPT[:1] + PROMPT[4:] and s.n_cached == 3
    assert all(torch.equal(a, p[s.row]) for a, p in zip(before, ctx.pool))
    assert ctx.supports_candidates is False
    assert ctx.supports_prefix_reuse is False
    assert ctx.supports_windows is False


def test_truncate_seq_raises(pm):
    ctx = prec.RecurrentContext(pm, n_ctx=64, n_seq_max=1)
    s = ctx.new_seq()
    ctx.prefill(s, PROMPT)
    with pytest.raises(NotImplementedError, match="cannot rewind"):
        ctx.truncate_seq(s, 3)
    with pytest.raises(RuntimeError, match="no free"):
        ctx.new_seq()


def _sched_pair(jm, pm, prompts, n_slots=3, n_ctx=128, chunk=16,
                max_tokens=8):
    """The same greedy requests through the reference Scheduler over its
    RecurrentContext and the port's over its own: (reference tokens, port
    tokens, port requests, port scheduler)."""
    out = []
    for ctx_cls, sched_cls, req_cls, sp, m in (
            (jrec.RecurrentContext, JScheduler, JRequest, JParams, jm),
            (prec.RecurrentContext, psched.Scheduler, psched.GenRequest,
             SamplerParams, pm)):
        sched = sched_cls(ctx_cls(m, n_ctx=n_ctx, n_seq_max=n_slots),
                          n_slots=n_slots, chunk_size=chunk)
        reqs = [sched.submit(req_cls(p, max_tokens=max_tokens,
                                     ignore_eos=True,
                                     sampling=sp(temp=0.0, seed=i)))
                for i, p in enumerate(prompts)]
        sched.run()
        out.append(([r.output_tokens for r in reqs], reqs, sched))
    (want, _, _), (got, reqs, sched) = out
    return want, got, reqs, sched


def test_scheduler_single_sequence_matches_reference(jm, pm):
    want, got, reqs, sched = _sched_pair(jm, pm, [PROMPT])
    assert got == want and len(got[0]) == 8
    m = sched.metrics()
    assert m["gen_tokens_fast_path"] == m["gen_tokens_candidate_path"] == 0
    assert m["gen_tokens_slow_path"] == 7


def test_scheduler_chunked_prefill_matches_reference(jm, pm):
    rng = np.random.default_rng(5)
    prompt = [int(t) for t in rng.integers(3, 250, 23)]
    want, got, _, _ = _sched_pair(jm, pm, [prompt], chunk=8)
    assert got == want
    assert got[0] == list(pmamba.generate(pmamba.MambaContext(pm), prompt,
                                          8))


def test_scheduler_concurrent_equals_reference_and_solo(jm, pm):
    prompts = [[3, 17, 42], [9, 150, 7, 22], [100, 5]]
    want, got, _, _ = _sched_pair(jm, pm, prompts)
    assert got == want
    for p, toks in zip(prompts, got):
        assert toks == list(pmamba.generate(pmamba.MambaContext(pm), p, 8))


def test_scheduler_shift_past_n_ctx_matches_reference(jm, pm):
    want, got, reqs, _ = _sched_pair(jm, pm, [[3, 17, 42]], n_slots=1,
                                     n_ctx=16, max_tokens=24)
    assert got == want
    assert reqs[0].finish_reason == "length" and len(got[0]) == 24
    assert got[0] == list(pmamba.generate(pmamba.MambaContext(pm),
                                          [3, 17, 42], 24))


def test_server_serves_mamba(path, pm, tmp_path):
    """The server's endpoints over the recurrent context: /props names the
    arch, /completion and a streamed chat give the Scheduler's greedy
    tokens, /embeddings and slot save answer 400 (the save with a save
    path set: the refusal is the recurrent one)."""
    pytest.importorskip("aiohttp")
    from aiohttp.test_utils import TestClient, TestServer

    from llama_cpp_test_tpu_torch.server.app import LlamaServer

    srv = LlamaServer(path, n_ctx=128, n_slots=2, device="cpu",
                      slot_save_path=str(tmp_path))
    assert srv.recurrent and isinstance(srv.sched.ctx,
                                        prec.RecurrentContext)
    want = list(pmamba.generate(pmamba.MambaContext(pm), [3, 17, 42], 6))
    tok = srv.model.tokenizer

    async def go():
        c = TestClient(TestServer(srv.make_app()))
        await c.start_server()
        try:
            r = await c.get("/props")
            assert (await r.json())["arch"] == "mamba"
            r = await c.post("/completion", json={
                "prompt": [3, 17, 42], "n_predict": 6, "temperature": 0.0,
                "ignore_eos": True})
            body = await r.json()
            assert r.status == 200
            assert body["choices"][0]["text"] == tok.decode(want)
            assert body["choices"][0]["finish_reason"] == "length"
            r = await c.post("/v1/chat/completions", json={
                "messages": [{"role": "user", "content": "<t5><t6>"}],
                "max_tokens": 4, "temperature": 0.0, "stream": True,
                "ignore_eos": True})
            assert r.status == 200
            chunks = [json.loads(line[6:]) for line in
                      (await r.text()).splitlines()
                      if line.startswith("data: {")]
            assert chunks[-1]["choices"][0]["finish_reason"] == "length"
            r = await c.post("/embeddings", json={"content": "hi"})
            assert r.status == 400
            r = await c.post("/slots/0?action=save", json={})
            assert r.status == 400
            assert "recurrent" in (await r.json())["error"]
            r = await c.post("/slots/0?action=erase", json={})
            assert r.status == 200
        finally:
            await c.close()

    loop = asyncio.new_event_loop()
    srv.engine.start()
    try:
        loop.run_until_complete(go())
    finally:
        srv.engine.stop()
        loop.close()


def test_server_refuses_draft_lora_followers(path):
    from llama_cpp_test_tpu_torch.server.app import LlamaServer

    for kw in ({"draft_model_path": path}, {"lora": [(path, 1.0)]},
               {"followers": []}):
        with pytest.raises(ValueError, match="recurrent"):
            LlamaServer(path, device="cpu", **kw)


def _stdout(main, argv, **kw) -> str:
    old = sys.stdout
    sys.stdout = io.StringIO()
    try:
        assert main(argv, **kw) == 0
        return sys.stdout.getvalue()
    finally:
        sys.stdout = old


def test_cli_text_matches_reference(path):
    argv = ["-m", path, "-p", "<t3><t17><t42>", "-n", "6", "--temp", "0.7"]
    want = _stdout(jmain, argv)
    assert want.startswith("<t3><t17><t42>") and len(want) > 16
    assert _stdout(pmain, argv, device="cpu") == want


@pytest.mark.parametrize("flags", [["--lora", "x.gguf"],
                                   ["--control-vector", "x.gguf"],
                                   ["--prompt-cache", "x.bin"],
                                   ["-tp", "2"]])
def test_cli_refuses_paged_options(path, flags):
    """The reference ignores these on a recurrent file; the port says
    they do not apply."""
    with pytest.raises(ValueError, match="recurrent mamba"):
        pmain(["-m", path, "-p", "hi", "-n", "2"] + flags, device="cpu")


@pytest.mark.parametrize("arch,cls", [
    ("mamba", "MambaModel"), ("rwkv6", "Rwkv6Model"),
    ("rwkv6qwen2", "Rwkv6Model"), ("rwkv7", "Rwkv7Model"),
    ("arwkv7", "Rwkv7Model")])
def test_paged_model_refuses_recurrent(tmp_path, arch, cls):
    p = str(tmp_path / f"{arch}.gguf")
    PWriter(p, arch=arch).write()
    with pytest.raises(ValueError, match=cls):
        pengine.Model(p, device="cpu")
    assert arch in pregistry.RECURRENT and arch not in pregistry.NOT_PAGED


def test_check_arch_still_refuses_t5():
    """The paged engine refuses t5 naming its own model class, as the
    reference's loader does, and the families it leaves to their own
    loaders are t5, t5encoder and wavtokenizer-dec."""
    with pytest.raises(ValueError, match="models.t5.T5Model"):
        pregistry.check_arch("t5")
    assert set(pregistry.NOT_PAGED) == {"t5", "t5encoder",
                                        "wavtokenizer-dec"}


def test_default_device_is_cuda(path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        pmamba.MambaModel(path)
    with pytest.raises(RuntimeError, match="CUDA"):
        pmain(["-m", path, "-p", "<t3>", "-n", "2"])


def test_paged_scheduler_keeps_fast_paths(tmp_path, monkeypatch):
    """The capability flags default to on: a paged Context still takes the
    candidate prefill (top_k), decode windows, prefix reuse and the
    host-candidates decode."""
    from llama_cpp_test_tpu_torch.runtime import device_sampling as ds

    p = str(tmp_path / "tiny.gguf")
    make_tiny_gguf(p)
    ctx = pengine.Context(pengine.Model(p, device="cpu"), n_ctx=128,
                          n_seq_max=1, block_size=8)
    calls = {"top_k": 0, "window": 0, "cand": 0}
    prefill, window = ctx.prefill, psched.Scheduler._decode_window_round
    cand = psched.Scheduler._decode_host_step_candidates

    def spy_prefill(s, toks, *a, **kw):
        calls["top_k"] += kw.get("top_k", 0) == ds.HOST_CANDIDATES_K
        return prefill(s, toks, *a, **kw)

    def spy(name, fn):
        def wrapped(self, *a, **kw):
            calls[name] += 1
            return fn(self, *a, **kw)
        return wrapped

    monkeypatch.setattr(ctx, "prefill", spy_prefill)
    monkeypatch.setattr(psched.Scheduler, "_decode_window_round",
                        spy("window", window))
    monkeypatch.setattr(psched.Scheduler, "_decode_host_step_candidates",
                        spy("cand", cand))
    sched = psched.Scheduler(ctx, n_slots=1, decode_window=4)
    assert sched.decode_window == 4
    prompt = [3, 17, 42, 9, 11, 12, 13, 14]
    sched.submit(psched.GenRequest(prompt, max_tokens=6, ignore_eos=True,
                                   sampling=SamplerParams(temp=0.0)))
    sched.run()
    assert calls["top_k"] == 1 and calls["window"] >= 1
    n0 = sched.n_prompt_tokens
    sched.submit(psched.GenRequest(prompt + [60, 61], max_tokens=4,
                                   ignore_eos=True,
                                   sampling=SamplerParams(temp=0.0,
                                                          typ_p=0.9)))
    sched.run()
    assert sched.n_prompt_tokens - n0 == 2          # the prefix was reused
    assert calls["cand"] >= 1 and calls["top_k"] == 2
