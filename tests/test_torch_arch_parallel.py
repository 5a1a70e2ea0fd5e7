"""The parallel-residual archs of the port (phi2, falcon, gptneox,
command-r, and stablelm with use_parallel_residual) against the JAX
package, on CPU, on six tiny F32 fixtures:

  phi2          tests/test_arch_quirks.make_tiny_phi2: one LayerNorm (with
                bias) feeding both branches, fused attn_qkv with bias, wo,
                up and down biases, a non-gated GELU FFN, partial rope (8
                of 16), a biased lm head
  falcon        tests/test_arch_quirks.make_tiny_falcon: falcon-40B's
                second LayerNorm (attn_norm_2) feeding the FFN, fused QKV
                on 2 KV heads, head dim 24
  falcon-7b     the same with one shared LayerNorm
  gptneox       a dedicated ffn_norm on the layer input, fused QKV with
                bias, every bias, partial rope (4 of 16)
  command-r     weight-only LayerNorms, a gated SwiGLU FFN, per-head
                LayerNorm QK norms [H, 16] (Command R+) in a NORM-rope
                file, logit_scale 0.0625, tied head
  stablelm-12b  stablelm with use_parallel_residual, per-head LayerNorm QK
                norms, no ffn_norm (stablelm-2-12B)

Checks as tests/test_torch_arch_ln.py makes them (hparams, loader,
logits at bf16 and q8_0 KV against the jitted and the op-by-op JAX
engine, greedy tokens, batched decode, the JAX-loaded parameters); the
CLI on gptneox, the Scheduler and the server on phi2; reference fault 11
on phi2 (the JAX imatrix raises on its non-gated FFN, the port collects
the served model; the tracer the same); and reference fault 13: the JAX
parallel layer leaves out the LoRA of wo, ffn_up and ffn_down and the
control vector, which the port applies, while the adapters it does apply
(q, k, v, gate, up) give the JAX logits.
"""
import asyncio

import jax
import numpy as np
import pytest
import torch

from test_arch_quirks import make_tiny_falcon, make_tiny_phi2
from test_torch_arch_ln import (CTX, PROMPT, SPECS, check_batched,
                                check_cli, check_greedy, check_hparams,
                                check_imatrix_and_trace, check_loader,
                                check_logits, check_op_by_op,
                                check_reference_parameters, check_scheduler,
                                make_tiny_arch, models, nmse, write_fixtures)
from test_torch_lora import dims_of, write_adapter

from llama_cpp_test_tpu.models import cvec as jcvec
from llama_cpp_test_tpu.models import lora as jlora
from llama_cpp_test_tpu.runtime import engine as jengine
from llama_cpp_test_tpu_torch.models import cvec as pcvec
from llama_cpp_test_tpu_torch.models import lora as plora
from llama_cpp_test_tpu_torch.runtime import engine as pengine

PARALLEL = {
    "gptneox": dict(norm="ln", norm_bias=True, qkv="fused", qkv_bias=True,
                    bo=True, ffn="up", ffn_bias=True, rope_dim=4),
    "command-r": dict(norm="ln", ffn_norm=False, qk="head", tied=True,
                      meta={"logit_scale": 0.0625}),
    "stablelm-12b": dict(SPECS["stablelm"], ffn_norm=False, qk="head",
                         qkv_bias=False,
                         meta={"use_parallel_residual": True}),
}
WRITERS = {"phi2": make_tiny_phi2,
           "falcon": make_tiny_falcon,
           "falcon-7b": lambda p: make_tiny_falcon(p, norm2=False),
           **{name: (lambda p, n=name: make_tiny_arch(
               p, PARALLEL[n], n.split("-12b")[0])) for name in PARALLEL}}
ARCHS = list(WRITERS)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return write_fixtures(tmp_path_factory, WRITERS)


@pytest.mark.parametrize("name", ARCHS)
def test_hparams_match_reference(paths, name):
    hp = check_hparams(paths[name])
    assert hp.parallel_residual and hp.norm_type == "ln"


@pytest.mark.parametrize("name", ARCHS)
def test_loader_planes_match_reference(paths, name):
    pw = check_loader(paths[name])
    lw = pw.layers[0]
    assert (lw.attn_norm_2 is not None) == (name == "falcon")
    assert (lw.ffn_norm is not None) == (name == "gptneox")
    if name in ("command-r", "stablelm-12b"):
        assert lw.attn_q_norm.shape == (4, 16) and \
            lw.attn_k_norm.shape == (2, 16)


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
@pytest.mark.parametrize("name", ARCHS)
def test_prefill_decode_logits_match_reference(paths, name, kv):
    check_logits(paths[name], kv)


@pytest.mark.parametrize("name", ARCHS)
def test_logits_match_reference_op_by_op(paths, name):
    check_op_by_op(paths[name])


@pytest.mark.parametrize("name", ARCHS)
def test_greedy_tokens_match_reference(paths, name):
    check_greedy(paths[name])


@pytest.mark.parametrize("name", ARCHS)
def test_batched_decode_matches_reference(paths, name):
    check_batched(paths[name])


@pytest.mark.parametrize("name", ARCHS)
def test_port_runs_on_reference_parameters(paths, name):
    check_reference_parameters(paths[name])


def test_command_r_qk_norms_follow_the_unpermuted_rows(paths):
    """Command R+'s per-head LayerNorm weights in a NORM-rope file take
    the within-head map of the un-permuted q/k rows: loaded as they are
    in the file, the logits move off the JAX engine's."""
    from llama_cpp_test_tpu_torch.models.llama import _unpermute_rows

    jm, pm = models(paths["command-r"])
    jctx = jengine.Context(jm, **CTX)
    want = jctx.prefill(jctx.new_seq(), PROMPT[:6], all_logits=True)
    prefill = lambda: pengine.Context(pm, **CTX).prefill(
        pengine.Context(pm, **CTX).new_seq(), PROMPT[:6], all_logits=True)
    got = prefill()
    lw = pm.weights.layers[0]
    saved = lw.attn_q_norm
    lw.attn_q_norm = saved[:, np.argsort(_unpermute_rows(1, 16))]
    try:
        off = prefill()
    finally:
        lw.attn_q_norm = saved
    assert nmse(want, got) < 2e-3
    assert nmse(want, off) > 10 * nmse(want, got), (nmse(want, off),
                                                    nmse(want, got))


def test_cli_text_matches_reference(paths):
    check_cli(paths["gptneox"])


def test_scheduler_serves_as_generate(paths):
    check_scheduler(paths["phi2"])


def test_server_completion_on_phi2(paths):
    """The server's greedy /completion on a phi2 file: generate()'s
    tokens, detokenized."""
    pytest.importorskip("aiohttp")
    from aiohttp.test_utils import TestClient, TestServer

    from llama_cpp_test_tpu_torch.server import app as papp

    _, pm = models(paths["phi2"])
    want = list(pengine.generate(pengine.Context(pm, **CTX), [3, 17, 42], 6))
    srv = papp.LlamaServer(paths["phi2"], n_ctx=64, n_slots=1, device="cpu")
    srv.engine.start()

    async def go():
        c = TestClient(TestServer(srv.make_app()))
        await c.start_server()
        try:
            r = await c.post("/completion", json={
                "prompt": [3, 17, 42], "n_predict": 6, "temperature": 0.0,
                "ignore_eos": True})
            assert r.status == 200
            return await r.json()
        finally:
            await c.close()

    loop = asyncio.new_event_loop()
    try:
        body = loop.run_until_complete(asyncio.wait_for(go(), 60))
    finally:
        loop.close()
        srv.engine.stop()
    assert body["usage"]["completion_tokens"] == 6
    assert body["choices"][0]["text"] == pm.tokenizer.decode(want)


def test_imatrix_and_trace_on_phi2_collect_the_served_model(paths):
    check_imatrix_and_trace(paths["phi2"], jax_imatrix_raises=True)


# ---------------------------------------------------------------------------
# adapters: reference fault 13


def _fresh(path):
    return jengine.Model(path), pengine.Model(path, device="cpu")


def test_adapters_the_reference_applies_match_it(paths, tmp_path):
    """A LoRA over q, k, v, gate and up, the projections the JAX parallel
    layer adapts, on command-r (NORM rope: the q/k rows un-permuted alike)
    and on phi2 (fused q|k|v): the logits equal the JAX engine's run op
    by op."""
    for name, targets, ff in (
            ("command-r", ("attn_q", "attn_k", "attn_v", "ffn_gate",
                           "ffn_up"), 128),
            ("phi2", ("attn_q", "attn_k", "attn_v"), 128)):
        path = paths[name]
        kv = 4 if name == "phi2" else 2
        adapter = write_adapter(str(tmp_path / f"{name}.gguf"),
                                dims_of(64, 4, kv, 16, ff), 2,
                                targets=targets, seed=5)
        jm, pm = _fresh(path)
        jlora.attach_lora(jm.weights, jlora.load_lora(adapter, jm.hp), 0.7)
        plora.attach_lora(pm.weights, plora.load_lora(adapter, pm.hp), 0.7)
        ctx = pengine.Context(pm, **CTX)
        got = ctx.prefill(ctx.new_seq(), PROMPT[:8], all_logits=True)
        base = pengine.Context(pengine.Model(path, device="cpu"), **CTX)
        assert nmse(got, base.prefill(base.new_seq(), PROMPT[:8],
                                      all_logits=True)) > 1e-4, name
        with jax.disable_jit():
            jctx = jengine.Context(jm, **CTX)
            want = jctx.prefill(jctx.new_seq(), PROMPT[:8], all_logits=True)
        assert nmse(want, got) < 1e-10, (name, nmse(want, got))


def test_parallel_layer_applies_wo_up_down_lora_and_cvec(paths, tmp_path):
    """Fault 13: on phi2 the JAX parallel layer leaves out a LoRA of
    attn_output, ffn_up and ffn_down (its logits stay the base's bits)
    and the control vector; the port applies them: with the adapter its
    logits are those of the file with the adapter merged in (F16
    weights), and with a control vector its layer outputs move by it."""
    path = paths["phi2"]
    adapter = write_adapter(str(tmp_path / "a.gguf"),
                            dims_of(64, 4, 4, 16, 128), 2,
                            targets=("attn_output", "ffn_up", "ffn_down"),
                            seed=6, s=0.3)
    merged = str(tmp_path / "merged.gguf")
    assert plora.merge_lora(path, adapter, merged, 0.7) == 6
    logits = lambda m, eng: eng.Context(m, **CTX).prefill(
        eng.Context(m, **CTX).new_seq(), PROMPT[:8], all_logits=True)
    jm, pm = _fresh(path)
    jbase, pbase = logits(jm, jengine), logits(pm, pengine)
    jlora.attach_lora(jm.weights, jlora.load_lora(adapter, jm.hp), 0.7)
    plora.attach_lora(pm.weights, plora.load_lora(adapter, pm.hp), 0.7)
    np.testing.assert_array_equal(logits(jm, jengine), jbase)
    got = logits(pm, pengine)
    want = logits(pengine.Model(merged, device="cpu"), pengine)
    assert nmse(want, got) < 1e-4, nmse(want, got)
    assert nmse(pbase, got) > 1e-2, nmse(pbase, got)

    from llama_cpp_test_tpu_torch.runtime import tracing as ptracing

    jm, pm = _fresh(path)
    vec = np.random.default_rng(3).standard_normal(64).astype(np.float32)
    trace = lambda: {t.name: t.values for t in ptracing.trace_eval(
        pengine.Context(pm, **CTX), PROMPT[:8], keep_values=True)}
    before = trace()
    jcvec.attach_control_vector(jm.weights, {1: vec}, 0.5)
    pcvec.attach_control_vector(pm.weights, {1: vec}, 0.5)
    np.testing.assert_array_equal(logits(jm, jengine), jbase)
    after = trace()
    np.testing.assert_allclose(after["l_out-0"] - before["l_out-0"],
                               np.broadcast_to(0.5 * vec, (8, 64)),
                               atol=0.05)
    assert nmse(before["result_output"], after["result_output"]) > 1e-4
