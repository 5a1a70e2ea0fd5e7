"""The gemma and qwen quirk axes of the port (llama_cpp_test_tpu_torch
models/{hparams,registry,llama}, runtime/{engine,kv_cache,imatrix}) against
the JAX package, on CPU, on six tiny F32 fixtures:

  gemma2       tests/test_arch_quirks.make_tiny_gemma2: GeGLU, embedding
               scale, QK norms, sandwich norms, attention and final
               softcaps, alternating sliding windows (pattern 2)
  gemma2-noqk  the same without the QK norms
  gemma3       6 layers, pattern 6 (layer 5 global), rope base 1e6 with a
               local base of 10000 on the sliding layers, QK and sandwich
               norms, no softcaps, tied head
  gemma        gemma (v1): GeGLU and the embedding scale only, tied head
  qwen2        tests/test_arch_quirks.make_tiny_qwen: NEOX rope, Q/K/V
               biases
  qwen3        the same with per-head QK norms instead of biases

Checks: hparams equal the JAX package's; the loader's planes and vectors
equal the JAX loader's; prefill, decode and batched-decode logits (bf16
and q8_0 KV) within NMSE 2e-3 of the jitted JAX engine
(tests/test_engine.py:225) and within 1e-10 of the JAX engine run op by
op (jax.disable_jit(): jitted XLA drops some bf16 roundings the port
keeps); greedy tokens equal to the op-by-op JAX engine's; the JAX-loaded
parameters through the port give the port's own logits; a context shift
on gemma3 re-rotates each layer's K by its own rope table as the JAX
engine does; the CLI prints the JAX CLI's text on gemma and gemma3, and
the Scheduler and the server serve gemma2 and gemma3 as generate();
every other arch the reference registers is refused naming its ROADMAP
item; and reference fault 11: the JAX imatrix on gemma2 collects the
statistics of another model, the port's those of the model it serves.
"""
import asyncio
import io
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_arch_quirks import make_tiny_gemma2, make_tiny_qwen
from test_engine import tiny_vocab
from test_torch_engine_pieces import cached_kv
from test_torch_model import assert_same_weights

from llama_cpp_test_tpu.cli.main import main as jmain
from llama_cpp_test_tpu.gguf.constants import GGMLType
from llama_cpp_test_tpu.gguf.reader import GGUFReader
from llama_cpp_test_tpu.gguf.writer import GGUFWriter
from llama_cpp_test_tpu.models import hparams as jhparams
from llama_cpp_test_tpu.models import llama as jllama
from llama_cpp_test_tpu.models.registry import ARCHITECTURES
from llama_cpp_test_tpu.ops import layers as jlayers
from llama_cpp_test_tpu.runtime import engine as jengine
from llama_cpp_test_tpu.runtime import imatrix as jimatrix
from llama_cpp_test_tpu_torch.cli.main import main as pmain
from llama_cpp_test_tpu_torch.gguf.reader import GGUFReader as PGGUFReader
from llama_cpp_test_tpu_torch.models import hparams as phparams
from llama_cpp_test_tpu_torch.models import llama as pllama
from llama_cpp_test_tpu_torch.models import registry as pregistry
from llama_cpp_test_tpu_torch.runtime import engine as pengine
from llama_cpp_test_tpu_torch.runtime import imatrix as pimatrix
from llama_cpp_test_tpu_torch.runtime.sampling import SamplerParams
from llama_cpp_test_tpu_torch.runtime.scheduler import GenRequest, Scheduler
from llama_cpp_test_tpu_torch.weights import port_weights_from_reference

LOGITS_GATE = 2e-3
PROMPT = [3, 17, 42, 9, 150, 7, 23, 88, 5, 61, 100, 4, 33, 71]
ARCHS = ["gemma2", "gemma2-noqk", "gemma3", "gemma", "qwen2", "qwen3"]
CTX = dict(n_ctx=64, n_seq_max=4, block_size=8)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist every
    worker's OpenMP pool takes all cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nmse(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(((a - b) ** 2).mean() / ((a * a).mean() + 1e-12))


def make_tiny_gemma(path, arch, seed=0, n_layer=6):
    """A gemma (v1) or gemma3 F32 fixture of make_tiny_gemma2's widths
    (vocab 288: the JAX CLI's sampler takes a top-k of 256), with no
    output.weight (the head is tied to the embedding). gemma3: QK
    and sandwich norms, sliding window 3 with pattern 6 (layer 5 global),
    rope base 1e6 and local base 10000, no softcaps. gemma: GeGLU and the
    embedding scale only."""
    rng = np.random.default_rng(seed)
    c, hq, hkv, d, v, ff = 64, 4, 2, 16, 288, 128
    g3 = arch == "gemma3"
    rand = lambda *shape, s=0.08: (rng.standard_normal(shape) * s).astype(
        np.float32)
    norm = lambda n: 1.0 + rand(n, s=0.05)
    wts = {"token_embd.weight": rand(v, c, s=0.3),
           "output_norm.weight": norm(c)}
    for i in range(n_layer):
        p = f"blk.{i}."
        wts.update({p + "attn_norm.weight": norm(c),
                    p + "attn_q.weight": rand(hq * d, c),
                    p + "attn_k.weight": rand(hkv * d, c),
                    p + "attn_v.weight": rand(hkv * d, c),
                    p + "attn_output.weight": rand(c, hq * d),
                    p + "ffn_norm.weight": norm(c),
                    p + "ffn_gate.weight": rand(ff, c),
                    p + "ffn_up.weight": rand(ff, c),
                    p + "ffn_down.weight": rand(c, ff)})
        if g3:
            wts.update({p + "attn_q_norm.weight": norm(d),
                        p + "attn_k_norm.weight": norm(d),
                        p + "post_attention_norm.weight": norm(c),
                        p + "post_ffw_norm.weight": norm(c)})
    md = {"context_length": 256, "embedding_length": c,
          "block_count": n_layer, "attention.head_count": hq,
          "attention.head_count_kv": hkv, "attention.key_length": d,
          "attention.value_length": d, "feed_forward_length": ff,
          "rope.dimension_count": d,
          "rope.freq_base": 1e6 if g3 else 10000.0,
          "attention.layer_norm_rms_epsilon": 1e-6, "vocab_size": v}
    if g3:
        md.update({"attention.sliding_window": 3,
                   "attention.sliding_window_pattern": 6,
                   "rope.local_freq_base": 10000.0})
    w = GGUFWriter(path, arch=arch)
    for key, val in md.items():
        w.add_kv(f"{arch}.{key}", val)
    toks, scores, types = tiny_vocab(v)
    for key, val in {"tokenizer.ggml.model": "llama",
                     "tokenizer.ggml.tokens": toks,
                     "tokenizer.ggml.scores": np.asarray(scores, np.float32),
                     "tokenizer.ggml.token_type": np.asarray(types, np.int32),
                     "tokenizer.ggml.bos_token_id": 1,
                     "tokenizer.ggml.eos_token_id": 2,
                     "tokenizer.ggml.unknown_token_id": 0,
                     "tokenizer.ggml.add_bos_token": True}.items():
        w.add_kv(key, val)
    for name, arr in wts.items():
        w.add_tensor(name, arr, ggml_type=GGMLType.F32)
    w.write()


WRITERS = {"gemma2": make_tiny_gemma2,
           "gemma2-noqk": lambda p: make_tiny_gemma2(p, qk_norm=False),
           "gemma3": lambda p: make_tiny_gemma(p, "gemma3"),
           "gemma": lambda p: make_tiny_gemma(p, "gemma", n_layer=2),
           "qwen2": lambda p: make_tiny_qwen(p, "qwen2"),
           "qwen3": lambda p: make_tiny_qwen(p, "qwen3")}


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    root = tmp_path_factory.mktemp("quirks")
    out = {}
    for name, write in WRITERS.items():
        out[name] = str(root / f"{name}.gguf")
        write(out[name])
    return out


_MODELS: dict = {}
_OP_BY_OP: dict = {}


def models(paths, name):
    """(path, JAX Model, port Model) of a fixture, loaded once a module."""
    if name not in _MODELS:
        p = paths[name]
        _MODELS[name] = (p, jengine.Model(p), pengine.Model(p, device="cpu"))
    return _MODELS[name]


def op_by_op(paths, name):
    """The JAX engine run op by op once a fixture: the prefill logits of
    PROMPT[:6], two decode steps after it, and 8 greedy tokens of
    generate()."""
    if name not in _OP_BY_OP:
        _, jm, _ = models(paths, name)
        with jax.disable_jit():
            ctx = jengine.Context(jm, **CTX)
            s = ctx.new_seq()
            rows = [ctx.prefill(s, PROMPT[:6], all_logits=True)]
            rows += [ctx.decode([s], [t])[0] for t in PROMPT[6:8]]
            greedy = list(jengine.generate(jengine.Context(jm, **CTX),
                                           [3, 17, 42], 8))
        _OP_BY_OP[name] = (rows, greedy)
    return _OP_BY_OP[name]


def _port_rows(pm, kv="bf16"):
    ctx = pengine.Context(pm, kv_type=kv, **CTX)
    s = ctx.new_seq()
    rows = [ctx.prefill(s, PROMPT[:6], all_logits=True)]
    return rows + [ctx.decode([s], [t])[0] for t in PROMPT[6:8]]


# ---------------------------------------------------------------------------
# hparams, registry, loader


@pytest.mark.parametrize("name", ARCHS)
def test_hparams_match_reference(paths, name):
    """Every field of the port's HParams (swa_pattern, rope_freq_base_swa,
    rope_type, act_fn, embd_scale, softcaps, attn_scale ...) and every
    layer's window equal the JAX package's."""
    with GGUFReader(paths[name]) as r:
        jhp = jhparams.hparams_from_metadata(r.metadata)
    php = phparams.hparams_from_metadata(PGGUFReader(paths[name]).metadata)
    for f in php.__dataclass_fields__:
        assert getattr(php, f) == getattr(jhp, f), f
    assert [phparams.layer_window(php, i) for i in range(php.n_layer)] == \
        [jhparams.layer_window(jhp, i) for i in range(jhp.n_layer)]
    assert phparams.attn_scale_of(php) == jhparams.attn_scale_of(jhp)


@pytest.mark.parametrize("arch,n_layer", [("gemma2", 46), ("gemma3", 62),
                                          ("gemma2", 26)])
def test_gemma_27b_attention_scale_by_layer_count(arch, n_layer):
    md = {"general.architecture": arch, f"{arch}.block_count": n_layer,
          f"{arch}.embedding_length": 4608, f"{arch}.attention.head_count": 32,
          f"{arch}.attention.key_length": 128}
    php = phparams.hparams_from_metadata(md)
    assert php.attn_scale == jhparams.hparams_from_metadata(md).attn_scale
    assert (php.attn_scale > 0) == (n_layer != 26)


@pytest.mark.parametrize("name", ARCHS)
def test_loader_planes_match_reference(paths, name):
    """Planes, norms, biases, QK and sandwich norms equal the JAX
    loader's, NEOX rows unpermuted, the tied head from the embedding, and
    gemma3's sliding-window rope table."""
    assert_same_weights(paths[name])
    _, jw = jllama.load_weights(GGUFReader(paths[name]))
    hp, pw = pllama.load_weights(PGGUFReader(paths[name]))
    assert (pw.rope_inv_freq_swa is None) == (jw.rope_inv_freq_swa is None)
    if name == "gemma3":
        np.testing.assert_array_equal(pw.rope_inv_freq_swa,
                                      jw.rope_inv_freq_swa)
        assert not np.array_equal(pw.rope_inv_freq_swa, pw.rope_inv_freq)
        assert pw.inv_freq_for(3) is pw.rope_inv_freq_swa
        assert pw.inv_freq_for(0) is pw.rope_inv_freq


def test_registry_covers_the_reference():
    """Every arch the JAX package registers is served by the paged engine
    or refused by it naming its own model class or loader, and the port
    serves only registered archs."""
    assert set(pregistry.PORTED) <= set(ARCHITECTURES)
    assert set(pregistry.PORTED) | set(pregistry.NOT_PAGED) | \
        set(pregistry.RECURRENT) == set(ARCHITECTURES)
    assert not set(pregistry.PORTED) & set(pregistry.NOT_PAGED)
    assert not set(pregistry.RECURRENT) & (set(pregistry.PORTED) |
                                           set(pregistry.NOT_PAGED))


def _arch_file(path, arch):
    from llama_cpp_test_tpu_torch.gguf.writer import GGUFWriter as PWriter

    PWriter(path, arch=arch).write()
    return path


def run(main, argv, **kw):
    old = sys.stdout
    sys.stdout = io.StringIO()
    try:
        return main(argv, **kw), sys.stdout.getvalue()
    finally:
        sys.stdout = old


@pytest.mark.parametrize("arch,item", [("wavtokenizer-dec", 9), ("t5", 9),
                                       ("t5encoder", 9)])
def test_unported_archs_name_their_item(tmp_path, arch, item):
    """The archs of ROADMAP item 9 load through their own loaders: the
    paged Model and the server refuse them with the reference's ValueError
    naming that loader (llama_cpp_test_tpu/models/llama.py:311-318), and
    so does the CLI a wavtokenizer-dec file (a t5 file takes its T5
    branch, tests/test_torch_t5.py)."""
    from llama_cpp_test_tpu.models.llama import load_weights as jload
    from llama_cpp_test_tpu.gguf.reader import GGUFReader as JReader
    from llama_cpp_test_tpu_torch.server import app as papp

    assert item == 9
    path = _arch_file(str(tmp_path / f"{arch}.gguf"), arch)
    match = ("load_wavtokenizer" if arch == "wavtokenizer-dec" else
             "T5Model / T5Context")
    with pytest.raises(ValueError, match=match):
        pengine.Model(path, device="cpu")
    with pytest.raises(ValueError, match=match):
        jload(JReader(path))
    if arch == "wavtokenizer-dec":
        with pytest.raises(ValueError, match=match):
            run(pmain, ["-m", path, "-p", "hi", "-n", "2"], device="cpu")
    with pytest.raises(ValueError, match=match):
        papp.LlamaServer(path, device="cpu")


def test_unknown_arch_is_refused(tmp_path):
    path = _arch_file(str(tmp_path / "x.gguf"), "no-such-arch")
    with pytest.raises(ValueError, match="no implemented forward"):
        pengine.Model(path, device="cpu")


# ---------------------------------------------------------------------------
# the forward against the JAX engine


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
@pytest.mark.parametrize("name", ARCHS)
def test_prefill_decode_logits_match_reference(paths, name, kv):
    """A 6-token prefill (every row) and two decode steps, past gemma's
    3-token windows, against the jitted JAX engine."""
    _, jm, pm = models(paths, name)
    jctx = jengine.Context(jm, kv_type=kv, **CTX)
    js = jctx.new_seq()
    want = [jctx.prefill(js, PROMPT[:6], all_logits=True)]
    want += [jctx.decode([js], [t])[0] for t in PROMPT[6:8]]
    got = _port_rows(pm, kv)
    assert got[0].shape == (6, pm.hp.n_vocab)
    for i, (a, b) in enumerate(zip(want, got)):
        assert np.isfinite(b).all()
        assert nmse(a, b) < LOGITS_GATE, (i, nmse(a, b))


@pytest.mark.parametrize("name", ARCHS)
def test_logits_match_reference_op_by_op(paths, name):
    """The same rows within 1e-10 of the JAX engine run op by op."""
    _, _, pm = models(paths, name)
    want, _ = op_by_op(paths, name)
    for i, (a, b) in enumerate(zip(want, _port_rows(pm))):
        assert nmse(a, b) < 1e-10, (i, nmse(a, b))


@pytest.mark.parametrize("name", ARCHS)
def test_greedy_tokens_match_reference(paths, name):
    _, _, pm = models(paths, name)
    _, want = op_by_op(paths, name)
    got = list(pengine.generate(pengine.Context(pm, **CTX), [3, 17, 42], 8))
    assert got == want


@pytest.mark.parametrize("name", ARCHS)
def test_batched_decode_matches_reference(paths, name):
    _, jm, pm = models(paths, name)
    outs = []
    for eng, model in ((jengine, jm), (pengine, pm)):
        ctx = eng.Context(model, **CTX)
        sa, sb, sc = ctx.new_seq(), ctx.new_seq(), ctx.new_seq()
        ctx.prefill(sa, [5, 6, 7])
        ctx.prefill(sb, [100, 101, 102, 103, 104])
        ctx.prefill(sc, [9])
        outs.append(ctx.decode([sa, sb, sc], [11, 12, 13]))
    assert nmse(outs[0], outs[1]) < LOGITS_GATE


@pytest.mark.parametrize("name", ARCHS)
def test_port_runs_on_reference_parameters(paths, name):
    """port_weights_from_reference carries the quirk fields: the JAX
    loader's parameters through the port give the port's own logits."""
    path, _, pm = models(paths, name)
    _, jw = jllama.load_weights(GGUFReader(path))
    model = pengine.Model.from_weights(pm.hp, port_weights_from_reference(jw),
                                       device="cpu")
    got = pengine.Context(model, **CTX)
    own = pengine.Context(pm, **CTX)
    np.testing.assert_array_equal(
        got.prefill(got.new_seq(), PROMPT, all_logits=True),
        own.prefill(own.new_seq(), PROMPT, all_logits=True))


def test_gemma3_context_shift_matches_reference_op_by_op(paths):
    """shift_context on gemma3 re-rotates each layer's K by its own table
    (10000 on the sliding layers, 1e6 on layer 5): the cached K/V and the
    next decode equal the JAX engine's run op by op; rotating every layer
    by the global table instead moves them."""
    _, jm, pm = models(paths, "gemma3")
    ctx_kw = dict(CTX, n_ctx=32)
    with jax.disable_jit():
        jctx = jengine.Context(jm, **ctx_kw)
        js = jctx.new_seq()
        jctx.prefill(js, PROMPT[:12])
        jctx.shift_context(js, 2, 5)
        want = cached_kv(jctx, js)
        jl = jctx.decode([js], [11])[0]
    pctx = pengine.Context(pm, **ctx_kw)
    ps = pctx.new_seq()
    pctx.prefill(ps, PROMPT[:12])
    pctx.shift_context(ps, 2, 5)
    assert ps.tokens == js.tokens[:-1] and ps.n_cached == 7
    np.testing.assert_array_equal(cached_kv(pctx, ps), want)
    assert nmse(jl, pctx.decode([ps], [11])[0]) < 1e-10
    # the same shift with the global table on every layer
    one = pengine.Context(pm, **ctx_kw)
    os_ = one.new_seq()
    one.prefill(os_, PROMPT[:12])
    swa = pm.weights.rope_inv_freq_swa
    pm.weights.rope_inv_freq_swa = None
    try:
        one.shift_context(os_, 2, 5)
    finally:
        pm.weights.rope_inv_freq_swa = swa
    assert nmse(cached_kv(one, os_), want) > 1e-4


# ---------------------------------------------------------------------------
# the entry points on a gemma2 file


@pytest.mark.parametrize("name", ["gemma3", "gemma"])
def test_cli_text_matches_reference(paths, name):
    argv = ["-m", paths[name], "-p", "hello world", "-n", "8", "--temp", "0"]
    want = run(jmain, argv)
    got = run(pmain, argv, device="cpu")
    assert got == want and got[0] == 0


def test_scheduler_serves_gemma_as_generate(paths):
    """Greedy requests through the Scheduler's windows, three at once,
    give generate()'s tokens on gemma2 and gemma3."""
    for name in ("gemma2", "gemma3"):
        _, _, pm = models(paths, name)
        prompts = [[3, 17, 42 + i] for i in range(3)]
        want = [list(pengine.generate(pengine.Context(pm, **CTX), p, 10))
                for p in prompts]
        sched = Scheduler(pengine.Context(pm, n_ctx=64, n_seq_max=3,
                                          block_size=8), n_slots=3,
                          decode_window=4)
        reqs = [sched.submit(GenRequest(p, max_tokens=10,
                                        sampling=SamplerParams(temp=0.0)))
                for p in prompts]
        sched.run()
        assert [r.output_tokens for r in reqs] == want, name


def test_server_completion_on_gemma2(paths):
    """The server's greedy /completion on a gemma2 file: generate()'s
    tokens, detokenized."""
    pytest.importorskip("aiohttp")
    from aiohttp.test_utils import TestClient, TestServer

    from llama_cpp_test_tpu_torch.server import app as papp

    _, _, pm = models(paths, "gemma2")
    want = list(pengine.generate(pengine.Context(pm, **CTX), [3, 17, 42], 6))
    srv = papp.LlamaServer(paths["gemma2"], n_ctx=64, n_slots=1,
                           device="cpu")
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


# ---------------------------------------------------------------------------
# imatrix: reference fault 11


def _layer0_output(path, tokens):
    """The hidden state after layer 0 of the JAX package's own model
    (its embed with the scale, its forward_layer with the window and the
    softcap), run op by op, and what layer 1's projections are fed (its
    attention norm of it)."""
    hp, w = jllama.load_weights(GGUFReader(path))
    t = len(tokens)
    with jax.disable_jit():
        x = jllama.embed(w, jnp.asarray([tokens], jnp.int32), hp.embd_scale)
        pos = jnp.arange(t, dtype=jnp.int32)[None]
        window = jhparams.layer_window(hp, 0)
        ii, jj = np.mgrid[0:t, 0:t]
        mask = jnp.asarray((jj <= ii) & ((window == 0) | (jj > ii - window)))
        attend = lambda q, k, v: jlayers.attention(
            q, k, v, mask[None], jhparams.attn_scale_of(hp),
            softcap=hp.attn_softcap)
        x = jllama.forward_layer(x, w.layers[0], hp, pos,
                                 w.inv_freq_for(window), w.rope_mscale,
                                 attend)
        cur = jlayers.rms_norm(x, w.layers[1].attn_norm, hp.rms_eps)
    f32 = lambda a: np.asarray(a.astype(jnp.float32))[0]
    return f32(x), f32(cur)


def test_imatrix_on_gemma2_collects_the_served_model(paths):
    """Fault 11: the JAX imatrix re-implements the layer without the
    gemma quirks, so its sums for layer 1's q/k/v (the squares of what
    layer 0 hands on) are those of another model; the port's layers tap
    the activations of the model they serve. On the llama fixture the two
    agree (tests/test_torch_imatrix.py)."""
    path, jm, pm = models(paths, "gemma2")
    toks = [int(t) for t in np.random.default_rng(0).integers(3, 190, 32)]
    _, cur = _layer0_output(path, toks)
    truth = (cur.astype(np.float64) ** 2).sum(0)
    rel = lambda a: float(np.abs(np.asarray(a, np.float64) - truth).max()
                          / np.abs(truth).max())
    pc, jc = pimatrix.IMatrixCollector(pm), jimatrix.IMatrixCollector(jm)
    pc.collect(toks, chunk=32)
    with jax.disable_jit():
        jc.collect(toks, chunk=32)
    name = "blk.1.attn_q.weight"
    assert rel(pc.sums[name]) < 1e-3, rel(pc.sums[name])
    assert rel(jc.sums[name]) > 0.05, rel(jc.sums[name])
    assert set(pc.sums) == set(jc.sums)
    assert math.isfinite(sum(float(v.sum()) for v in pc.sums.values()))


def test_trace_eval_on_gemma2_traces_the_served_model(paths):
    """Fault 12: the JAX tracer's forward embeds without the scale and
    attends without the softcap, so its l_out-0 on gemma2 is another
    model's; the port's tracer taps the engine's own forward."""
    from llama_cpp_test_tpu.runtime import tracing as jtracing
    from llama_cpp_test_tpu_torch.runtime import tracing as ptracing

    path, jm, pm = models(paths, "gemma2")
    toks = PROMPT[:10]
    truth, _ = _layer0_output(path, toks)
    got = ptracing.trace_eval(pengine.Context(pm, **CTX), toks,
                              keep_values=True)
    with jax.disable_jit():
        ref = jtracing.trace_eval(jengine.Context(jm, **CTX), toks,
                                  keep_values=True)
    by = lambda tr: {t.name: t.values for t in tr}
    assert nmse(truth, by(got)["l_out-0"]) < 1e-10
    assert nmse(truth, by(ref)["l_out-0"]) > 1e-2


@pytest.mark.parametrize("arch,name,shape,match", [
    ("llama", "blk.0.attn_q_norm.weight", (16,), "NORM-rope"),
    ("llama", "blk.0.attn_q_norm.weight", (64,), "NORM-rope"),
    ("gemma2", "blk.0.attn_qkv.weight", (8, 64), "attention tensors"),
], ids=["qk-norm-on-norm-rope", "flat-qk-norm", "fused-qkv"])
def test_quirk_tensors_the_port_does_not_carry_raise(tmp_path, arch, name,
                                                     shape, match):
    """Per-head and flat (olmo2-style) QK norms on a NORM-rope file, and
    a fused attn_qkv beside attn_q, attn_k and attn_v (the fused layout
    alone is served since the phi and falcon archs) are refused before a
    tensor is read."""
    from llama_cpp_test_tpu_torch.gguf.writer import GGUFWriter as PWriter

    path = str(tmp_path / "v.gguf")
    w = PWriter(path, arch=arch)
    for k, v in {"block_count": 1, "embedding_length": 64,
                 "attention.head_count": 4, "attention.head_count_kv": 2,
                 "attention.key_length": 16}.items():
        w.add_kv(f"{arch}.{k}", v)
    names = ["token_embd.weight", "output_norm.weight"] + [
        f"blk.0.{n}" for n in ("attn_norm.weight", "attn_q.weight",
                               "attn_k.weight", "attn_v.weight",
                               "attn_output.weight", "ffn_norm.weight",
                               "ffn_gate.weight", "ffn_up.weight",
                               "ffn_down.weight")]
    for n in names:
        w.add_tensor(n, np.zeros((2, 8), np.float32))
    w.add_tensor(name, np.zeros(shape[::-1], np.float32))
    w.write()
    with pytest.raises(NotImplementedError, match=match):
        pengine.Model(path, device="cpu")


@pytest.mark.parametrize("name", ["gemma2", "qwen2"])
def test_lora_on_neox_archs_matches_reference(paths, tmp_path, name):
    """A LoRA adapter on a NEOX-rope file keeps its attn_q/attn_k rows as
    the loader keeps the base rows (only NORM rows are un-permuted): the
    adapted logits equal the JAX engine's run op by op."""
    from test_torch_lora import dims_of, write_adapter

    from llama_cpp_test_tpu.models import lora as jlora
    from llama_cpp_test_tpu_torch.models import lora as plora

    path, _, _ = models(paths, name)
    adapter = write_adapter(str(tmp_path / "a.gguf"),
                            dims_of(64, 4, 2, 16, 128), 2, seed=5)
    jm, pm = jengine.Model(path), pengine.Model(path, device="cpu")
    jlora.attach_lora(jm.weights, jlora.load_lora(adapter, jm.hp), 0.7)
    plora.attach_lora(pm.weights, plora.load_lora(adapter, pm.hp), 0.7)
    ctx = pengine.Context(pm, **CTX)
    got = ctx.prefill(ctx.new_seq(), PROMPT[:8], all_logits=True)
    with jax.disable_jit():
        jctx = jengine.Context(jm, **CTX)
        want = jctx.prefill(jctx.new_seq(), PROMPT[:8], all_logits=True)
    assert nmse(want, got) < 1e-10, nmse(want, got)
