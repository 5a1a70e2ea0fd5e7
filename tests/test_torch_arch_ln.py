"""The LayerNorm, partial-rope and mup archs of the port that keep a
sequential residual (llama_cpp_test_tpu_torch models/{hparams,registry,
llama}, runtime/{engine,kv_cache,imatrix,tracing}) against the JAX
package, on CPU, on seven tiny F32 fixtures in the reference's tensor
layout (make_tiny_arch):

  phi3        RMS norms, fused attn_qkv and [gate|up] ffn_up, long rope
              (short and long factor tables, original context 32), a
              sliding window of 40 on every layer, GQA
  granite     the llama layout with the mup scales (embedding 12,
              residual 0.22, attention 0.0625, logits 8), tied head
  stablelm    LayerNorms with biases, Q/K/V biases, partial rope (4 of 16)
  olmo2       no pre-norms, post norms, RMS norms over the flat q and k
  starcoder2  LayerNorms with biases, Q/K/V and wo biases, a non-gated
              GELU FFN with biases, window 5, tied head
  nemotron    LayerNorms with biases, a non-gated squared-ReLU FFN,
              partial rope (8 of 16)
  olmo        no norm tensors (weightless LayerNorms), q/k/v clamped to
              +-0.5, NORM rope

Checks, as tests/test_torch_arch_quirks.py makes them: hparams equal the
JAX package's; the loader's planes and vectors equal the JAX loader's;
prefill, decode and batched-decode logits (bf16 and q8_0 KV) within NMSE
2e-3 of the jitted JAX engine and within 1e-10 of the JAX engine run op
by op; greedy tokens equal; the JAX-loaded parameters through the port
give the port's own logits. Then phi3's long-rope table: chosen by n_ctx
as the JAX Context chooses it, through a context shift too; a window
that cannot bind (>= n_ctx) dispatched as no window, with the logits of
window 0; the CLI on stablelm, the Scheduler on phi3 and olmo2; reference
fault 11 on stablelm: the JAX imatrix collects another model's
statistics, the port's those of the model it serves (the tracer's layer
outputs too), and fault 12 on granite: the JAX tracer embeds without the
scale; and the layouts the port does not carry raise.
"""
import dataclasses
import io
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_engine import tiny_vocab
from test_torch_engine_pieces import cached_kv
from test_torch_model import assert_same_weights

from llama_cpp_test_tpu.cli.main import main as jmain
from llama_cpp_test_tpu.gguf.constants import GGMLType
from llama_cpp_test_tpu.gguf.reader import GGUFReader
from llama_cpp_test_tpu.gguf.writer import GGUFWriter
from llama_cpp_test_tpu.models import hparams as jhparams
from llama_cpp_test_tpu.models import llama as jllama
from llama_cpp_test_tpu.ops import layers as jlayers
from llama_cpp_test_tpu.runtime import engine as jengine
from llama_cpp_test_tpu.runtime import imatrix as jimatrix
from llama_cpp_test_tpu_torch.cli.main import main as pmain
from llama_cpp_test_tpu_torch.gguf.reader import GGUFReader as PGGUFReader
from llama_cpp_test_tpu_torch.models import hparams as phparams
from llama_cpp_test_tpu_torch.models import llama as pllama
from llama_cpp_test_tpu_torch.runtime import engine as pengine
from llama_cpp_test_tpu_torch.runtime import imatrix as pimatrix
from llama_cpp_test_tpu_torch.runtime import kv_cache as pkv
from llama_cpp_test_tpu_torch.runtime.sampling import SamplerParams
from llama_cpp_test_tpu_torch.runtime.scheduler import GenRequest, Scheduler
from llama_cpp_test_tpu_torch.weights import port_weights_from_reference

LOGITS_GATE = 2e-3
PROMPT = [3, 17, 42, 9, 150, 7, 23, 88, 5, 61, 100, 4, 33, 71]
CTX = dict(n_ctx=64, n_seq_max=4, block_size=8)
C, HQ, HKV, D, V, FF, L = 64, 4, 2, 16, 288, 128, 2

# arch -> the layout of its tiny fixture: norm "rms" | "ln" | None (no
# pre-norm tensors), norm_bias (LayerNorm biases), qkv "fused" | "split",
# qkv_bias, bo, ffn "gated" | "fused" ([gate|up] in ffn_up) | "up"
# (non-gated), ffn_bias, ffn_norm (a pre-FFN norm), post_norms, qk "head"
# ([H, D] LayerNorms) | "flat" (olmo2), output_norm, tied, head_bias,
# rope_dim, window, rope_factors (phi3), meta (more keys)
SPECS = {
    "phi3": dict(norm="rms", qkv="fused", ffn="fused", window=40,
                 rope_factors=True,
                 meta={"rope.scaling.type": "longrope",
                       "rope.scaling.original_context_length": 32,
                       "rope.scaling.attn_factor": math.sqrt(
                           1 + math.log(8) / math.log(32))}),
    "granite": dict(norm="rms", tied=True,
                    meta={"embedding_scale": 12.0, "residual_scale": 0.22,
                          "attention.scale": 0.0625, "logit_scale": 8.0}),
    "stablelm": dict(norm="ln", norm_bias=True, qkv_bias=True, rope_dim=4),
    "olmo2": dict(norm=None, post_norms=True, qk="flat"),
    "starcoder2": dict(norm="ln", norm_bias=True, qkv_bias=True, bo=True,
                       ffn="up", ffn_bias=True, window=5, tied=True),
    "nemotron": dict(norm="ln", norm_bias=True, ffn="up", rope_dim=8),
    "olmo": dict(norm=None, output_norm=False,
                 meta={"attention.clamp_kqv": 0.5}),
}
ARCHS = list(SPECS)


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


def make_tiny_arch(path, spec: dict, arch: str, seed=0):
    """An F32 GGUF of arch `arch` laid out by `spec` (see SPECS): 2 layers
    of width 64, 4 query heads on 2 KV heads of 16 dims, FFN 128, an SPM
    vocabulary of 288 tokens (the JAX CLI's sampler takes a top-k of
    256)."""
    rng = np.random.default_rng(seed)
    rand = lambda *shape, s=0.08: (rng.standard_normal(shape) * s).astype(
        np.float32)
    norm = lambda *n: 1.0 + rand(*n, s=0.05)
    bias = lambda n: rand(n, s=0.05)
    sp = dict(dict(qkv="split", ffn="gated", ffn_norm=True, output_norm=True,
                   rope_dim=D), **spec)
    ln_bias = sp["norm"] == "ln" and sp.get("norm_bias")
    wts = {"token_embd.weight": rand(V, C, s=0.3)}
    if sp["output_norm"]:
        wts["output_norm.weight"] = norm(C)
        if ln_bias:
            wts["output_norm.bias"] = bias(C)
    if not sp.get("tied"):
        wts["output.weight"] = rand(V, C, s=0.2)
    if sp.get("head_bias"):
        wts["output.bias"] = bias(V)
    for i in range(L):
        p = f"blk.{i}."
        pre = ["attn_norm"] + (["ffn_norm"] if sp["ffn_norm"] else [])
        for n in pre if sp["norm"] else []:
            wts[p + n + ".weight"] = norm(C)
            if ln_bias:
                wts[p + n + ".bias"] = bias(C)
        if sp["qkv"] == "fused":
            wts[p + "attn_qkv.weight"] = rand((HQ + 2 * HKV) * D, C)
            if sp.get("qkv_bias"):
                wts[p + "attn_qkv.bias"] = bias((HQ + 2 * HKV) * D)
        else:
            for n, h in (("attn_q", HQ), ("attn_k", HKV), ("attn_v", HKV)):
                wts[p + n + ".weight"] = rand(h * D, C)
                if sp.get("qkv_bias"):
                    wts[p + n + ".bias"] = bias(h * D)
        wts[p + "attn_output.weight"] = rand(C, HQ * D)
        if sp.get("bo"):
            wts[p + "attn_output.bias"] = bias(C)
        if sp.get("qk") == "head":   # distinct heads, weights far from 1
            wts[p + "attn_q_norm.weight"] = 1.0 + rand(HQ, D, s=0.3)
            wts[p + "attn_k_norm.weight"] = 1.0 + rand(HKV, D, s=0.3)
        elif sp.get("qk") == "flat":
            wts[p + "attn_q_norm.weight"] = norm(HQ * D)
            wts[p + "attn_k_norm.weight"] = norm(HKV * D)
        if sp.get("post_norms"):
            wts[p + "post_attention_norm.weight"] = norm(C)
            wts[p + "post_ffw_norm.weight"] = norm(C)
        if sp["ffn"] == "gated":
            wts[p + "ffn_gate.weight"] = rand(FF, C)
            wts[p + "ffn_up.weight"] = rand(FF, C)
        else:
            wts[p + "ffn_up.weight"] = rand(
                (2 if sp["ffn"] == "fused" else 1) * FF, C)
        wts[p + "ffn_down.weight"] = rand(C, FF)
        if sp.get("ffn_bias"):
            wts[p + "ffn_up.bias"] = bias(FF)
            wts[p + "ffn_down.bias"] = bias(C)
    if sp.get("rope_factors"):
        half = sp["rope_dim"] // 2
        wts["rope_factors_short.weight"] = rng.uniform(1.0, 1.5, half).astype(
            np.float32)
        wts["rope_factors_long.weight"] = rng.uniform(1.0, 40.0, half).astype(
            np.float32)
    eps = ("attention.layer_norm_epsilon" if sp["norm"] == "ln" or
           arch == "olmo" else "attention.layer_norm_rms_epsilon")
    md = {"context_length": 256, "embedding_length": C, "block_count": L,
          "attention.head_count": HQ, "attention.head_count_kv": HKV,
          "attention.key_length": D, "attention.value_length": D,
          "feed_forward_length": FF, "rope.dimension_count": sp["rope_dim"],
          "rope.freq_base": 10000.0, eps: 1e-5, "vocab_size": V,
          **sp.get("meta", {})}
    if sp.get("window"):
        md["attention.sliding_window"] = sp["window"]
    w = GGUFWriter(path, arch=arch)
    for key, val in md.items():
        w.add_kv(f"{arch}.{key}", val)
    toks, scores, types = tiny_vocab(V)
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


def write_fixtures(tmp_path_factory, writers: dict) -> dict:
    root = tmp_path_factory.mktemp("archs")
    out = {}
    for name, write in writers.items():
        out[name] = str(root / f"{name}.gguf")
        write(out[name])
    return out


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return write_fixtures(tmp_path_factory, {
        name: (lambda p, n=name: make_tiny_arch(p, SPECS[n], n))
        for name in ARCHS})


_MODELS: dict = {}
_OP_BY_OP: dict = {}


def models(path):
    """(JAX Model, port Model) of a fixture file, loaded once a process."""
    if path not in _MODELS:
        _MODELS[path] = (jengine.Model(path), pengine.Model(path,
                                                            device="cpu"))
    return _MODELS[path]


def op_by_op(path):
    """The JAX engine run op by op once a fixture: the prefill logits of
    PROMPT[:6], two decode steps after it, and 8 greedy tokens of
    generate()."""
    if path not in _OP_BY_OP:
        jm, _ = models(path)
        with jax.disable_jit():
            ctx = jengine.Context(jm, **CTX)
            s = ctx.new_seq()
            rows = [ctx.prefill(s, PROMPT[:6], all_logits=True)]
            rows += [ctx.decode([s], [t])[0] for t in PROMPT[6:8]]
            greedy = list(jengine.generate(jengine.Context(jm, **CTX),
                                           [3, 17, 42], 8))
        _OP_BY_OP[path] = (rows, greedy)
    return _OP_BY_OP[path]


def port_rows(pm, kv="bf16"):
    ctx = pengine.Context(pm, kv_type=kv, **CTX)
    s = ctx.new_seq()
    rows = [ctx.prefill(s, PROMPT[:6], all_logits=True)]
    return rows + [ctx.decode([s], [t])[0] for t in PROMPT[6:8]]


def run(main, argv, **kw):
    old = sys.stdout
    sys.stdout = io.StringIO()
    try:
        return main(argv, **kw), sys.stdout.getvalue()
    finally:
        sys.stdout = old


# ---------------------------------------------------------------------------
# the checks each fixture runs (shared with tests/test_torch_arch_parallel)


def check_hparams(path):
    """Every field of the port's HParams (norm_type, parallel_residual,
    act_fn, residual_scale, logits_scale, clamp_kqv, rope_scaling,
    rope_orig_ctx, rope_type, rms_eps ...) and every layer's window equal
    the JAX package's."""
    with GGUFReader(path) as r:
        jhp = jhparams.hparams_from_metadata(r.metadata)
    php = phparams.hparams_from_metadata(PGGUFReader(path).metadata)
    for f in php.__dataclass_fields__:
        assert getattr(php, f) == getattr(jhp, f), f
    assert [phparams.layer_window(php, i) for i in range(php.n_layer)] == \
        [jhparams.layer_window(jhp, i) for i in range(jhp.n_layer)]
    assert phparams.attn_scale_of(php) == jhparams.attn_scale_of(jhp)
    return php


def check_loader(path):
    """Planes, norms and every bias equal the JAX loader's (the fused
    q|k|v and gate|up splits re-fused), and so do the long-rope table and
    the final norm's and lm head's biases."""
    assert_same_weights(path)
    _, jw = jllama.load_weights(GGUFReader(path))
    _, pw = pllama.load_weights(PGGUFReader(path))
    for f in ("rope_inv_freq_long", "output_norm_b", "output_b",
              "output_norm"):
        a, b = getattr(jw, f), getattr(pw, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b)
    return pw


def check_logits(path, kv):
    """A 6-token prefill (every row) and two decode steps against the
    jitted JAX engine."""
    jm, pm = models(path)
    jctx = jengine.Context(jm, kv_type=kv, **CTX)
    js = jctx.new_seq()
    want = [jctx.prefill(js, PROMPT[:6], all_logits=True)]
    want += [jctx.decode([js], [t])[0] for t in PROMPT[6:8]]
    got = port_rows(pm, kv)
    assert got[0].shape == (6, pm.hp.n_vocab)
    for i, (a, b) in enumerate(zip(want, got)):
        assert np.isfinite(b).all()
        assert nmse(a, b) < LOGITS_GATE, (i, nmse(a, b))


def check_op_by_op(path):
    _, pm = models(path)
    want, _ = op_by_op(path)
    for i, (a, b) in enumerate(zip(want, port_rows(pm))):
        assert nmse(a, b) < 1e-10, (i, nmse(a, b))


def check_greedy(path):
    _, pm = models(path)
    _, want = op_by_op(path)
    got = list(pengine.generate(pengine.Context(pm, **CTX), [3, 17, 42], 8))
    assert got == want


def check_batched(path):
    jm, pm = models(path)
    outs = []
    for eng, model in ((jengine, jm), (pengine, pm)):
        ctx = eng.Context(model, **CTX)
        sa, sb, sc = ctx.new_seq(), ctx.new_seq(), ctx.new_seq()
        ctx.prefill(sa, [5, 6, 7])
        ctx.prefill(sb, [100, 101, 102, 103, 104])
        ctx.prefill(sc, [9])
        outs.append(ctx.decode([sa, sb, sc], [11, 12, 13]))
    assert nmse(outs[0], outs[1]) < LOGITS_GATE


def check_reference_parameters(path):
    """port_weights_from_reference carries the new fields: the JAX
    loader's parameters through the port give the port's own logits."""
    _, pm = models(path)
    _, jw = jllama.load_weights(GGUFReader(path))
    model = pengine.Model.from_weights(pm.hp, port_weights_from_reference(jw),
                                       device="cpu")
    got = pengine.Context(model, **CTX)
    own = pengine.Context(pm, **CTX)
    np.testing.assert_array_equal(
        got.prefill(got.new_seq(), PROMPT, all_logits=True),
        own.prefill(own.new_seq(), PROMPT, all_logits=True))


def check_cli(path):
    argv = ["-m", path, "-p", "hello world", "-n", "8", "--temp", "0"]
    want = run(jmain, argv)
    got = run(pmain, argv, device="cpu")
    assert got == want and got[0] == 0


def check_scheduler(path):
    """Greedy requests through the Scheduler's windows, three at once,
    give generate()'s tokens (generate() takes no end-of-generation
    token, so neither do the requests)."""
    _, pm = models(path)
    prompts = [[3, 17, 42 + i] for i in range(3)]
    want = [list(pengine.generate(pengine.Context(pm, **CTX), p, 10))
            for p in prompts]
    sched = Scheduler(pengine.Context(pm, n_ctx=64, n_seq_max=3,
                                      block_size=8), n_slots=3,
                      decode_window=4)
    reqs = [sched.submit(GenRequest(p, max_tokens=10, ignore_eos=True,
                                    sampling=SamplerParams(temp=0.0)))
            for p in prompts]
    sched.run()
    assert [r.output_tokens for r in reqs] == want


def layer0_output(path, tokens):
    """The hidden state after layer 0 of the JAX package's own model, run
    op by op with dense causal attention (no window binds these tokens),
    and what layer 1's attention projections are fed (its attention norm
    of it)."""
    hp, w = jllama.load_weights(GGUFReader(path))
    t = len(tokens)
    with jax.disable_jit():
        x = jllama.embed(w, jnp.asarray([tokens], jnp.int32), hp.embd_scale)
        pos = jnp.arange(t, dtype=jnp.int32)[None]
        mask = jnp.asarray(np.tril(np.ones((t, t), bool)))[None]
        attend = lambda q, k, v: jlayers.attention(
            q, k, v, mask, jhparams.attn_scale_of(hp),
            softcap=hp.attn_softcap)
        x = jllama.forward_layer(x, w.layers[0], hp, pos, w.inv_freq_for(0),
                                 w.rope_mscale, attend)
        lw = w.layers[1]
        cur = (jlayers.layer_norm(x, lw.attn_norm, lw.attn_norm_b,
                                  hp.rms_eps) if hp.norm_type == "ln"
               else jlayers.rms_norm(x, lw.attn_norm, hp.rms_eps))
    f32 = lambda a: np.asarray(a.astype(jnp.float32))[0]
    return f32(x), f32(cur)


def check_imatrix_and_trace(path, jax_imatrix_raises: bool):
    """Fault 11: the JAX imatrix re-implements the layer with RMS norms,
    a sequential residual and a gated FFN, so on a LayerNorm arch its sums
    for layer 1's attention input are another model's, and on a non-gated
    FFN it raises; the port's layers tap the activations of the model they
    serve. The port's tracer (the engine's own forward) gives the JAX
    model's own layer-0 output."""
    from llama_cpp_test_tpu_torch.runtime import tracing as ptracing

    jm, pm = models(path)
    toks = [int(t) for t in np.random.default_rng(0).integers(3, 190, 32)]
    x0, cur = layer0_output(path, toks)
    truth = (cur.astype(np.float64) ** 2).sum(0)
    rel = lambda a: float(np.abs(np.asarray(a, np.float64) - truth).max()
                          / np.abs(truth).max())
    pc = pimatrix.IMatrixCollector(pm)
    pc.collect(toks, chunk=32)
    qkv = [n for n in pc.sums if n.startswith("blk.1.attn_q")]
    assert qkv and all(rel(pc.sums[n]) < 1e-3 for n in qkv), \
        [(n, rel(pc.sums[n])) for n in qkv]
    assert math.isfinite(sum(float(v.sum()) for v in pc.sums.values()))
    jc = jimatrix.IMatrixCollector(jm)
    if jax_imatrix_raises:
        with pytest.raises(Exception), jax.disable_jit():
            jc.collect(toks, chunk=32)
    else:
        with jax.disable_jit():
            jc.collect(toks, chunk=32)
        assert rel(jc.sums["blk.1.attn_q.weight"]) > 0.05
    got = ptracing.trace_eval(pengine.Context(pm, **CTX), toks[:10],
                              keep_values=True)
    want, _ = layer0_output(path, toks[:10])
    assert nmse(want, {t.name: t.values for t in got}["l_out-0"]) < 1e-10


# ---------------------------------------------------------------------------
# the per-fixture tests


@pytest.mark.parametrize("name", ARCHS)
def test_hparams_match_reference(paths, name):
    hp = check_hparams(paths[name])
    assert hp.arch == name and not hp.parallel_residual


@pytest.mark.parametrize("name", ARCHS)
def test_loader_planes_match_reference(paths, name):
    pw = check_loader(paths[name])
    assert (pw.rope_inv_freq_long is not None) == (name == "phi3")


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


# ---------------------------------------------------------------------------
# phi3: the long-rope table and the window that cannot bind


@pytest.mark.parametrize("n_ctx", [24, 32, 48])
def test_phi3_rope_table_follows_n_ctx_as_reference(paths, n_ctx):
    """The Context serves the long table iff n_ctx > rope_orig_ctx (32),
    as the JAX Context picks it; the Model's own weights keep the short
    one; a context shift re-rotates the cached K by the chosen table: the
    cached K/V and the next decode equal the JAX engine's run op by op."""
    jm, pm = models(paths["phi3"])
    kw = dict(CTX, n_ctx=n_ctx)
    with jax.disable_jit():
        jctx = jengine.Context(jm, **kw)
        js = jctx.new_seq()
        jctx.prefill(js, PROMPT[:12])
        jctx.shift_context(js, 2, 5)
        want = cached_kv(jctx, js)
        jl = jctx.decode([js], [11])[0]
    pctx = pengine.Context(pm, **kw)
    np.testing.assert_array_equal(pctx.w.rope_inv_freq.numpy(),
                                  np.asarray(jctx.w.rope_inv_freq))
    long = n_ctx > 32
    assert (pctx.w.rope_inv_freq is pm.weights.rope_inv_freq_long) == long
    assert pm.weights.rope_inv_freq is not pm.weights.rope_inv_freq_long
    ps = pctx.new_seq()
    pctx.prefill(ps, PROMPT[:12])
    pctx.shift_context(ps, 2, 5)
    np.testing.assert_array_equal(cached_kv(pctx, ps), want)
    assert nmse(jl, pctx.decode([ps], [11])[0]) < 1e-10


def _windows_seen(monkeypatch):
    """The window every decode-attention dispatch is given."""
    seen = []
    orig = pkv.attend_decode

    def spy(q, kp, vp, bt, kv_len, scale, window=0, *a, **kw):
        seen.append(window)
        return orig(q, kp, vp, bt, kv_len, scale, window, *a, **kw)

    monkeypatch.setattr(pkv, "attend_decode", spy)
    return seen


@pytest.mark.parametrize("n_ctx,window", [(32, 0), (40, 0), (48, 40),
                                          (64, 40)])
def test_window_that_cannot_bind_is_no_window(paths, monkeypatch, n_ctx,
                                              window):
    """phi3's window (40) on every layer: a Context of n_ctx <= 40 holds
    no position that reaches past it, so its decode is dispatched with no
    window (K3 on the card) and gives the logits of the same model with
    no window; at n_ctx > 40 the window stays, and binds from position 40
    on. Both against the jitted JAX engine, which masks by the window
    (at n_ctx a multiple of the block size: reference fault 4)."""
    jm, pm = models(paths["phi3"])
    toks = [int(t) for t in np.random.default_rng(1).integers(
        3, 280, n_ctx - 3)]
    seen = _windows_seen(monkeypatch)
    ctx = pengine.Context(pm, **dict(CTX, n_ctx=n_ctx))
    s = ctx.new_seq()
    got = [ctx.prefill(s, toks)] + [ctx.decode([s], [t])[0]
                                    for t in (5, 6, 7)]
    assert set(seen) == {window}
    free = pengine.Model(paths["phi3"], device="cpu",
                         hp=dataclasses.replace(pm.hp, sliding_window=0))
    fctx = pengine.Context(free, **dict(CTX, n_ctx=n_ctx))
    fs = fctx.new_seq()
    plain = [fctx.prefill(fs, toks)] + [fctx.decode([fs], [t])[0]
                                        for t in (5, 6, 7)]
    if window == 0:
        for a, b in zip(plain, got):
            np.testing.assert_array_equal(a, b)
    else:
        assert nmse(plain[-1], got[-1]) > 1e-6
    jctx = jengine.Context(jm, **dict(CTX, n_ctx=n_ctx))
    js = jctx.new_seq()
    want = [jctx.prefill(js, toks)] + [jctx.decode([js], [t])[0]
                                       for t in (5, 6, 7)]
    for a, b in zip(want, got):
        assert nmse(a, b) < LOGITS_GATE


def test_step_past_n_ctx_raises(paths):
    """The dispatch drops windows >= n_ctx only because no mask position
    reaches n_ctx: a step that would is refused."""
    _, pm = models(paths["phi3"])
    ctx = pengine.Context(pm, **dict(CTX, n_ctx=16))
    s = ctx.new_seq()
    ctx.prefill(s, PROMPT[:10])
    with pytest.raises(ValueError, match="exceed"):
        ctx.prefill(s, PROMPT[:8])
    with pytest.raises(RuntimeError, match="past n_ctx"):
        ctx._step(np.zeros((1, 8), np.int32), np.arange(10, 18)[None],
                  ctx._table_arr([s]), np.full((1, 8), -1, np.int32),
                  np.asarray([18], np.int32), False)


# ---------------------------------------------------------------------------
# the entry points, imatrix and the tracer


def test_cli_text_matches_reference(paths):
    check_cli(paths["stablelm"])


def test_scheduler_serves_as_generate(paths):
    for name in ("phi3", "olmo2"):
        check_scheduler(paths[name])


def test_imatrix_and_trace_on_stablelm_collect_the_served_model(paths):
    check_imatrix_and_trace(paths["stablelm"], jax_imatrix_raises=False)


def test_trace_eval_on_granite_traces_the_served_model(paths):
    """Fault 12 on granite: the JAX tracer embeds without the embedding
    scale (12), so its l_out-0 is another model's; the port's tracer taps
    the engine's own forward and gives the JAX model's own layer 0."""
    from llama_cpp_test_tpu.runtime import tracing as jtracing
    from llama_cpp_test_tpu_torch.runtime import tracing as ptracing

    jm, pm = models(paths["granite"])
    toks = PROMPT[:10]
    truth, _ = layer0_output(paths["granite"], toks)
    got = ptracing.trace_eval(pengine.Context(pm, **CTX), toks,
                              keep_values=True)
    with jax.disable_jit():
        ref = jtracing.trace_eval(jengine.Context(jm, **CTX), toks,
                                  keep_values=True)
    by = lambda tr: {t.name: t.values for t in tr}
    assert nmse(truth, by(got)["l_out-0"]) < 1e-10
    assert nmse(truth, by(ref)["l_out-0"]) > 1e-2


def test_imatrix_names_the_file_tensors(paths):
    """The port keys each sum by the tensor the file holds: phi3's fused
    attn_qkv and [gate|up] ffn_up, nemotron's non-gated ffn_up."""
    for name, want, absent in (
            ("phi3", {"blk.0.attn_qkv.weight", "blk.0.ffn_up.weight"},
             {"blk.0.attn_q.weight", "blk.0.ffn_gate.weight"}),
            ("nemotron", {"blk.0.attn_q.weight", "blk.0.ffn_up.weight"},
             {"blk.0.ffn_gate.weight"})):
        _, pm = models(paths[name])
        pc = pimatrix.IMatrixCollector(pm)
        pc.collect(PROMPT * 2, chunk=28)
        assert want <= set(pc.sums) and not absent & set(pc.sums), name
        assert set(pc.sums) <= set(PGGUFReader(paths[name]).tensors)


@pytest.mark.parametrize("arch,drop,add,exc,match", [
    ("phi2", (), ("position_embd.weight", (8, 64)), NotImplementedError,
     "outside"),
    ("stablelm", (), ("blk.0.ffn_gate.bias", (128,)), NotImplementedError,
     "outside"),
    ("stablelm", ("blk.0.attn_norm.weight",), None, KeyError,
     "requires pre-norms"),
    ("phi2", ("blk.0.ffn_down.weight",), None, NotImplementedError,
     "FFN tensors"),
    ("phi2", (), ("blk.0.attn_q_norm.weight", (16,)), NotImplementedError,
     "parallel-residual"),
    ("phi3", (), ("rope_factors_long.weight", (8,)), NotImplementedError,
     "as a pair"),
], ids=["learned-positions", "gate-bias", "missing-pre-norm",
        "no-down", "rms-qk-norm-parallel", "one-rope-factor-table"])
def test_layouts_the_port_does_not_carry_raise(tmp_path, arch, drop, add,
                                               exc, match):
    """Tensors outside the served layouts (gpt2's learned positions,
    jais's gate bias), a missing pre-norm on an arch that has them, an
    FFN without its down projection, a 1-D QK norm in a parallel layer
    and one long-rope factor table without the other are refused before
    a tensor is read."""
    from llama_cpp_test_tpu_torch.gguf.writer import GGUFWriter as PWriter

    path = str(tmp_path / "v.gguf")
    w = PWriter(path, arch=arch)
    for k, v in {"block_count": 1, "embedding_length": 64,
                 "attention.head_count": 4, "attention.head_count_kv": 4,
                 "attention.key_length": 16, "feed_forward_length": 128,
                 "rope.dimension_count": 16}.items():
        w.add_kv(f"{arch}.{k}", v)
    names = ["token_embd.weight", "output_norm.weight"] + [
        f"blk.0.{n}" for n in ("attn_norm.weight", "attn_qkv.weight",
                               "attn_output.weight", "ffn_norm.weight",
                               "ffn_up.weight", "ffn_down.weight")]
    for n in names:
        if n not in drop:
            w.add_tensor(n, np.zeros((2, 8), np.float32))
    if add is not None:
        w.add_tensor(add[0], np.zeros(add[1][::-1], np.float32))
    w.write()
    with pytest.raises(exc, match=match):
        pengine.Model(path, device="cpu")


def test_adapters_on_olmo_match_reference(tmp_path):
    """A LoRA over all seven projections and a control vector on olmo, a
    file with no norm tensors (whose weights the adapters used to find
    their device by) and NORM rope: the logits equal the JAX engine's run
    op by op, within 1e-4: the low-rank products sum in another order
    than XLA's (one f32 ulp apart), which flips a few bf16 roundings of
    q, k and v on this fixture."""
    from test_torch_lora import TARGETS, dims_of, write_adapter

    from llama_cpp_test_tpu.models import cvec as jcvec
    from llama_cpp_test_tpu.models import lora as jlora
    from llama_cpp_test_tpu_torch.models import cvec as pcvec
    from llama_cpp_test_tpu_torch.models import lora as plora

    path = str(tmp_path / "olmo.gguf")
    make_tiny_arch(path, SPECS["olmo"], "olmo")
    adapter = write_adapter(str(tmp_path / "a.gguf"),
                            dims_of(C, HQ, HKV, D, FF), L, TARGETS, seed=7)
    vec = {2: np.random.default_rng(2).standard_normal(C).astype(
        np.float32)}
    jm, pm = jengine.Model(path), pengine.Model(path, device="cpu")
    jlora.attach_lora(jm.weights, jlora.load_lora(adapter, jm.hp), 0.7)
    plora.attach_lora(pm.weights, plora.load_lora(adapter, pm.hp), 0.7)
    jcvec.attach_control_vector(jm.weights, vec, 0.5)
    pcvec.attach_control_vector(pm.weights, vec, 0.5)
    ctx = pengine.Context(pm, **CTX)
    got = ctx.prefill(ctx.new_seq(), PROMPT[:8], all_logits=True)
    with jax.disable_jit():
        jctx = jengine.Context(jm, **CTX)
        want = jctx.prefill(jctx.new_seq(), PROMPT[:8], all_logits=True)
    assert nmse(want, got) < 1e-4, nmse(want, got)
