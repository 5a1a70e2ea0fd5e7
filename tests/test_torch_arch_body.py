"""The llama-body archs that need only small switches (llama_cpp_test_tpu_torch
models/{hparams,registry,llama}, runtime/{engine,kv_cache,imatrix,tracing})
against the JAX package, on CPU, on twelve tiny F32 fixtures in the
reference's tensor layout (make_tiny_body):

  minicpm    the llama layout with the mup scales (embedding 12, residual
             0.22, logits 9), tied head
  internlm2  the llama layout, GQA
  baichuan   the 7B layout (rope; no max_alibi_bias key, 2 layers)
  xverse     the llama layout, MHA
  orion      LayerNorms with biases, NEOX rope
  qwen       a fused attn_qkv with its bias, NEOX rope
  exaone     the llama layout with NEOX rope, head dim 20 (no multiple of
             16: the plain versions' D-generic path)
  codeshell  LayerNorms with biases, a fused attn_qkv with bias, wo bias, a
             non-gated GELU FFN with biases, NEOX rope, GQA
  chatglm    q/k/v with biases as the JAX converter writes them, partial
             NORM rope (8 of 16), a fused [gate|up] ffn_up, 2 KV groups
  cohere2    a parallel layer of one weight-only LayerNorm and a gated FFN,
             4 layers: window 5 on layers 0-2, no rope on layer 3, logit
             scale 0.0625, tied head
  plamo      a parallel layer of one RMS norm and a gated FFN, NORM rope
  bitnet     RMS sub-norms before wo and ffn_down, NEOX rope, tied head

Checks, as tests/test_torch_arch_ln.py makes them: hparams and the
loader's planes equal the JAX package's; prefill, decode and
batched-decode logits (bf16 and q8_0 KV) within NMSE 2e-3 of the jitted
JAX engine and within 1e-10 of the JAX engine run op by op; greedy tokens
equal; the JAX-loaded parameters through the port give the port's own
logits. Then cohere2's context shift against the JAX engine run op by op,
bf16 and q8_0, its NoPE layer's K moved unrotated and its first layer's
K equal to a fresh prefill's; the CLI on internlm2, the
Scheduler on cohere2; reference fault 11 on bitnet (the JAX imatrix
leaves out the sub-norms) and fault 12 (its tracer too); and reference
fault 14: a chatglm file whose q|k|v is fused, as llama.cpp converts it,
serves the same model as the split file in the port, not in the
reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_engine import tiny_vocab
from test_torch_arch_ln import (CTX, PROMPT, check_batched, check_cli,
                                check_greedy, check_hparams, check_loader,
                                check_logits, check_op_by_op,
                                check_reference_parameters, check_scheduler,
                                models, nmse, write_fixtures)
from test_torch_engine_pieces import cached_kv

from llama_cpp_test_tpu.gguf.constants import GGMLType
from llama_cpp_test_tpu.gguf.reader import GGUFReader
from llama_cpp_test_tpu.gguf.writer import GGUFWriter
from llama_cpp_test_tpu.models import hparams as jhparams
from llama_cpp_test_tpu.models import llama as jllama
from llama_cpp_test_tpu.ops import layers as jlayers
from llama_cpp_test_tpu.runtime import engine as jengine
from llama_cpp_test_tpu.runtime import imatrix as jimatrix
from llama_cpp_test_tpu_torch.runtime import engine as pengine
from llama_cpp_test_tpu_torch.runtime import imatrix as pimatrix

V = 288

# arch -> the layout of its tiny fixture (make_tiny_body): geometry c, hq,
# hkv, d, ff, n_layer; norm "rms" | "ln", norm_bias (LayerNorm biases),
# ffn_norm (a pre-FFN norm; a parallel layer has one norm); qkv "fused" |
# "split", qkv_bias, bo; ffn "gated" | "fused" ([gate|up] in ffn_up) |
# "up" (non-gated), ffn_bias (up and down), down_bias, gate_bias;
# sub_norms (bitnet); pos_rows (learned position rows), tok_norm (the
# embedding LayerNorm), types (token-type rows); post_norm (an encoder's
# LayerNorms of the residual sums, no pre-norms, no final norm, no head);
# qk_norm "rms" ([d] weights) | "ln_bias" ([H, d] LayerNorms with biases);
# layers (per-layer (hq, hkv, ff), written as GGUF arrays; hq 0 an
# attention-free layer, hkv 0 a linear-attention one); tied, rope_dim,
# window, meta (more keys)
BODY = {
    "minicpm": dict(tied=True, meta={"embedding_scale": 12.0,
                                     "residual_scale": 0.22,
                                     "logit_scale": 9.0}),
    "internlm2": dict(),
    "baichuan": dict(hkv=4),
    "xverse": dict(hkv=4),
    "orion": dict(norm="ln", norm_bias=True, hkv=4),
    "qwen": dict(qkv="fused", qkv_bias=True, hkv=4),
    "exaone": dict(d=20),
    "codeshell": dict(norm="ln", norm_bias=True, qkv="fused", qkv_bias=True,
                      bo=True, ffn="up", ffn_bias=True),
    "chatglm": dict(qkv_bias=True, ffn="fused", rope_dim=8),
    "cohere2": dict(norm="ln", ffn_norm=False, tied=True, window=5,
                    n_layer=4, meta={"logit_scale": 0.0625}),
    "plamo": dict(ffn_norm=False),
    "bitnet": dict(sub_norms=True, tied=True),
}
ARCHS = list(BODY)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist every
    worker's OpenMP pool takes all cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_tiny_body(path, spec: dict, arch: str, seed=0):
    """An F32 GGUF of arch `arch` laid out by `spec` (see BODY): by
    default 2 layers of width 64, 4 query heads on 2 KV heads of 16 dims,
    FFN 128, RMS norms, separate q/k/v, a gated FFN, an SPM vocabulary of
    288 tokens (the JAX CLI's sampler takes a top-k of 256). spec's
    layers gives each layer its own head counts and FFN width."""
    rng = np.random.default_rng(seed)
    rand = lambda *shape, s=0.08: (rng.standard_normal(shape) * s).astype(
        np.float32)
    norm = lambda *n: 1.0 + rand(*n, s=0.05)
    bias = lambda n: rand(n, s=0.05)
    sp = dict(dict(c=64, hq=4, hkv=2, d=16, ff=128, n_layer=2, norm="rms",
                   qkv="split", ffn="gated", ffn_norm=True), **spec)
    c, d = sp["c"], sp["d"]
    geom = sp.get("layers") or [(sp["hq"], sp["hkv"], sp["ff"])] * \
        sp["n_layer"]
    post = sp.get("post_norm")
    ln_bias = sp["norm"] == "ln" and sp.get("norm_bias")

    def add_norm(name, n=c):
        wts[name + ".weight"] = norm(n)
        if ln_bias:
            wts[name + ".bias"] = bias(n)

    wts = {"token_embd.weight": rand(V, c, s=0.3)}
    if sp.get("pos_rows"):
        wts["position_embd.weight"] = rand(sp["pos_rows"], c, s=0.3)
    if sp.get("types"):
        wts["token_types.weight"] = rand(2, c, s=0.3)
    if sp.get("tok_norm"):
        wts["token_embd_norm.weight"] = norm(c)
        wts["token_embd_norm.bias"] = bias(c)
    if not post:
        add_norm("output_norm")
    if not (sp.get("tied") or post):
        wts["output.weight"] = rand(V, c, s=0.2)
    for i, (hq, hkv, ff) in enumerate(geom):
        p = f"blk.{i}."
        if post:
            add_norm(p + "attn_output_norm")
            add_norm(p + "layer_output_norm")
        elif hq:
            add_norm(p + "attn_norm")
        if sp["ffn_norm"] and not post:
            add_norm(p + "ffn_norm")
        if hq == 0:                   # attention-free: the FFN alone
            pass
        elif hkv == 0:                # linear attention: wo on the norm
            wts[p + "attn_output.weight"] = rand(c, c)
        elif sp["qkv"] == "fused":
            wts[p + "attn_qkv.weight"] = rand((hq + 2 * hkv) * d, c)
            if sp.get("qkv_bias"):
                wts[p + "attn_qkv.bias"] = bias((hq + 2 * hkv) * d)
        else:
            for n, h in (("attn_q", hq), ("attn_k", hkv), ("attn_v", hkv)):
                wts[p + n + ".weight"] = rand(h * d, c)
                if sp.get("qkv_bias"):
                    wts[p + n + ".bias"] = bias(h * d)
        if hq and hkv:
            wts[p + "attn_output.weight"] = rand(c, hq * d)
            if sp.get("bo"):
                wts[p + "attn_output.bias"] = bias(c)
            if sp.get("qk_norm") == "rms":
                wts[p + "attn_q_norm.weight"] = norm(d)
                wts[p + "attn_k_norm.weight"] = norm(d)
            elif sp.get("qk_norm") == "ln_bias":
                for n, h in (("attn_q_norm", hq), ("attn_k_norm", hkv)):
                    wts[p + n + ".weight"] = norm(h, d)
                    wts[p + n + ".bias"] = rand(h, d, s=0.05)
        if sp["ffn"] == "gated":
            wts[p + "ffn_gate.weight"] = rand(ff, c)
            wts[p + "ffn_up.weight"] = rand(ff, c)
        else:
            wts[p + "ffn_up.weight"] = rand(
                (2 if sp["ffn"] == "fused" else 1) * ff, c)
        wts[p + "ffn_down.weight"] = rand(c, ff)
        if sp.get("ffn_bias"):
            wts[p + "ffn_up.bias"] = bias(ff)
        if sp.get("ffn_bias") or sp.get("down_bias"):
            wts[p + "ffn_down.bias"] = bias(c)
        if sp.get("gate_bias"):
            wts[p + "ffn_gate.bias"] = bias(ff)
        if sp.get("sub_norms"):
            wts[p + "attn_sub_norm.weight"] = norm(hq * d)
            wts[p + "ffn_sub_norm.weight"] = norm(ff)
    eps = ("attention.layer_norm_epsilon" if sp["norm"] == "ln"
           else "attention.layer_norm_rms_epsilon")
    per_layer = lambda j: (geom[0][j] if not sp.get("layers")
                           else [g[j] for g in geom])
    md = {"context_length": sp.get("n_ctx_train", 256),
          "embedding_length": c, "block_count": len(geom),
          "attention.head_count": per_layer(0),
          "attention.head_count_kv": per_layer(1),
          "attention.key_length": d, "attention.value_length": d,
          "feed_forward_length": per_layer(2),
          "rope.dimension_count": sp.get("rope_dim", d),
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


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return write_fixtures(tmp_path_factory, {
        name: (lambda p, n=name: make_tiny_body(p, BODY[n], n))
        for name in ARCHS})


# ---------------------------------------------------------------------------
# the served model's own layer 0, and the imatrix and tracer against it


def layer0_output(path, tokens):
    """The hidden state after layer 0 of the JAX package's own model, run
    op by op with dense causal attention (no window binds these tokens; the
    ALiBi bias of an ALiBi file) after its embedding extras, and what layer
    1's attention projections are fed (its attention norm of it)."""
    hp, w = jllama.load_weights(GGUFReader(path))
    t = len(tokens)
    with jax.disable_jit():
        pos = jnp.arange(t, dtype=jnp.int32)[None]
        x = jllama.embed(w, jnp.asarray([tokens], jnp.int32), hp.embd_scale)
        if hp.pos_embd != "rope":
            x = jllama.embed_extras(w, hp, x, pos)
        mask = jnp.asarray(np.tril(np.ones((t, t), bool)))[None]
        alibi = (jnp.asarray(jlayers.alibi_slopes(
            hp.n_head, hp.alibi_max_bias, style=hp.alibi_style))
            if hp.alibi else None)
        attend = lambda q, k, v: jlayers.attention(
            q, k, v, mask, jhparams.attn_scale_of(hp),
            softcap=hp.attn_softcap, alibi=alibi)
        x = jllama.forward_layer(x, w.layers[0], hp, pos, w.inv_freq_for(0),
                                 w.rope_mscale, attend)
        lw = w.layers[1]
        cur = (jlayers.layer_norm(x, lw.attn_norm, lw.attn_norm_b,
                                  hp.rms_eps) if hp.norm_type == "ln"
               else jlayers.rms_norm(x, lw.attn_norm, hp.rms_eps))
    f32 = lambda a: np.asarray(a.astype(jnp.float32))[0]
    return f32(x), f32(cur)


def check_imatrix_and_trace(path, jax_imatrix_raises: bool):
    """Faults 11 and 12 on the new axes: the JAX imatrix re-implements the
    layer without the sub-norms, the gate bias, the embedding extras and
    ALiBi (and raises on a non-gated FFN), so its sums for layer 1's
    attention input are another model's; the port's layers tap the
    activations of the model they serve, and its tracer (the engine's own
    forward) gives the JAX model's own layer-0 output, where the JAX
    tracer's embedding leaves out the extras."""
    from llama_cpp_test_tpu.runtime import tracing as jtracing
    from llama_cpp_test_tpu_torch.runtime import tracing as ptracing

    jm, pm = models(path)
    toks = [int(t) for t in np.random.default_rng(0).integers(3, 190, 32)]
    _, cur = layer0_output(path, toks)
    truth = (cur.astype(np.float64) ** 2).sum(0)
    rel = lambda a: float(np.abs(np.asarray(a, np.float64) - truth).max()
                          / np.abs(truth).max())
    pc = pimatrix.IMatrixCollector(pm)
    pc.collect(toks, chunk=32)
    qkv = [n for n in pc.sums if n.startswith("blk.1.attn_q")]
    assert qkv and all(rel(pc.sums[n]) < 1e-3 for n in qkv), \
        [(n, rel(pc.sums[n])) for n in qkv]
    jc = jimatrix.IMatrixCollector(jm)
    if jax_imatrix_raises:
        with pytest.raises(Exception), jax.disable_jit():
            jc.collect(toks, chunk=32)
    else:
        with jax.disable_jit():
            jc.collect(toks, chunk=32)
        assert rel(jc.sums["blk.1.attn_q.weight"]) > 0.05
    want, _ = layer0_output(path, toks[:10])
    got = ptracing.trace_eval(pengine.Context(pm, **CTX), toks[:10],
                              keep_values=True)
    by = lambda tr: {t.name: t.values for t in tr}
    assert nmse(want, by(got)["l_out-0"]) < 1e-10
    if jm.hp.pos_embd != "rope":
        with jax.disable_jit():
            ref = jtracing.trace_eval(jengine.Context(jm, **CTX), toks[:10],
                                      keep_values=True)
        assert nmse(want, by(ref)["l_out-0"]) > 1e-2


# ---------------------------------------------------------------------------
# the per-fixture tests


@pytest.mark.parametrize("name", ARCHS)
def test_hparams_match_reference(paths, name):
    hp = check_hparams(paths[name])
    assert hp.arch == name and hp.pos_embd == "rope" and not hp.alibi
    assert hp.parallel_residual == (name in ("cohere2", "plamo"))


@pytest.mark.parametrize("name", ARCHS)
def test_loader_planes_match_reference(paths, name):
    pw = check_loader(paths[name])
    lw = pw.layers[0]
    assert (lw.attn_sub_norm is not None) == (name == "bitnet")
    assert pw.nope_global == (name == "cohere2")
    assert [pw.inv_freq_for(jhparams.layer_window(check_hparams(
        paths[name]), i)) is None for i in range(len(pw.layers))] == \
        [name == "cohere2" and i == 3 for i in range(len(pw.layers))]


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
# cohere2: the context shift over its NoPE global layer


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
def test_cohere2_shift_matches_reference(paths, kv):
    """A context shift re-rotates the sliding layers' K and moves the
    global layer's K unrotated (it took no rope): the cached K/V equal the
    JAX engine's run op by op, and so do the next decode's logits. Against
    a fresh prefill of the tokens the shift kept: layer 0's K (a function
    of each token alone) within a rotation's rounding, and the global
    layer's K equal to its rows before the shift. (A deeper layer's K and
    the logits depend on the dropped tokens, which the shift does not
    recompute, in the reference and in llama.cpp alike.)"""
    jm, pm = models(paths["cohere2"])
    kw = dict(CTX, kv_type=kv)
    with jax.disable_jit():
        jctx = jengine.Context(jm, **kw)
        js = jctx.new_seq()
        jctx.prefill(js, PROMPT[:12])
        jctx.shift_context(js, 2, 5)
        want = cached_kv(jctx, js)
        jl = jctx.decode([js], [11])[0]
    pctx = pengine.Context(pm, **kw)
    ps = pctx.new_seq()
    pctx.prefill(ps, PROMPT[:12])
    before = cached_kv(pctx, ps)
    pctx.shift_context(ps, 2, 5)
    after = cached_kv(pctx, ps)
    np.testing.assert_array_equal(after, want)
    assert nmse(jl, pctx.decode([ps], [11])[0]) < 1e-10
    kept = [0, 1] + list(range(7, 12))
    np.testing.assert_array_equal(after[0, 3], before[0, 3][:, kept])
    assert nmse(before[0, 3], before[0, 3][:, ::-1]) > 1e-2
    fresh = pengine.Context(pm, **kw)
    fs = fresh.new_seq()
    fresh.prefill(fs, [PROMPT[i] for i in kept])
    assert nmse(cached_kv(fresh, fs)[0, 0], after[0, 0]) < 1e-4


# ---------------------------------------------------------------------------
# the entry points, imatrix and the tracer


def test_cli_text_matches_reference(paths):
    check_cli(paths["internlm2"])


def test_scheduler_serves_as_generate(paths):
    check_scheduler(paths["cohere2"])


def test_imatrix_and_trace_on_bitnet_collect_the_served_model(paths):
    check_imatrix_and_trace(paths["bitnet"], jax_imatrix_raises=False)


def test_fused_chatglm_serves_the_split_model(tmp_path, paths):
    """Fault 14: llama.cpp's converter keeps chatglm's fused q|k|v with
    its NORM (interleaved) rope rows. The port un-permutes the fused rows
    as it un-permutes separate attn_q and attn_k, so the fused file gives
    the split file's logits; the reference splits the fused rows without
    it and ropes interleaved pairs as half-split ones."""
    fused = str(tmp_path / "chatglm_fused.gguf")
    split = paths["chatglm"]
    r = GGUFReader(split)
    wts = {n: r.dequantize(n, np.float32) for n in r.tensors}
    md = dict(r.metadata)
    r.close()
    for i in range(2):
        p = f"blk.{i}."
        wts[p + "attn_qkv.weight"] = np.concatenate(
            [wts.pop(p + f"attn_{x}.weight") for x in "qkv"])
        wts[p + "attn_qkv.bias"] = np.concatenate(
            [wts.pop(p + f"attn_{x}.bias") for x in "qkv"])
    w = GGUFWriter(fused, arch="chatglm")
    for key, val in md.items():
        if key != "general.architecture" and not key.startswith("GGUF."):
            w.add_kv(key, val)
    for name, arr in wts.items():
        w.add_tensor(name, arr, ggml_type=GGMLType.F32)
    w.write()

    def rows(eng, path, **kw):
        ctx = eng.Context(eng.Model(path, **kw), **CTX)
        return ctx.prefill(ctx.new_seq(), PROMPT[:8], all_logits=True)

    want = rows(pengine, split, device="cpu")
    assert nmse(want, rows(pengine, fused, device="cpu")) < 1e-10
    assert nmse(rows(jengine, split), rows(jengine, fused)) > 1e-3
