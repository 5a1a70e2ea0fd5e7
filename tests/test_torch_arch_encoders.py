"""The bert-family encoders of the port (llama_cpp_test_tpu_torch models/
{hparams,registry,llama}, ops/layers, runtime/{engine,kv_cache,imatrix,
tracing}, cli/{embedding,retrieval}, server/app) against the JAX package,
on CPU, on three tiny F32 fixtures in the reference's tensor layout
(test_torch_arch_body.make_tiny_body):

  bert          post-norm layers (LayerNorms with biases over the
                residual sums), 64 learned positions, the token-type row,
                the embedding LayerNorm, Q/K/V and wo biases, a non-gated
                erf-GELU FFN with biases, CLS pooling, no LM head
  nomic-bert    the same body with NEOX rope, a bias-free fused attn_qkv
                and a SwiGLU FFN, mean pooling
  jina-bert-v2  symmetric ALiBi (-slope * |i - j|, no position rows), Q/K/V
                and wo biases, an erf-GELU GeGLU with a down bias, mean
                pooling

Checks: hparams and the loader's planes equal the JAX package's; the
pooled embeddings (CLS, mean, last) at bf16 and q8_0 KV within NMSE 2e-3
of the jitted JAX engine and within 1e-10 of the JAX engine run op by op;
the symmetric-ALiBi attention against the JAX function; the JAX-loaded
parameters through the port give the port's own embeddings; the
embedding and retrieval CLIs print what the JAX CLIs print, their
numbers (entries of unit vectors, cosines) within 2e-3 of the jitted JAX
CLI's; the server's /v1/embeddings and /rerank against the JAX
server's, its n_ctx cut to the learned table; a generation request on an
encoder answered 400 where the reference's engine thread dies (fault 22);
the imatrix and the tracer on bert against the JAX model's own layer
(faults 11 and 12); jina's GeGLU against an independent float64 forward,
which the reference's SiLU misses (fault 17); and the layouts an encoder
does not carry raise.

The reference's swiglu takes SiLU for the erf GELU (fault 17): the parity
checks run the JAX side with an erf-GELU swiglu in its place
(_reference_geglu), the fault test with its own.
"""
import io
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_arch_body import make_tiny_body
from test_torch_arch_ln import (LOGITS_GATE, check_hparams, models, nmse,
                                write_fixtures)

from llama_cpp_test_tpu.cli import embedding as jembedding
from llama_cpp_test_tpu.cli import retrieval as jretrieval
from llama_cpp_test_tpu.gguf.reader import GGUFReader
from llama_cpp_test_tpu.models import hparams as jhparams
from llama_cpp_test_tpu.models import llama as jllama
from llama_cpp_test_tpu.ops import layers as jlayers
from llama_cpp_test_tpu.runtime import engine as jengine
from llama_cpp_test_tpu.runtime import imatrix as jimatrix
from llama_cpp_test_tpu.runtime import scheduler as jscheduler
from llama_cpp_test_tpu_torch.cli import embedding as pembedding
from llama_cpp_test_tpu_torch.cli import retrieval as pretrieval
from llama_cpp_test_tpu_torch.gguf.reader import GGUFReader as PGGUFReader
from llama_cpp_test_tpu_torch.models import llama as pllama
from llama_cpp_test_tpu_torch.ops import layers as players
from llama_cpp_test_tpu_torch.runtime import engine as pengine
from llama_cpp_test_tpu_torch.runtime import imatrix as pimatrix
from llama_cpp_test_tpu_torch.runtime import tracing as ptracing
from llama_cpp_test_tpu_torch.weights import port_weights_from_reference

ENC = dict(post_norm=True, types=True, tok_norm=True, norm="ln",
           norm_bias=True, hkv=4)
ENCODERS = {
    "bert": dict(ENC, pos_rows=64, n_ctx_train=64, qkv_bias=True, bo=True,
                 ffn="up", ffn_bias=True, meta={"pooling_type": 2}),
    "nomic-bert": dict(ENC, qkv="fused", meta={"pooling_type": 1}),
    "jina-bert-v2": dict(ENC, qkv_bias=True, bo=True, down_bias=True,
                         meta={"pooling_type": 1}),
}
ARCHS = list(ENCODERS)
POOLINGS = ("cls", "mean", "last")
TOKENS = [3, 17, 42, 9, 150, 7, 23, 88, 5, 61, 100]
CTX = dict(n_ctx=64, n_seq_max=2, block_size=8)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist every
    worker's OpenMP pool takes all cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _erf_geglu(orig):
    def swiglu(gate, up, act="silu"):
        if act != "gelu_erf":
            return orig(gate, up, act)
        g = gate.astype(jnp.float32)
        return (jax.nn.gelu(g, approximate=False)
                * up.astype(jnp.float32)).astype(gate.dtype)
    return swiglu


@pytest.fixture(scope="module", autouse=True)
def _reference_geglu():
    """Fault 17 worked around: while this module runs, the reference's
    swiglu takes the erf GELU its hparams ask for on jina-bert-v2 (its
    own falls back to SiLU). Yields the reference's own swiglu."""
    orig = jlayers.swiglu
    jlayers.swiglu = _erf_geglu(orig)
    yield orig
    jlayers.swiglu = orig


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return write_fixtures(tmp_path_factory, {
        name: (lambda p, n=name: make_tiny_body(p, ENCODERS[n], n))
        for name in ARCHS})


def embed_rows(eng, model, kv="bf16", tokens=TOKENS):
    """The pooled embeddings of `tokens` at each pooling."""
    ctx = eng.Context(model, kv_type=kv, **CTX)
    return [np.asarray(ctx.embed(tokens, p)) for p in POOLINGS]


_OP_BY_OP: dict = {}


def op_by_op(path):
    """The JAX engine's pooled embeddings run op by op, once a fixture."""
    if path not in _OP_BY_OP:
        jm, _ = models(path)
        with jax.disable_jit():
            _OP_BY_OP[path] = embed_rows(jengine, jm)
    return _OP_BY_OP[path]


def run(main, argv, **kw):
    old = sys.stdout
    sys.stdout = io.StringIO()
    try:
        return main(argv, **kw), sys.stdout.getvalue()
    finally:
        sys.stdout = old


_NUM = re.compile(r"-?\d+\.\d+(?:e-?\d+)?")


def same_printout(want, got, tol=2e-3):
    """The same text with every number replaced, and each number within
    tol of the JAX CLI's (jitted XLA drops some bf16 roundings: an entry
    of a unit embedding moves by up to ~5e-4)."""
    assert want[0] == got[0] == 0
    assert _NUM.sub("#", want[1]) == _NUM.sub("#", got[1]), (want, got)
    a = np.asarray([float(x) for x in _NUM.findall(want[1])])
    b = np.asarray([float(x) for x in _NUM.findall(got[1])])
    assert a.size and np.abs(a - b).max() <= tol, np.abs(a - b).max()


# ---------------------------------------------------------------------------
# hparams, planes, embeddings


@pytest.mark.parametrize("name", ARCHS)
def test_hparams_match_reference(paths, name):
    hp = check_hparams(paths[name])
    assert hp.arch == name and hp.post_norm and not hp.causal
    assert hp.pooling == ("cls" if name == "bert" else "mean")
    assert hp.alibi_sym == hp.alibi == (name == "jina-bert-v2")
    assert hp.pos_embd == {"bert": "learned", "nomic-bert": "rope",
                           "jina-bert-v2": "none"}[name]


@pytest.mark.parametrize("name", ARCHS)
def test_loader_planes_match_reference(paths, name):
    """Every plane, norm and bias equals the JAX loader's, the encoders'
    post-norms and token-type rows too; the port keeps no LM head (the
    reference points its head at the embedding rows)."""
    from test_torch_model import assert_same_qtensor

    _, jw = jllama.load_weights(GGUFReader(paths[name]))
    _, pw = pllama.load_weights(PGGUFReader(paths[name]))
    assert pw.output is None and pw.output_norm is None
    assert_same_qtensor(jw.tok_embd, pw.tok_embd, "tok_embd")
    for f in ("type_embd", "pos_embd", "tok_norm", "tok_norm_b"):
        a, b = getattr(jw, f), getattr(pw, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert pw.type_embd.shape == (2, 64)
    for i, (jl, pl) in enumerate(zip(jw.layers, pw.layers)):
        assert pl.attn_out_norm is not None and pl.layer_out_norm_b is not None
        for f in pllama.LayerWeights.__dataclass_fields__:
            a, b = getattr(jl, f), getattr(pl, f)
            assert (a is None) == (b is None), (i, f)
            if isinstance(b, pllama.QTensor):
                assert_same_qtensor(a, b, f"blk.{i}.{f}")
            elif isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
@pytest.mark.parametrize("name", ARCHS)
def test_embeddings_match_reference(paths, name, kv):
    """Each pooling, at unit norm, within the logits gate of the jitted
    JAX engine's."""
    jm, pm = models(paths[name])
    for pooling, a, b in zip(POOLINGS, embed_rows(jengine, jm, kv),
                             embed_rows(pengine, pm, kv)):
        assert np.isfinite(b).all() and b.shape == (64,)
        assert abs(float(np.linalg.norm(b)) - 1.0) < 1e-5
        assert nmse(a, b) < LOGITS_GATE, (pooling, nmse(a, b))


@pytest.mark.parametrize("name", ARCHS)
def test_embeddings_match_reference_op_by_op(paths, name):
    """The model's own pooling by default (bert CLS, the others mean) and
    bidirectional attention: each pooling within 1e-10 of the JAX engine
    run op by op; the default equals its pooling's row."""
    _, pm = models(paths[name])
    got = embed_rows(pengine, pm)
    for pooling, a, b in zip(POOLINGS, op_by_op(paths[name]), got):
        assert nmse(a, b) < 1e-10, (pooling, nmse(a, b))
    default = pengine.Context(pm, **CTX).embed(TOKENS)
    np.testing.assert_array_equal(default,
                                  got[POOLINGS.index(pm.hp.pooling)])
    causal = pengine.Context(pm, **CTX).embed(TOKENS, causal=True)
    assert nmse(default, causal) > 1e-4


@pytest.mark.parametrize("rows", ["encoder", "causal"])
def test_symmetric_alibi_attention_matches_reference(rows):
    """layers.attention with alibi_sym_pos: -slope_h * |pos - s| after the
    softcap and before the mask, on non-causal and on causal rows, against
    the JAX function, GQA 8 heads on 2."""
    rng = np.random.default_rng(5)
    b, t, s, h, kv, d = 2, 6, 16, 8, 2, 16
    q, k, v = (rng.standard_normal(sh).astype(np.float32) for sh in
               ((b, t, h, d), (b, s, kv, d), (b, s, kv, d)))
    pos = np.stack([np.arange(t) + 3, np.arange(t) + 9]).astype(np.int32)
    kv_len = np.asarray([9, 15], np.int32)
    mask_pos = pos if rows == "causal" else \
        np.broadcast_to((kv_len - 1)[:, None], pos.shape)
    mask = (np.arange(s)[None, None] <= mask_pos[:, :, None]) & \
        (np.arange(s)[None, None] < kv_len[:, None, None])
    slopes = jlayers.alibi_slopes(h, 8.0)
    want = jlayers.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(mask), 0.25, softcap=30.0,
                             alibi=jnp.asarray(slopes),
                             alibi_sym_pos=jnp.asarray(pos))
    got = players.attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), torch.from_numpy(mask),
                            0.25, softcap=30.0,
                            alibi=torch.from_numpy(slopes),
                            alibi_sym_pos=torch.from_numpy(pos))
    assert nmse(np.asarray(want), got.numpy()) < 1e-12
    plain = players.attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(mask),
                              0.25, softcap=30.0,
                              alibi=torch.from_numpy(slopes))
    # on causal rows the two forms differ by a constant a row: the same
    # softmax; on an encoder's rows they differ
    assert (nmse(plain.numpy(), got.numpy()) < 1e-10) == (rows == "causal")


@pytest.mark.parametrize("name", ARCHS)
def test_port_runs_on_reference_parameters(paths, name):
    """port_weights_from_reference carries the post-norms, the token-type
    rows and no LM head: the JAX-loaded parameters through the port give
    the port's own embeddings, to the bit."""
    _, pm = models(paths[name])
    _, jw = jllama.load_weights(GGUFReader(paths[name]))
    pw = port_weights_from_reference(jw)
    assert pw.output is None
    model = pengine.Model.from_weights(pm.hp, pw, device="cpu")
    for a, b in zip(embed_rows(pengine, model), embed_rows(pengine, pm)):
        np.testing.assert_array_equal(a, b)


def test_encoder_has_no_lm_head(paths):
    """A prefill for logits on an encoder raises in both packages: the
    port names the encoder, the reference's head is the embedding rows
    and its matmul asserts on their layout."""
    jm, pm = models(paths["bert"])
    ctx = pengine.Context(pm, **CTX)
    with pytest.raises(NotImplementedError, match="encoder"):
        ctx.prefill(ctx.new_seq(), TOKENS)
    jctx = jengine.Context(jm, **CTX)
    with pytest.raises(AssertionError):
        jctx.prefill(jctx.new_seq(), TOKENS)


def test_bert_context_fits_the_learned_table(paths):
    """engine.fit_n_ctx cuts a Context size to BERT's 64-row table (a
    longer Context is refused, fault 15) and leaves a rope encoder's."""
    _, pm = models(paths["bert"])
    assert pengine.fit_n_ctx(pm, 2048) == 64
    assert pengine.fit_n_ctx(pm, 32) == 32
    with pytest.raises(ValueError, match="learned position table"):
        pengine.Context(pm, n_ctx=128)
    _, nomic = models(paths["nomic-bert"])
    assert pengine.fit_n_ctx(nomic, 2048) == 2048


# ---------------------------------------------------------------------------
# the CLIs and the server


@pytest.mark.parametrize("name", ARCHS)
def test_embedding_cli_matches_reference(paths, name):
    """The default printout, --similarity and --embd-output-format json
    (mean pooling) print what the JAX CLI prints (its Context 2048 tokens,
    the port's cut to bert's table)."""
    path = paths[name]
    for argv in (["-p", "hello world", "-p", "the cat sat"],
                 ["-p", "hello world\nthe cat sat\nworld", "--similarity"],
                 ["-p", "hello", "--embd-output-format", "json",
                  "--pooling", "mean"]):
        argv = ["-m", path] + argv
        same_printout(run(jembedding.main, argv),
                      run(pembedding.main, argv, device="cpu"))


@pytest.mark.parametrize("name", ARCHS)
def test_retrieval_cli_matches_reference(paths, name, tmp_path):
    docs = tmp_path / "docs.txt"
    docs.write_text("the cat sat on the mat\nhello world again\n"
                    "some other words here\nnumbers one two three\n")
    argv = ["-m", paths[name], "-f", str(docs), "--chunk-size", "10",
            "--query", "hello cat", "--query", "one two", "--top-k", "3"]
    want = run(jretrieval.main, argv)
    got = run(pretrieval.main, argv, device="cpu")
    same_printout(want, got)


def _servers(path):
    from test_torch_server import Client

    from llama_cpp_test_tpu.server import app as japp
    from llama_cpp_test_tpu_torch.server import app as papp

    srv = papp.LlamaServer(path, n_ctx=2048, n_slots=2, device="cpu")
    jsrv = japp.LlamaServer(path, n_ctx=2048, n_slots=2)
    for s in (srv, jsrv):
        s.engine.start()
    return (srv, Client(srv)), (jsrv, Client(jsrv))


def _stop(*pairs):
    for srv, c in pairs:
        c.close()
        srv.engine.stop()
        assert not srv.engine.thread.is_alive()


@pytest.mark.parametrize("name", ARCHS)
def test_server_embeddings_and_rerank_match_reference(paths, name):
    """/v1/embeddings with the model's own pooling (and CLS asked for)
    within the logits gate of the JAX server's, /rerank in its order; the
    port's Context is cut to bert's learned table, the JAX server's is
    not."""
    pytest.importorskip("aiohttp")
    (srv, c), (jsrv, jc) = _servers(paths[name])
    try:
        assert srv.sched.ctx.n_ctx == (64 if name == "bert" else 2048)
        assert jsrv.sched.ctx.n_ctx == 2048
        for body in ({"input": [TOKENS, "hello world"]},
                     {"input": "the cat sat", "pooling": "cls"}):
            (_, got), (_, want) = c.post("/v1/embeddings", body), \
                jc.post("/v1/embeddings", body)
            assert got["usage"] == want["usage"]
            for g, w in zip(got["data"], want["data"]):
                g, w = np.asarray(g["embedding"]), np.asarray(w["embedding"])
                assert nmse(w, g) < LOGITS_GATE, nmse(w, g)
        body = {"query": "hello world", "documents": [
            "zzz qqq", "hello world", "world hello", "the cat", "abc"]}
        (_, got), (_, want) = c.post("/rerank", body), \
            jc.post("/rerank", body)
        assert [r["index"] for r in got["results"]] == \
            [r["index"] for r in want["results"]]
        assert got["results"][0]["index"] == 1
    finally:
        _stop((srv, c), (jsrv, jc))


def test_generation_on_an_encoder_answers_400(paths):
    """Fault 22: a completion on an encoder reaches the reference's LM
    head, whose assertion escapes Scheduler.step and ends its server's
    engine thread (the request never answers). The port answers 400 on
    every generation route and goes on serving embeddings."""
    pytest.importorskip("aiohttp")
    from test_torch_server import Client

    from llama_cpp_test_tpu_torch.server import app as papp

    jm, _ = models(paths["bert"])
    sched = jscheduler.Scheduler(jengine.Context(jm, **CTX), n_slots=1)
    sched.submit(jscheduler.GenRequest([3, 17, 42], max_tokens=4))
    with pytest.raises(AssertionError):
        sched.step()
    srv = papp.LlamaServer(paths["bert"], n_ctx=64, n_slots=1, device="cpu")
    srv.engine.start()
    c = Client(srv)
    try:
        for url, body in (("/completion", {"prompt": "hello"}),
                          ("/v1/completions", {"prompt": "hello",
                                               "stream": True}),
                          ("/v1/chat/completions", {"messages": [
                              {"role": "user", "content": "hi"}]})):
            status, out = c.post(url, body)
            assert status == 400 and "encoder" in out["error"], (url, out)
        status, out = c.post("/v1/embeddings", {"input": "hello"})
        assert status == 200 and len(out["data"][0]["embedding"]) == 64
    finally:
        _stop((srv, c))


def test_lora_on_bert_matches_reference(paths, tmp_path):
    """A LoRA over bert's q, k, v, wo, up and down in both layers: the
    post-norm layer applies each update as the reference does, so the
    pooled embedding equals the JAX engine's run op by op within 1e-4 (the
    low-rank products sum in another order than XLA's), and moves far
    from the base's."""
    from test_torch_lora import dims_of, write_adapter

    from llama_cpp_test_tpu.models import lora as jlora
    from llama_cpp_test_tpu_torch.models import lora as plora

    path = paths["bert"]
    adapter = write_adapter(
        str(tmp_path / "a.gguf"), dims_of(64, 4, 4, 16, 128), 2,
        ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_up",
         "ffn_down"), seed=5)
    jm, pm = jengine.Model(path), pengine.Model(path, device="cpu")
    base = pengine.Context(pm, **CTX).embed(TOKENS, "mean")
    jlora.attach_lora(jm.weights, jlora.load_lora(adapter, jm.hp), 0.7)
    plora.attach_lora(pm.weights, plora.load_lora(adapter, pm.hp), 0.7)
    got = pengine.Context(pm, **CTX).embed(TOKENS, "mean")
    with jax.disable_jit():
        want = jengine.Context(jm, **CTX).embed(TOKENS, "mean")
    assert nmse(want, got) < 1e-4, nmse(want, got)
    assert nmse(base, got) > 1e-3


# ---------------------------------------------------------------------------
# the imatrix and the tracer; fault 17


def layer0_output(path, tokens):
    """The hidden state after layer 0 of the JAX package's own encoder,
    run op by op with bidirectional attention after its embedding extras
    (layer 1's attention input: an encoder's layer takes no pre-norm)."""
    hp, w = jllama.load_weights(GGUFReader(path))
    t = len(tokens)
    with jax.disable_jit():
        pos = jnp.arange(t, dtype=jnp.int32)[None]
        x = jllama.embed_extras(w, hp, jllama.embed(
            w, jnp.asarray([tokens], jnp.int32)), pos)
        mask = jnp.ones((1, t, t), bool)
        attend = lambda q, k, v: jlayers.attention(
            q, k, v, mask, jhparams.attn_scale_of(hp))
        x = jllama.forward_layer(x, w.layers[0], hp, pos, w.inv_freq_for(0),
                                 w.rope_mscale, attend)
    return np.asarray(x.astype(jnp.float32))[0]


def test_imatrix_and_trace_on_bert_collect_the_served_model(paths):
    """Faults 11 and 12 on an encoder: the JAX imatrix re-implements a
    pre-norm layer and raises on bert's; the port's taps bert's own
    layers, bidirectional: layer 1's q/k/v sums are the squares of the JAX
    model's layer-0 output, with no output.weight (no LM head). The port's
    tracer runs the encoder as it serves it and ends in result_embd."""
    jm, pm = models(paths["bert"])
    toks = [int(t) for t in np.random.default_rng(0).integers(3, 190, 32)]
    truth = (layer0_output(paths["bert"], toks).astype(np.float64) ** 2
             ).sum(0)
    pc = pimatrix.IMatrixCollector(pm)
    pc.collect(toks, chunk=32)
    for n in ("attn_q", "attn_k", "attn_v"):
        got = pc.sums[f"blk.1.{n}.weight"]
        assert np.abs(got - truth).max() / np.abs(truth).max() < 1e-3
    assert "output.weight" not in pc.sums
    assert {"blk.0.attn_output.weight", "blk.0.ffn_up.weight",
            "blk.0.ffn_down.weight"} <= set(pc.sums)
    with pytest.raises(Exception), jax.disable_jit():
        jimatrix.IMatrixCollector(jm).collect(toks, chunk=32)
    got = ptracing.trace_eval(pengine.Context(pm, **CTX), toks[:10],
                              keep_values=True)
    assert [t.name for t in got][-1] == "result_embd"
    assert nmse(layer0_output(paths["bert"], toks[:10]),
                got[1].values) < 1e-10
    emb = pengine.Context(pm, **CTX).embed(toks[:10], "mean")
    mean = got[-1].values.mean(0)
    np.testing.assert_allclose(mean / np.linalg.norm(mean), emb, atol=1e-6)


def jina_forward(path, tokens):
    """jina-bert-v2 in float64 torch from the file's tensors, as its model
    defines it: the token-type row 0 and the embedding LayerNorm, then
    post-norm layers with symmetric ALiBi and an erf-GELU GeGLU; the mean
    of the last hidden states, L2-normalized."""
    r = GGUFReader(path)
    t = lambda n: torch.from_numpy(r.dequantize(n, np.float32)).double()
    hp = jhparams.hparams_from_metadata(r.metadata)
    ln = lambda x, p: torch.nn.functional.layer_norm(
        x, (x.shape[-1],), t(p + ".weight"), t(p + ".bias"), hp.rms_eps)
    n, h, d = len(tokens), hp.n_head, hp.head_dim
    x = ln(t("token_embd.weight")[tokens] + t("token_types.weight")[0],
           "token_embd_norm")
    slopes = torch.from_numpy(jlayers.alibi_slopes(h, 8.0)).double()
    idx = torch.arange(n, dtype=torch.float64)
    bias = -slopes[:, None, None] * (idx[:, None] - idx[None]).abs()
    for i in range(hp.n_layer):
        p = f"blk.{i}."
        proj = lambda y, name: y @ t(p + name + ".weight").T + t(
            p + name + ".bias")
        q, k, v = (proj(x, f"attn_{c}").view(n, h, d) for c in "qkv")
        att = torch.einsum("qhd,khd->hqk", q, k) / d ** 0.5 + bias
        o = torch.einsum("hqk,khd->qhd", att.softmax(-1), v).reshape(n, -1)
        x = ln(x + proj(o, "attn_output"), p + "attn_output_norm")
        g, u = x @ t(p + "ffn_gate.weight").T, x @ t(p + "ffn_up.weight").T
        f = proj(torch.nn.functional.gelu(g) * u, "ffn_down")
        x = ln(x + f, p + "layer_output_norm")
    e = x.mean(0)
    return (e / e.norm()).numpy()


def test_jina_geglu_is_the_erf_gelu(paths, _reference_geglu):
    """Fault 17: jina-bert-v2's GeGLU is the erf GELU (its hparams say
    gelu_erf), which the reference's swiglu does not know and runs as
    SiLU. The port's mean embedding is within bf16 rounding of the model's
    float64 forward; the reference's own, run op by op, is not."""
    jm, pm = models(paths["jina-bert-v2"])
    want = jina_forward(paths["jina-bert-v2"], TOKENS)
    got = pengine.Context(pm, **CTX).embed(TOKENS, "mean")
    assert nmse(want, got) < 1e-4, nmse(want, got)
    patched, jlayers.swiglu = jlayers.swiglu, _reference_geglu
    try:
        with jax.disable_jit():
            ref = jengine.Context(jm, **CTX).embed(TOKENS, "mean")
    finally:
        jlayers.swiglu = patched
    assert nmse(want, ref) > 1e-3, nmse(want, ref)


# ---------------------------------------------------------------------------
# layouts an encoder does not carry


@pytest.mark.parametrize("drop,add,match", [
    ((), ("blk.0.attn_norm.weight", (64,)), "another kind of layer"),
    (("blk.1.layer_output_norm.weight", "blk.1.layer_output_norm.bias"),
     None, "layer_output_norm are required"),
    ((), ("output.weight", (288, 64)), "outside the layouts"),
], ids=["pre-norm", "no-layer-output-norm", "lm-head"])
def test_encoder_layouts_the_port_does_not_carry_raise(paths, tmp_path, drop,
                                                       add, match):
    """A pre-norm tensor in a post-norm layer, a missing post-norm and an
    LM head on an encoder are refused before a tensor is read."""
    from llama_cpp_test_tpu_torch.gguf.writer import GGUFWriter as PWriter

    src = PGGUFReader(paths["bert"])
    path = str(tmp_path / "v.gguf")
    w = PWriter(path, arch="bert")
    for key, val in src.metadata.items():
        if key.startswith("bert."):
            w.add_kv(key, val)
    for name in src.tensors:
        if name not in drop:
            w.add_tensor(name, src.dequantize(name, np.float32))
    if add is not None:
        w.add_tensor(add[0], np.zeros(add[1], np.float32))
    w.write()
    with pytest.raises((NotImplementedError, KeyError), match=match):
        pengine.Model(path, device="cpu")
