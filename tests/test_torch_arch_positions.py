"""The position axes of the port (llama_cpp_test_tpu_torch models/{hparams,
llama}, ops/layers, runtime/{engine,kv_cache,imatrix,tracing}): learned
absolute positions and ALiBi, against the JAX package, on CPU, on seven
tiny F32 fixtures in the reference's tensor layout
(test_torch_arch_body.make_tiny_body):

  gpt2         256 learned position rows, LayerNorms with biases, a fused
               attn_qkv with bias, wo bias, a non-gated GELU FFN with
               biases, tied head
  starcoder    the same on one KV head (MQA), untied head
  bloom        ALiBi over 4 heads, the embedding LayerNorm, the gpt2 layout
               otherwise
  mpt          ALiBi over 6 heads in mpt's slope order, weight-only
               LayerNorms, a fused attn_qkv without bias, the exact erf
               GELU
  jais         ALiBi over 6 heads in bloom's slope order, 1/d_head
               attention, a gated FFN with gate, up and down biases
  refact       ALiBi on one KV head (MQA), RMS norms, the llama layout
  baichuan-13b baichuan at 2 layers, ALiBi by its max_alibi_bias key

Checks as tests/test_torch_arch_ln.py makes them (hparams, loader, logits
at bf16 and q8_0 KV against the jitted and the op-by-op JAX engine,
greedy tokens, batched decode, the JAX-loaded parameters). Then the
slopes against the JAX ones at 12, 16, 40 and 71 heads in both orders;
baichuan's rope or ALiBi as the JAX hparams pick it; shift_context
refused on gpt2 and bloom as in the reference; the CLI and the Scheduler
on bloom; faults 11 and 12 on bloom (its embedding extras) and jais (its
gate bias); fault 15 (the reference's NaN logits past gpt2's learned
table, a Context the port refuses) and fault 16 (the reference rotates
the K of a file without rope positions when it reuses a prompt cache;
the port keeps the common prefix).
"""
import jax
import numpy as np
import pytest
import torch

from test_torch_arch_body import check_imatrix_and_trace, make_tiny_body
from test_torch_arch_ln import (CTX, PROMPT, check_batched, check_cli,
                                check_greedy, check_hparams, check_loader,
                                check_logits, check_op_by_op,
                                check_reference_parameters, check_scheduler,
                                models, nmse, write_fixtures)
from test_torch_engine_pieces import cached_kv

from llama_cpp_test_tpu.gguf.reader import GGUFReader
from llama_cpp_test_tpu.models import hparams as jhparams
from llama_cpp_test_tpu.ops import layers as jlayers
from llama_cpp_test_tpu.runtime import engine as jengine
from llama_cpp_test_tpu_torch.models import hparams as phparams
from llama_cpp_test_tpu_torch.ops import layers as players
from llama_cpp_test_tpu_torch.runtime import engine as pengine

GPT2 = dict(norm="ln", norm_bias=True, qkv="fused", qkv_bias=True, bo=True,
            ffn="up", ffn_bias=True, hkv=4, pos_rows=256, tied=True)
POSITIONS = {
    "gpt2": GPT2,
    "starcoder": dict(GPT2, hkv=1, tied=False),
    "bloom": dict(GPT2, pos_rows=0, tok_norm=True),
    "mpt": dict(norm="ln", qkv="fused", ffn="up", hq=6, hkv=6, c=96,
                tied=True),
    "jais": dict(norm="ln", norm_bias=True, qkv="fused", qkv_bias=True,
                 bo=True, ffn_bias=True, gate_bias=True, hq=6, hkv=6, c=96),
    "refact": dict(hkv=1),
    "baichuan-13b": dict(hkv=4, meta={"attention.max_alibi_bias": 8.0}),
}
ARCHS = list(POSITIONS)
arch_of = lambda name: name.split("-13b")[0]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return write_fixtures(tmp_path_factory, {
        name: (lambda p, n=name: make_tiny_body(p, POSITIONS[n], arch_of(n)))
        for name in ARCHS})


@pytest.mark.parametrize("name", ARCHS)
def test_hparams_match_reference(paths, name):
    hp = check_hparams(paths[name])
    learned = name in ("gpt2", "starcoder")
    assert hp.pos_embd == ("learned" if learned else "none")
    assert hp.alibi == (not learned)


@pytest.mark.parametrize("name", ARCHS)
def test_loader_planes_match_reference(paths, name):
    pw = check_loader(paths[name])
    from llama_cpp_test_tpu.models import llama as jllama

    _, jw = jllama.load_weights(GGUFReader(paths[name]))
    for f in ("pos_embd", "tok_norm", "tok_norm_b"):
        a, b = getattr(jw, f), getattr(pw, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert (pw.pos_embd is not None) == (name in ("gpt2", "starcoder"))
    assert (pw.tok_norm is not None) == (name == "bloom")
    assert (pw.layers[0].b_gate is not None) == (name == "jais")


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
# the axes


@pytest.mark.parametrize("style", ["bloom", "mpt"])
@pytest.mark.parametrize("n_head", [12, 16, 40, 71])
def test_alibi_slopes_match_reference(n_head, style):
    for max_bias in (8.0, 4.0):
        np.testing.assert_array_equal(
            players.alibi_slopes(n_head, max_bias, style),
            jlayers.alibi_slopes(n_head, max_bias, style=style))


@pytest.mark.parametrize("n_layer,key", [(2, None), (2, 8.0), (40, None),
                                         (40, 8.0)])
def test_baichuan_positions_follow_reference(n_layer, key):
    """The 13B-class baichuan takes ALiBi by its 40 layers or by an
    explicit max_alibi_bias key, rope otherwise, in both packages."""
    md = {"general.architecture": "baichuan", "baichuan.block_count": n_layer}
    if key is not None:
        md["baichuan.attention.max_alibi_bias"] = key
    php = phparams.hparams_from_metadata(md)
    jhp = jhparams.hparams_from_metadata(md)
    for f in php.__dataclass_fields__:
        assert getattr(php, f) == getattr(jhp, f), f
    assert php.alibi == (n_layer >= 40 or key is not None)
    assert php.pos_embd == ("none" if php.alibi else "rope")


@pytest.mark.parametrize("name", ["gpt2", "bloom"])
def test_shift_context_refused_as_reference(paths, name):
    jm, pm = models(paths[name])
    for eng, model in ((jengine, jm), (pengine, pm)):
        ctx = eng.Context(model, **CTX)
        s = ctx.new_seq()
        ctx.prefill(s, PROMPT[:12])
        with pytest.raises(NotImplementedError, match="rope positions"):
            ctx.shift_context(s, 2, 5)
    ctx = pengine.Context(pm, **CTX)
    s = ctx.new_seq()
    ctx.prefill(s, PROMPT[:12])
    with pytest.raises(NotImplementedError, match="rope positions"):
        ctx.self_extend(s, 2, 2)


def test_cli_text_matches_reference(paths):
    check_cli(paths["bloom"])


def test_scheduler_serves_as_generate(paths):
    check_scheduler(paths["bloom"])


@pytest.mark.parametrize("name,raises", [("bloom", True), ("jais", False)])
def test_imatrix_and_trace_collect_the_served_model(paths, name, raises):
    check_imatrix_and_trace(paths[name], jax_imatrix_raises=raises)


def test_context_past_the_learned_table_refused(tmp_path):
    """Fault 15: the reference looks the position rows up with jnp.take,
    which fills a position past gpt2's table with NaN, so its logits
    there are NaN; the port refuses a Context longer than the table (and
    serves one that fits it as the reference does)."""
    path = str(tmp_path / "gpt2_16.gguf")
    make_tiny_body(path, dict(GPT2, pos_rows=16, n_ctx_train=16), "gpt2")
    jm, pm = jengine.Model(path), pengine.Model(path, device="cpu")
    jctx = jengine.Context(jm, n_ctx=32, n_seq_max=1, block_size=8)
    js = jctx.new_seq()
    inside = jctx.prefill(js, PROMPT[:8])
    past = jctx.prefill(js, PROMPT[:12])       # positions 8..19
    assert np.isfinite(inside).all() and np.isnan(past).all()
    with pytest.raises(ValueError, match="learned position table"):
        pengine.Context(pm, n_ctx=32, n_seq_max=1, block_size=8)
    pctx = pengine.Context(pm, n_ctx=16, n_seq_max=1, block_size=8)
    assert nmse(inside, pctx.prefill(pctx.new_seq(), PROMPT[:8])) < 2e-3


def test_prompt_cache_reuse_keeps_the_prefix(paths):
    """Fault 16: a prompt-cache reuse whose chunk moves (compact_reuse
    with n_reuse_min > 0) re-rotates the moved K by rope in the
    reference, though bloom's K took none: layer 0's K of the moved tokens
    (a function of each token alone) leaves a fresh prefill's. The port
    keeps only the common prefix and prefills the rest, so its cache and
    logits are the fresh prefill's."""
    jm, pm = models(paths["bloom"])
    old = PROMPT[:12]
    new = PROMPT[:3] + PROMPT[6:12]       # [6, 12) moves down by 3
    with jax.disable_jit():
        jctx = jengine.Context(jm, **CTX)
        js = jctx.new_seq()
        jctx.prefill(js, old)
        assert jctx.compact_reuse(js, new, 4) == len(new)
        fresh = jengine.Context(jm, **CTX)
        fs = fresh.new_seq()
        fresh.prefill(fs, new)
        moved, want = cached_kv(jctx, js), cached_kv(fresh, fs)
    assert nmse(want[0, 0][:, 3:], moved[0, 0][:, 3:]) > 1e-2
    pctx = pengine.Context(pm, **CTX)
    ps = pctx.new_seq()
    pctx.prefill(ps, old)
    assert pctx.compact_reuse(ps, new, 4) == 3
    got = pctx.prefill(ps, new[3:])
    pfresh = pengine.Context(pm, **CTX)
    pfs = pfresh.new_seq()
    assert nmse(pfresh.prefill(pfs, new), got) < 1e-6
    np.testing.assert_allclose(cached_kv(pctx, ps), cached_kv(pfresh, pfs),
                               atol=1e-2)
