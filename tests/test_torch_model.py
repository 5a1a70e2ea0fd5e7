"""Port conformance of the llama and Mixtral slices end to end
(llama_cpp_test_tpu_torch models/llama + runtime/engine + weights) against
the JAX package, on CPU, on three tiny GGUF fixtures:

  q8  tests/test_engine.make_tiny_gguf (Q8_0, n_embd 64, 2 layers)
  q4k __graft_entry__._tiny_gguf (Q4_K at n_embd 256, 2 layers)
  moe __graft_entry__._tiny_gguf(n_expert=4, n_expert_used=2) (Mixtral
      layout: F32 router, Q4_K expert stacks, 2 layers)

Checks: loader planes equal llama.load_weights planes; prefill and decode
logits within NMSE 2e-3 of the JAX Model/Context (tests/test_engine.py:225);
identical greedy tokens from generate(); the port run on the JAX-loaded
parameters (weights.py) gives the port's own logits. MoE files the port
does not carry raise NotImplementedError at load.

The MoE fixture is held against the JAX engine run op by op
(jax.disable_jit()): jitted XLA drops the bf16 rounding of the router's
input, which flips a near-tied expert choice of this random model (one
prefill position differs from the op-by-op run by NMSE 0.65).
"""
import dataclasses

import jax
import numpy as np
import pytest

from test_engine import make_tiny_gguf

from __graft_entry__ import _tiny_gguf
from llama_cpp_test_tpu.gguf.reader import GGUFReader
from llama_cpp_test_tpu.models import llama as jllama
from llama_cpp_test_tpu.runtime import engine as jengine
from llama_cpp_test_tpu_torch.gguf.reader import GGUFReader as PGGUFReader
from llama_cpp_test_tpu_torch.models import llama as pllama
from llama_cpp_test_tpu_torch.models.hparams import hparams_from_metadata
from llama_cpp_test_tpu_torch.quant.repack import QTensor
from llama_cpp_test_tpu_torch.runtime import engine as pengine
from llama_cpp_test_tpu_torch.weights import (host_array,
                                              port_weights_from_reference)

LOGITS_GATE = 2e-3
PROMPT = [3, 17, 42, 9, 150, 7, 23, 88, 5, 61]


def nmse(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(((a - b) ** 2).mean() / ((a * a).mean() + 1e-12))


@pytest.fixture(scope="module", params=["q8", "q4k"])
def models(request, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tm") / f"{request.param}.gguf")
    if request.param == "q8":
        make_tiny_gguf(path)
    else:
        _tiny_gguf(path)
    return path, jengine.Model(path), pengine.Model(path, device="cpu")


def assert_same_qtensor(jqt, pqt, name):
    assert (pqt.kind, tuple(pqt.shape), pqt.n_orig, pqt.group, pqt.layout,
            pqt.parts) == (jqt.kind, tuple(jqt.shape), jqt.n_orig, jqt.group,
                           jqt.layout, jqt.parts), name
    for f in ("qs", "scale", "min_"):
        a, b = host_array(getattr(jqt, f)), getattr(pqt, f)
        assert (a is None) == (b is None), (name, f)
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f"{name}.{f}")


def test_loader_planes_match_reference(models):
    assert_same_weights(models[0])


def assert_same_weights(path):
    _, jw = jllama.load_weights(GGUFReader(path))
    _, pw = pllama.load_weights(PGGUFReader(path))
    assert_same_qtensor(jw.tok_embd, pw.tok_embd, "tok_embd")
    assert_same_qtensor(jw.output, pw.output, "output")
    np.testing.assert_array_equal(jw.output_norm, pw.output_norm)
    np.testing.assert_array_equal(jw.rope_inv_freq, pw.rope_inv_freq)
    assert jw.rope_mscale == pw.rope_mscale
    assert len(jw.layers) == len(pw.layers)
    for i, (jl, pl) in enumerate(zip(jw.layers, pw.layers)):
        for f in dataclasses.fields(pllama.LayerWeights):
            a, b = getattr(jl, f.name), getattr(pl, f.name)
            assert (a is None) == (b is None), (i, f.name)
            if a is None:
                continue
            if isinstance(b, QTensor):
                assert_same_qtensor(a, b, f"blk.{i}.{f.name}")
            else:
                np.testing.assert_array_equal(a, b)


def _logits_pair(jmodel, pmodel):
    jctx = jengine.Context(jmodel, n_ctx=64, n_seq_max=2, block_size=8)
    pctx = pengine.Context(pmodel, n_ctx=64, n_seq_max=2, block_size=8)
    js, ps = jctx.new_seq(), pctx.new_seq()
    out = [(jctx.prefill(js, PROMPT[:6], all_logits=True),
            pctx.prefill(ps, PROMPT[:6], all_logits=True))]
    for t in PROMPT[6:]:
        out.append((jctx.decode([js], [t])[0], pctx.decode([ps], [t])[0]))
    return out


def test_prefill_decode_logits_match_reference(models):
    _, jmodel, pmodel = models
    pairs = _logits_pair(jmodel, pmodel)
    assert pairs[0][1].shape == (6, pmodel.hp.n_vocab)
    for i, (ref, got) in enumerate(pairs):
        assert np.isfinite(got).all()
        assert nmse(ref, got) < LOGITS_GATE, (i, nmse(ref, got))


def test_batched_decode_matches_reference(models):
    _, jmodel, pmodel = models
    outs = []
    for eng, model in ((jengine, jmodel), (pengine, pmodel)):
        ctx = eng.Context(model, n_ctx=64, n_seq_max=4, block_size=8)
        sa, sb, sc = ctx.new_seq(), ctx.new_seq(), ctx.new_seq()
        ctx.prefill(sa, [5, 6, 7])
        ctx.prefill(sb, [100, 101, 102, 103, 104])
        ctx.prefill(sc, [9])
        outs.append(ctx.decode([sa, sb, sc], [11, 12, 13]))
    assert outs[1].shape == (3, pmodel.hp.n_vocab)
    assert nmse(outs[0], outs[1]) < LOGITS_GATE


def test_generate_greedy_tokens_match_reference(models):
    """Identical greedy tokens. The reference runs op by op (disable_jit):
    under jit, XLA fuses away some of the program's bf16 roundings (logits
    NMSE ~6e-5 against its own eager run on the q4k fixture), enough to flip
    that fixture's near-tied second token. Op by op, the port's logits
    equal the reference's to float32 rounding."""
    _, jmodel, pmodel = models
    jctx = jengine.Context(jmodel, n_ctx=64, n_seq_max=4, block_size=8)
    pctx = pengine.Context(pmodel, n_ctx=64, n_seq_max=4, block_size=8)
    with jax.disable_jit():
        ref = list(jengine.generate(jctx, [3, 17, 42], 12))
        eager = jctx.prefill(jctx.new_seq(), PROMPT[:6], all_logits=True)
    got = list(pengine.generate(pctx, [3, 17, 42], 12))
    assert got == ref
    port = pctx.prefill(pctx.new_seq(), PROMPT[:6], all_logits=True)
    assert nmse(eager, port) < 1e-10, nmse(eager, port)


def test_port_runs_on_reference_parameters(models):
    """weights.py: the reference's loaded parameters (numpy, bf16 viewed as
    uint16) run through the port give the port's own logits."""
    path, jmodel, pmodel = models
    hp, jw = jllama.load_weights(GGUFReader(path))
    phps = hparams_from_metadata(GGUFReader(path).metadata)
    model = pengine.Model.from_weights(phps, port_weights_from_reference(jw),
                                       device="cpu")
    ctx = pengine.Context(model, n_ctx=64, n_seq_max=2, block_size=8)
    own = pengine.Context(pmodel, n_ctx=64, n_seq_max=2, block_size=8)
    s, so = ctx.new_seq(), own.new_seq()
    got = ctx.prefill(s, PROMPT, all_logits=True)
    np.testing.assert_array_equal(got, own.prefill(so, PROMPT, all_logits=True))
    jctx = jengine.Context(jmodel, n_ctx=64, n_seq_max=2, block_size=8)
    ref = jctx.prefill(jctx.new_seq(), PROMPT, all_logits=True)
    assert nmse(ref, got) < LOGITS_GATE


# ---------------------------------------------------------------------------
# MoE (Mixtral layout)

MOE_PROMPT = np.random.default_rng(5).integers(3, 250, size=130).tolist()


@pytest.fixture(scope="module")
def moe_models(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tm") / "moe.gguf")
    _tiny_gguf(path, n_expert=4, n_expert_used=2)
    return path, jengine.Model(path), pengine.Model(path, device="cpu")


def test_moe_loader_planes_match_reference(moe_models):
    """Router, expert stacks (leading E axis) and attention planes equal
    the JAX loader's."""
    path, _, pmodel = moe_models
    assert_same_weights(path)
    lw = pmodel.weights.layers[0]
    assert lw.w_down is None and lw.up_exps.qs.shape[0] == 4
    assert lw.gate_inp.kind == "dense" and lw.gate_exps.qs.shape[0] == 4


def _moe_run(ctx, prompt):
    """130-token prefill (R = 260 routed rows, tile_m 64), three decode
    steps, then a batched decode of that sequence and a fresh one (tile_m
    8)."""
    s = ctx.new_seq()
    out = [ctx.prefill(s, prompt, all_logits=True)]
    for t in (7, 19, 101):
        out.append(ctx.decode([s], [t])[0])
    s2 = ctx.new_seq()
    ctx.prefill(s2, [4, 9, 250])
    out.append(ctx.decode([s, s2], [33, 44]))
    return out


@pytest.mark.parametrize("kv_type", ["bf16", "q8_0"])
def test_moe_logits_match_reference(moe_models, kv_type):
    _, jmodel, pmodel = moe_models
    jctx = jengine.Context(jmodel, n_ctx=256, n_seq_max=4, block_size=8,
                           kv_type=kv_type)
    pctx = pengine.Context(pmodel, n_ctx=256, n_seq_max=4, block_size=8,
                           kv_type=kv_type)
    with jax.disable_jit():
        ref = _moe_run(jctx, MOE_PROMPT)
    got = _moe_run(pctx, MOE_PROMPT)
    assert got[0].shape == (130, pmodel.hp.n_vocab)
    assert got[-1].shape == (2, pmodel.hp.n_vocab)
    for i, (r, g) in enumerate(zip(ref, got)):
        assert np.isfinite(g).all()
        assert nmse(r, g) < LOGITS_GATE, (i, nmse(r, g))


def test_moe_generate_greedy_tokens_match_reference(moe_models):
    _, jmodel, pmodel = moe_models
    jctx = jengine.Context(jmodel, n_ctx=64, n_seq_max=2, block_size=8)
    pctx = pengine.Context(pmodel, n_ctx=64, n_seq_max=2, block_size=8)
    with jax.disable_jit():
        ref = list(jengine.generate(jctx, [3, 17, 42], 12))
    assert list(pengine.generate(pctx, [3, 17, 42], 12)) == ref


def test_moe_port_runs_on_reference_parameters(moe_models):
    """weights.port_weights_from_reference carries the router and the
    expert stacks across: the port on the JAX-loaded MoE parameters gives
    its own logits."""
    path, _, pmodel = moe_models
    _, jw = jllama.load_weights(GGUFReader(path))
    model = pengine.Model.from_weights(
        pmodel.hp, port_weights_from_reference(jw), device="cpu")
    ctx = pengine.Context(model, n_ctx=64, n_seq_max=2, block_size=8)
    own = pengine.Context(pmodel, n_ctx=64, n_seq_max=2, block_size=8)
    got = ctx.prefill(ctx.new_seq(), PROMPT, all_logits=True)
    np.testing.assert_array_equal(
        got, own.prefill(own.new_seq(), PROMPT, all_logits=True))


def test_moe_fused_reference_parameters_raise(moe_models, monkeypatch):
    """A reference loaded with its gate|up expert stacks fused is carried
    with the stacks split back apart (the port keeps gate and up as
    separate stacks): the split planes equal the port loader's, and the
    port on them gives its own logits."""
    path, _, pmodel = moe_models
    monkeypatch.setenv("LLAMA_TPU_MOE_FUSE", "1")
    _, jw = jllama.load_weights(GGUFReader(path))
    assert jw.layers[0].gate_exps is None
    pw = port_weights_from_reference(jw)
    _, own = pllama.load_weights(PGGUFReader(path))
    for lw, ol in zip(pw.layers, own.layers):
        for f in ("gate_exps", "up_exps"):
            assert_same_qtensor(getattr(ol, f), getattr(lw, f), f)
    model = pengine.Model.from_weights(pmodel.hp, pw, device="cpu")
    ctx = pengine.Context(model, n_ctx=64, n_seq_max=2, block_size=8)
    own_ctx = pengine.Context(pmodel, n_ctx=64, n_seq_max=2, block_size=8)
    np.testing.assert_array_equal(
        ctx.prefill(ctx.new_seq(), PROMPT, all_logits=True),
        own_ctx.prefill(own_ctx.new_seq(), PROMPT, all_logits=True))


def _moe_variant(path, arch="llama", md=None, add=(), drop=()):
    """A one-layer MoE file's metadata and tensor names (F32 stand-ins: the
    loader refuses these before it reads any tensor)."""
    from llama_cpp_test_tpu_torch.gguf.writer import GGUFWriter

    w = GGUFWriter(path, arch=arch)
    for k, v in {"block_count": 1, "embedding_length": 8,
                 "attention.head_count": 2, "expert_count": 2,
                 "expert_used_count": 1, **(md or {})}.items():
        w.add_kv(f"{arch}.{k}", v)
    names = ["token_embd.weight", "output_norm.weight"] + [
        f"blk.0.{n}" for n in ("attn_norm.weight", "attn_q.weight",
                               "attn_k.weight", "attn_v.weight",
                               "attn_output.weight", "ffn_norm.weight",
                               "ffn_gate_inp.weight", "ffn_gate_exps.weight",
                               "ffn_up_exps.weight", "ffn_down_exps.weight")]
    for name in [n for n in names if n not in drop] + list(add):
        w.add_tensor(name, np.zeros((2, 8), np.float32))
    w.write()
    return path


_DENSE_SET = ["blk.0.ffn_gate.weight", "blk.0.ffn_up.weight",
              "blk.0.ffn_down.weight"]
_EXPERT_SET = ["blk.0.ffn_gate_inp.weight", "blk.0.ffn_gate_exps.weight",
               "blk.0.ffn_up_exps.weight", "blk.0.ffn_down_exps.weight"]


@pytest.mark.parametrize("variant", [
    # a shared-expert gate without its expert
    dict(arch="qwen2moe", add=["blk.0.ffn_gate_inp_shexp.weight"]),
    # a kv LoRA rank on a layer without the MLA tensors
    dict(arch="deepseek2", md={"attention.kv_lora_rank": 4}),
    # experts in a leading dense layer
    dict(md={"expert_gating_func": 2, "leading_dense_block_count": 1}),
    # the sparsemixer at one expert a token
    dict(arch="phimoe"),
    dict(md={"expert_shared_count": 1}),
    # two of the three shared-expert planes
    dict(add=["blk.0.ffn_up_shexp.weight", "blk.0.ffn_gate_shexp.weight"]),
    # the selection bias in a dense layer
    dict(md={"leading_dense_block_count": 1}, drop=_EXPERT_SET,
         add=["blk.0.exp_probs_b.bias"] + _DENSE_SET),
    # a dense MLP beside the experts without arctic's ffn_norm_exps
    dict(add=_DENSE_SET),
    dict(drop=["blk.0.ffn_up_exps.weight"]),
], ids=["qwen2moe", "deepseek2", "sigmoid-gating", "sparsemixer",
        "shared-count", "shexp-tensors", "exp-probs-b", "dense-beside",
        "missing-stack"])
def test_moe_files_the_port_does_not_carry_raise(tmp_path, variant):
    path = _moe_variant(str(tmp_path / "v.gguf"), **variant)
    with pytest.raises(NotImplementedError):
        pengine.Model(path, device="cpu")
