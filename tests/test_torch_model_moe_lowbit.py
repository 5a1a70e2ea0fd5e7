"""Port conformance of the Mixtral-layout MoE path on low-bit and bf16 GGUF
files (llama_cpp_test_tpu_torch models/llama + ops/gmm + runtime/engine)
against the JAX package, on CPU.

The fixtures are __graft_entry__._tiny_gguf(qtype=F32, n_expert=4,
n_expert_used=2) requantized by the JAX quantize_model with its per-tensor
rules (tensor_target_type):

  Q2_K   every matmul tensor Q2_K (u2 planes with a min), expert stacks
         and the router included, output Q6_K
  IQ1_S  attn_q/k/output, ffn_gate/up_exps and the router IQ1_S (u2lut),
         attn_v Q4_K, ffn_down_exps IQ2_XXS (u4lut), output Q5_K,
         token_embd Q2_K; written at n_ff = 256, since the IQ1_S encoder
         takes ~60 s of CPU on the default n_ff = 512 file
  BF16   everything BF16: dense expert stacks, router and head

quantize_model has no router rule, so ffn_gate_inp takes the file's base
type (llama.cpp keeps it F32); the port's loader takes it as the JAX
loader does. Checks: loader planes (LUTs included) equal the JAX loader's;
the logits of a 130-token prefill (R = 260 routed rows, tile_m 64), three
decode steps and a batched decode (tile_m 8) within NMSE 2e-3
(tests/test_engine.py:225) of the JAX engine run op by op
(jax.disable_jit()); identical greedy tokens. The JAX engine runs once per
file.
"""
import dataclasses

import jax
import numpy as np
import pytest

from __graft_entry__ import _tiny_gguf
from llama_cpp_test_tpu.gguf.constants import GGMLType
from llama_cpp_test_tpu.gguf.reader import GGUFReader
from llama_cpp_test_tpu.models import llama as jllama
from llama_cpp_test_tpu.quant import repack
from llama_cpp_test_tpu.quant.quantize_model import quantize_model
from llama_cpp_test_tpu.runtime import engine as jengine
from llama_cpp_test_tpu_torch.gguf.reader import GGUFReader as PGGUFReader
from llama_cpp_test_tpu_torch.models import llama as pllama
from llama_cpp_test_tpu_torch.quant.repack import QTensor
from llama_cpp_test_tpu_torch.runtime import engine as pengine
from test_torch_model_lowbit import assert_same_qtensor

LOGITS_GATE = 2e-3
PROMPT = np.random.default_rng(5).integers(3, 250, size=130).tolist()
N_GREEDY = 12
N_FF = {"Q2_K": 512, "IQ1_S": 256, "BF16": 512}
# plane kinds of each file's router and expert stacks (gate, up, down)
MOE_KINDS = {"Q2_K": ("u2", "u2", "u2", "u2"),
             "IQ1_S": ("u2lut", "u2lut", "u2lut", "u4lut"),
             "BF16": ("dense", "dense", "dense", "dense")}


def nmse(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(((a - b) ** 2).mean() / ((a * a).mean() + 1e-12))


def _ctx(engine, model):
    return engine.Context(model, n_ctx=256, n_seq_max=4, block_size=8)


def _run(ctx):
    """130-token prefill (logits at every row), three decode steps, then a
    batched decode of that sequence and a fresh one."""
    s = ctx.new_seq()
    out = [ctx.prefill(s, PROMPT, all_logits=True)]
    for t in (7, 19, 101):
        out.append(ctx.decode([s], [t])[0])
    s2 = ctx.new_seq()
    ctx.prefill(s2, [4, 9, 250])
    out.append(ctx.decode([s, s2], [33, 44]))
    return out


@pytest.fixture(scope="module", params=list(N_FF))
def moe_lowbit(request, tmp_path_factory):
    """(ftype, path, JAX weights, JAX reference readings, port Model)."""
    d = tmp_path_factory.mktemp("moe_lowbit")
    src, dst = str(d / "f32.gguf"), str(d / f"{request.param}.gguf")
    _tiny_gguf(src, qtype=GGMLType.F32, n_ff=N_FF[request.param],
               n_expert=4, n_expert_used=2)
    quantize_model(src, dst, request.param)
    # the JAX loader's numpy repack, the path the port copies
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(repack, "USE_NATIVE", False)
        _, jw = jllama.load_weights(GGUFReader(dst))
        jmodel = jengine.Model(dst)
    with jax.disable_jit():
        logits = _run(_ctx(jengine, jmodel))
        tokens = list(jengine.generate(_ctx(jengine, jmodel), [3, 17, 42],
                                       N_GREEDY))
    return (request.param, dst, jw, {"logits": logits, "tokens": tokens},
            pengine.Model(dst, device="cpu"))


def test_moe_lowbit_loader_planes_match_reference(moe_lowbit):
    ftype, path, jw, _, _ = moe_lowbit
    _, pw = pllama.load_weights(PGGUFReader(path))
    assert_same_qtensor(jw.tok_embd, pw.tok_embd, "tok_embd")
    assert_same_qtensor(jw.output, pw.output, "output")
    for i, (jl, pl) in enumerate(zip(jw.layers, pw.layers)):
        for f in dataclasses.fields(pllama.LayerWeights):
            a, b = getattr(jl, f.name), getattr(pl, f.name)
            assert (a is None) == (b is None), (i, f.name)
            if isinstance(b, QTensor):
                assert_same_qtensor(a, b, f"blk.{i}.{f.name}")
            elif b is not None:
                np.testing.assert_array_equal(a, b)
        kinds = tuple(getattr(pl, f).kind for f in
                      ("gate_inp", "gate_exps", "up_exps", "down_exps"))
        assert kinds == MOE_KINDS[ftype], (i, kinds)
        assert pl.gate_exps.qs.shape[0] == 4 and pl.w_down is None
    if ftype == "Q2_K":
        assert pw.layers[0].gate_exps.min_ is not None
    if ftype == "BF16":
        assert pw.layers[0].down_exps.scale is None


def test_moe_lowbit_logits_match_reference(moe_lowbit):
    _, _, _, ref, pmodel = moe_lowbit
    got = _run(_ctx(pengine, pmodel))
    assert got[0].shape == (130, pmodel.hp.n_vocab)
    assert got[-1].shape == (2, pmodel.hp.n_vocab)
    for i, (r, g) in enumerate(zip(ref["logits"], got)):
        assert np.isfinite(g).all()
        assert nmse(r, g) < LOGITS_GATE, (i, nmse(r, g))


def test_moe_lowbit_generate_greedy_tokens_match_reference(moe_lowbit):
    _, _, _, ref, pmodel = moe_lowbit
    got = list(pengine.generate(_ctx(pengine, pmodel), [3, 17, 42], N_GREEDY))
    assert got == ref["tokens"]
