"""Port conformance of the dense llama path on low-bit GGUF files
(llama_cpp_test_tpu_torch models/llama + runtime/engine) against the JAX
package, on CPU.

The fixtures are __graft_entry__._tiny_gguf(qtype=F32) requantized by the
JAX quantize_model with its per-tensor rules (tensor_target_type):

  IQ4_XS  every matmul tensor, output and token_embd IQ4_XS (u4lut planes)
  Q2_K    Q2_K everywhere (u2 planes with a min), output Q6_K
  IQ1_S   attn_q/k/output and ffn_gate/up IQ1_S (u2lut), attn_v Q4_K (so
          Q/K/V stay three projections), ffn_down IQ2_XXS (u4lut),
          output Q5_K, token_embd Q2_K (rows-layout crumbs)

Checks: loader planes (LUTs included) equal the JAX loader's; prefill and
decode logits within NMSE 2e-3 (tests/test_engine.py:225) of the JAX
engine run op by op (jax.disable_jit()); identical greedy tokens; the
port on the JAX-loaded parameters (LUTs as float32) gives its own logits.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

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
from llama_cpp_test_tpu_torch.weights import (host_array,
                                              port_weights_from_reference)

LOGITS_GATE = 2e-3
PROMPT = [3, 17, 42, 9, 150, 7, 23, 88, 5, 61]
N_GREEDY = 12


def nmse(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(((a - b) ** 2).mean() / ((a * a).mean() + 1e-12))


def _ctx(engine, model):
    return engine.Context(model, n_ctx=64, n_seq_max=2, block_size=8)


def _run(ctx, prompt):
    """Prefill of 6 tokens (logits at every row), four decode steps, then a
    batched decode of that sequence and a fresh one."""
    s = ctx.new_seq()
    out = [ctx.prefill(s, prompt[:6], all_logits=True)]
    for t in prompt[6:]:
        out.append(ctx.decode([s], [t])[0])
    s2 = ctx.new_seq()
    ctx.prefill(s2, [4, 9, 250])
    out.append(ctx.decode([s, s2], [33, 44]))
    return out


@pytest.fixture(scope="module", params=["IQ4_XS", "Q2_K", "IQ1_S"])
def lowbit(request, tmp_path_factory):
    """(ftype, path, JAX weights, JAX reference readings, port Model). The
    JAX engine runs op by op once per file: the logits of _run and the
    greedy tokens of generate()."""
    d = tmp_path_factory.mktemp("lowbit")
    src, dst = str(d / "f32.gguf"), str(d / f"{request.param}.gguf")
    _tiny_gguf(src, qtype=GGMLType.F32)
    quantize_model(src, dst, request.param)
    # the JAX loader's numpy repack, the path the port copies
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(repack, "USE_NATIVE", False)
        _, jw = jllama.load_weights(GGUFReader(dst))
        jmodel = jengine.Model(dst)
    with jax.disable_jit():
        logits = _run(_ctx(jengine, jmodel), PROMPT)
        tokens = list(jengine.generate(_ctx(jengine, jmodel), [3, 17, 42],
                                       N_GREEDY))
    return (request.param, dst, jw, {"logits": logits, "tokens": tokens},
            pengine.Model(dst, device="cpu"))


def assert_same_qtensor(jqt, pqt, name):
    assert (pqt.kind, tuple(pqt.shape), pqt.n_orig, pqt.group, pqt.layout,
            pqt.parts) == (jqt.kind, tuple(jqt.shape), jqt.n_orig, jqt.group,
                           jqt.layout, jqt.parts), name
    for f in ("qs", "scale", "min_", "lut"):
        a, b = host_array(getattr(jqt, f)), getattr(pqt, f)
        assert (a is None) == (b is None), (name, f)
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f"{name}.{f}")


def test_loader_planes_match_reference(lowbit):
    ftype, path, jw, _, _ = lowbit
    _, pw = pllama.load_weights(PGGUFReader(path))
    kinds = {pw.tok_embd.kind, pw.output.kind}
    assert_same_qtensor(jw.tok_embd, pw.tok_embd, "tok_embd")
    assert_same_qtensor(jw.output, pw.output, "output")
    np.testing.assert_array_equal(jw.output_norm, pw.output_norm)
    for i, (jl, pl) in enumerate(zip(jw.layers, pw.layers)):
        for f in dataclasses.fields(pllama.LayerWeights):
            a, b = getattr(jl, f.name), getattr(pl, f.name)
            assert (a is None) == (b is None), (i, f.name)
            if isinstance(b, QTensor):
                assert_same_qtensor(a, b, f"blk.{i}.{f.name}")
                kinds.add(b.kind)
            elif b is not None:
                np.testing.assert_array_equal(a, b)
    want = {"IQ4_XS": {"u4lut"}, "Q2_K": {"u2", "int8"},
            "IQ1_S": {"u2", "u2lut", "u4", "u4lut", "int8"}}[ftype]
    assert kinds == want
    if ftype == "IQ1_S":
        # Q4_K attn_v beside IQ1_S attn_q/k: three projections, no wqkv
        lw = pw.layers[0]
        assert lw.wqkv is None and lw.wv.kind == "u4"
        assert lw.wq.kind == lw.wk.kind == "u2lut"
        assert lw.w_gateup.kind == "u2lut" and lw.w_down.kind == "u4lut"


def test_logits_match_reference_op_by_op(lowbit):
    _, _, _, ref, pmodel = lowbit
    got = _run(_ctx(pengine, pmodel), PROMPT)
    assert got[0].shape == (6, pmodel.hp.n_vocab)
    assert got[-1].shape == (2, pmodel.hp.n_vocab)
    for i, (r, g) in enumerate(zip(ref["logits"], got)):
        assert np.isfinite(g).all()
        assert nmse(r, g) < LOGITS_GATE, (i, nmse(r, g))


def test_generate_greedy_tokens_match_reference(lowbit):
    _, _, _, ref, pmodel = lowbit
    got = list(pengine.generate(_ctx(pengine, pmodel), [3, 17, 42], N_GREEDY))
    assert got == ref["tokens"]


def test_port_runs_on_reference_parameters(lowbit):
    """weights.py carries the reference's LUT planes across as float32: the
    port on the JAX-loaded parameters gives its own logits."""
    _, _, jw, _, pmodel = lowbit
    model = pengine.Model.from_weights(
        pmodel.hp, port_weights_from_reference(jw), device="cpu")
    luts = [qt.lut for _, qt in _planes(model.weights) if qt.lut is not None]
    assert all(t.dtype == torch.float32 and t.device.type == "cpu"
               for t in luts)
    assert bool(luts) == any(qt.lut is not None
                             for _, qt in _planes(pmodel.weights))
    ctx, own = _ctx(pengine, model), _ctx(pengine, pmodel)
    np.testing.assert_array_equal(
        ctx.prefill(ctx.new_seq(), PROMPT, all_logits=True),
        own.prefill(own.new_seq(), PROMPT, all_logits=True))


def _planes(w):
    """(name, QTensor) of every plane of port weights w."""
    out = [("tok_embd", w.tok_embd), ("output", w.output)]
    for i, lw in enumerate(w.layers):
        out += [(f"blk.{i}.{f.name}", getattr(lw, f.name))
                for f in dataclasses.fields(pllama.LayerWeights)
                if isinstance(getattr(lw, f.name), QTensor)]
    return out
