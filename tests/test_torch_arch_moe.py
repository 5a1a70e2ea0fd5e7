"""The other MoE forms in the port (llama_cpp_test_tpu_torch models/{hparams,
registry,llama}, weights.py) against the JAX package, on CPU, on tiny F32
files that tests/test_convert_hf.py's converter tests write from seeded
HF checkpoints (converted(): the test runs until its GGUF is written):

  qwen2moe    a sigmoid-gated shared expert, Q/K/V biases, softmax top-2
              of 4 not renormalized
  qwen3moe    per-head QK norms, softmax top-2 renormalized
  olmoe       flat QK norms, softmax top-2 not renormalized
  granitemoe  the mup scales, softmax top-2
  phimoe      the sparsemixer (two masked-softmax picks), LayerNorms with
              biases
  deepseek    a leading dense layer, an ungated shared expert
  dbrx        a fused attn_qkv, bias-free LayerNorms, its pre-MoE norm
              under attn_output_norm, q/k/v clamped
  grok        GELU experts, the norms of the branch outputs, the
              attention softcap 30, the embedding and logit multipliers
  arctic      a dense MLP beside the experts, the experts on the layer
              input through ffn_norm_exps

Checks: the routing forms one MoE layer at a time against the JAX
moe_ffn run op by op (softmax with and without renormalized weights,
sigmoid gating with DeepSeek-V3's selection bias, the sparsemixer, the
routed scale, GELU experts; NMSE 1e-10), and qwen2moe's shared expert
against the JAX shared_expert_ffn; then every fixture as
tests/test_torch_arch_ln.py checks one: hparams equal field for field,
the loader's planes equal the JAX loader's (grok's and dbrx's norms
remapped alike), prefill and decode logits at bf16 KV (q8_0 and a
batched decode on two) within NMSE 2e-3 of the jitted JAX engine and
within 1e-10 of it run op by op, greedy tokens equal, and the JAX-loaded
parameters through the port give the port's own logits, those of a
reference loaded with LLAMA_TPU_MOE_FUSE=1 (fused gate|up expert stacks)
too; the CLI on grok and the Scheduler on two.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers  # noqa: F401  (at module top: ROADMAP §3, sys.modules)

import test_convert_hf as hf_tests
from test_torch_arch_ln import (CTX, PROMPT, check_batched, check_cli,
                                check_greedy, check_hparams, check_logits,
                                check_scheduler, models, nmse, op_by_op,
                                port_rows)
from test_torch_model import assert_same_weights

from llama_cpp_test_tpu.gguf.reader import GGUFReader
from llama_cpp_test_tpu.models import llama as jllama
from llama_cpp_test_tpu.tools import convert_hf
from llama_cpp_test_tpu_torch.gguf.reader import GGUFReader as PGGUFReader
from llama_cpp_test_tpu_torch.models import llama as pllama
from llama_cpp_test_tpu_torch.runtime import engine as pengine
from llama_cpp_test_tpu_torch.weights import port_weights_from_reference

# fixture -> the test_convert_hf test whose converter writes it
CONVERTERS = {
    "qwen2moe": hf_tests.test_convert_qwen2moe_matches_transformers,
    "qwen3moe": hf_tests.test_convert_qwen3moe_matches_transformers,
    "olmoe": hf_tests.test_convert_olmoe_matches_transformers,
    "granitemoe": hf_tests.test_convert_granitemoe_matches_transformers,
    "phimoe": hf_tests.test_convert_phimoe_matches_transformers,
    "deepseek": hf_tests.test_convert_deepseek_v1_matches_torch_reference,
    "dbrx": hf_tests.test_convert_dbrx_matches_transformers,
    "grok": hf_tests.test_convert_grok_matches_torch_reference,
    "arctic": hf_tests.test_convert_arctic_matches_torch_reference,
}
NAMES = list(CONVERTERS)
# the fixtures a KV type (q8_0 beside bf16) or batched decode is held on:
# each jitted JAX engine check compiles anew a fixture (Tier-1's clock).
# phimoe stays off the q8_0 list: there the jitted engine masks another
# expert out of a sparsemixer pick than the same engine run op by op
# (jitted XLA skips a bf16 rounding of the router input)
Q8_NAMES = ("qwen2moe", "deepseek")
BATCHED_NAMES = ("qwen2moe", "arctic")
# the op-by-op gate: 1e-10, as every other arch fixture; grok's residual
# stream carries its 78.4x embedding scale, so a float32 ulp of its
# post-branch RMS norm (a reduction XLA and torch order differently)
# flips a bf16 rounding of the residual sum now and then: NMSE ~1e-5 over
# two layers against the JAX engine run op by op
OP_BY_OP_GATE = {"grok": 1e-4}


class _Converted(Exception):
    """Ends a converter test once its GGUF is written."""


def converted(test_fn, root) -> str:
    """The GGUF a test_convert_hf test converts (F32, its seeded weights):
    the test runs until its converter has written the file, which ends
    it; its comparisons with transformers are that test's own."""
    real, out = convert_hf.convert, []

    def capture(src, dst, *args, **kw):
        real(src, dst, *args, **kw)
        out.append(dst)
        raise _Converted

    convert_hf.convert = capture
    try:
        test_fn(root)
    except _Converted:
        pass
    finally:
        convert_hf.convert = real
    return out[0]


def hf_file(root, cfg: dict, ws: dict) -> str:
    """cfg and ws written as an HF checkpoint under root (with
    test_convert_hf's BPE tokenizer of cfg's vocab) and converted to an
    F32 GGUF."""
    import json
    import os

    import safetensors.numpy as st

    hf = root / "hf"
    hf.mkdir(exist_ok=True)
    with open(hf / "config.json", "w") as f:
        json.dump(cfg, f)
    st.save_file(ws, str(hf / "model.safetensors"))
    hf_tests._bpe_tokenizer_json(str(hf), cfg["vocab_size"])
    out = os.path.join(str(root), "m.gguf")
    convert_hf.convert(str(hf), out, dtype="F32")
    return out


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist every
    worker's OpenMP pool takes all cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return {name: converted(fn, tmp_path_factory.mktemp(name))
            for name, fn in CONVERTERS.items()}


# ---------------------------------------------------------------------------
# the routing forms, one MoE layer at a time


def _layer_pair(path, li):
    """(JAX HParams, JAX layer, port HParams, port layer) of layer li."""
    jm, pm = models(path)
    return jm.hp, jm.weights.layers[li], pm.hp, pm.weights.layers[li]


ROUTINGS = {
    "softmax-renormalized": dict(norm_topk=True),
    "softmax-raw-scaled": dict(norm_topk=False, expert_weights_scale=2.5),
    "sigmoid": dict(expert_gating="sigmoid", norm_topk=True),
    "sigmoid-selection-bias": dict(expert_gating="sigmoid", norm_topk=True,
                                   expert_weights_scale=2.5, bias=True),
    "sparsemixer-wide": dict(expert_gating="sparsemixer", n_expert_used=2,
                             router_jitter=0.4),
    "gelu-experts": dict(act_fn="gelu", n_expert_used=3),
}


@pytest.mark.parametrize("form", list(ROUTINGS))
def test_routing_forms_match_reference(paths, form):
    """moe_ffn of one olmoe layer at each routing form (the HParams of the
    form on both sides; DeepSeek-V3's selection bias as a seeded
    exp_probs_b that moves the picks but not the weights) against the JAX
    moe_ffn run op by op: NMSE 1e-10 over 24 rows."""
    jhp, jlw, php, plw = _layer_pair(paths["olmoe"], 1)
    kw = dict(ROUTINGS[form])
    rng = np.random.default_rng(5)
    bias = rng.standard_normal(jhp.n_expert).astype(np.float32) * 0.5 \
        if kw.pop("bias", False) else None
    jhp, php = (dataclasses.replace(h, **kw) for h in (jhp, php))
    jlw = dataclasses.replace(jlw, exp_probs_b=None if bias is None
                              else jnp.asarray(bias))
    plw = dataclasses.replace(plw, exp_probs_b=None if bias is None
                              else torch.from_numpy(bias))
    x = (rng.standard_normal((2, 12, jhp.n_embd)) * 1.5).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(jllama.moe_ffn(jnp.asarray(x, jnp.bfloat16), jlw,
                                         jhp), np.float32)
    got = pllama.moe_ffn(torch.from_numpy(x).to(torch.bfloat16), plw,
                         php).numpy()
    assert np.isfinite(got).all()
    assert nmse(want, got) < 1e-10, nmse(want, got)


def test_routing_bias_moves_the_selection_only():
    """exp_probs_b picks the experts, the weights stay the unbiased
    probabilities (the reference's build_moe_ffn selection_probs)."""
    from llama_cpp_test_tpu_torch.models.hparams import HParams

    hp = HParams(n_expert=4, n_expert_used=2, expert_gating="sigmoid",
                 norm_topk=False)
    router = torch.tensor([[3.0, 2.0, 1.0, 0.0]])
    lw = pllama.LayerWeights(attn_norm=None, wo=None, ffn_norm=None,
                             exp_probs_b=torch.tensor([0.0, 0.0, 5.0, 5.0]))
    topi, topv = pllama._route(router, lw, hp)
    assert sorted(topi[0].tolist()) == [2, 3]
    np.testing.assert_allclose(sorted(topv[0].tolist()),
                               torch.sigmoid(torch.tensor([0.0, 1.0])))


def test_shared_expert_matches_reference(paths):
    """qwen2moe's shared expert, gated by sigmoid(x . gate_inp_shexp),
    against the JAX shared_expert_ffn run op by op (NMSE 1e-10)."""
    jhp, jlw, php, plw = _layer_pair(paths["qwen2moe"], 0)
    assert plw.gate_inp_shexp is not None and plw.up_shexp is not None
    x = np.random.default_rng(6).standard_normal(
        (1, 9, jhp.n_embd)).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(jllama.shared_expert_ffn(
            jnp.asarray(x, jnp.bfloat16), jlw, jhp), np.float32)
    got = pllama.shared_expert_ffn(torch.from_numpy(x).to(torch.bfloat16),
                                   plw, php).numpy()
    assert nmse(want, got) < 1e-10, nmse(want, got)


# ---------------------------------------------------------------------------
# the fixtures through the engine


@pytest.mark.parametrize("name", NAMES)
def test_hparams_match_reference(paths, name):
    hp = check_hparams(paths[name])
    assert hp.arch == name and hp.n_expert > 0
    assert hp.act_fn == ("gelu" if name == "grok" else "silu")
    assert hp.norm_topk == (name not in ("qwen2moe", "olmoe", "deepseek"))
    assert hp.expert_gating == ("sparsemixer" if name == "phimoe"
                                else "softmax")


@pytest.mark.parametrize("name", NAMES)
def test_loader_planes_match_reference(paths, name):
    """Every plane and vector equals the JAX loader's: the shared experts
    and their gate, the leading dense layer, arctic's dense MLP and
    ffn_norm_exps, grok's post-branch norms and dbrx's pre-MoE norm."""
    assert_same_weights(paths[name])
    _, pw = pllama.load_weights(PGGUFReader(paths[name]))
    lw = pw.layers[-1]
    assert (lw.up_shexp is not None) == (name in ("qwen2moe", "deepseek"))
    assert (lw.ffn_norm_exps is not None) == (lw.w_gateup is not None) == \
        (name == "arctic")
    assert (lw.ffn_post_norm is not None) == (name == "grok")
    if name == "deepseek":
        assert pw.layers[0].gate_inp is None
    assert lw.ffn_norm is not None


@pytest.mark.parametrize("name,kv", [(n, "bf16") for n in NAMES] +
                         [(n, "q8_0") for n in Q8_NAMES])
def test_prefill_decode_logits_match_reference(paths, name, kv):
    check_logits(paths[name], kv)


@pytest.mark.parametrize("name", NAMES)
def test_logits_match_reference_op_by_op(paths, name):
    _, pm = models(paths[name])
    want, _ = op_by_op(paths[name])
    gate = OP_BY_OP_GATE.get(name, 1e-10)
    for i, (a, b) in enumerate(zip(want, port_rows(pm))):
        assert nmse(a, b) < gate, (i, nmse(a, b))


@pytest.mark.parametrize("name", NAMES)
def test_greedy_tokens_match_reference(paths, name):
    check_greedy(paths[name])


@pytest.mark.parametrize("name", BATCHED_NAMES)
def test_batched_decode_matches_reference(paths, name):
    check_batched(paths[name])


@pytest.mark.parametrize("name,fuse", [(n, "separate") for n in NAMES] + [
    (n, "fused") for n in ("qwen2moe", "deepseek", "arctic")])
def test_port_runs_on_reference_parameters(paths, name, fuse, monkeypatch):
    """port_weights_from_reference carries the new fields: the JAX
    loader's parameters through the port give the port's own logits,
    also from a reference that fused its gate|up expert stacks
    (LLAMA_TPU_MOE_FUSE=1), whose stacks are split back into the
    loader's."""
    _, pm = models(paths[name])
    if fuse == "fused":
        monkeypatch.setenv("LLAMA_TPU_MOE_FUSE", "1")
    _, jw = jllama.load_weights(GGUFReader(paths[name]))
    pw = port_weights_from_reference(jw)
    last = jw.layers[-1]
    assert (last.gateup_exps is not None) == (fuse == "fused")
    model = pengine.Model.from_weights(pm.hp, pw, device="cpu")
    got = pengine.Context(model, **CTX)
    own = pengine.Context(pm, **CTX)
    np.testing.assert_array_equal(
        got.prefill(got.new_seq(), PROMPT, all_logits=True),
        own.prefill(own.new_seq(), PROMPT, all_logits=True))


@pytest.mark.parametrize("name", ["grok"])
def test_cli_text_matches_reference(paths, name):
    check_cli(paths[name])


@pytest.mark.parametrize("name", ["deepseek", "arctic"])
def test_scheduler_serves_as_generate(paths, name):
    check_scheduler(paths[name])
