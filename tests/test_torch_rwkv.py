"""The rwkv families of the port (llama_cpp_test_tpu_torch models/rwkv6.py,
rwkv7.py, runtime/recurrent.py) against the JAX package, on CPU, in one
process, from numpy seeds. Each fixture is an HF checkpoint of the JAX
tests' layout converted once by the reference's converter (F32):

  rwkv6       tests/test_rwkv6._rwkv6_ws (width 64, head 16, 2 layers)
  rwkv6qwen2  the QRWKV weights of tests/test_rwkv6.py (GQA 4 on 2 heads,
              q/k/v biases, SwiGLU FFN, rkvwg lerp order)
  rwkv7       tests/test_rwkv7._rwkv7_ws (3 layers, the output gate)
  arwkv7      tests/test_rwkv7._arwkv7_ws (RMS norms, SwiGLU FFN)

Checks, per arch: all-position prefill logits and the state after it
within NMSE 1e-8 of the JAX _forward_tokens; step-by-step decode equal
to one prefill; greedy tokens equal; port_*_from_reference equal to the
port's loader bit for bit; the state pool's prefill (n = 5, 7) and
batched decode (B = 3, reused rows) against the reference's _rec_prefill
and _rec_decode; the Scheduler's greedy tokens over three concurrent
requests equal to the reference Scheduler's; cli.main's printout equal
to the JAX CLI's. Plus rwkv6's rescale (every 1 and 2 layers) and an
rwkv7 file without the output gate (5 lerp rows).
"""
import io
import json
import sys

import numpy as np
import pytest
import torch

from test_rwkv6 import _rwkv6_ws, _write_hf as _write_hf6
from test_rwkv7 import _arwkv7_ws, _rwkv7_ws, _write_hf as _write_hf7

from llama_cpp_test_tpu.cli.main import main as jmain
from llama_cpp_test_tpu.models import rwkv6 as jrwkv6
from llama_cpp_test_tpu.models import rwkv7 as jrwkv7
from llama_cpp_test_tpu.runtime import recurrent as jrec
from llama_cpp_test_tpu.runtime.sampling import SamplerParams as JParams
from llama_cpp_test_tpu.runtime.scheduler import (GenRequest as JRequest,
                                                  Scheduler as JScheduler)
from llama_cpp_test_tpu.tools.convert_hf import convert
from llama_cpp_test_tpu_torch.cli.main import main as pmain
from llama_cpp_test_tpu_torch.models import rwkv6 as prwkv6
from llama_cpp_test_tpu_torch.models import rwkv7 as prwkv7
from llama_cpp_test_tpu_torch.runtime import recurrent as prec
from llama_cpp_test_tpu_torch.runtime.sampling import SamplerParams
from llama_cpp_test_tpu_torch.runtime.scheduler import GenRequest, Scheduler
from llama_cpp_test_tpu_torch.weights import (port_rwkv6_from_reference,
                                              port_rwkv7_from_reference)

GATE = 1e-8                      # f32 logits and states against the JAX run
PROMPT = [3, 17, 42, 9, 150, 7]
V, C, L, D, E, FF = 256, 64, 2, 16, 8, 96
H = C // D


def nmse(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(((a - b) ** 2).mean() / ((b * b).mean() + 1e-30))


def _qrwkv_ws(rng):
    """The QRWKV (rwkv6qwen2) checkpoint of tests/test_rwkv6.py: qwen body
    names, GQA kv heads 2 of 4, q/k/v biases, the rkvwg lerp order."""
    r = lambda *s: (rng.standard_normal(s) * 0.08).astype(np.float32)
    kvh = 2
    ws = {"model.embed_tokens.weight": r(V, C),
          "model.norm.weight": 1.0 + r(C), "lm_head.weight": r(V, C)}
    for i in range(L):
        p = f"model.layers.{i}."
        ws.update({
            p + "input_layernorm.weight": 1.0 + r(C),
            p + "post_attention_layernorm.weight": 1.0 + r(C),
            **{p + f"self_attn.time_maa_{s}": r(1, 1, C) for s in "xwkvrg"},
            p + "self_attn.time_maa_w1": r(C, 5 * E),
            p + "self_attn.time_maa_w2": r(5, E, C),
            p + "self_attn.time_decay": r(1, 1, C) - 4.0,
            p + "self_attn.time_decay_w1": r(C, 16),
            p + "self_attn.time_decay_w2": r(16, C),
            p + "self_attn.q_proj.weight": r(C, C),
            p + "self_attn.q_proj.bias": r(C),
            p + "self_attn.k_proj.weight": r(kvh * D, C),
            p + "self_attn.k_proj.bias": r(kvh * D),
            p + "self_attn.v_proj.weight": r(kvh * D, C),
            p + "self_attn.v_proj.bias": r(kvh * D),
            p + "self_attn.gate.weight": r(C, C),
            p + "self_attn.o_proj.weight": r(C, C),
            p + "mlp.gate_proj.weight": r(FF, C),
            p + "mlp.up_proj.weight": r(FF, C),
            p + "mlp.down_proj.weight": r(C, FF),
        })
    cfg = {"architectures": ["RWKV6Qwen2ForCausalLM"], "hidden_size": C,
           "num_hidden_layers": L, "num_attention_heads": H,
           "num_key_value_heads": kvh, "intermediate_size": FF,
           "vocab_size": V, "rms_norm_eps": 1e-5, "bos_token_id": 0,
           "eos_token_id": 0}
    return ws, cfg


def _rwkv7_cfg(arch: str) -> dict:
    base = {"hidden_size": C, "num_hidden_layers": 3, "head_size": D,
            "intermediate_size": FF, "vocab_size": V, "bos_token_id": 0,
            "eos_token_id": 0}
    if arch == "arwkv7":
        return dict(base, architectures=["RwkvHybridForCausalLM"],
                    rms_norm_eps=1e-5, wkv_has_gate=True, wkv_version=7)
    return dict(base, architectures=["Rwkv7ForCausalLM"],
                layer_norm_epsilon=1e-5)


def _hf_dir(tmp, arch: str, seed: int, rescale: int = 0,
            gate: bool = True) -> str:
    rng = np.random.default_rng(seed)
    if arch == "rwkv6":
        return _write_hf6(tmp, _rwkv6_ws(rng), rescale)
    if arch == "rwkv6qwen2":
        ws, cfg = _qrwkv_ws(rng)
        d = _write_hf6(tmp, ws, 0)
        with open(d + "/config.json", "w") as f:
            json.dump(cfg, f)
        return d
    ws = _rwkv7_ws(rng) if arch == "rwkv7" else _arwkv7_ws(rng)
    if not gate:
        ws = {k: v for k, v in ws.items()
              if not k.endswith(("attention.g1", "attention.g2",
                                 "attention.x_g"))}
    return _write_hf7(tmp, ws, dict(_rwkv7_cfg(arch), wkv_has_gate=gate))


ARCHS = ("rwkv6", "rwkv6qwen2", "rwkv7", "arwkv7")
_SEEDS = {"rwkv6": 301, "rwkv6qwen2": 302, "rwkv7": 303, "arwkv7": 304}


class Pair:
    """One converted file, loaded by both packages (the port on the CPU)."""

    def __init__(self, path: str):
        self.path = path
        arch = path.rsplit("/", 1)[-1].split(".")[0].split("_")[0]
        six = arch.startswith("rwkv6")
        self.jmod, self.pmod = (jrwkv6, prwkv6) if six else (jrwkv7, prwkv7)
        self.jm = (jrwkv6.Rwkv6Model if six else jrwkv7.Rwkv7Model)(path)
        self.pm = (prwkv6.Rwkv6Model if six else prwkv7.Rwkv7Model)(
            path, device="cpu")
        self.jctx_cls = jrwkv6.Rwkv6Context if six else jrwkv7.Rwkv7Context
        self.pctx_cls = prwkv6.Rwkv6Context if six else prwkv7.Rwkv7Context
        self.port_from_ref = (port_rwkv6_from_reference if six
                              else port_rwkv7_from_reference)


def _convert(tmp_path_factory, name: str, dtype: str = "F32", **kw) -> str:
    tmp = tmp_path_factory.mktemp(name)
    out = str(tmp / f"{name}.gguf")
    convert(_hf_dir(tmp, name.split("_")[0], **kw), out, dtype=dtype)
    return out


@pytest.fixture(scope="module", params=ARCHS)
def pair(request, tmp_path_factory):
    arch = request.param
    return Pair(_convert(tmp_path_factory, arch, seed=_SEEDS[arch]))


def test_prefill_logits_and_state_match_reference(pair):
    jctx, pctx = pair.jctx_cls(pair.jm), pair.pctx_cls(pair.pm)
    want = jctx.prefill(PROMPT, all_logits=True)
    got = pctx.prefill(PROMPT, all_logits=True)
    assert got.shape == want.shape == (len(PROMPT), V)
    assert nmse(got, want) < GATE
    for a, b in zip(pctx.states, jctx.states):
        assert a.shape[1:] == b.shape
        assert nmse(a[0].numpy(), np.asarray(b)) < GATE


def test_stepwise_decode_equals_prefill(pair):
    full = pair.pctx_cls(pair.pm)
    lf = full.prefill(PROMPT)
    step = pair.pctx_cls(pair.pm)
    step.prefill(PROMPT[:2])
    for t in PROMPT[2:-1]:
        step.decode(t)
    ls = step.decode(PROMPT[-1])
    np.testing.assert_allclose(ls, lf, rtol=1e-5, atol=1e-5)
    for a, b in zip(step.states, full.states):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert step.n_past == full.n_past == len(PROMPT)


def test_greedy_tokens_match_reference(pair):
    want = list(jrwkv6.generate(pair.jctx_cls(pair.jm), PROMPT, 8))
    got = list(prwkv6.generate(pair.pctx_cls(pair.pm), PROMPT, 8))
    assert got == want


def test_port_from_reference_equals_loader(pair):
    pm = pair.port_from_ref(pair.jm, device="cpu")
    assert pm.hp == pair.pm.hp
    assert pm.tokenizer is None and pm.path is None
    a, b = pm.weights, pair.pm.weights
    for f in ("tok_embd", "tok_norm_w", "tok_norm_b", "output_norm_w",
              "output_norm_b", "output"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        assert x is None or torch.equal(x, y), f
    for la, lb in zip(a.layers, b.layers):
        for k, x in vars(la).items():
            y = getattr(lb, k)
            assert (x is None) == (y is None), k
            assert x is None or (x.dtype == torch.float32
                                 and torch.equal(x, y)), k


@pytest.mark.parametrize("dtype", ["F16", "BF16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_half_precision_file_loads_as_reference(tmp_path_factory, arch,
                                                dtype):
    """A file of F16 or BF16 matrices: the loader moves them in their own
    type and widens them where they are placed; every weight equals the
    reference's f32 dequantization bit for bit."""
    p = Pair(_convert(tmp_path_factory, f"{arch}_{dtype}", dtype,
                      seed=_SEEDS[arch]))
    ref = p.port_from_ref(p.jm, device="cpu").weights
    got = p.pm.weights
    for la, lb in zip([ref] + ref.layers, [got] + got.layers):
        for k, x in vars(la).items():
            if k == "layers":
                continue
            y = getattr(lb, k)
            assert (x is None) == (y is None), k
            assert x is None or (y.dtype == torch.float32
                                 and torch.equal(x, y)), k
    lg = p.pctx_cls(p.pm).prefill(PROMPT)
    assert nmse(lg, p.jctx_cls(p.jm).prefill(PROMPT)) < GATE


def test_pool_prefill_and_decode_match_reference(pair):
    """RecurrentContext against the reference's _rec_prefill (n in the
    middle of the 8-token bucket) and its _rec_decode at B = 3 on rows
    used out of order after a free."""
    jctx = jrec.RecurrentContext(pair.jm, n_ctx=128, n_seq_max=4)
    pctx = prec.RecurrentContext(pair.pm, n_ctx=128, n_seq_max=4)
    rng = np.random.default_rng(7)
    js, ps = [], []
    for n in (5, 7, 5, 7):
        toks = [int(t) for t in rng.integers(1, V, n)]
        js.append(jctx.new_seq())
        ps.append(pctx.new_seq())
        want = jctx.prefill(js[-1], toks)
        got = pctx.prefill(ps[-1], toks)
        assert js[-1].row == ps[-1].row
        assert nmse(got, want) < GATE, n
    freed = ps[1].row
    jctx.free_seq(js[1])
    pctx.free_seq(ps[1])
    js[1], ps[1] = jctx.new_seq(), pctx.new_seq()      # the freed row again
    assert js[1].row == ps[1].row == freed
    jctx.prefill(js[1], [11, 12, 13])
    pctx.prefill(ps[1], [11, 12, 13])
    order = [2, 1, 0]
    for step in range(2):
        toks = [20 + step + i for i in order]
        want = jctx.decode([js[i] for i in order], toks)
        got = pctx.decode([ps[i] for i in order], toks)
        assert got.shape == (3, V)
        assert nmse(got, want) < GATE, step
    for pj, pp in zip(jctx.pool, pctx.pool):
        for i in range(4):
            r = ps[i].row
            assert nmse(pp[r].numpy(), np.asarray(pj[r])) < GATE


def test_scheduler_matches_reference(pair):
    """Three concurrent greedy requests (one chunked) through the port's
    Scheduler over its RecurrentContext equal the reference Scheduler's
    over its own."""
    prompts = [PROMPT, [200, 9, 88, 41], [5, 6, 7, 8, 9, 10, 11, 12, 13]]
    runs = []
    for ctx_cls, sched_cls, req_cls, sp, m in (
            (jrec.RecurrentContext, JScheduler, JRequest, JParams, pair.jm),
            (prec.RecurrentContext, Scheduler, GenRequest, SamplerParams,
             pair.pm)):
        sched = sched_cls(ctx_cls(m, n_ctx=128, n_seq_max=3), n_slots=3,
                          chunk_size=4)
        reqs = [sched.submit(req_cls(p, max_tokens=6, ignore_eos=True,
                                     sampling=sp(temp=0.0)))
                for p in prompts]
        sched.run()
        runs.append([r.output_tokens for r in reqs])
    assert runs[1] == runs[0]
    assert all(len(t) == 6 for t in runs[1])


def _stdout(main, argv, **kw) -> str:
    old = sys.stdout
    sys.stdout = io.StringIO()
    try:
        assert main(argv, **kw) == 0
        return sys.stdout.getvalue()
    finally:
        sys.stdout = old


def test_cli_text_matches_reference(pair):
    argv = ["-m", pair.path, "-p", "<t3><t17><t42>", "-n", "6"]
    want = _stdout(jmain, argv)
    assert want.startswith("<t3><t17><t42>")
    assert _stdout(pmain, argv, device="cpu") == want


@pytest.mark.parametrize("every", [1, 2])
def test_rwkv6_rescale_matches_reference(tmp_path_factory, every):
    """rescale_every > 0: the activation halving at (li + 1) % every == 0
    on weights the converter pre-divided, as the reference."""
    p = Pair(_convert(tmp_path_factory, "rwkv6", seed=310 + every,
                      rescale=every))
    assert p.pm.hp.rescale_every == every
    assert [prwkv6.rescales(p.pm.hp, li) for li in range(L)] == \
        [(li + 1) % every == 0 for li in range(L)]
    want = p.jctx_cls(p.jm).prefill(PROMPT, all_logits=True)
    got = p.pctx_cls(p.pm).prefill(PROMPT, all_logits=True)
    assert nmse(got, want) < GATE


def test_rwkv7_without_gate_matches_reference(tmp_path_factory):
    """An rwkv7 file without the output gate: 5 lerp rows, no g1/g2."""
    p = Pair(_convert(tmp_path_factory, "rwkv7", seed=320, gate=False))
    ly = p.pm.weights.layers[1]
    assert ly.g1 is None and ly.lerp_fused.shape == (5, C)
    assert p.pm.weights.layers[0].v1 is None and ly.v1 is not None
    want = p.jctx_cls(p.jm).prefill(PROMPT, all_logits=True)
    got = p.pctx_cls(p.pm).prefill(PROMPT, all_logits=True)
    assert nmse(got, want) < GATE
