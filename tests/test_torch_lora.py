"""LoRA adapters in the port (llama_cpp_test_tpu_torch/models/lora.py and
the update in models/llama.py) against the JAX package on the tiny
fixtures: all-logits NMSE of an attached adapter < 5e-5 of the jitted JAX
engine on an F32 base and < 2e-3 on a Q8_0 base (and < 1e-10 of the JAX
engine run op by op, whose bf16 roundings the port keeps); the attached
adapter against the merged model (tests/test_lora.py's check); stacking
with attach_loras, and an adapter at scale 0 leaving the logits bit-equal
to the base; merge_lora's file byte-equal to the JAX one; greedy tokens
through decode windows with an adapter equal to the JAX generate(); the
attention LoRA on the tiny MoE fixture (against the JAX engine op by op,
which keeps the router input's bf16 rounding)."""
import jax
import numpy as np
import pytest
import torch

from test_engine import make_tiny_gguf, nmse
from test_lora import make_lora_gguf

from __graft_entry__ import _tiny_gguf
from llama_cpp_test_tpu.gguf.constants import GGMLType
from llama_cpp_test_tpu.models import lora as jlora
from llama_cpp_test_tpu.runtime import engine as jengine
from llama_cpp_test_tpu_torch.gguf.writer import GGUFWriter
from llama_cpp_test_tpu_torch.models import lora as plora
from llama_cpp_test_tpu_torch.runtime import engine as pengine
from llama_cpp_test_tpu_torch.weights import port_weights_from_reference

GATES = {"f32": 5e-5, "q8": 2e-3}   # all-logits NMSE against jitted JAX
OP_BY_OP_GATE = 1e-10
TOKENS = [3, 17, 42, 9, 150, 7, 23, 88, 5]
TARGETS = ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate",
           "ffn_up", "ffn_down")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist every
    worker's OpenMP pool takes all cores, and these small steps spin
    against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_adapter(path, dims, n_layer, targets=TARGETS, rank=4, alpha=8.0,
                  seed=0, s=0.1):
    """A LoRA GGUF over `targets` of every layer; dims: target -> (N, K)."""
    rng = np.random.default_rng(seed)
    w = GGUFWriter(path, arch="llama")
    w.add_kv("adapter.type", "lora")
    w.add_kv("adapter.lora.alpha", alpha)
    for li in range(n_layer):
        for t in targets:
            n, k = dims[t]
            base = f"blk.{li}.{t}.weight"
            for suffix, shape in ((".lora_a", (rank, k)),
                                  (".lora_b", (n, rank))):
                w.add_tensor(base + suffix, (rng.standard_normal(shape)
                                             * s).astype(np.float32),
                             ggml_type=GGMLType.F32)
    w.write()
    return path


def dims_of(n_embd, n_head, n_head_kv, head_dim, n_ff):
    q, kv = n_head * head_dim, n_head_kv * head_dim
    return {"attn_q": (q, n_embd), "attn_k": (kv, n_embd),
            "attn_v": (kv, n_embd), "attn_output": (n_embd, q),
            "ffn_gate": (n_ff, n_embd), "ffn_up": (n_ff, n_embd),
            "ffn_down": (n_embd, n_ff)}


TINY_DIMS = dims_of(64, 4, 2, 16, 96)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("lora")
    out = {"f32": str(d / "f32.gguf"), "q8": str(d / "q8.gguf"),
           "a1": write_adapter(str(d / "a1.gguf"), TINY_DIMS, 2, seed=1),
           "a2": write_adapter(str(d / "a2.gguf"), TINY_DIMS, 2, rank=2,
                               alpha=4.0, seed=2,
                               targets=("attn_q", "ffn_down"))}
    make_tiny_gguf(out["f32"], qtype=GGMLType.F32)
    make_tiny_gguf(out["q8"])
    return out


def all_logits(ctx, tokens=TOKENS):
    return ctx.prefill(ctx.new_seq(), tokens, all_logits=True)


def port_ctx(model, **kw):
    return pengine.Context(model, **{"n_ctx": 64, "n_seq_max": 2,
                                     "block_size": 8, **kw})


def jax_ctx(model, **kw):
    return jengine.Context(model, **{"n_ctx": 64, "n_seq_max": 2,
                                     "block_size": 8, **kw})


@pytest.mark.parametrize("base", ["f32", "q8"])
def test_attached_lora_matches_reference(files, base):
    jm = jengine.Model(files[base])
    jlora.attach_lora(jm.weights, jlora.load_lora(files["a1"], jm.hp), 0.7)
    pm = pengine.Model(files[base], device="cpu")
    plain = all_logits(port_ctx(pm))
    plora.attach_lora(pm.weights, plora.load_lora(files["a1"], pm.hp), 0.7)
    got = all_logits(port_ctx(pm))
    assert nmse(all_logits(jax_ctx(jm)), got) < GATES[base]
    with jax.disable_jit():
        want = all_logits(jax_ctx(jm))
    assert nmse(want, got) < OP_BY_OP_GATE
    # the adapter moves the logits far past the gate
    assert nmse(plain, got) > 100 * GATES[base]
    # the plain path carries the same adapter
    assert nmse(all_logits(port_ctx(pm, plain=True)), got) < 1e-12


def test_reference_weights_carry_the_adapter(files):
    """port_weights_from_reference + to_device carry the (A, B, scale)
    pairs and a control vector attached on the JAX side."""
    from llama_cpp_test_tpu.models.cvec import attach_control_vector

    jm = jengine.Model(files["q8"])
    jlora.attach_lora(jm.weights, jlora.load_lora(files["a1"], jm.hp), 0.7)
    rng = np.random.default_rng(3)
    attach_control_vector(jm.weights, {2: rng.standard_normal(64) * 0.5})
    pm = pengine.Model.from_weights(
        jm.hp, port_weights_from_reference(jm.weights), device="cpu")
    assert set(pm.weights.layers[0].lora) == {
        "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"}
    assert pm.weights.layers[0].cvec is None
    assert pm.weights.layers[1].cvec.dtype == torch.float32
    mine = pengine.Model(files["q8"], device="cpu")
    plora.attach_lora(mine.weights, plora.load_lora(files["a1"], mine.hp), 0.7)
    from llama_cpp_test_tpu_torch.models.cvec import (
        attach_control_vector as pattach)
    pattach(mine.weights, {2: np.random.default_rng(3).standard_normal(64)
                           * 0.5})
    np.testing.assert_array_equal(all_logits(port_ctx(pm)),
                                  all_logits(port_ctx(mine)))


def test_attached_matches_merged(tmp_path):
    """tests/test_lora.py's check on the port: an adapter attached at run
    time against the same delta baked into an F32 file."""
    from llama_cpp_test_tpu.gguf.reader import GGUFReader
    from llama_cpp_test_tpu.gguf.writer import GGUFWriter as JWriter

    base = str(tmp_path / "base.gguf")
    make_tiny_gguf(base, qtype=GGMLType.F32)
    adapter = str(tmp_path / "adapter.gguf")
    pairs, alpha, rank = make_lora_gguf(adapter, np.random.default_rng(7))
    merged = str(tmp_path / "merged.gguf")
    with GGUFReader(base) as r:
        w = JWriter(merged)
        for k, v in r.metadata.items():
            w.add_kv(k, v)
        for name in r.tensors:
            dense = r.dequantize(name, np.float32)
            if name in pairs:
                a, b = pairs[name]
                dense = dense + (b @ a).reshape(dense.shape) * (alpha / rank)
            w.add_tensor(name, dense, ggml_type=GGMLType.F32)
        w.write()
    ref = all_logits(port_ctx(pengine.Model(merged, device="cpu")))
    m = pengine.Model(base, device="cpu")
    plain = all_logits(port_ctx(m))
    plora.attach_lora(m.weights, plora.load_lora(adapter, m.hp))
    got = all_logits(port_ctx(m))
    assert nmse(ref, got) < 5e-5
    assert nmse(ref, plain) > 1e-5


def test_attach_loras_stacks_and_scale_zero_drops(files):
    jm = jengine.Model(files["q8"])
    pm = pengine.Model(files["q8"], device="cpu")
    base = all_logits(port_ctx(pm))
    j1, j2 = (jlora.load_lora(files[k], jm.hp) for k in ("a1", "a2"))
    p1, p2 = (plora.load_lora(files[k], pm.hp) for k in ("a1", "a2"))
    jlora.attach_loras(jm.weights, [(j1, 0.5), (j2, 1.0)])
    plora.attach_loras(pm.weights, [(p1, 0.5), (p2, 1.0)])
    # the stacked pair is the sum of the two updates
    a, b, sc = pm.weights.layers[0].lora["wq"]
    assert sc == 1.0 and a.shape == (6, 64) and b.shape == (64, 6)
    want = 0.5 * p1.pairs["blk.0.attn_q.weight"].scale * (
        p1.pairs["blk.0.attn_q.weight"].b @ p1.pairs["blk.0.attn_q.weight"].a
    ) + p2.pairs["blk.0.attn_q.weight"].scale * (
        p2.pairs["blk.0.attn_q.weight"].b @ p2.pairs["blk.0.attn_q.weight"].a)
    assert nmse((b @ a).numpy(), want) < 1e-4
    assert set(pm.weights.layers[1].lora) == set(jm.weights.layers[1].lora)
    stacked = all_logits(port_ctx(pm))
    assert nmse(all_logits(jax_ctx(jm)), stacked) < GATES["q8"]
    # scale 0 drops an adapter: alone, the logits are the base's bits
    plora.attach_loras(pm.weights, [(p1, 0.0)])
    assert all(lw.lora == {} for lw in pm.weights.layers)
    np.testing.assert_array_equal(all_logits(port_ctx(pm)), base)
    plora.attach_loras(pm.weights, [(p1, 0.0), (p2, 1.0)])
    alone = pengine.Model(files["q8"], device="cpu")
    plora.attach_loras(alone.weights, [(p2, 1.0)])
    np.testing.assert_array_equal(all_logits(port_ctx(pm)),
                                  all_logits(port_ctx(alone)))


def test_merge_lora_file_equals_reference(files, tmp_path):
    want, got = str(tmp_path / "j.gguf"), str(tmp_path / "p.gguf")
    n = jlora.merge_lora(files["q8"], files["a1"], want, user_scale=0.5)
    assert plora.merge_lora(files["q8"], files["a1"], got, 0.5) == n == 14
    with open(want, "rb") as f, open(got, "rb") as g:
        assert f.read() == g.read()


def test_greedy_windows_with_adapter_match_reference(files):
    """Greedy tokens through chained decode windows with an adapter equal
    the JAX generate()'s."""
    jm = jengine.Model(files["q8"])
    jlora.attach_lora(jm.weights, jlora.load_lora(files["a1"], jm.hp))
    pm = pengine.Model(files["q8"], device="cpu")
    plora.attach_lora(pm.weights, plora.load_lora(files["a1"], pm.hp))
    want = list(jengine.generate(jax_ctx(jm), TOKENS[:5], 17))
    ctx = port_ctx(pm)
    s = ctx.new_seq()
    first = int(np.argmax(ctx.prefill(s, TOKENS[:5])))
    h = ctx.decode_window_async([s], [first], [None], n_steps=8)
    h2 = ctx.decode_window_async([s], n_steps=8, carry=h)
    got = [first] + np.concatenate([h.fetch(), h2.fetch()])[:, 0].tolist()
    assert got == want
    assert list(pengine.generate(port_ctx(pm), TOKENS[:5], 17)) == want


def test_attention_lora_on_moe_matches_reference_op_by_op(tmp_path):
    path = _tiny_gguf(str(tmp_path / "moe.gguf"), n_expert=4,
                      n_expert_used=2)
    adapter = write_adapter(str(tmp_path / "att.gguf"),
                            dims_of(256, 8, 4, 32, 512), 2,
                            targets=TARGETS[:4], seed=5)
    jm = jengine.Model(path)
    jlora.attach_lora(jm.weights, jlora.load_lora(adapter, jm.hp))
    pm = pengine.Model(path, device="cpu")
    plain = all_logits(port_ctx(pm, n_ctx=32, n_seq_max=4), TOKENS[:8])
    plora.attach_lora(pm.weights, plora.load_lora(adapter, pm.hp))
    assert set(pm.weights.layers[1].lora) == {"wq", "wk", "wv", "wo"}
    got = all_logits(port_ctx(pm, n_ctx=32, n_seq_max=4), TOKENS[:8])
    with jax.disable_jit():
        want = all_logits(jax_ctx(jm, n_ctx=32, n_seq_max=4), TOKENS[:8])
    assert nmse(want, got) < 2e-3
    assert nmse(plain, got) > 0.2


def test_export_lora_cli_writes_the_reference_file(files, tmp_path):
    import contextlib
    import io

    from llama_cpp_test_tpu.cli.export_lora import main as jmain
    from llama_cpp_test_tpu_torch.cli.export_lora import main as pmain

    outs = {}
    for side, main in (("j", jmain), ("p", pmain)):
        dst = str(tmp_path / f"{side}.gguf")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(["-m", files["q8"], "--lora", files["a1"],
                       "--lora-scaled", files["a2"], "0.5", "-o", dst])
        text = buf.getvalue().splitlines()
        assert rc == 0 and len(text) == 2 and text[1].endswith(f"-> {dst}")
        outs[side] = (text[0].split(" -> ")[0], text[1].split(" -> ")[0],
                      open(dst, "rb").read())
    assert outs["p"] == outs["j"]
