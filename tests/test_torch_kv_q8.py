"""Port conformance of the q8_0 KV cache (llama_cpp_test_tpu_torch
runtime/kv_cache q8 ops, ops/paged_attention over int8 pages, the engine
with kv_type="q8_0") against the JAX package on CPU, mirroring
tests/test_kv_quant.py:15,26,64.

Gates: quantization bit-equal to the reference; decode attention NMSE
< 2e-4 against the Pallas kernel in interpret mode
(tests/test_kv_quant.py:93); engine logits NMSE < 2e-3
(tests/test_engine.py:225).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from test_engine import make_tiny_gguf

from llama_cpp_test_tpu.ops import paged_attention as pa
from llama_cpp_test_tpu.runtime import engine as jengine
from llama_cpp_test_tpu.runtime import kv_cache as jkv
from llama_cpp_test_tpu_torch.ops import paged_attention as ppa
from llama_cpp_test_tpu_torch.runtime import engine as pengine
from llama_cpp_test_tpu_torch.runtime import kv_cache as pkv


def nmse(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(((a - b) ** 2).mean() / ((a * a).mean() + 1e-12))


def test_quantize_q8_roundtrip_equals_reference():
    x = np.random.default_rng(0).standard_normal((4, 7, 16)).astype(np.float32)
    jq, js = jkv.quantize_q8(jnp.asarray(x))
    q, s = pkv.quantize_q8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(jq), q.numpy())
    np.testing.assert_array_equal(np.asarray(js), s.numpy())
    deq = q.float().numpy() * s.numpy()[..., None]
    assert nmse(x, deq) < 1e-4


def test_write_and_gather_kv_q8_match_reference():
    """The quantizing scatter fills the kept slots as the reference does and
    leaves the others alone; the dequantizing gather equals the
    reference's."""
    rng = np.random.default_rng(4)
    kv, nb, bs, d = 2, 6, 8, 16
    new = rng.standard_normal((2, 3, kv, d)).astype(np.float32)
    slots = np.asarray([[5, 6, 7], [17, 30, 41]], np.int32)
    jpool = jnp.zeros((kv, nb, bs, d), jnp.int8)
    jscale = jnp.zeros((kv, nb, bs), jnp.float32)
    jpool, jscale = jkv.write_kv_q8(jpool, jscale,
                                    jnp.asarray(new, jnp.bfloat16),
                                    jnp.asarray(slots))
    ppool = torch.zeros((kv, nb, bs, d), dtype=torch.int8)
    pscale = torch.zeros((kv, nb, bs), dtype=torch.float32)
    flat = slots.reshape(-1)
    pkv.write_kv_q8(ppool, pscale, torch.from_numpy(new).to(torch.bfloat16),
                    torch.arange(flat.size), torch.from_numpy(flat).long())
    np.testing.assert_array_equal(np.asarray(jpool), ppool.numpy())
    np.testing.assert_array_equal(np.asarray(jscale), pscale.numpy())
    table = np.asarray([[0, 2, 5], [3, 1, 4]], np.int32)
    ref = jkv.gather_kv_q8(jpool, jscale, jnp.asarray(table))
    got = pkv.gather_kv_q8(ppool, pscale, torch.from_numpy(table))
    np.testing.assert_array_equal(np.asarray(ref.astype(jnp.float32)),
                                  got.float().numpy())


@pytest.mark.parametrize("lengths,cap", [([64, 17, 33], None),
                                         ([1, 2, 5], None),
                                         ([40, 9, 64], 30.0)],
                         ids=["mixed", "short", "softcap"])
def test_paged_decode_q8_matches_pallas(lengths, cap):
    """The q8 decode plain version (what K3-q8 is held against) against
    the JAX q8 Pallas kernel in interpret mode."""
    rng = np.random.default_rng(0)
    b, kv, g, d, nb, bs, nbmax = 3, 2, 4, 64, 16, 16, 4
    kf = rng.standard_normal((kv, nb, bs, d)).astype(np.float32) * 0.3
    vf = rng.standard_normal((kv, nb, bs, d)).astype(np.float32) * 0.3
    q = (rng.standard_normal((b, kv * g, d)) * 0.3).astype(np.float32)
    pages = np.stack([rng.permutation(nb)[:nbmax] for _ in range(b)]) \
        .astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    kq, ks = jkv.quantize_q8(jnp.asarray(kf))
    vq, vs = jkv.quantize_q8(jnp.asarray(vf))
    ref = pa.paged_attention_decode(
        jnp.asarray(q, jnp.bfloat16), kq, vq, jnp.asarray(lens),
        jnp.asarray(pages), soft_cap=cap, interpret=True, pages_per_step=2,
        k_scale=ks, v_scale=vs)
    t = lambda a: torch.from_numpy(np.array(a))
    got = ppa.paged_attention_decode(
        torch.from_numpy(q).to(torch.bfloat16), t(kq), t(vq), t(lens),
        t(pages), soft_cap=cap, k_scale=t(ks), v_scale=t(vs))
    assert got.shape == tuple(ref.shape) and got.dtype == torch.bfloat16
    r = np.asarray(ref.astype(jnp.float32))
    assert nmse(r, got.float().numpy()) < 2e-4, nmse(r, got.float().numpy())


def test_attend_decode_q8_matches_reference():
    """The q8 decode dispatcher (q [B, 1, H, D], logits scaled) against the
    reference's, which on CPU is the same gather + masked softmax."""
    rng = np.random.default_rng(7)
    b, kv, g, d, nb, bs, nbmax = 3, 2, 4, 32, 12, 8, 4
    kq, ks = jkv.quantize_q8(jnp.asarray(rng.standard_normal((kv, nb, bs, d)),
                                         jnp.float32))
    vq, vs = jkv.quantize_q8(jnp.asarray(rng.standard_normal((kv, nb, bs, d)),
                                         jnp.float32))
    q = (rng.standard_normal((b, 1, kv * g, d)) * 0.3).astype(np.float32)
    table = np.stack([rng.permutation(nb)[:nbmax] for _ in range(b)]) \
        .astype(np.int32)
    kl = np.asarray([30, 3, 17], np.int32)
    ref = jkv.attend_decode_q8(jnp.asarray(q, jnp.bfloat16), kq, ks, vq, vs,
                               jnp.asarray(table), jnp.asarray(kl), 0.125)
    t = lambda a: torch.from_numpy(np.array(a))
    got = pkv.attend_decode_q8(torch.from_numpy(q).to(torch.bfloat16),
                               t(kq), t(ks), t(vq), t(vs), t(table), t(kl),
                               0.125)
    assert got.shape == tuple(ref.shape)
    r = np.asarray(ref.astype(jnp.float32))
    assert nmse(r, got.float().numpy()) < 1e-6


@pytest.fixture(scope="module")
def dense_models(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("q8") / "tiny.gguf")
    make_tiny_gguf(path)
    return jengine.Model(path), pengine.Model(path, device="cpu")


def test_q8_kv_logits_match_reference(dense_models):
    """Prefill, decode steps and a batched decode over q8_0 pools, port
    against the JAX engine with kv_type="q8_0"."""
    jm, pm = dense_models
    prompt = [3, 17, 42, 9, 105]
    jc = jengine.Context(jm, n_ctx=64, n_seq_max=4, block_size=8,
                         kv_type="q8_0")
    pc = pengine.Context(pm, n_ctx=64, n_seq_max=4, block_size=8,
                         kv_type="q8_0")
    assert pc.pools.quantized and pc.pools.k[0].dtype == torch.int8
    js, ps = jc.new_seq(), pc.new_seq()
    ref, got = jc.prefill(js, prompt, all_logits=True), \
        pc.prefill(ps, prompt, all_logits=True)
    assert nmse(ref, got) < 2e-3, nmse(ref, got)
    tok = int(np.argmax(ref[-1]))
    for _ in range(4):
        ref, got = jc.decode([js], [tok])[0], pc.decode([ps], [tok])[0]
        assert np.isfinite(got).all()
        assert nmse(ref, got) < 2e-3, nmse(ref, got)
        tok = int(np.argmax(ref))
    outs = []
    for ctx in (jc, pc):
        ctx.prefill(ctx.new_seq(), [100, 101, 102])
        outs.append(ctx.decode(list(ctx.seqs.values()), [11, 12]))
    assert nmse(outs[0], outs[1]) < 2e-3
