"""Port conformance for every GGUF weight type the JAX package repacks
(llama_cpp_test_tpu_torch quant/codecs, quant/iq_repack, quant/repack and
the plain versions of kernels K1 and K5 in ops/qmatmul).

The K-quant and legacy inputs are made by the JAX quantizers from seeded
numpy weights; the codebook i-quant and ternary inputs are random blocks
with their fp16 scale fields drawn from a bounded range, so every weight
is finite. Checks: block decode equal bit for bit; planes (layout 't' and
'rows') equal array for array, LUT included, against the JAX numpy repack
(its native repacker switched off); the port's qmm on CPU tensors within
NMSE 5e-5 of the float golden and of the JAX Pallas kernel in interpret
mode (tests/test_qmatmul.py's gate), and equal to the JAX XLA path; the
"cache" variant against the JAX strip-cached kernel in interpret mode.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from llama_cpp_test_tpu.gguf.constants import GGML_BLOCK_SIZES, GGMLType
from llama_cpp_test_tpu.ops import qmatmul
from llama_cpp_test_tpu.quant import codecs, repack
from llama_cpp_test_tpu_torch.gguf.constants import GGMLType as PGGMLType
from llama_cpp_test_tpu_torch.ops import qmatmul as pqmm
from llama_cpp_test_tpu_torch.quant import codecs as pcodecs
from llama_cpp_test_tpu_torch.quant import repack as prepack
from llama_cpp_test_tpu_torch.weights import qtensor_to_torch

N, K = 256, 512
QMM_GATE = 5e-5

QUANTIZED = [GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q2_K,
             GGMLType.Q3_K, GGMLType.Q5_K, GGMLType.IQ4_NL, GGMLType.IQ4_XS]
# byte offset of the fp16 scale field of each random-block type
RANDOM = {GGMLType.IQ2_XXS: 0, GGMLType.IQ2_XS: 0, GGMLType.IQ2_S: 0,
          GGMLType.IQ3_XXS: 0, GGMLType.IQ3_S: 0, GGMLType.IQ1_S: 0,
          GGMLType.IQ1_M: None, GGMLType.TQ1_0: 52, GGMLType.TQ2_0: 64}
NEW_TYPES = QUANTIZED + list(RANDOM)
ALL_TYPES = [GGMLType.Q8_0, GGMLType.Q4_0, GGMLType.Q4_K,
             GGMLType.Q6_K] + NEW_TYPES


def nmse(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(((a - b) ** 2).mean() / ((a * a).mean() + 1e-12))


def random_blocks(qtype, n, k, seed):
    """Random block bytes with the fp16 scale d drawn from [1e-3, 3e-3]
    (IQ1_M keeps d in the top nibbles of its four scale words)."""
    rng = np.random.default_rng(seed)
    blk, nbytes = GGML_BLOCK_SIZES[qtype]
    nb = n * k // blk
    raw = rng.integers(0, 256, size=(nb, nbytes), dtype=np.uint8)
    d = rng.uniform(1e-3, 3e-3, nb).astype(np.float16)
    off = RANDOM[qtype]
    if off is None:
        bits = d.view(np.uint16)
        sc = raw[:, 48:56].copy().view(np.uint16).reshape(nb, 4) & 0x0FFF
        for i in range(4):
            sc[:, i] |= ((bits >> (4 * i)) & 0xF) << 12
        raw[:, 48:56] = sc.view(np.uint8).reshape(nb, 8)
    else:
        raw[:, off:off + 2] = d.view(np.uint8).reshape(nb, 2)
    return raw.reshape(n, -1)


def raw_of(qtype, n=N, k=K, seed=0):
    if qtype in RANDOM:
        return random_blocks(qtype, n, k, seed)
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, k), dtype=np.float32) * 0.3
    return codecs.quantize(w, qtype)


@pytest.fixture
def numpy_repack(monkeypatch):
    """The JAX numpy repack path, the one the port copies."""
    monkeypatch.setattr(repack, "USE_NATIVE", False)


def make(qtype, layout="t", n=N, k=K, seed=0):
    raw = raw_of(qtype, n, k, seed)
    jqt = repack.repack(raw, qtype, n, k, layout=layout)
    pqt = prepack.repack(raw, PGGMLType(int(qtype)), n, k, layout=layout)
    return jqt, pqt


def plane_bits(a):
    a = np.asarray(a)
    if a.dtype.itemsize == 2 and a.dtype.kind not in "iu":
        return a.view(np.uint16)
    return a


@pytest.mark.parametrize("qtype", NEW_TYPES, ids=lambda t: t.name)
def test_codecs_decode_bit_for_bit(qtype):
    raw = raw_of(qtype, seed=3)
    ref = codecs.dequantize(raw, qtype)
    got = pcodecs.dequantize(raw, PGGMLType(int(qtype)))
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("layout", ["t", "rows"])
@pytest.mark.parametrize("qtype", ALL_TYPES, ids=lambda t: t.name)
def test_repack_planes_match_reference(numpy_repack, qtype, layout):
    jqt, pqt = make(qtype, layout)
    assert (pqt.kind, tuple(pqt.shape), pqt.n_orig, pqt.group,
            pqt.layout) == (jqt.kind, tuple(jqt.shape), jqt.n_orig,
                            jqt.group, jqt.layout)
    for name in ("qs", "scale", "min_", "lut"):
        a, b = getattr(jqt, name), getattr(pqt, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert np.asarray(b).dtype == plane_bits(a).dtype, name
            np.testing.assert_array_equal(plane_bits(a), plane_bits(b),
                                          err_msg=name)
    np.testing.assert_array_equal(repack.dequantize_qtensor_np(jqt),
                                  prepack.dequantize_qtensor_np(pqt))


@pytest.mark.parametrize("m", [1, 17])
@pytest.mark.parametrize("qtype", [GGMLType.Q2_K, GGMLType.IQ4_XS,
                                   GGMLType.IQ2_XXS, GGMLType.IQ1_S,
                                   GGMLType.TQ2_0], ids=lambda t: t.name)
def test_qmm_matches_golden_and_pallas(numpy_repack, qtype, m):
    jqt, pqt = make(qtype)
    assert pqt.kind in ("u2", "u4lut", "u2lut")
    x = np.random.default_rng(2).standard_normal((m, K), dtype=np.float32)
    golden = x @ repack.dequantize_qtensor_np(jqt).T
    tq = qtensor_to_torch(pqt, "cpu")
    assert tq.lut is None or tq.lut.dtype == torch.float32
    y_port = pqmm.qmm(torch.from_numpy(x), tq).numpy()
    assert y_port.shape == (m, N)
    assert nmse(golden, y_port) < QMM_GATE, nmse(golden, y_port)
    y_pallas = np.asarray(qmatmul.qmm(jnp.asarray(x), jqt, interpret=True))
    assert nmse(y_pallas, y_port) < QMM_GATE, nmse(y_pallas, y_port)
    y_xla = np.asarray(qmatmul.qmm_xla(jnp.asarray(x), jqt))
    assert nmse(y_xla, y_port) < 1e-9, nmse(y_xla, y_port)


@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q2_K,
                                   GGMLType.IQ4_XS], ids=lambda t: t.name)
def test_cache_variant_matches_reference(numpy_repack, qtype):
    """variant="cache" at m = 520 (several row tiles): the JAX strip-cached
    kernel in interpret mode and the port agree, both near the golden."""
    jqt, pqt = make(qtype)
    x = np.random.default_rng(7).standard_normal((520, K), dtype=np.float32)
    golden = x @ repack.dequantize_qtensor_np(jqt).T
    ref = np.asarray(qmatmul.qmm(jnp.asarray(x), jqt, interpret=True,
                                 variant="cache"))
    got = pqmm.qmm(torch.from_numpy(x), qtensor_to_torch(pqt, "cpu"),
                   variant="cache").numpy()
    assert got.shape == ref.shape == (520, N)
    assert nmse(golden, ref) < QMM_GATE
    assert nmse(golden, got) < QMM_GATE, nmse(golden, got)
    assert nmse(ref, got) < QMM_GATE, nmse(ref, got)


@pytest.mark.parametrize("m,k,group,has_min,want", [
    (512, 4096, 16, True, True),      # 8B gate|up, Q2_K: K/16 = 256 groups
    (512, 4096, 32, False, True),     # IQ4_XS / IQ1_S
    (130, 4096, 32, True, True),      # padded to 256 rows: two 128-row tiles
    (64, 4096, 32, False, False),     # one row tile: nothing to reuse
    (8, 4096, 32, False, False),      # decode
    (512, 14336, 32, False, False),   # ffn_down: the strip would not fit
    (512, 8192, 32, False, False),    # 70B widths
    (512, 2304, 32, False, False),    # K % 512 != 0
    (512, 2048, 32, True, False),     # (K / group) % 128 != 0 with a min
    (512, 2048, 32, False, True),
])
def test_cache_route_keeps_reference_conditions(m, k, group, has_min, want):
    assert pqmm.cache_route(m, k, group, has_min) is want


def test_unknown_variant_raises(monkeypatch):
    _, pqt = make(GGMLType.Q4_K)
    x = torch.zeros((2, K))
    tq = qtensor_to_torch(pqt, "cpu")
    with pytest.raises(ValueError, match="variant"):
        pqmm.qmm(x, tq, variant="tiles")
    for v in pqmm.VARIANTS:
        assert pqmm.qmm(x, tq, variant=v).shape == (2, N)
    monkeypatch.setattr(pqmm, "QMM_VARIANT", "bogus")
    with pytest.raises(ValueError, match="variant"):
        pqmm.qmm(x, tq)


@pytest.mark.parametrize("qtype", [GGMLType.Q2_K, GGMLType.IQ4_XS,
                                   GGMLType.IQ1_S], ids=lambda t: t.name)
def test_qgather_lut_and_crumb_rows(numpy_repack, qtype):
    """A rows-layout Q2_K, IQ4_XS or IQ1_S table (the token embedding of the
    low-bit files) gathers the reference's rows."""
    jqt, pqt = make(qtype, layout="rows")
    ids = np.asarray([0, 3, 255, 17, 128], np.int32)
    ref = np.asarray(qmatmul.qgather(jnp.asarray(ids), jqt, dtype=jnp.float32))
    got = pqmm.qgather(torch.from_numpy(ids), qtensor_to_torch(pqt, "cpu"),
                       dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
