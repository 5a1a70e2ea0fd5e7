"""Port conformance of the GGUF decode, plane repack and dequant-matmul
(llama_cpp_test_tpu_torch quant/ + ops/qmatmul) against the JAX package.

The same numpy-made weights and activations go through the JAX repack and
qmm (Pallas kernel in interpret mode, and the XLA path) and through the
port's repack and qmm on CPU tensors (the plain version of kernel K1).
Gates are the JAX suite's: NMSE < 5e-5 against the float golden
(tests/test_qmatmul.py:66,86).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from llama_cpp_test_tpu.gguf.constants import GGMLType
from llama_cpp_test_tpu.ops import qmatmul
from llama_cpp_test_tpu.quant import codecs, repack
from llama_cpp_test_tpu_torch.gguf.constants import GGMLType as PGGMLType
from llama_cpp_test_tpu_torch.ops import qmatmul as pqmm
from llama_cpp_test_tpu_torch.quant import codecs as pcodecs
from llama_cpp_test_tpu_torch.quant import repack as prepack
from llama_cpp_test_tpu_torch.weights import qtensor_to_torch

TYPES = [GGMLType.Q8_0, GGMLType.Q4_0, GGMLType.Q4_K, GGMLType.Q6_K]
N, K = 256, 512
QMM_GATE = 5e-5


def nmse(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(((a - b) ** 2).mean() / ((a * a).mean() + 1e-12))


def make(qtype, n=N, k=K, seed=0, layout="t"):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, k), dtype=np.float32) * 0.3
    raw = codecs.quantize(w, qtype)
    jqt = repack.repack(raw, qtype, n, k, layout=layout)
    pqt = prepack.repack(raw, PGGMLType(int(qtype)), n, k, layout=layout)
    return jqt, pqt, raw


def plane_bits(a):
    """A plane as comparable integers (bf16 planes as their uint16 bits)."""
    a = np.asarray(a)
    if a.dtype.itemsize == 2 and a.dtype.kind not in "iu":
        return a.view(np.uint16)
    return a


def assert_same_planes(jqt, pqt):
    assert (pqt.kind, tuple(pqt.shape), pqt.n_orig, pqt.group, pqt.layout,
            pqt.parts) == (jqt.kind, tuple(jqt.shape), jqt.n_orig, jqt.group,
                           jqt.layout, jqt.parts)
    for name in ("qs", "scale", "min_"):
        a, b = getattr(jqt, name), getattr(pqt, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(plane_bits(a), plane_bits(b),
                                          err_msg=name)


@pytest.mark.parametrize("layout", ["t", "rows"])
@pytest.mark.parametrize("qtype", TYPES, ids=lambda t: t.name)
def test_repack_planes_match_reference(qtype, layout):
    jqt, pqt, raw = make(qtype, layout=layout)
    assert_same_planes(jqt, pqt)
    np.testing.assert_array_equal(repack.dequantize_qtensor_np(jqt),
                                  prepack.dequantize_qtensor_np(pqt))
    # the port's block decoder is the reference's, bit for bit
    np.testing.assert_array_equal(codecs.dequantize(raw, qtype),
                                  pcodecs.dequantize(raw, PGGMLType(int(qtype))))


@pytest.mark.parametrize("m", [1, 64])
@pytest.mark.parametrize("qtype", TYPES, ids=lambda t: t.name)
def test_qmm_matches_golden_and_pallas(qtype, m):
    jqt, pqt, _ = make(qtype)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((m, K), dtype=np.float32)
    golden = x @ repack.dequantize_qtensor_np(jqt).T
    y_port = pqmm.qmm(torch.from_numpy(x), qtensor_to_torch(pqt, "cpu")).numpy()
    assert y_port.shape == (m, N)
    assert nmse(golden, y_port) < QMM_GATE, nmse(golden, y_port)
    y_pallas = np.asarray(qmatmul.qmm(jnp.asarray(x), jqt, interpret=True))
    assert nmse(golden, y_pallas) < QMM_GATE
    # the plain version follows the XLA path: same bf16 weights, f32 sums
    y_xla = np.asarray(qmatmul.qmm_xla(jnp.asarray(x), jqt))
    assert nmse(y_xla, y_port) < 1e-9, nmse(y_xla, y_port)


@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q8_0],
                         ids=lambda t: t.name)
def test_fused_split_column_order(qtype):
    """fuse_qtensors + qmm_split == separate qmm on each constituent, and
    the fused planes equal the reference's (test_qmatmul.py:90)."""
    jparts, pparts = [], []
    for i, n_i in enumerate((256, 128, 128)):
        jqt, pqt, _ = make(qtype, n=n_i, seed=10 + i)
        jparts.append(jqt)
        pparts.append(pqt)
    jf, pf = repack.fuse_qtensors(jparts), prepack.fuse_qtensors(pparts)
    assert_same_planes(jf, pf)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, K), dtype=np.float32)
    outs = pqmm.qmm_split(torch.from_numpy(x), qtensor_to_torch(pf, "cpu"))
    plain = pqmm.qmm_split_plain(torch.from_numpy(x), qtensor_to_torch(pf, "cpu"))
    ref = qmatmul.qmm_split(jnp.asarray(x), jf, use_pallas=False)
    assert len(outs) == 3
    for pqt, y, yp, yr in zip(pparts, outs, plain, ref):
        one = pqmm.qmm(torch.from_numpy(x), qtensor_to_torch(pqt, "cpu"))
        assert y.shape == one.shape == (3, pqt.n_orig)
        assert nmse(one.numpy(), y.numpy()) < 1e-9
        assert nmse(yp.numpy(), y.numpy()) < 1e-9
        assert nmse(np.asarray(yr), y.numpy()) < 1e-9


@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q8_0, GGMLType.Q6_K],
                         ids=lambda t: t.name)
def test_qgather_rows_layout(qtype):
    jqt, pqt, _ = make(qtype, layout="rows")
    ids = np.asarray([0, 3, 255, 17, 128], np.int32)
    ref = np.asarray(qmatmul.qgather(jnp.asarray(ids), jqt, dtype=jnp.float32))
    got = pqmm.qgather(torch.from_numpy(ids), qtensor_to_torch(pqt, "cpu"),
                       dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    golden = repack.dequantize_qtensor_np(jqt)[ids]
    assert nmse(golden, got) < 1e-9


def test_cuda_only_kinds_raise():
    """K1 and K5 take every plane kind now; K4 still covers int8 and u4
    expert planes only, so its CUDA path must raise for u2/LUT planes, never
    fall back (checked without a card through the plane-kind guard)."""
    from llama_cpp_test_tpu_torch.ops import gmm as pgmm

    rt = pgmm.Routing(*(torch.zeros(1, dtype=torch.int32) for _ in range(4)))
    for kind in ("u2", "u4lut", "u2lut"):
        pack = prepack.PACK[kind]
        qt = prepack.QTensor(kind, (256, 512), 256, 32,
                             np.zeros((2, 512, 256 // pack), np.uint8))
        with pytest.raises(NotImplementedError):
            pgmm._planes_cuda(torch.zeros((8, 512), dtype=torch.bfloat16),
                              qt, rt, pgmm.TILE_GEMV)
