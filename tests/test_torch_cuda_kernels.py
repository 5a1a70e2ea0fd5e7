"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Marked `cuda`; every test skips where torch sees no CUDA device (decided
in the `cuda` fixture, never at import). On a machine with a card, and
without JAX, run from the repository root:

    python -m pytest tests/test_torch_cuda_kernels.py -q --noconftest

Covers kernel paths that the serving path of chip_smoke.py does not reach:
all four GGML types of K1 at several row counts, K1 on the u2, u4lut and
u2lut kinds (groups 16, 32 and 256), K1's GEMM at M 9-512 (its one- and
two-warpgroup tiles, ragged rows) and K up to 14336 with npk 640/pack
(a ragged 256-column tile for int8), its refusals, K5 on every kind (and
against K1 at M 130-512, K 512 and 4096), K2 at G in {1, 2, 4, 8, 71}
(71: Falcon-7B), D in {64, 80, 96, 100, 128, 192, 256} and BS in {8, 16, 64}
with a sliding window, softcap and a cached prefix, windowed decode on the
gather path, K3 (bf16 and q8 pages) at G in {1, 2, 4, 8, 71} and D in
{64, 80, 96, 100, 128, 192, 256} with softcap and very short caches, and with a
sequence's pages split across blocks (~4000 cached tokens at B = 1, at
Phi-2's and BitNet-3B's geometry too, 4608 at Gemma-2's, one long
sequence beside ones shorter than a split, BitNet-3B's D = 100 at B = 8),
K2 and K3 refusing other head dims, K4 on
every plane kind (the four GGML types above, Q2_K u2 with a min, IQ4_XS
and IQ2_XS u4lut, IQ1_S u2lut, TQ2_0 u2lut at group 256, and dense BF16
stacks) with ragged expert loads, one-expert batches, dead tiles and K not
a multiple of 2048, K4's GEMM against K1's on one expert and against the
plain fold (its exact min fold), its zeros past a tile's live rows over
an output full of NaN, its refusal of a min at group 128, the decode GEMV
of K1 and K4 (qmm_gemv.cuh) at K 5632 and 14336 for every row count 1-8
and plane kind, at groups its tensor-core path does not take (8, 24,
40), bit-equal on a second call, and K4's GEMV writing the zeros of dead
tiles and pad rows into an output full of NaN, and the five probe kernels
of the port's tools (the probe GEMV of csrc/probe_gemv.cuh in every format
and at each pairs block width, at the probes' shapes, at a K that is not a
multiple of the stage rows and at the smallest N each wrapper takes;
bit-equal on a second call; one kernel and no memset a call; the byte
stream integer-exact).
Gates are the JAX suites': qmm NMSE < 5e-5 against the float golden,
attention and gmm NMSE < 2e-4, the probes NMSE < 1e-5 against their plain
versions.
"""
import dataclasses

import numpy as np
import pytest
import torch

from llama_cpp_test_tpu_torch.gguf.constants import GGML_BLOCK_SIZES, GGMLType
from llama_cpp_test_tpu_torch.ops import _cuda
from llama_cpp_test_tpu_torch.ops import flash_prefill as fp
from llama_cpp_test_tpu_torch.ops import gmm
from llama_cpp_test_tpu_torch.ops import paged_attention as pa
from llama_cpp_test_tpu_torch.ops import qmatmul
from llama_cpp_test_tpu_torch.quant import repack
from llama_cpp_test_tpu_torch.runtime import kv_cache
from llama_cpp_test_tpu_torch import tools
from llama_cpp_test_tpu_torch.tools import kbench, pairprobe
from llama_cpp_test_tpu_torch.weights import qtensor_to_torch

pytestmark = pytest.mark.cuda

# fp16 scale fields of each block type: (byte offset, low, high)
_SCALES = {GGMLType.Q8_0: [(0, 1e-3, 3e-3)],
           GGMLType.Q4_0: [(0, 1e-2, 3e-2)],
           GGMLType.Q4_K: [(0, 1e-4, 3e-4), (2, 7e-4, 2e-3)],
           GGMLType.Q6_K: [(208, 2e-4, 6e-4)]}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def nmse(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(((a - b) ** 2).mean() / ((a * a).mean() + 1e-30))


# the low-bit kinds: Q2_K u2 with a min (group 16), IQ4_XS u4lut (32),
# IQ2_XS u4lut (16), IQ1_S u2lut (32), TQ2_0 u2lut (256)
_LOWBIT = {GGMLType.Q2_K: [(80, 1e-3, 3e-3), (82, 1e-3, 3e-3)],
           GGMLType.IQ4_XS: [(0, 1e-4, 3e-4)],
           GGMLType.IQ2_XS: [(0, 1e-3, 3e-3)],
           GGMLType.IQ1_S: [(0, 1e-3, 3e-3)],
           GGMLType.TQ2_0: [(64, 1e-3, 3e-3)]}


# Q4_1: u4 with a min at group 32, so K need not make K / group a
# multiple of 8 (K-quant blocks always do)
_LEGACY_MIN = {GGMLType.Q4_1: [(0, 1e-3, 3e-3), (2, 1e-3, 3e-3)]}


def random_qtensor(ggml_type, n, k, seed):
    rng = np.random.default_rng(seed)
    if ggml_type == GGMLType.BF16:       # dense planes from normal weights
        w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
        raw = repack.f32_to_bf16_bits(w).view(np.uint8)
        return repack.repack(raw.reshape(-1), ggml_type, n, k)
    blk, nbytes = GGML_BLOCK_SIZES[ggml_type]
    nb = n * k // blk
    raw = rng.integers(0, 256, size=(nb, nbytes), dtype=np.uint8)
    for off, lo, hi in {**_SCALES, **_LOWBIT, **_LEGACY_MIN}[ggml_type]:
        d = rng.uniform(lo, hi, nb).astype(np.float16)
        raw[:, off:off + 2] = d.view(np.uint8).reshape(nb, 2)
    return repack.repack(raw.reshape(-1), ggml_type, n, k)


# K1 row counts: the GEMV's 1-8 rows, then the GEMM's one-warpgroup tiles
# (9-64 rows; 9 and 16 ragged), its two-warpgroup tiles (100-512 rows;
# 130 and 300 ragged), at K = 1024 (16 pipeline steps, N = 768)
_K1_M = (9, 16, 64, 100, 130, 300, 512)
# deeper K at a 640-column output (npk 640/pack: an odd number of 128-wide
# plane blocks): K = 5632 (TinyLlama's ffn_down) and 14336 (Llama-3-8B's)
_K1_DEEP = ((300, 5632, 640), (512, 14336, 640))


def _k1_name(m):
    return "qmm_gemv" if m <= 8 else "qmm_gemm"


@pytest.mark.parametrize("m,k,n", [(m, 1024, 768) for m in (1, 2, 5, 8)]
                         + [(m, 1024, 768) for m in _K1_M] + list(_K1_DEEP),
                         ids=lambda v: str(v))
@pytest.mark.parametrize("ggml_type", list(_SCALES), ids=lambda t: t.name)
def test_qmm_kernel_matches_golden(cuda, ggml_type, m, k, n):
    qt = random_qtensor(ggml_type, n, k, seed=m)
    golden_w = repack.dequantize_qtensor_np(qt)            # [n, k] float32
    x = np.random.default_rng(7).standard_normal((m, k)).astype(np.float32)
    xb = torch.from_numpy(x).to(cuda).to(torch.bfloat16)
    golden = xb.float().cpu().numpy() @ golden_w.T
    before = _cuda.LAUNCHES[_k1_name(m)]
    got = qmatmul.qmm(xb, qtensor_to_torch(qt, cuda)).cpu().numpy()
    assert _cuda.LAUNCHES[_k1_name(m)] == before + 1
    assert got.shape == (m, n)
    assert nmse(golden, got) < 5e-5, nmse(golden, got)


def _golden_case(ggml_type, n, k, m, seed, cuda):
    qt = random_qtensor(ggml_type, n, k, seed=seed)
    x = np.random.default_rng(seed + 1).standard_normal((m, k)).astype(np.float32)
    xb = torch.from_numpy(x).to(cuda).to(torch.bfloat16)
    golden = xb.float().cpu().numpy() @ repack.dequantize_qtensor_np(qt).T
    return qt, xb, golden


@pytest.mark.parametrize("m,k,n", [(m, 1024, 768) for m in (1, 3, 8, 17)]
                         + [(m, 1024, 768) for m in _K1_M if m != 512]
                         + [(512, 1024, 768)] + list(_K1_DEEP),
                         ids=lambda v: str(v))
@pytest.mark.parametrize("ggml_type", list(_LOWBIT), ids=lambda t: t.name)
def test_qmm_lowbit_kinds_match_golden(cuda, ggml_type, m, k, n):
    qt, xb, golden = _golden_case(ggml_type, n, k, m, m, cuda)
    assert qt.kind in ("u2", "u4lut", "u2lut")
    name = _k1_name(m)
    before = _cuda.LAUNCHES[name]
    got = qmatmul.qmm(xb, qtensor_to_torch(qt, cuda)).cpu().numpy()
    assert _cuda.LAUNCHES[name] == before + 1
    assert got.shape == (m, n)
    assert nmse(golden, got) < 5e-5, nmse(golden, got)


@pytest.mark.parametrize("m", [130, 512])
@pytest.mark.parametrize("ggml_type", [GGMLType.Q4_K, GGMLType.Q8_0,
                                       GGMLType.Q6_K, *_LOWBIT],
                         ids=lambda t: t.name)
def test_qmm_cache_kernel_matches_plain(cuda, ggml_type, m):
    """K5 (variant "cache") on every plane kind at K = 4096: against the
    float golden, the plain version and K1's GEMM on the same inputs."""
    n, k = 768, 4096
    qt, xb, golden = _golden_case(ggml_type, n, k, m, 40 + m, cuda)
    tq = qtensor_to_torch(qt, cuda)
    assert qmatmul.cache_route(m, k, qt.group, qt.min_ is not None)
    before = dict(_cuda.LAUNCHES)
    got = qmatmul.qmm(xb, tq, variant="cache").cpu().numpy()
    assert _cuda.LAUNCHES["qmm_cache"] == before["qmm_cache"] + 1
    assert _cuda.LAUNCHES["qmm_gemm"] == before["qmm_gemm"]
    assert got.shape == (m, n) and np.isfinite(got).all()
    assert nmse(golden, got) < 5e-5, nmse(golden, got)
    plain = qmatmul.qmm_plain(xb, tq).cpu().numpy()
    assert nmse(plain, got) < 5e-5, nmse(plain, got)
    k1 = qmatmul.qmm(xb, tq, variant="f32").cpu().numpy()
    assert nmse(k1, got) < 1e-8, nmse(k1, got)


@pytest.mark.parametrize("k", [512, 4096])
@pytest.mark.parametrize("m", [130, 256, 512])
@pytest.mark.parametrize("ggml_type", [GGMLType.Q4_K, GGMLType.Q2_K,
                                       GGMLType.IQ4_XS, GGMLType.IQ1_S],
                         ids=lambda t: t.name)
def test_qmm_cache_kernel_matches_k1(cuda, ggml_type, m, k):
    """K5 launched directly (the cache route takes K = 512 only without a
    min) on the kinds with a min (u4, u2) and both LUT kinds, at M where
    one 256-row tile holds every row and where two do: against the float
    golden and against K1's GEMM on the same inputs."""
    qt, xb, golden = _golden_case(ggml_type, 768, k, m, 60 + m + k, cuda)
    tq = qtensor_to_torch(qt, cuda)
    before = _cuda.LAUNCHES["qmm_cache"]
    got = qmatmul._qmm_cache_cuda(xb, tq).reshape(m, -1)[:, :768]
    assert _cuda.LAUNCHES["qmm_cache"] == before + 1
    got = got.cpu().numpy()
    assert np.isfinite(got).all()
    assert nmse(golden, got) < 5e-5, nmse(golden, got)
    k1 = qmatmul.qmm(xb, tq, variant="f32").cpu().numpy()
    assert nmse(k1, got) < 1e-8, nmse(k1, got)


def test_qmm_cache_raises_on_operands_it_does_not_take(cuda):
    """K5 refuses K > 4096 and K not a multiple of 128, in the wrapper and
    in the C entry point, and never falls back."""
    qt = qtensor_to_torch(random_qtensor(GGMLType.Q4_K, 256, 8192, 1), cuda)
    x = _bf16(np.ones((300, 8192)), cuda)
    before = _cuda.LAUNCHES["qmm_cache"]
    with pytest.raises(ValueError, match="K <= 4096"):
        qmatmul._qmm_cache_cuda(x, qt)
    assert _cuda.LAUNCHES["qmm_cache"] == before
    out = torch.empty((300, 2, qt.npk), dtype=torch.float32, device=cuda)
    fn = _cuda.bind("qmm_cache", "qmm_cache", "piipiipppipp")
    for k in (8192, 4064):
        rc = fn(x.data_ptr(), 300, k, qt.qs.data_ptr(), qt.npk, 1,
                qt.scale.data_ptr(), qt.min_.data_ptr(), 0, qt.group,
                out.data_ptr(), _cuda.stream_ptr(cuda))
        assert rc != 0, (k, rc)
    torch.cuda.synchronize()


def test_qmm_cache_route_falls_to_k1(cuda):
    """Shapes outside the reference's cache conditions take K1's GEMM."""
    qt, xb, _ = _golden_case(GGMLType.Q4_K, 768, 2048, 512, 9, cuda)
    before = dict(_cuda.LAUNCHES)
    qmatmul.qmm(xb, qtensor_to_torch(qt, cuda), variant="cache")
    assert _cuda.LAUNCHES["qmm_cache"] == before["qmm_cache"]
    assert _cuda.LAUNCHES["qmm_gemm"] == before["qmm_gemm"] + 1


@pytest.mark.parametrize("m", [3, 512])
def test_qmm_split_kernel_column_order(cuda, m):
    parts = [random_qtensor(GGMLType.Q4_K, n_i, 1024, seed=i)
             for i, n_i in enumerate((512, 256, 256))]
    fused = qtensor_to_torch(repack.fuse_qtensors(parts), cuda)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (m, 1024)).astype(np.float32)).to(cuda).to(torch.bfloat16)
    before = _cuda.LAUNCHES[_k1_name(m)]
    outs = qmatmul.qmm_split(x, fused)
    assert _cuda.LAUNCHES[_k1_name(m)] == before + 1
    plain = qmatmul.qmm_split_plain(x, fused)
    for qt, y, yp in zip(parts, outs, plain):
        one = qmatmul.qmm(x, qtensor_to_torch(qt, cuda))
        assert y.shape == one.shape == (m, qt.n_orig)
        assert nmse(one.cpu(), y.cpu()) < 1e-12
        assert nmse(yp.cpu(), y.cpu()) < 5e-5


def test_qmm_gemm_raises_on_operands_it_does_not_take(cuda):
    """K1's GEMM refuses what it has no tile for, in the wrapper and in the
    C entry point, and never falls back: a min at group 128 (the fold takes
    whole groups of one 64-deep K step), a LUT kind without its LUT, and in
    the C entry point group 4 (not a multiple of 8) and K = 500 (not a
    multiple of 32)."""
    qt = qtensor_to_torch(random_qtensor(GGMLType.Q4_K, 256, 512, 1), cuda)
    x = _bf16(np.ones((16, 512)), cuda)
    before = _cuda.LAUNCHES["qmm_gemm"]
    g128 = dataclasses.replace(qt, group=128,
                               scale=qt.scale[:, ::4].contiguous(),
                               min_=qt.min_[:, ::4].contiguous())
    with pytest.raises(ValueError, match="group 128"):
        qmatmul.qmm(x, g128)
    iq = qtensor_to_torch(random_qtensor(GGMLType.IQ4_XS, 256, 512, 2), cuda)
    with pytest.raises(ValueError, match="LUT"):
        qmatmul.qmm(x, dataclasses.replace(iq, lut=None))
    assert _cuda.LAUNCHES["qmm_gemm"] == before
    out = torch.empty((16, 2, qt.npk), dtype=torch.float32, device=cuda)
    fn = _cuda.bind("qmm", "qmm_gemm", "piipiipppipp")
    scale_g4 = torch.zeros((2, 512 // 4, qt.npk), dtype=torch.bfloat16,
                          device=cuda)
    for group, scale in ((4, scale_g4), (qt.group, qt.scale)):
        rc = fn(x.data_ptr(), 16, 512 if group == 4 else 500,
                qt.qs.data_ptr(), qt.npk, 1, scale.data_ptr(), 0, 0, group,
                out.data_ptr(), _cuda.stream_ptr(cuda))
        assert rc != 0, (group, rc)
    torch.cuda.synchronize()


def _bf16(a, dev):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dev).to(torch.bfloat16)


def _i32(a, dev):
    return torch.from_numpy(np.asarray(a, np.int32)).to(dev)


@pytest.mark.parametrize("bs", [8, 16, 64])
@pytest.mark.parametrize("h,kv,d", [(8, 2, 64), (4, 4, 64), (32, 4, 64),
                                    (32, 8, 128), (8, 4, 256), (4, 1, 256),
                                    (4, 4, 80), (8, 2, 96), (71, 1, 64),
                                    (4, 4, 100), (8, 2, 100), (16, 16, 192),
                                    (8, 2, 192)],
                         ids=["G4", "G1", "G8", "G4-D128", "G2-D256",
                              "G4-D256", "G1-D80", "G4-D96", "G71",
                              "G1-D100", "G4-D100", "G1-D192", "G4-D192"])
@pytest.mark.parametrize("window,cap,start", [(0, 0.0, 0), (5, 0.0, 0),
                                              (0, 30.0, 0), (7, 50.0, 40)])
def test_flash_prefill_kernel_matches_plain(cuda, h, kv, d, window, cap, start,
                                            bs):
    rng = np.random.default_rng(h + d + window)
    b, t = 2, 37
    lens = [start + t, start + t - 5]
    nbmax = -(-max(lens) // bs)
    nb = 2 * nbmax + 3
    q = _bf16(rng.standard_normal((b, t, h, d)) * 0.2, cuda)
    kp = _bf16(rng.standard_normal((kv, nb, bs, d)), cuda)
    vp = _bf16(rng.standard_normal((kv, nb, bs, d)), cuda)
    table = _i32(rng.permutation(nb)[: b * nbmax].reshape(b, nbmax), cuda)
    pos = _i32(np.stack([np.maximum(np.arange(l - t, l), 0) for l in lens]), cuda)
    kvl = _i32(lens, cuda)
    before = _cuda.LAUNCHES["flash_prefill"]
    got = fp.flash_prefill(q, kp, vp, pos, kvl, table, window=window,
                           soft_cap=cap)
    assert _cuda.LAUNCHES["flash_prefill"] == before + 1
    ref = fp.flash_prefill_plain(q, kp, vp, pos, kvl, table, window=window,
                                 soft_cap=cap)
    assert nmse(ref.float().cpu(), got.float().cpu()) < 2e-4


@pytest.mark.parametrize("t,start", [(512, 0), (100, 300)])
def test_flash_prefill_kernel_tinyllama(cuda, t, start):
    """TinyLlama's layout (H 32, KV 4, D 64: G = 8) at the smoke's shapes:
    a 512-token prefill (8 key tiles, every diagonal tile masked) and a
    100-token chunk after 300 cached tokens, pages in random order."""
    rng = np.random.default_rng(t)
    h, kv, d, bs = 32, 4, 64, 16
    n = start + t
    nbmax = -(-n // bs)
    nb = nbmax + 4
    q = _bf16(rng.standard_normal((1, t, h, d)) / 8, cuda)
    kp = _bf16(rng.standard_normal((kv, nb, bs, d)) * 0.5, cuda)
    vp = _bf16(rng.standard_normal((kv, nb, bs, d)) * 0.5, cuda)
    table = _i32(rng.permutation(nb)[:nbmax].reshape(1, nbmax), cuda)
    pos = _i32(np.arange(start, n)[None], cuda)
    kvl = _i32([n], cuda)
    got = fp.flash_prefill(q, kp, vp, pos, kvl, table)
    ref = fp.flash_prefill_plain(q, kp, vp, pos, kvl, table)
    assert nmse(ref.float().cpu(), got.float().cpu()) < 2e-4


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8_0"])
def test_windowed_decode_takes_the_gather_path(cuda, q8):
    """A sliding-window decode on CUDA returns the gather path's result, as
    the reference sends any window to its gather: the same as the CPU plain
    path on the same pools, with no K3 launch."""
    rng = np.random.default_rng(21)
    b, kv, g, d, bs, nbmax = 3, 2, 4, 64, 16, 6
    nb = b * nbmax + 2
    qn = rng.standard_normal((b, 1, kv * g, d)) * 0.3
    kn = rng.standard_normal((kv, nb, bs, d))
    vn = rng.standard_normal((kv, nb, bs, d))
    table = rng.permutation(nb)[: b * nbmax].reshape(b, nbmax)
    lens = [70, 9, 96]
    outs = []
    for dev in ("cpu", cuda):
        q, kp, vp = _bf16(qn, dev), _bf16(kn, dev), _bf16(vn, dev)
        tab, kvl = _i32(table, dev), _i32(lens, dev)
        before = dict(_cuda.LAUNCHES)
        if q8:
            (kq, ks), (vq, vs) = kv_cache.quantize_q8(kp), kv_cache.quantize_q8(vp)
            out = kv_cache.attend_decode_q8(q, kq, ks, vq, vs, tab, kvl, 0.125,
                                            window=20)
        else:
            out = kv_cache.attend_decode(q, kp, vp, tab, kvl, 0.125, window=20)
        assert _cuda.LAUNCHES == before
        assert out.shape == (b, 1, kv * g, d)
        outs.append(out.float().cpu())
    # float32 attention on both devices; only the order of sums and the
    # bf16 output rounding differ
    assert nmse(outs[0], outs[1]) < 1e-6, nmse(outs[0], outs[1])


@pytest.mark.parametrize("g,kv,d", [(1, 4, 64), (4, 2, 64), (8, 4, 64),
                                    (4, 8, 128), (8, 2, 128), (16, 2, 64),
                                    (20, 2, 64), (40, 1, 128), (2, 4, 256),
                                    (4, 1, 256), (1, 4, 80), (1, 4, 96),
                                    (4, 2, 96), (71, 1, 64), (1, 4, 100),
                                    (4, 2, 100), (20, 1, 100), (1, 16, 192),
                                    (4, 2, 192)])
@pytest.mark.parametrize("cap,short", [(None, False), (30.0, False),
                                       (None, True)], ids=["plain", "softcap",
                                                           "short"])
def test_paged_decode_kernel_matches_plain(cuda, g, kv, d, cap, short):
    rng = np.random.default_rng(g * kv + d)
    b, bs, nbmax = 5, 16, 12
    nb = b * nbmax + 2
    q = _bf16(rng.standard_normal((b, kv * g, d)) * 0.3, cuda)
    kp = _bf16(rng.standard_normal((kv, nb, bs, d)) * 0.3, cuda)
    vp = _bf16(rng.standard_normal((kv, nb, bs, d)) * 0.3, cuda)
    table = _i32(rng.permutation(nb)[: b * nbmax].reshape(b, nbmax), cuda)
    lens = [1, 2, 17, 3, 9] if short else \
        rng.integers(1, nbmax * bs + 1, size=b).tolist()
    lens_t = _i32(lens, cuda)
    got = pa.paged_attention_decode(q, kp, vp, lens_t, table, soft_cap=cap)
    ref = pa.paged_attention_decode_plain(q, kp, vp, lens_t, table,
                                          soft_cap=cap)
    assert nmse(ref.float().cpu(), got.float().cpu()) < 2e-4


@pytest.mark.parametrize("g,kv,d", [(1, 4, 64), (4, 2, 64), (4, 8, 128),
                                    (20, 1, 128), (2, 4, 256), (4, 1, 256),
                                    (1, 4, 80), (1, 4, 96), (71, 1, 64),
                                    (1, 4, 100), (4, 2, 100), (1, 16, 192),
                                    (4, 2, 192)])
@pytest.mark.parametrize("cap,short", [(None, False), (30.0, False),
                                       (None, True)], ids=["plain", "softcap",
                                                           "short"])
def test_paged_decode_q8_kernel_matches_plain(cuda, g, kv, d, cap, short):
    rng = np.random.default_rng(g * kv + d + 1)
    b, bs, nbmax = 5, 16, 12
    nb = b * nbmax + 2
    q = _bf16(rng.standard_normal((b, kv * g, d)) * 0.3, cuda)
    kq, ks = kv_cache.quantize_q8(_bf16(rng.standard_normal((kv, nb, bs, d)), cuda))
    vq, vs = kv_cache.quantize_q8(_bf16(rng.standard_normal((kv, nb, bs, d)), cuda))
    table = _i32(rng.permutation(nb)[: b * nbmax].reshape(b, nbmax), cuda)
    lens = [1, 2, 17, 3, 9] if short else \
        rng.integers(1, nbmax * bs + 1, size=b).tolist()
    lens_t = _i32(lens, cuda)
    before = _cuda.LAUNCHES["paged_decode_q8"]
    got = pa.paged_attention_decode(q, kq, vq, lens_t, table, soft_cap=cap,
                                    k_scale=ks, v_scale=vs)
    assert _cuda.LAUNCHES["paged_decode_q8"] == before + 1
    ref = pa.paged_attention_decode_plain(q, kq, vq, lens_t, table,
                                          soft_cap=cap, k_scale=ks, v_scale=vs)
    assert nmse(ref.float().cpu(), got.float().cpu()) < 2e-4


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8_0"])
@pytest.mark.parametrize("b,lens,h,kv,d,nbmax", [
    (1, [4000], 32, 8, 128, 256), (1, [4000], 32, 4, 64, 256),
    (1, [70], 32, 4, 64, 64), (3, [1, 16, 37 * 16 + 5], 8, 2, 64, 40),
    (4, [37 * 16 + 5, 3, 16, 200], 32, 8, 128, 40),
    (1, [4608], 8, 4, 256, 320), (4, [37 * 16 + 5, 3, 16, 200], 4, 1, 256, 40),
    (1, [4000], 32, 32, 80, 256), (4, [37 * 16 + 5, 3, 16, 200], 32, 32, 96,
                                   40),
    (1, [4000], 32, 32, 100, 256),
    (8, [37 * 16 + 5, 3, 16, 200, 400, 1, 64, 333], 32, 32, 100, 40)],
    ids=["8B-B1-4000", "TinyLlama-B1-4000", "B1-short", "B3-1-BS-37BS+5",
         "B4-mixed-D128", "Gemma2-B1-4608", "Gemma3-B4-mixed",
         "Phi2-B1-4000", "Phi3-B4-mixed", "BitNet3B-B1-4000",
         "BitNet3B-B8-mixed"])
def test_paged_decode_kernel_splits_across_blocks(cuda, q8, b, lens, h, kv, d,
                                                  nbmax):
    """K3 and K3-q8 with each sequence's pages split across blocks: one
    sequence whose length spans many splits beside sequences shorter than
    one split (their later splits hold no key), and a single sequence of
    about 4000 tokens at 8B and TinyLlama geometry, against the plain
    version."""
    rng = np.random.default_rng(b * 100 + d + int(q8))
    bs = 16
    splits, pages = pa.split_plan(b, kv, nbmax, bs, torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    assert splits > 1 and splits * pages >= nbmax
    assert pages * bs < max(lens)          # the longest spans several
    nb = b * nbmax + 3
    q = _bf16(rng.standard_normal((b, h, d)) * 0.3, cuda)
    kp = _bf16(rng.standard_normal((kv, nb, bs, d)) * 0.5, cuda)
    vp = _bf16(rng.standard_normal((kv, nb, bs, d)) * 0.5, cuda)
    scales = {}
    if q8:
        (kp, ks), (vp, vs) = kv_cache.quantize_q8(kp), kv_cache.quantize_q8(vp)
        scales = {"k_scale": ks, "v_scale": vs}
    table = _i32(rng.permutation(nb)[: b * nbmax].reshape(b, nbmax), cuda)
    lens_t = _i32(lens, cuda)
    name = "paged_decode_q8" if q8 else "paged_decode"
    before = _cuda.LAUNCHES[name]
    got = pa.paged_attention_decode(q, kp, vp, lens_t, table, **scales)
    assert _cuda.LAUNCHES[name] == before + 1
    ref = pa.paged_attention_decode_plain(q, kp, vp, lens_t, table, **scales)
    assert torch.isfinite(got.float()).all()
    assert nmse(ref.float().cpu(), got.float().cpu()) < 2e-4
    # every sequence on its own, as a batch of one, gives the same rows
    for i in range(b):
        one = pa.paged_attention_decode(q[i:i + 1], kp, vp, lens_t[i:i + 1],
                                        table[i:i + 1], **scales)
        r1 = pa.paged_attention_decode_plain(q[i:i + 1], kp, vp,
                                             lens_t[i:i + 1], table[i:i + 1],
                                             **scales)
        assert nmse(r1.float().cpu(), one.float().cpu()) < 2e-4


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8_0"])
@pytest.mark.parametrize("bs", [1, 5, 8, 32, 64])
def test_paged_decode_kernel_any_page_size(cuda, q8, bs):
    """K3's 64-key tiles cross pages of any size (a tile of one-slot pages
    reads 64 page ids; a 5-slot page straddles tiles), split or not."""
    rng = np.random.default_rng(bs + 7 * int(q8))
    b, h, kv, d = 3, 8, 2, 64
    nbmax = -(-700 // bs)
    nb = b * nbmax + 2
    q = _bf16(rng.standard_normal((b, h, d)) * 0.3, cuda)
    kp = _bf16(rng.standard_normal((kv, nb, bs, d)) * 0.5, cuda)
    vp = _bf16(rng.standard_normal((kv, nb, bs, d)) * 0.5, cuda)
    scales = {}
    if q8:
        (kp, ks), (vp, vs) = kv_cache.quantize_q8(kp), kv_cache.quantize_q8(vp)
        scales = {"k_scale": ks, "v_scale": vs}
    table = _i32(rng.permutation(nb)[: b * nbmax].reshape(b, nbmax), cuda)
    lens_t = _i32([700, 63, 129], cuda)
    got = pa.paged_attention_decode(q, kp, vp, lens_t, table, **scales)
    ref = pa.paged_attention_decode_plain(q, kp, vp, lens_t, table, **scales)
    assert nmse(ref.float().cpu(), got.float().cpu()) < 2e-4


@pytest.mark.parametrize("d", [32, 72, 112, 160, 512])
def test_attention_kernels_refuse_other_head_dims(cuda, d):
    """K2 and K3 take D in {64, 80, 96, 100, 128, 192, 256}; any other head dim
    raises on CUDA (72, and 112, the dim D = 100 runs at inside the
    kernels, too), with no fallback to the plain version."""
    b, t, h, kv, bs, nb = 1, 4, 4, 2, 16, 2
    z = lambda *shape: torch.zeros(shape, dtype=torch.bfloat16, device=cuda)
    table = _i32([[0, 1]], cuda)
    with pytest.raises(ValueError, match="unsupported"):
        fp.flash_prefill(z(b, t, h, d), z(kv, nb, bs, d), z(kv, nb, bs, d),
                         _i32([list(range(t))], cuda), _i32([t], cuda), table)
    with pytest.raises(ValueError, match="unsupported"):
        pa.paged_attention_decode(z(b, h, d), z(kv, nb, bs, d),
                                  z(kv, nb, bs, d), _i32([t], cuda), table)


def expert_stack(ggml_type, e, n, k, seed):
    """E random experts of one GGML type, planes stacked on a leading axis
    (the loader's _repack_3d layout)."""
    qts = [random_qtensor(ggml_type, n, k, seed * 31 + i) for i in range(e)]
    q0 = qts[0]
    st = lambda xs: None if xs[0] is None else np.stack(xs)
    return repack.QTensor(q0.kind, q0.shape, q0.n_orig, q0.group,
                          st([q.qs for q in qts]), st([q.scale for q in qts]),
                          st([q.min_ for q in qts]), q0.lut, q0.ggml_type)


def routing_case(pattern, m, e, rng):
    """topi/topv [m, 2]: 'ragged' skews the load (some experts get none),
    'one' sends every token to expert 3 alone (top-1)."""
    if pattern == "one":
        return np.full((m, 1), 3, np.int64), np.ones((m, 1), np.float32)
    p = np.asarray([0.4, 0.25, 0.15, 0.1, 0.1, 0, 0, 0][:e])
    p = p / p.sum()
    topi = np.stack([rng.choice(e, size=2, replace=False, p=p)
                     for _ in range(m)])
    topv = rng.dirichlet([1.0, 1.0], size=m).astype(np.float32)
    return topi, topv


@pytest.mark.parametrize("pattern", ["ragged", "one"])
@pytest.mark.parametrize("m", [1, 3, 8, 130, 300])
@pytest.mark.parametrize("ggml_type", [*_SCALES, *_LOWBIT, GGMLType.BF16],
                         ids=lambda t: t.name)
def test_gmm_kernel_matches_plain(cuda, ggml_type, m, pattern):
    """K = 2304 (not a multiple of 2048); dead tail tiles come out finite
    and rows without an assignment come out zero. Every plane kind: int8,
    u4 (with and without a min), u2 with a min, u4lut, u2lut (TQ2_0 at
    group 256) and dense bf16 stacks."""
    e, n, k = 8, 768, 2304
    rng = np.random.default_rng(m)
    qt = qtensor_to_torch(expert_stack(ggml_type, e, n, k, seed=m), cuda)
    topi, topv = routing_case(pattern, m, e, rng)
    tile_m = gmm.TILE_GEMV if topi.size <= 256 else gmm.TILE_GEMM
    rt = gmm.route_tokens(torch.from_numpy(topi).to(cuda),
                          torch.from_numpy(topv).to(cuda),
                          n_expert_local=e, tile_m=tile_m)
    x = _bf16(rng.standard_normal((m, k)), cuda)
    xs = x[rt.tok_idx.long()]
    name = "gmm_gemv" if tile_m == gmm.TILE_GEMV else "gmm_gemm"
    before = _cuda.LAUNCHES[name]
    got = gmm.gmm_apply(xs, qt, rt, tile_m)
    assert _cuda.LAUNCHES[name] == before + 1
    ref = gmm.gmm_apply(xs, qt, rt, tile_m, plain=True)
    assert got.shape == ref.shape == (xs.shape[0], n)
    assert torch.isfinite(got).all()
    rows = rt.tile_rows.cpu().numpy()
    live = np.concatenate([np.arange(tile_m) < r for r in rows])
    assert (got[torch.from_numpy(~live).to(cuda)] == 0).all()
    assert nmse(ref.cpu(), got.cpu()) < 2e-4, nmse(ref.cpu(), got.cpu())
    if tile_m == gmm.TILE_GEMM and qt.min_ is not None:
        # the GEMM rounds bf16(s*q) and folds the min in f32, as the plain
        # fold does: only the order of f32 sums differs
        fold = gmm._planes_plain(xs, qt, rt, tile_m, rounding="fold")
        fold = fold.reshape(xs.shape[0], -1)[:, :n]
        assert nmse(fold.cpu(), got.cpu()) < 1e-8, nmse(fold.cpu(), got.cpu())
    comb = gmm.gmm(x, qt, rt, tile_m=tile_m)
    comb_ref = gmm.gmm_plain(x, qt, rt, tile_m=tile_m)
    assert nmse(comb_ref.cpu(), comb.cpu()) < 2e-4


@pytest.mark.parametrize("ggml_type,k", [(GGMLType.Q4_K, 2304),
                                         (GGMLType.Q2_K, 2304),
                                         (GGMLType.Q4_1, 2336)],
                         ids=["Q4_K", "Q2_K", "Q4_1-G73"])
def test_gmm_gemm_folds_min_as_k1(cuda, ggml_type, k):
    """K4's GEMM rounds bf16(s*q) and folds the min in f32, as the TPU
    kernel and K1 do: rows that all route to one expert give K1's GEMM
    result on that expert's planes taken as one QTensor. Q4_1 at K = 2336
    has 73 groups, so the fold's last window holds one group."""
    e, n, m = 4, 768, 200
    st = expert_stack(ggml_type, e, n, k, seed=5)
    qt = qtensor_to_torch(st, cuda)
    rt = gmm.route_tokens(torch.full((m, 1), 2, dtype=torch.int64, device=cuda),
                          torch.ones((m, 1), device=cuda), n_expert_local=e,
                          tile_m=gmm.TILE_GEMM)
    x = _bf16(np.random.default_rng(6).standard_normal((m, k)), cuda)
    before = _cuda.LAUNCHES["gmm_gemm"]
    got = gmm.gmm(x, qt, rt, tile_m=gmm.TILE_GEMM)
    assert _cuda.LAUNCHES["gmm_gemm"] == before + 1
    one = repack.QTensor(st.kind, st.shape, st.n_orig, st.group, st.qs[2],
                         st.scale[2], st.min_[2], st.lut, st.ggml_type)
    k1 = qmatmul.qmm(x, qtensor_to_torch(one, cuda))
    assert nmse(k1.cpu(), got.cpu()) < 1e-8, nmse(k1.cpu(), got.cpu())
    # and the plain version at the same rounding, independent of K1
    xs = x[rt.tok_idx.long()]
    fold = gmm._planes_plain(xs, qt, rt, gmm.TILE_GEMM, rounding="fold")
    fold = gmm.combine(fold.reshape(xs.shape[0], -1)[:, :n], rt, m)
    assert nmse(fold.cpu(), got.cpu()) < 1e-8, nmse(fold.cpu(), got.cpu())


_GMM_SIG = "piipiipppippipp"


@pytest.mark.parametrize("ggml_type", [GGMLType.Q4_K, GGMLType.Q2_K,
                                       GGMLType.IQ1_S, GGMLType.BF16],
                         ids=lambda t: t.name)
def test_gmm_gemm_writes_zeros_past_live_rows(cuda, ggml_type):
    """K4's GEMM on an output buffer full of NaN: rows past a tile's live
    count and every row of a dead tile come out 0, live rows as through
    gmm_apply. Top-1 routing of 70 rows to expert 1 and 1 row to expert 3:
    a full tile, a 6-row tile, a 1-row tile, and dead tail tiles."""
    e, n, k = 4, 768, 1024
    qt = qtensor_to_torch(expert_stack(ggml_type, e, n, k, seed=3), cuda)
    topi = torch.tensor([1] * 70 + [3], device=cuda)[:, None]
    rt = gmm.route_tokens(topi, torch.ones((71, 1), device=cuda),
                          n_expert_local=e, tile_m=gmm.TILE_GEMM)
    rows = rt.tile_rows.cpu().numpy()
    assert rows.tolist()[:3] == [64, 6, 1] and (rows[3:] == 0).all()
    xs = _bf16(np.random.default_rng(4).standard_normal((71, k)), cuda)[
        rt.tok_idx.long()]
    t = rows.shape[0]
    out = torch.full((t * gmm.TILE_GEMM, qt.pack, qt.npk), float("nan"),
                     device=cuda)
    fn = _cuda.bind("gmm", "gmm_gemm", _GMM_SIG)
    dense = qt.kind == "dense"
    rc = fn(xs.data_ptr(), t, k, qt.qs.data_ptr(), qt.npk,
            gmm._GMM_KIND[qt.kind], 0 if dense else qt.scale.data_ptr(),
            0 if qt.min_ is None else qt.min_.data_ptr(), qmatmul.lut_ptr(qt),
            qt.group, rt.tile_expert.data_ptr(), rt.tile_rows.data_ptr(), e,
            out.data_ptr(), _cuda.stream_ptr(cuda))
    assert rc == 0
    live = torch.from_numpy(np.concatenate(
        [np.arange(gmm.TILE_GEMM) < r for r in rows])).to(cuda)
    assert (out[~live] == 0).all()
    want = gmm._planes_cuda(xs, qt, rt, gmm.TILE_GEMM)
    assert torch.equal(out[live], want[live])
    ref = gmm._planes_plain(xs, qt, rt, gmm.TILE_GEMM)
    assert nmse(ref[live].cpu(), out[live].cpu()) < 2e-4


@pytest.mark.parametrize("ggml_type", [GGMLType.Q4_K, GGMLType.BF16],
                         ids=lambda t: t.name)
@pytest.mark.parametrize("m", [1300, 2500])
def test_gmm_gemm_pairs_tiles_over_many_tiles(cuda, ggml_type, m):
    """K4's GEMM pairs consecutive routing tiles of one expert's run into a
    block; the pairing walks the routing 32 tiles at a time. 16 experts,
    top-2 of a skewed distribution with empty experts, 57 and 95 tiles (two
    and three steps of the walk, runs of odd and even length crossing
    them): against the plain version (and the plain fold at 1e-8 with a
    min), zeros in every row without an assignment."""
    e, n, k = 16, 256, 512
    rng = np.random.default_rng(m)
    qt = qtensor_to_torch(expert_stack(ggml_type, e, n, k, seed=7), cuda)
    p = rng.dirichlet(np.full(e, 0.3))
    p[[3, 9]] = 0
    p /= p.sum()
    topi = np.stack([rng.choice(e, size=2, replace=False, p=p)
                     for _ in range(m)])
    topv = rng.dirichlet([1.0, 1.0], size=m).astype(np.float32)
    rt = gmm.route_tokens(torch.from_numpy(topi).to(cuda),
                          torch.from_numpy(topv).to(cuda),
                          n_expert_local=e, tile_m=gmm.TILE_GEMM)
    rows = rt.tile_rows.cpu().numpy()
    assert rows.shape[0] > 32 * (1 + (m > 2000)) and (rows == 0).any()
    xs = _bf16(rng.standard_normal((m, k)), cuda)[rt.tok_idx.long()]
    got = gmm.gmm_apply(xs, qt, rt, gmm.TILE_GEMM)
    ref = gmm.gmm_apply(xs, qt, rt, gmm.TILE_GEMM, plain=True)
    live = torch.from_numpy(np.concatenate(
        [np.arange(gmm.TILE_GEMM) < r for r in rows])).to(cuda)
    assert (got[~live] == 0).all()
    assert nmse(ref.cpu(), got.cpu()) < 2e-4, nmse(ref.cpu(), got.cpu())
    if qt.min_ is not None:
        fold = gmm._planes_plain(xs, qt, rt, gmm.TILE_GEMM, rounding="fold")
        fold = fold.reshape(xs.shape[0], -1)[:, :n]
        assert nmse(fold.cpu(), got.cpu()) < 1e-8, nmse(fold.cpu(), got.cpu())


def test_gmm_gemm_raises_on_a_min_group_it_does_not_fold(cuda):
    """With a min, K4's GEMM folds groups of 8, 16, 32 or 64 (one 64-deep
    K step holds them whole); a min at group 128 raises in the wrapper
    and is refused by the C entry point, with no launch and no fallback.
    The decode GEMV takes it."""
    e, k = 2, 512
    qt = qtensor_to_torch(expert_stack(GGMLType.Q4_K, e, 256, k, 1), cuda)
    g128 = dataclasses.replace(qt, group=128,
                               scale=qt.scale[:, :, ::4].contiguous(),
                               min_=qt.min_[:, :, ::4].contiguous())
    rt = gmm.route_tokens(torch.zeros((100, 1), dtype=torch.int64,
                                      device=cuda),
                          torch.ones((100, 1), device=cuda), n_expert_local=e,
                          tile_m=gmm.TILE_GEMM)
    xs = _bf16(np.ones((rt.tok_idx.shape[0], k)), cuda)
    before = _cuda.LAUNCHES["gmm_gemm"]
    with pytest.raises(ValueError, match="group 128 with a min"):
        gmm.gmm_apply(xs, g128, rt, gmm.TILE_GEMM)
    assert _cuda.LAUNCHES["gmm_gemm"] == before
    t = rt.tile_rows.shape[0]
    out = torch.empty((t * gmm.TILE_GEMM, 2, qt.npk), device=cuda)
    fn = _cuda.bind("gmm", "gmm_gemm", _GMM_SIG)
    rc = fn(xs.data_ptr(), t, k, g128.qs.data_ptr(), g128.npk, 1,
            g128.scale.data_ptr(), g128.min_.data_ptr(), 0, 128,
            rt.tile_expert.data_ptr(), rt.tile_rows.data_ptr(), e,
            out.data_ptr(), _cuda.stream_ptr(cuda))
    assert rc != 0
    torch.cuda.synchronize()
    rt8 = gmm.route_tokens(torch.zeros((3, 1), dtype=torch.int64, device=cuda),
                           torch.ones((3, 1), device=cuda), n_expert_local=e,
                           tile_m=gmm.TILE_GEMV)
    xs8 = _bf16(np.ones((rt8.tok_idx.shape[0], k)), cuda)
    got = gmm.gmm_apply(xs8, g128, rt8, gmm.TILE_GEMV)
    ref = gmm.gmm_apply(xs8, g128, rt8, gmm.TILE_GEMV, plain=True)
    assert nmse(ref.cpu(), got.cpu()) < 2e-4


def test_gmm_split_kernel_column_order(cuda):
    """fuse_expert_qtensors + gmm_apply_split equals two gmm_apply passes."""
    e, k = 4, 1024
    parts = [expert_stack(GGMLType.Q4_K, e, n, k, seed=i)
             for i, n in enumerate((512, 768))]
    fused = qtensor_to_torch(repack.fuse_expert_qtensors(parts), cuda)
    rng = np.random.default_rng(5)
    topi, topv = routing_case("ragged", 6, e, rng)
    rt = gmm.route_tokens(torch.from_numpy(topi).to(cuda),
                          torch.from_numpy(topv).to(cuda),
                          n_expert_local=e, tile_m=gmm.TILE_GEMV)
    xs = _bf16(rng.standard_normal((6, k)), cuda)[rt.tok_idx.long()]
    outs = gmm.gmm_apply_split(xs, fused, rt, gmm.TILE_GEMV)
    for qt, y in zip(parts, outs):
        one = gmm.gmm_apply(xs, qtensor_to_torch(qt, cuda), rt, gmm.TILE_GEMV)
        assert y.shape == one.shape
        assert nmse(one.cpu(), y.cpu()) < 1e-12


def test_gmm_raises_on_operands_it_does_not_take(cuda):
    """A LUT kind without its LUT, or a row tile the kernel has no variant
    for, raises: K4 never falls back to the plain version."""
    qt = qtensor_to_torch(expert_stack(GGMLType.IQ4_XS, 2, 256, 256, 1), cuda)
    rt = gmm.route_tokens(torch.zeros((1, 1), dtype=torch.int64, device=cuda),
                          torch.ones((1, 1), device=cuda), n_expert_local=2,
                          tile_m=gmm.TILE_GEMV)
    xs = _bf16(np.ones((rt.tok_idx.shape[0], 256)), cuda)
    with pytest.raises(ValueError, match="LUT"):
        gmm.gmm_apply(xs, dataclasses.replace(qt, lut=None), rt, gmm.TILE_GEMV)
    with pytest.raises(ValueError, match="tile_m"):
        gmm.gmm_apply(xs, qt, rt, 16)


@pytest.mark.parametrize("fmt", ["F", "G", "H"])
@pytest.mark.parametrize("k,n", [(512, 1024), (kbench.K, kbench.N)])
def test_kbench_gemv_matches_plain(cuda, fmt, k, n):
    x, q, s = kbench.make_data(seed=k, k=k, n=n)
    xb, qs, sc = kbench.device_tensors(fmt, x, q, s, cuda)
    before = _cuda.LAUNCHES["kbench_" + fmt.lower()]
    got = kbench.probe_gemv(fmt, xb, qs, sc)
    assert _cuda.LAUNCHES["kbench_" + fmt.lower()] == before + 1
    ref = kbench.probe_gemv_plain(fmt, xb, qs, sc)
    assert got.shape == ref.shape
    assert nmse(ref.cpu(), got.cpu()) < 1e-5, nmse(ref.cpu(), got.cpu())


@pytest.mark.parametrize("rows", [511, 1100, 12672])
def test_kbench_stream_matches_plain(cuda, rows):
    a = torch.randint(0, 256, (rows, 1024), dtype=torch.uint8, device=cuda)
    x = torch.full((1, 128), 0.375, device=cuda)
    got = kbench.stream_colsum(x, a)
    ref = kbench.stream_colsum_plain(x, a)
    assert got.shape == ref.shape == (1, 128)
    assert torch.equal(got, ref)  # integer sums, exact in f32


@pytest.mark.parametrize("cpl", pairprobe.BLOCK_CPL)
def test_pairs_gemv_matches_plain(cuda, cpl):
    rng = np.random.default_rng(cpl)
    k, n = 1024, 2048
    x = _bf16(rng.standard_normal((8, k)), cuda)
    qs, sc, fold = pairprobe.make_data(rng, cuda, k, n)
    got = pairprobe.pairs_qmm(x, qs, sc, fold, cpl=cpl)
    ref = pairprobe.pairs_qmm_plain(x, qs, sc, fold)
    assert nmse(ref.cpu(), got.cpu()) < 1e-5, nmse(ref.cpu(), got.cpu())
    assert pairprobe.correctness_check(cuda)


_PROBES = ["F", "G", "H", "pairs2", "pairs4", "pairs8"]


@pytest.mark.parametrize("name", [*_PROBES, "E"])
def test_probe_kernels_two_calls_are_bit_equal(cuda, name):
    """The K split (the stream's slabs) meets in distributed shared memory
    in a fixed order, with no atomics: the same inputs give the same bits."""
    fn, _ = tools.probe_case(name, *tools.probe_shape(name), cuda, seed=7)
    assert torch.equal(fn(), fn())


@pytest.mark.parametrize("name", [*_PROBES, "E"])
def test_probe_kernels_launch_once_without_memset(cuda, name):
    """One call runs one kernel on the device and no memset."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn, _ = tools.probe_case(name, *tools.probe_shape(name), cuda)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [(ev.key, ev.count) for ev in prof.key_averages()
           if ev.device_type == DeviceType.CUDA]
    assert not any("memset" in k.lower() for k, _ in dev), dev
    assert sum(c for k, c in dev if "memcpy" not in k.lower()) == 1, dev


@pytest.mark.parametrize("name", _PROBES)
@pytest.mark.parametrize("k", [2080, 2144])
def test_probe_gemv_k_not_a_multiple_of_the_stage_rows(cuda, name, k):
    """A split's last stage holds fewer rows than the TMA box brings."""
    n = 1024 if name != "pairs8" else 2048
    nbc = n // 2 if name in "FG" else n
    fmt = "PAIRS" if name.startswith("pairs") else name
    tile = 32 * int(name[5:]) if fmt == "PAIRS" else None
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = tools.probe_plan(fmt, k, nbc, sms, tile=tile)
    assert k % plan.stage_rows or k % plan.rows_per_split
    fn, plain = tools.probe_case(name, k, n, cuda, seed=k)
    got, ref = fn(), plain()
    assert got.shape == ref.shape
    assert nmse(ref.cpu(), got.cpu()) < 1e-5, nmse(ref.cpu(), got.cpu())


@pytest.mark.parametrize("name,n", [("F", 256), ("G", 256), ("H", 128),
                                    *[(f"pairs{c}", 32 * c)
                                      for c in pairprobe.BLOCK_CPL]])
def test_probe_gemv_smallest_n(cuda, name, n):
    """The narrowest weight each wrapper takes: 128 byte columns for
    kbench_gemv, one block of 32 * cpl columns for pairs_gemv."""
    fn, plain = tools.probe_case(name, 512, n, cuda, seed=n)
    got, ref = fn(), plain()
    assert got.shape == ref.shape
    assert nmse(ref.cpu(), got.cpu()) < 1e-5, nmse(ref.cpu(), got.cpu())


@pytest.mark.parametrize("sms", [132, 16])
def test_probe_smem_matches_the_kernel(cuda, sms):
    """tools.probe_smem (which sizes the plan's ring) gives the bytes the C
    launcher asks for, on every plan the CPU plan tests cover, and the C
    entry refuses a plan whose splits leave one empty."""
    import test_torch_probe_plan as tp

    fn = _cuda.bind("kbench", "probe_smem_bytes", "iii" "iiiiii")
    fmt_id = {"F": 0, "G": 1, "H": 2, "PAIRS": 3}
    for fmt, k, nbc, tile in tp._CASES:
        plan = tools.probe_plan(fmt, k, nbc, sms, tile=tile)
        assert fn(fmt_id[fmt], k, nbc, *plan.args()) == \
            tools.probe_smem(fmt, plan), (fmt, k, nbc, plan)
    plan = tools.probe_plan("F", 2048, 512, sms)
    bad = plan._replace(splits=plan.splits + 1)
    assert fn(0, 2048, 512, *bad.args()) == -1


# ---------------------------------------------------------------------------
# The decode GEMV shared by K1 (qmm_gemv) and K4 (gmm_gemv), qmm_gemv.cuh:
# a TMA ring of plane tiles, x staged once a block, the FMA pipe for up to
# 2 rows and mma.sync above on groups of 16 rows or more, K split across a
# cluster that sums in distributed shared memory

# deep K (TinyLlama's ffn_down 5632, Llama-3-8B's 14336) at N = 2048, one
# GGML type of each plane kind
_GEMV_DEEP = [(GGMLType.Q8_0, 5632), (GGMLType.Q6_K, 14336),
              (GGMLType.Q4_0, 5632), (GGMLType.Q4_K, 14336),
              (GGMLType.Q2_K, 14336), (GGMLType.IQ4_XS, 5632),
              (GGMLType.IQ1_S, 14336), (GGMLType.TQ2_0, 5632)]


@pytest.mark.parametrize("ggml_type,k", _GEMV_DEEP,
                         ids=lambda v: getattr(v, "name", str(v)))
def test_gemv_deep_k_every_row_count(cuda, ggml_type, k):
    """K1's GEMV at every row count 1-8 (the FMA pipe at 1-2 rows, the
    tensor-core path at 3-8) against the float golden."""
    n = 2048
    qt_np = random_qtensor(ggml_type, n, k, seed=k % 97)
    golden_w = repack.dequantize_qtensor_np(qt_np)
    qt = qtensor_to_torch(qt_np, cuda)
    x = np.random.default_rng(11).standard_normal((8, k)).astype(np.float32)
    xb = torch.from_numpy(x).to(cuda).to(torch.bfloat16)
    golden = xb.float().cpu().numpy() @ golden_w.T
    for m in range(1, 9):
        before = _cuda.LAUNCHES["qmm_gemv"]
        got = qmatmul.qmm(xb[:m], qt).cpu().numpy()
        assert _cuda.LAUNCHES["qmm_gemv"] == before + 1
        assert got.shape == (m, n)
        err = nmse(golden[:m], got)
        assert err < 5e-5, (m, err)


def _random_planes(kind, k, n, group, has_min, cuda, seed, e=None):
    """Planes of `kind` at any group, drawn on the card (the GGUF types do
    not make groups such as 8, 24 or 40)."""
    g = torch.Generator(device=cuda)
    g.manual_seed(seed)
    lead = () if e is None else (e,)
    pack = repack.PACK[kind]
    npk = n // pack
    if kind == "int8":
        qs = torch.randint(-128, 128, lead + (k, npk), generator=g,
                           device=cuda, dtype=torch.int8)
    else:
        qs = torch.randint(0, 256, lead + (k, npk), generator=g,
                           device=cuda, dtype=torch.uint8)
    shape = lead + (pack, k // group, npk)
    scale = ((torch.rand(shape, generator=g, device=cuda) + 0.5) * 1e-2) \
        .to(torch.bfloat16)
    min_ = ((torch.rand(shape, generator=g, device=cuda) + 0.5) * 1e-2) \
        .to(torch.bfloat16) if has_min else None
    return repack.QTensor(kind, (n, k), n, group, qs, scale, min_)


@pytest.mark.parametrize("kind,group,has_min", [("u4", 24, True),
                                                ("int8", 8, False),
                                                ("u2", 40, True)])
def test_gemv_groups_the_tensor_core_path_does_not_take(cuda, kind, group,
                                                        has_min):
    """Groups that are not a multiple of 16 run on the FMA pipe at every
    row count (the plan says so), against the plain fold."""
    k, n = 2400, 1024
    qt = _random_planes(kind, k, n, group, has_min, cuda, seed=group)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert qmatmul.gemv_plan(k, group, qt.npk, kind, 8, sms,
                             has_min=has_min).mma == 0
    x = _bf16(np.random.default_rng(group).standard_normal((8, k)), cuda)
    for m in range(1, 9):
        got = qmatmul._qmm_planes_cuda(x[:m].contiguous(), qt)
        ref = qmatmul.plain_planes(x[:m], qt, rounding="fold")
        err = nmse(ref.reshape(got.shape).cpu(), got.cpu())
        assert err < 5e-5, (m, err)


@pytest.mark.parametrize("m", [3, 8])
def test_gemv_ring_slots_serve_one_row_group(cuda, m):
    """An 8B lm head (int8, group 16) at 3-8 rows runs two row groups: the
    plan's ring is a multiple of them, the kernel matches the plain version
    on it, and the C entry refuses the same plan with one stage fewer (a
    slot two row groups share, whose parity wait could pass early)."""
    k, n, group = 4096, 129024, 16
    qt = _random_planes("int8", k, n, group, False, cuda, seed=m)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = qmatmul.gemv_plan(k, group, qt.npk, "int8", m, sms)
    assert plan.row_groups == 2 and plan.stages % 2 == 0, plan
    x = _bf16(np.random.default_rng(m).standard_normal((m, k)), cuda)
    got = qmatmul._qmm_planes_cuda(x, qt)
    ref = qmatmul.plain_planes(x, qt)
    assert nmse(ref.reshape(got.shape).cpu(), got.cpu()) < 5e-5
    out = torch.empty_like(got)
    fn = _cuda.bind("qmm", "qmm_gemv", "piipiipppipp" "iiiiiiii")
    args = (x.data_ptr(), m, k, qt.qs.data_ptr(), qt.npk,
            qmatmul._KIND_ID["int8"], qt.scale.data_ptr(), 0, 0, group,
            out.data_ptr(), _cuda.stream_ptr(cuda))
    assert fn(*args, *plan.args()) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, got)
    odd = plan._replace(stages=plan.stages - 1)
    assert fn(*args, *odd.args()) != 0


@pytest.mark.parametrize("m", [1, 2, 5, 8])
def test_gemv_two_calls_are_bit_equal(cuda, m):
    """The K split meets in distributed shared memory in a fixed order (no
    atomics): the same inputs give the same bits, for K1 and K4."""
    k, n, e = 14336, 2048, 8
    qt = _random_planes("u4", k, n, 32, True, cuda, seed=m)
    x = _bf16(np.random.default_rng(m).standard_normal((m, k)), cuda)
    a = qmatmul._qmm_planes_cuda(x, qt)
    b = qmatmul._qmm_planes_cuda(x, qt)
    assert torch.equal(a, b)
    stack = _random_planes("u2", k, n, 16, True, cuda, seed=m, e=e)
    topi, topv = routing_case("ragged", m, e, np.random.default_rng(m))
    rt = gmm.route_tokens(torch.from_numpy(topi).to(cuda),
                          torch.from_numpy(topv).to(cuda),
                          n_expert_local=e, tile_m=gmm.TILE_GEMV)
    xs = x[rt.tok_idx.long()].contiguous()
    assert torch.equal(gmm._planes_cuda(xs, stack, rt, gmm.TILE_GEMV),
                       gmm._planes_cuda(xs, stack, rt, gmm.TILE_GEMV))


@pytest.mark.parametrize("m", [1, 5])
@pytest.mark.parametrize("ggml_type", [GGMLType.Q4_K, GGMLType.Q2_K,
                                       GGMLType.IQ1_S, GGMLType.BF16],
                         ids=lambda t: t.name)
def test_gmm_gemv_writes_zeros_for_dead_tiles_and_pad_rows(cuda, ggml_type, m):
    """K4's GEMV on an output buffer full of NaN, ragged routing: every row
    of a dead tile and every row past a live tile's count come out 0 (no
    memset: the kernel writes them), live rows as through gmm_apply."""
    e, n, k = 8, 768, 2304
    qt = qtensor_to_torch(expert_stack(ggml_type, e, n, k, seed=m), cuda)
    rng = np.random.default_rng(m + 40)
    topi, topv = routing_case("ragged", m, e, rng)
    rt = gmm.route_tokens(torch.from_numpy(topi).to(cuda),
                          torch.from_numpy(topv).to(cuda),
                          n_expert_local=e, tile_m=gmm.TILE_GEMV)
    rows = rt.tile_rows.cpu().numpy()
    t = rows.shape[0]
    assert (rows == 0).any() and (rows[rows > 0] < gmm.TILE_GEMV).any()
    xs = _bf16(rng.standard_normal((m, k)), cuda)[rt.tok_idx.long()]
    out = torch.full((t * gmm.TILE_GEMV, qt.pack, qt.npk), float("nan"),
                     device=cuda)
    dense = qt.kind == "dense"
    group = qmatmul.GEMV_DENSE_GROUP if dense else qt.group
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = qmatmul.gemv_plan(k, group, qt.npk, qt.kind, rt.max_rows, sms,
                             tiles=min(t, e), has_min=qt.min_ is not None)
    fn = _cuda.bind("gmm", "gmm_gemv", _GMM_SIG + "iiiiiiiii")
    rc = fn(xs.data_ptr(), t, k, qt.qs.data_ptr(), qt.npk,
            gmm._GMM_KIND[qt.kind], 0 if dense else qt.scale.data_ptr(),
            0 if qt.min_ is None else qt.min_.data_ptr(), qmatmul.lut_ptr(qt),
            group, rt.tile_expert.data_ptr(), rt.tile_rows.data_ptr(), e,
            out.data_ptr(), _cuda.stream_ptr(cuda), *plan.args(), rt.max_rows)
    assert rc == 0
    live = torch.from_numpy(np.concatenate(
        [np.arange(gmm.TILE_GEMV) < r for r in rows])).to(cuda)
    assert (out[~live] == 0).all()
    want = gmm._planes_cuda(xs, qt, rt, gmm.TILE_GEMV)
    assert torch.equal(out[live], want[live])
    ref = gmm._planes_plain(xs, qt, rt, gmm.TILE_GEMV)
    assert nmse(ref[live].cpu(), out[live].cpu()) < 2e-4
