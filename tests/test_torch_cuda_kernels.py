"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Marked `cuda`; every test skips where torch sees no CUDA device (decided
in the `cuda` fixture, never at import). On a machine with a card, and
without JAX, run from the repository root:

    python -m pytest tests/test_torch_cuda_kernels.py -q --noconftest

Covers kernel paths that the serving path of chip_smoke.py does not reach:
all four GGML types of K1 at several row counts, K1 on the u2, u4lut and
u2lut kinds (groups 16, 32 and 256) and K5 on every kind, K2 with a sliding window,
softcap, G = 1 and a cached prefix, K3 (bf16 and q8 pages) at G in
{1, 4, 8} and D in {64, 128} with softcap and very short caches, K4 on all
four GGML types with ragged expert loads, one-expert batches, dead tiles
and K not a multiple of 2048. Gates are the JAX suites': qmm NMSE < 5e-5
against the float golden, attention and gmm NMSE < 2e-4.
"""
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


def random_qtensor(ggml_type, n, k, seed):
    rng = np.random.default_rng(seed)
    blk, nbytes = GGML_BLOCK_SIZES[ggml_type]
    nb = n * k // blk
    raw = rng.integers(0, 256, size=(nb, nbytes), dtype=np.uint8)
    for off, lo, hi in {**_SCALES, **_LOWBIT}[ggml_type]:
        d = rng.uniform(lo, hi, nb).astype(np.float16)
        raw[:, off:off + 2] = d.view(np.uint8).reshape(nb, 2)
    return repack.repack(raw.reshape(-1), ggml_type, n, k)


@pytest.mark.parametrize("m", [1, 2, 5, 8, 9, 64, 100])
@pytest.mark.parametrize("ggml_type", list(_SCALES), ids=lambda t: t.name)
def test_qmm_kernel_matches_golden(cuda, ggml_type, m):
    n, k = 768, 1024
    qt = random_qtensor(ggml_type, n, k, seed=m)
    golden_w = repack.dequantize_qtensor_np(qt)            # [n, k] float32
    x = np.random.default_rng(7).standard_normal((m, k)).astype(np.float32)
    xb = torch.from_numpy(x).to(cuda).to(torch.bfloat16)
    golden = xb.float().cpu().numpy() @ golden_w.T
    got = qmatmul.qmm(xb, qtensor_to_torch(qt, cuda)).cpu().numpy()
    assert got.shape == (m, n)
    assert nmse(golden, got) < 5e-5, nmse(golden, got)


def _golden_case(ggml_type, n, k, m, seed, cuda):
    qt = random_qtensor(ggml_type, n, k, seed=seed)
    x = np.random.default_rng(seed + 1).standard_normal((m, k)).astype(np.float32)
    xb = torch.from_numpy(x).to(cuda).to(torch.bfloat16)
    golden = xb.float().cpu().numpy() @ repack.dequantize_qtensor_np(qt).T
    return qt, xb, golden


@pytest.mark.parametrize("m", [1, 3, 8, 17, 512])
@pytest.mark.parametrize("ggml_type", list(_LOWBIT), ids=lambda t: t.name)
def test_qmm_lowbit_kinds_match_golden(cuda, ggml_type, m):
    n, k = 768, 1024
    qt, xb, golden = _golden_case(ggml_type, n, k, m, m, cuda)
    assert qt.kind in ("u2", "u4lut", "u2lut")
    name = "qmm_gemv" if m <= 8 else "qmm_gemm"
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


def test_qmm_cache_route_falls_to_k1(cuda):
    """Shapes outside the reference's cache conditions take K1's GEMM."""
    qt, xb, _ = _golden_case(GGMLType.Q4_K, 768, 2048, 512, 9, cuda)
    before = dict(_cuda.LAUNCHES)
    qmatmul.qmm(xb, qtensor_to_torch(qt, cuda), variant="cache")
    assert _cuda.LAUNCHES["qmm_cache"] == before["qmm_cache"]
    assert _cuda.LAUNCHES["qmm_gemm"] == before["qmm_gemm"] + 1


def test_qmm_split_kernel_column_order(cuda):
    parts = [random_qtensor(GGMLType.Q4_K, n_i, 1024, seed=i)
             for i, n_i in enumerate((512, 256, 256))]
    fused = qtensor_to_torch(repack.fuse_qtensors(parts), cuda)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, 1024)).astype(np.float32)).to(cuda).to(torch.bfloat16)
    outs = qmatmul.qmm_split(x, fused)
    plain = qmatmul.qmm_split_plain(x, fused)
    for qt, y, yp in zip(parts, outs, plain):
        one = qmatmul.qmm(x, qtensor_to_torch(qt, cuda))
        assert y.shape == one.shape == (3, qt.n_orig)
        assert nmse(one.cpu(), y.cpu()) < 1e-12
        assert nmse(yp.cpu(), y.cpu()) < 5e-5


def _bf16(a, dev):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dev).to(torch.bfloat16)


def _i32(a, dev):
    return torch.from_numpy(np.asarray(a, np.int32)).to(dev)


@pytest.mark.parametrize("h,kv,d", [(8, 2, 64), (4, 4, 64), (32, 8, 128)],
                         ids=["G4", "G1", "G4-D128"])
@pytest.mark.parametrize("window,cap,start", [(0, 0.0, 0), (5, 0.0, 0),
                                              (0, 30.0, 0), (7, 50.0, 40)])
def test_flash_prefill_kernel_matches_plain(cuda, h, kv, d, window, cap, start):
    rng = np.random.default_rng(h + d + window)
    b, t, bs = 2, 37, 16
    lens = [start + t, start + t - 5]
    nbmax = -(-max(lens) // bs)
    nb = 2 * nbmax + 3
    q = _bf16(rng.standard_normal((b, t, h, d)) * 0.2, cuda)
    kp = _bf16(rng.standard_normal((kv, nb, bs, d)), cuda)
    vp = _bf16(rng.standard_normal((kv, nb, bs, d)), cuda)
    table = _i32(rng.permutation(nb)[: b * nbmax].reshape(b, nbmax), cuda)
    pos = _i32(np.stack([np.maximum(np.arange(l - t, l), 0) for l in lens]), cuda)
    kvl = _i32(lens, cuda)
    got = fp.flash_prefill(q, kp, vp, pos, kvl, table, window=window,
                           soft_cap=cap)
    ref = fp.flash_prefill_plain(q, kp, vp, pos, kvl, table, window=window,
                                 soft_cap=cap)
    assert nmse(ref.float().cpu(), got.float().cpu()) < 2e-4


@pytest.mark.parametrize("g,kv,d", [(1, 4, 64), (4, 2, 64), (8, 4, 64),
                                    (4, 8, 128), (8, 2, 128)])
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


@pytest.mark.parametrize("g,kv,d", [(1, 4, 64), (4, 2, 64), (4, 8, 128)])
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


def expert_stack(ggml_type, e, n, k, seed):
    """E random experts of one GGML type, planes stacked on a leading axis
    (the loader's _repack_3d layout)."""
    qts = [random_qtensor(ggml_type, n, k, seed * 31 + i) for i in range(e)]
    q0 = qts[0]
    st = lambda xs: None if xs[0] is None else np.stack(xs)
    return repack.QTensor(q0.kind, q0.shape, q0.n_orig, q0.group,
                          st([q.qs for q in qts]), st([q.scale for q in qts]),
                          st([q.min_ for q in qts]), None, q0.ggml_type)


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
@pytest.mark.parametrize("ggml_type", list(_SCALES), ids=lambda t: t.name)
def test_gmm_kernel_matches_plain(cuda, ggml_type, m, pattern):
    """K = 2304 (not a multiple of 2048); dead tail tiles come out finite
    and rows without an assignment come out zero."""
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
    comb = gmm.gmm(x, qt, rt, tile_m=tile_m)
    comb_ref = gmm.gmm_plain(x, qt, rt, tile_m=tile_m)
    assert nmse(comb_ref.cpu(), comb.cpu()) < 2e-4


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
