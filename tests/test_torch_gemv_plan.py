"""The decode GEMV's launch plan (ops.qmatmul.gemv_plan, taken by K1's
qmm_gemv and K4's gmm_gemv) and the bf16-exactness of the plane values the
GEMV's tensor-core path would feed the MMA, on the CPU.

The plan is the only place the GEMV's launch is decided (the kernels check
it with gemv_plan_ok and take any plan that passes), so these tests hold
it to what the kernel needs at every projection the port serves: every K
group walked by exactly one split, splits of whole groups, at most 8 CTAs
a cluster, stage rows that hold whole groups or a whole share of one, ring
slots that each serve one row group, and at least one block an SM wherever the columns and groups allow it.
"""
import numpy as np
import pytest
import torch

from llama_cpp_test_tpu_torch.gguf.constants import GGML_BLOCK_SIZES, GGMLType
from llama_cpp_test_tpu_torch.ops import qmatmul
from llama_cpp_test_tpu_torch.quant import iq_repack, repack

SMS = 132                   # an H100 SXM
SMEM_OPT_IN = 232448        # dynamic shared memory a block may opt into

# (label, K, N, kind, group, has_min): the projections the smoke serves,
# at the published widths (N the logical columns, padded as the loader
# pads them)
_SERVED = [
    ("TinyLlama wqkv Q4_K", 2048, 2560, "u4", 32, True),
    ("TinyLlama wo Q4_K", 2048, 2048, "u4", 32, True),
    ("TinyLlama gate|up Q4_K", 2048, 11264, "u4", 32, True),
    ("TinyLlama down Q4_K", 5632, 2048, "u4", 32, True),
    ("TinyLlama lm head Q6_K", 2048, 32768, "int8", 16, False),
    ("TinyLlama gate|up Q8_0", 2048, 11264, "int8", 32, False),
    ("8B gate|up Q2_K", 4096, 28672, "u2", 16, True),
    ("8B down Q2_K", 14336, 4096, "u2", 16, True),
    ("8B gate|up IQ1_S", 4096, 28672, "u2lut", 32, False),
    ("8B down IQ2_XXS", 14336, 4096, "u4lut", 16, False),
    ("8B lm head Q6_K", 4096, 129024, "int8", 16, False),
    ("8B lm head Q5_K", 4096, 129024, "int8", 32, True),
    ("70B gate|up IQ4_XS", 8192, 57344, "u4lut", 32, False),
    ("70B down IQ4_XS", 28672, 8192, "u4lut", 32, False),
    ("70B wqkv IQ4_XS", 8192, 10240, "u4lut", 32, False),
    ("Mixtral gate Q4_K", 4096, 14336, "u4", 32, True),
    ("Mixtral down Q4_K", 14336, 4096, "u4", 32, True),
    ("Mixtral gate Q2_K", 4096, 14336, "u2", 16, True),
    ("Mixtral gate IQ1_S", 4096, 14336, "u2lut", 32, False),
    ("Mixtral down IQ2_XXS", 14336, 4096, "u4lut", 16, False),
    ("Mixtral gate BF16", 4096, 14336, "dense", 4096, False),
    ("Mixtral down BF16", 14336, 4096, "dense", 14336, False),
    ("TQ2_0 gate", 4096, 14336, "u2lut", 256, False),
    ("Q4_1 odd K", 2304, 768, "u4", 32, True),
]


def _smem_bytes(plan, kind, has_min, mt, group):
    """Dynamic shared memory of one GEMV block (qmm_gemv.cuh gemv_smem)."""
    ct = qmatmul.GEMV_CONSUMERS // plan.row_groups
    kt = plan.stage_rows
    seg = min(group, kt)
    cols, lane = qmatmul.gemv_lane(kind, mt)
    up = lambda b: -(-b // 128) * 128
    plane = up(kt * ct * lane)
    scale = 0 if kind == "dense" else \
        up(max(1, kt // group) * repack.PACK[kind] * ct * cols * 2)
    stage = plane + scale * (2 if has_min else 1)
    no = 8 if mt <= 2 else 4
    ring = max(plan.stages * stage, mt * no * qmatmul.GEMV_CONSUMERS * 4)
    xsum = mt * (plan.x_rows // seg) * 4 if has_min else 0
    return ring + up(mt * plan.x_rows * 2) + up(xsum) + 16 * plan.stages + 64


@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("label,k,n,kind,group,has_min", _SERVED,
                         ids=[s[0] for s in _SERVED])
def test_gemv_plan_covers_every_group(label, k, n, kind, group, has_min, m):
    pack = repack.PACK[kind]
    npk = -(-n // (256 * pack)) * 256          # the loader's tile_n padding
    tiles = 2 if label.startswith("Mixtral") else 1
    plan = qmatmul.gemv_plan(k, group, npk, kind, m, SMS, tiles=tiles,
                             has_min=has_min)
    g = qmatmul.GEMV_DENSE_GROUP if kind == "dense" else group
    groups = k // g
    # splits: whole groups, every group in exactly one, none empty
    assert plan.rows_per_split % g == 0
    walked = np.zeros(groups, np.int32)
    for s in range(plan.splits):
        lo, hi = s * plan.rows_per_split, min(k, (s + 1) * plan.rows_per_split)
        assert lo < hi, f"split {s} is empty"
        walked[lo // g:hi // g] += 1
    assert (walked == 1).all()
    assert plan.cluster == plan.splits <= qmatmul.GEMV_MAX_SPLITS
    # stages hold whole groups or a whole share of one; x in whole stages
    kt = plan.stage_rows
    assert kt % g == 0 or g % kt == 0
    assert plan.x_rows % kt == 0 and plan.x_rows >= kt
    assert 2 <= plan.stages <= 16 and plan.row_groups in (1, 2, 4)
    assert plan.stages % plan.row_groups == 0
    assert kt <= qmatmul.GEMV_MAX_STAGE_ROWS
    # the tensor-core path: 16-row K steps within one group
    if plan.mma:
        assert kind != "dense" and min(g, kt) % 16 == 0 and kt % 16 == 0
    # column blocks cover npk, none empty
    lane_cols = qmatmul.gemv_lane(kind, m)[0]
    cols = qmatmul.GEMV_CONSUMERS // plan.row_groups * lane_cols
    assert plan.col_blocks * cols >= npk > (plan.col_blocks - 1) * cols
    # at least one block an SM where the columns and the groups allow it
    blocks = plan.col_blocks * plan.splits * tiles
    widest = -(-npk // (qmatmul.GEMV_CONSUMERS // 4 * lane_cols)) \
        * min(qmatmul.GEMV_MAX_SPLITS, groups) * tiles
    assert blocks >= min(SMS, widest)
    # x of the widest row count fits with the ring in one block
    mt = qmatmul._gemv_mt(m)
    assert _smem_bytes(plan, kind, has_min, mt, g) <= SMEM_OPT_IN // 2


@pytest.mark.parametrize("m", range(1, 9))
@pytest.mark.parametrize("label,k,n,kind,group,has_min", _SERVED,
                         ids=[s[0] for s in _SERVED])
def test_gemv_plan_ring_slot_serves_one_row_group(label, k, n, kind, group,
                                                  has_min, m):
    """Row group r takes stages r, r + row_groups, ... and waits on its
    slot's mbarrier by parity: where the slot's previous stage belonged to
    another group and had not landed, the wait would pass two phases
    early. So the ring's stages are a multiple of the row groups, at every
    row count (the 8B lm heads at 3-8 rows had 5 stages over 2 groups),
    and the ring still fits two blocks an SM."""
    pack = repack.PACK[kind]
    npk = -(-n // (256 * pack)) * 256
    tiles = 2 if label.startswith("Mixtral") else 1
    plan = qmatmul.gemv_plan(k, group, npk, kind, m, SMS, tiles=tiles,
                             has_min=has_min)
    assert plan.stages % plan.row_groups == 0, plan
    assert plan.stages >= max(2, plan.row_groups)
    g = qmatmul.GEMV_DENSE_GROUP if kind == "dense" else group
    assert _smem_bytes(plan, kind, has_min, qmatmul._gemv_mt(m), g) \
        <= SMEM_OPT_IN // 2


@pytest.mark.parametrize("group", [1, 9, 24, 48, 96, 128, 768, 2304])
def test_gemv_plan_takes_any_group_dividing_k(group):
    """Groups no GGUF type has (K4 and K1 took any group dividing K)."""
    k, npk = 2304, 512
    for m in (1, 3, 8):
        plan = qmatmul.gemv_plan(k, group, npk, "u4", m, SMS, has_min=True)
        assert plan.rows_per_split % group == 0
        assert plan.splits * plan.rows_per_split >= k
        assert (plan.splits - 1) * plan.rows_per_split < k
        kt = plan.stage_rows
        assert kt % group == 0 or group % kt == 0
        assert plan.stages % plan.row_groups == 0
        assert _smem_bytes(plan, "u4", True, qmatmul._gemv_mt(m), group) \
            <= SMEM_OPT_IN


def _codes(qt):
    """Every code value in a repacked plane (int8 values, or the nibbles /
    crumbs of the packed kinds)."""
    q = np.asarray(qt.qs)
    if qt.kind == "int8":
        return np.unique(q.astype(np.int32))
    bits = repack.BITS[qt.kind]
    q = q.astype(np.int32)
    return np.unique(np.concatenate([(q >> (bits * h)) & ((1 << bits) - 1)
                                     for h in range(8 // bits)]).ravel())


def _round_trips_bf16(v):
    t = torch.from_numpy(np.asarray(v, np.float32))
    return torch.equal(t.to(torch.bfloat16).float(), t)


_TYPES = sorted(set(repack._DECOMPOSERS) | set(iq_repack.IQ_DECOMPOSERS),
                key=lambda t: t.value)


@pytest.mark.parametrize("ggml_type", _TYPES, ids=lambda t: t.name)
def test_repacked_codes_and_lut_entries_are_exact_in_bf16(ggml_type):
    """The tensor-core path takes a weight's code (or its LUT entry) as a
    bf16 MMA operand: each must be exact in bf16, for every plane kind the
    port's repack makes."""
    blk, nbytes = GGML_BLOCK_SIZES[ggml_type]
    n, k = 256, 512
    rng = np.random.default_rng(int(ggml_type.value))
    raw = rng.integers(0, 256, size=(n * k // blk, nbytes), dtype=np.uint8)
    with np.errstate(invalid="ignore", over="ignore"):  # random scales
        qt = repack.repack(raw.reshape(-1), ggml_type, n, k)
    assert qt.kind in ("int8", "u4", "u2", "u4lut", "u2lut")
    codes = _codes(qt)
    assert _round_trips_bf16(codes)
    if qt.kind in ("u4lut", "u2lut"):
        lut = np.asarray(qt.lut, np.float32)
        assert lut.shape == (1 << repack.BITS[qt.kind],)
        assert _round_trips_bf16(lut)
        assert _round_trips_bf16(lut[codes])
