"""The launch plan of the probe GEMV on the CPU: tools.probe_plan (taken
by kbench_gemv and pairs_gemv, csrc/probe_gemv.cuh).

The plan is the only place the probe GEMV's launch is decided (the kernel
checks it with probe_plan_ok and takes any plan that passes), so these
tests hold it to what the kernel needs, at the probes' own shapes and at
small ones: every K group walked by exactly one split, splits of whole
stages and none empty, at most 8 CTAs a cluster, every byte column in
exactly one column block, the pairs' block width (32 * cpl) as the
column tile, a ring of two stages or more, and shared memory within what
one block may hold.
"""
import pytest

from llama_cpp_test_tpu_torch import tools
from llama_cpp_test_tpu_torch.tools import kbench, pairprobe

SMEM_OPT_IN = 232448        # dynamic shared memory a block may opt into

# (format, K, byte columns, tile or None): the probes' shapes, then small
# and ragged ones (K not a multiple of the stage rows, the narrowest N)
_CASES = [
    ("F", kbench.K, kbench.N // 2, None),
    ("G", kbench.K, kbench.N // 2, None),
    ("H", kbench.K, kbench.N, None),
    *[("PAIRS", pairprobe.C, pairprobe.N, 32 * c) for c in pairprobe.BLOCK_CPL],
    ("F", 512, 512, None),
    ("G", 2080, 512, None),
    ("H", 2144, 384, None),
    ("F", 32, 128, None),
    ("H", 64, 128, None),
    *[("PAIRS", 1024, 2048, 32 * c) for c in pairprobe.BLOCK_CPL],
    *[("PAIRS", 2080, 32 * c, 32 * c) for c in pairprobe.BLOCK_CPL],
    ("PAIRS", 14336, 4096, 128),
]


def _id(case):
    fmt, k, nbc, tile = case
    return f"{fmt}-K{k}-B{nbc}" + (f"-t{tile}" if tile else "")


@pytest.mark.parametrize("sms", [132, 114, 16])
@pytest.mark.parametrize("fmt,k,nbc,tile", _CASES, ids=[_id(c) for c in _CASES])
def test_probe_plan_covers_k_and_columns(fmt, k, nbc, tile, sms):
    plan = tools.probe_plan(fmt, k, nbc, sms, tile=tile)
    kpb = 2 if fmt == "PAIRS" else 1
    group = tools.PROBE_GROUP
    # the pairs' block width is the column tile; columns covered once
    if tile is not None:
        assert plan.tile == tile
    assert plan.tile in (64, 128, 256, 512) and nbc % plan.tile == 0
    assert plan.col_blocks * plan.tile == nbc
    # 1, 2 or 4 warps across the tile
    assert plan.tile // (8 * tools.probe_lane_bytes(fmt, plan.tile)) in (1, 2, 4)
    # stages of whole groups within one TMA box of at most 256 rows
    kt = plan.stage_rows
    assert kt % group == 0 and kt // kpb <= 256
    # splits of whole stages cover K, every group in exactly one, none
    # empty; a cluster of at most 8
    assert plan.rows_per_split % kt == 0
    assert 1 <= plan.splits <= tools.PROBE_MAX_SPLITS
    walked = [0] * (k // group)
    for s in range(plan.splits):
        lo = s * plan.rows_per_split
        hi = min(k, lo + plan.rows_per_split)
        assert lo < hi, f"split {s} is empty"
        for g in range(lo // group, hi // group):
            walked[g] += 1
    assert walked == [1] * (k // group)
    # a ring of two stages or more where the split has two
    assert min(2, plan.rows_per_split // kt) <= plan.stages <= 16
    assert tools.probe_smem(fmt, plan) <= SMEM_OPT_IN


@pytest.mark.parametrize("fmt,k,nbc,tile", _CASES[:6], ids=[_id(c) for c in _CASES[:6]])
def test_probe_plan_fills_one_wave_at_the_probes_shapes(fmt, k, nbc, tile):
    """On an H100 the probes' plans fill every SM at least twice and stay
    in one wave of PROBE_BLOCKS_PER_SM blocks an SM."""
    sms = 132
    plan = tools.probe_plan(fmt, k, nbc, sms, tile=tile)
    blocks = plan.col_blocks * plan.splits
    assert 2 * sms - 8 <= blocks <= tools.PROBE_BLOCKS_PER_SM * sms
    per_sm = -(-blocks // sms)
    assert per_sm * (tools.probe_smem(fmt, plan) + 1024) <= tools.SMEM_PER_SM

