"""Kernel probes on the card: the counterparts of the JAX package's
microbenchmarks tools/kbench.py and tools/pairprobe.py, run as
`python -m llama_cpp_test_tpu_torch.tools.kbench` and
`python -m llama_cpp_test_tpu_torch.tools.pairprobe`, the launch plan of
their GEMV kernel (csrc/probe_gemv.cuh), and the timer they share with
chip_smoke.py."""
from __future__ import annotations

import subprocess
from typing import NamedTuple

import numpy as np
import torch

HBM_BW = 3.35e12           # H100 SXM HBM3 bytes/s (data sheet)

# The probe GEMV's launch plan (probe_gemv.cuh). The kernel's threads and
# the outputs a lane holds are fixed in C (probe_lane_bytes); everything
# else is chosen here, and the C entry points check what they are given
# (probe_plan_ok) and take any plan that passes.
PROBE_GROUP = 32
PROBE_ROWS = 8               # x rows (M) of every probe
PROBE_MAX_SPLITS = 8         # CTAs of a cluster (the portable maximum)
PROBE_BLOCKS_PER_SM = 3      # blocks the plan aims at, per SM, in one wave
PROBE_STAGE_BYTES = 8 << 10  # plane bytes a ring stage brings
PROBE_X_ROWS = 4096          # K rows of x a block stages at most (64 KB)
PROBE_TILE = 128             # plane bytes a block takes of a row (the
                             # pairs': 32 * cpl)
SMEM_PER_SM = 233472         # shared memory of an H100 SM; 1 KB of it is
                             # reserved a resident block
SMEM_BLOCK_MAX = 232448      # dynamic shared memory one block may hold


class ProbePlan(NamedTuple):
    col_blocks: int      # column tiles of the plane's bytes
    tile: int            # plane bytes a block takes of a row
    splits: int          # K ranges, one CTA each, one cluster
    rows_per_split: int  # K rows a split, whole stages
    stage_rows: int      # K rows a ring stage, whole groups
    stages: int          # ring stages a block

    def args(self) -> tuple:
        """The plan as the C entry points take it (after the stream)."""
        return tuple(self)


def probe_lane_bytes(fmt: str, tile: int) -> int:
    """Plane bytes a lane reads a row (probe_gemv.cuh probe_lane_bytes):
    16 for the pairs on tiles of 128 bytes or more, else 8."""
    return 16 if fmt == "PAIRS" and tile >= 128 else 8


def probe_smem(fmt: str, plan: ProbePlan) -> int:
    """Dynamic shared memory of one block (probe_gemv.cuh probe_smem)."""
    up = lambda b, a: -(-b // a) * a
    kpb = 2 if fmt == "PAIRS" else 1
    vals = 2 if fmt in ("F", "G") else 1
    kt, tile = plan.stage_rows, plan.tile
    gps, outs = kt // PROBE_GROUP, tile * vals
    cw = tile // (8 * probe_lane_bytes(fmt, tile))
    fold = up(gps * tile * 4, 128) if fmt == "PAIRS" else 0
    stage = up(up(kt // kpb * tile, 1024) + up(gps * outs * 2, 128) + fold,
               1024)
    ring = up(max(plan.stages * stage, 4 // cw * PROBE_ROWS * outs * 4), 128)
    recv = up(plan.splits * up(-(-PROBE_ROWS * outs // plan.splits), 4) * 4,
              128)
    x = up(PROBE_ROWS * (plan.rows_per_split * 2 + 32), 128)
    xsum = up(PROBE_ROWS * (plan.rows_per_split // PROBE_GROUP) * 4, 16) \
        if fmt == "PAIRS" else 0
    return ring + recv + x + xsum + (2 * plan.stages + 1) * 8 + 1024


def probe_plan(fmt: str, k: int, nbc: int, sms: int,
               tile: int | None = None) -> ProbePlan:
    """Launch plan of the probe GEMV (kbench_gemv fmt "F", "G", "H";
    pairs_gemv "PAIRS") for x [8, k] against a plane of nbc byte columns
    on a card of `sms` SMs; `tile`: the pairs' block width (32 * cpl),
    else PROBE_TILE (the wrappers take byte columns in multiples of it).

    Splits of K (whole stages, none empty): aimed at the largest power of
    two up to PROBE_MAX_SPLITS with which the blocks fill at most
    PROBE_BLOCKS_PER_SM an SM in one wave (a power of two, so the
    clusters pack the card's GPCs: 3 splits of 128 tiles left a second
    wave), then as few as cover K in whole stages. Stages of about
    PROBE_STAGE_BYTES of plane in whole groups (at most 256 box rows); as
    many stages as the split has, short of the shared memory that lets the
    blocks an SM holds share it, but two (smaller stages where that does
    not fit)."""
    kpb = 2 if fmt == "PAIRS" else 1
    tile = PROBE_TILE if tile is None else tile
    col_blocks = nbc // tile
    groups = k // PROBE_GROUP
    splits = max(1, min(PROBE_MAX_SPLITS, groups,
                        PROBE_BLOCKS_PER_SM * sms // col_blocks))
    splits = 1 << (splits.bit_length() - 1)   # clusters that pack the GPCs
    # no split stages more x than PROBE_X_ROWS rows
    splits = min(PROBE_MAX_SPLITS, max(splits, -(-k // PROBE_X_ROWS)))
    per_sm = -(-col_blocks * splits // sms)   # blocks an SM holds at once
    kt = min(256 * kpb, PROBE_STAGE_BYTES * kpb // tile)
    kt = max(PROBE_GROUP, kt // PROBE_GROUP * PROBE_GROUP)
    per = -(-groups // splits) * PROBE_GROUP
    budget = min(SMEM_BLOCK_MAX,
                 SMEM_PER_SM // min(per_sm, PROBE_BLOCKS_PER_SM) - 1024)
    kt = min(kt, per)
    while True:
        rows = -(-per // kt) * kt
        plan = lambda st: ProbePlan(col_blocks, tile, -(-k // rows), rows, kt,
                                    st)
        stages = min(16, rows // kt)
        while stages > 2 and probe_smem(fmt, plan(stages)) > budget:
            stages -= 1
        if kt == PROBE_GROUP or probe_smem(fmt, plan(stages)) <= budget:
            return plan(stages)
        kt = max(PROBE_GROUP, kt // 2 // PROBE_GROUP * PROBE_GROUP)


def card() -> str:
    """nvidia-smi's name and power limit of the card, or why not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
            else f"nvidia-smi failed: {out.stderr.strip()}"
    except (OSError, subprocess.TimeoutExpired, IndexError) as e:
        return f"nvidia-smi unavailable ({e})"


class L2FlushedTimer:
    """Median per-launch time in ms from CUDA events, with the 50 MB L2
    flushed by a 64 MiB read before every launch (a read leaves clean
    lines, as a decode step finds them; a write would leave ~50 MB of dirty
    lines for the timed kernel to write back). A ~1 ms spin kernel runs
    ahead of the flush, so the host has queued the timed call before the
    card reaches the start event: without it the events of one launch also
    bracket the host's launch work (the stream probe read 54 us by events
    and 15 us of device time by torch.profiler on an H100)."""

    SPIN_CYCLES = 2_000_000

    def __init__(self, device="cuda"):
        self.flush = torch.zeros(16 << 20, dtype=torch.float32, device=device)

    def __call__(self, fn, iters: int = 15, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        events = []
        for _ in range(iters):
            torch.cuda._sleep(self.SPIN_CYCLES)
            self.flush.sum()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            events.append((s, e))
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in events]))


PROBES = ("F", "G", "H", "E", "pairs2", "pairs4", "pairs8")


def probe_case(name: str, k: int, n: int, device, seed: int = 0):
    """(kernel call, plain call) of probe `name` on inputs drawn from
    `seed`: "F", "G", "H" (kbench_gemv: x [8, k] against a weight of n
    columns, kbench.make_data), "E" (kbench_stream over a u8 [k, n] array)
    or "pairs<cpl>" (pairs_gemv at block width 32 * cpl, x [8, k],
    pairprobe.make_data). The shapes each probe's entry point runs:
    probe_shape(name). The probe modules are imported by their absolute
    name, so that tools/gemv_rows.py can build the same calls on another
    checkout's package."""
    from llama_cpp_test_tpu_torch.tools import kbench, pairprobe

    if name == "E":
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        a = torch.randint(0, 256, (k, n), generator=g, dtype=torch.uint8,
                          device=device)
        x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            (1, 128)).astype(np.float32)).to(device)
        return (lambda: kbench.stream_colsum(x, a),
                lambda: kbench.stream_colsum_plain(x, a))
    if name.startswith("pairs"):
        cpl = int(name[5:])
        rng = np.random.default_rng(seed)
        x = torch.from_numpy(rng.standard_normal((pairprobe.M, k)).astype(
            np.float32)).to(device).to(torch.bfloat16)
        qs, sc, fold = pairprobe.make_data(rng, device, k, n)
        return (lambda: pairprobe.pairs_qmm(x, qs, sc, fold, cpl=cpl),
                lambda: pairprobe.pairs_qmm_plain(x, qs, sc, fold))
    x, q, s = kbench.make_data(seed=seed, k=k, n=n)
    xb, qs, sc = kbench.device_tensors(name, x, q, s, device)
    return (lambda: kbench.probe_gemv(name, xb, qs, sc),
            lambda: kbench.probe_gemv_plain(name, xb, qs, sc))


def probe_shape(name: str) -> tuple[int, int]:
    """(k, n) of probe `name` at its entry point: kbench's M=8 K=2048
    N=11264 and 12672 x 1024 byte array, pairprobe's K=4096 N=16384."""
    from llama_cpp_test_tpu_torch.tools import kbench, pairprobe

    if name == "E":
        return kbench.STREAM_SHAPE
    if name.startswith("pairs"):
        return pairprobe.C, pairprobe.N
    return kbench.K, kbench.N
