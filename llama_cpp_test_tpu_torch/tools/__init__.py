"""Kernel probes on the card: the counterparts of the JAX package's
microbenchmarks tools/kbench.py and tools/pairprobe.py, run as
`python -m llama_cpp_test_tpu_torch.tools.kbench` and
`python -m llama_cpp_test_tpu_torch.tools.pairprobe`, and the timer they
share with chip_smoke.py."""
from __future__ import annotations

import subprocess

import numpy as np
import torch

HBM_BW = 3.35e12           # H100 SXM HBM3 bytes/s (data sheet)


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
