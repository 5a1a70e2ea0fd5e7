"""K1's and K4's decode GEMV, or the five probe kernels, timed on one GPU,
at the shapes of the rows PERF.md keeps for them.

    python llama_cpp_test_tpu_torch/tools/gemv_rows.py [--tree DIR] [--m M ...]
        [--set NAME=INT ...] [--probes]

K1 (`qmm_gemv`): TinyLlama's four projections as Q4_K, Llama-3-8B gate|up
Q2_K and IQ1_S,
Llama-3-70B gate|up IQ4_XS, and the 8B lm heads (129024 rows) as Q6_K and
Q5_K (int8, the second with a min). K4 (`gmm_gemv`, top-2 of 8 experts):
Mixtral gate and down Q4_K, gate Q2_K and IQ1_S, down IQ2_XXS, gate BF16.
Planes are drawn on the device with each kind's layout (codes, bf16 group
scales, a min where the type has one, the type's LUT), so the bytes a call
reads are those of the loaded model; each row goes through chip_smoke.py's
KernelChecks (NMSE against the plain version, the kernel's time, the
plain version's, one PyTorch call's, and the byte bound).

With --probes the rows are instead the probes' (chip_smoke.py's probe
rows: kbench's F, G, H GEMVs and byte stream E, pairprobe's pairs GEMV at
cpl 4, each against its plain version), each also timed by torch.profiler
(the device time of the call's own kernels and memsets over 15 calls, each
after the L2 flush, whose own kernel and memset are left out), the pairs
also at cpl 2 and 8.

With --tree DIR the rows run on the package and chip_smoke.py of another
checkout (for example `git archive` of an earlier commit), so two
versions can be timed one after the other in one call to the card; --set overrides
constants of a launch plan (ops.qmatmul.gemv_plan, or with --probes
tools.probe_plan). Prints one JSON object a row, the timer's floor for one
empty kernel, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

# (label, kind, K, N, group, has_min)
K1_ROWS = [
    ("TinyLlama wqkv Q4_K", "u4", 2048, 3072, 32, True),
    ("TinyLlama wo Q4_K", "u4", 2048, 2048, 32, True),
    ("TinyLlama gate|up Q4_K", "u4", 2048, 11264, 32, True),
    ("TinyLlama down Q4_K", "u4", 5632, 2048, 32, True),
    ("8B gate|up Q2_K", "u2", 4096, 28672, 16, True),
    ("8B gate|up IQ1_S", "u2lut", 4096, 28672, 32, False),
    ("70B gate|up IQ4_XS", "u4lut", 8192, 57344, 32, False),
    ("8B lm head Q6_K", "int8", 4096, 129024, 16, False),
    ("8B lm head Q5_K", "int8", 4096, 129024, 32, True),
]
K4_ROWS = [
    ("Mixtral gate Q4_K", "u4", 4096, 14336, 32, True),
    ("Mixtral down Q4_K", "u4", 14336, 4096, 32, True),
    ("Mixtral gate Q2_K", "u2", 4096, 14336, 16, True),
    ("Mixtral gate IQ1_S", "u2lut", 4096, 14336, 32, False),
    ("Mixtral down IQ2_XXS", "u4lut", 14336, 4096, 16, False),
    ("Mixtral gate BF16", "dense", 4096, 14336, 4096, False),
]
N_EXPERT = 8
PACK = {"dense": 1, "int8": 1, "u4": 2, "u2": 4, "u4lut": 2, "u2lut": 4}
# a LUT of each LUT kind's types (IQ4_NL's values; IQ1_S's)
LUTS = {"u4lut": [-127, -104, -83, -65, -49, -35, -22, -10, 1, 13, 25, 38,
                  53, 69, 89, 113],
        "u2lut": [-0.875, 0.125, 1.125, 0.0]}


def planes(torch, QTensor, gen, kind, k, n, group, has_min, e=None):
    """Random planes of `kind` for an (n, k) weight on the card, stacked
    over e experts when e is given. Scales put the weights near a std of
    0.015; a min centers them."""
    lead = () if e is None else (e,)
    dev = "cuda"
    if kind == "dense":
        w = (torch.randn(lead + (k, n), generator=gen, device=dev) * 0.015)
        return QTensor("dense", (n, k), n, k, w.to(torch.bfloat16))
    pack = PACK[kind]
    npk = n // pack
    if kind == "int8":
        qs = torch.randint(-32, 32, lead + (k, npk), generator=gen,
                           device=dev, dtype=torch.int8)
        s_lo = 4e-4
    else:
        qs = torch.randint(0, 256, lead + (k, npk), generator=gen,
                           device=dev, dtype=torch.uint8)
        s_lo = {"u4": 2e-3, "u2": 1e-2, "u4lut": 2e-4, "u2lut": 1e-2}[kind]
    shape = lead + (pack, k // group, npk)
    scale = ((torch.rand(shape, generator=gen, device=dev) + 1) * s_lo) \
        .to(torch.bfloat16)
    mid = {"int8": 0.0, "u4": 7.5, "u2": 1.5}.get(kind, 0.0)
    min_ = (scale.float() * mid).to(torch.bfloat16) if has_min else None
    lut = (torch.tensor(LUTS[kind], dtype=torch.float32, device=dev)
           if kind in LUTS else None)
    return QTensor(kind, (n, k), n, group, qs, scale, min_, lut)


def device_ms(torch, timer, fn, iters: int = 15) -> float:
    """Device time a call of fn by torch.profiler, each call after the
    timer's L2 flush, averaged over iters calls: every device event but the
    flush's reduction kernel and the one memset each flush runs (so a
    parent's own memset counts). A session that records no device activity
    at all is run again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                timer.flush.sum()
                fn()
            torch.cuda.synchronize()
        events = [ev for ev in prof.key_averages()
                  if ev.device_type == DeviceType.CUDA]
        if events:
            break
    us = 0.0
    for ev in events:
        t = getattr(ev, "self_device_time_total", 0.0)
        if "reduce" in ev.key:
            continue
        if "memset" in ev.key.lower():
            t *= (ev.count - iters) / ev.count
        us += t
    return us / iters / 1e3


def _own_tools():
    """This checkout's tools module, loaded from its file: its probe_case
    builds the same calls, on the same inputs, for any --tree (the kbench
    and pairprobe modules it calls are the tree's)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_gemv_rows_tools", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "__init__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def probe_rows(torch, cs, kc, timer) -> None:
    """The probe rows of chip_smoke.py's probes phase, then each probe's
    device time (tools.probe_case at its entry point's shape; the pairs at
    every block width)."""
    from llama_cpp_test_tpu_torch.tools import kbench

    tools = _own_tools()

    for name, r in cs._probe_rows(torch, kc).items():
        print(json.dumps({"k": name, **r}), flush=True)
    rows, cols = kbench.STREAM_SHAPE
    e_bytes = kbench.stream_rows(rows) * cols
    for name in tools.PROBES:
        fn, _ = tools.probe_case(name, *tools.probe_shape(name), "cuda")
        dev = device_ms(torch, timer, fn)
        row = {"k": name, "device_ms": dev, "ms": timer(fn)}
        if name == "E":
            row["device_tb_s"] = e_bytes / dev / 1e9
        print(json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "..", ".."),
        help="checkout whose package and chip_smoke.py are timed")
    ap.add_argument("--m", type=int, nargs="*", default=[1, 8],
                    help="rows (tokens) of each call")
    ap.add_argument("--set", nargs="*", default=[], metavar="NAME=INT",
                    help="plan constants of ops.qmatmul to override "
                         "(GEMV_RING_BYTES, GEMV_BLOCKS_PER_SM, "
                         "GEMV_MMA_MIN_ROWS, ...), or with --probes of "
                         "tools (PROBE_BLOCKS_PER_SM, PROBE_STAGE_BYTES)")
    ap.add_argument("--probes", action="store_true",
                    help="time the five probe kernels instead of the GEMVs")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from llama_cpp_test_tpu_torch.quant.repack import QTensor
    from llama_cpp_test_tpu_torch.tools import L2FlushedTimer, card

    if not torch.cuda.is_available():
        print("gemv_rows: needs a CUDA device", file=sys.stderr)
        return 1
    if args.set:
        if args.probes:
            from llama_cpp_test_tpu_torch import tools as consts
        else:
            from llama_cpp_test_tpu_torch.ops import qmatmul as consts
        for kv in args.set:
            name, value = kv.split("=")
            getattr(consts, name)  # an unknown name raises
            setattr(consts, name, int(value))
    timer = L2FlushedTimer()
    print(json.dumps({"tree": tree, "card": card(), "set": args.set,
                      "one_empty_kernel_ms": timer(lambda: torch.cuda._sleep(0))}),
          flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    kc = cs.KernelChecks(torch, timer, np.random.default_rng(1234))
    if args.probes:
        probe_rows(torch, cs, kc, timer)
        return 0
    for label, kind, k, n, group, has_min in K1_ROWS:
        qt = planes(torch, QTensor, gen, kind, k, n, group, has_min)
        for m in args.m:
            r = kc.qmm(label, kind + ("+min" if has_min else ""), qt, m)
            print(json.dumps({"k": "K1", **r}), flush=True)
        del qt
    for label, kind, k, n, group, has_min in K4_ROWS:
        qt = planes(torch, QTensor, gen, kind, k, n, group, has_min,
                    e=N_EXPERT)
        for m in args.m:
            r = kc.gmm(label, kind + ("+min" if has_min else ""), qt, m)
            print(json.dumps({"k": "K4", **r}), flush=True)
        del qt
    if kc.failures:
        print(f"gemv_rows: rows outside their gate: {kc.failures}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
