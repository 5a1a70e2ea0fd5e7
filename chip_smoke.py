#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (llama_cpp_test_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing one JSON line as it finishes; any failure exits
non-zero before the final line:

  device   nvidia-smi name/power limit, torch and CUDA versions
  build    nvcc builds every kernel under llama_cpp_test_tpu_torch/csrc
  kernels  each kernel against its plain PyTorch version at the main
           paths' shapes: TinyLlama-1.1B and Mixtral-8x7B, plus the widest
           Llama-3-8B ones (error, gate, kernel/plain/library times,
           roofline bound)
  serve    a TinyLlama-1.1B-geometry Q4_K GGUF synthesized from seeded
           random block bytes is loaded with Model(path) on cuda and serves
           three generate() requests plus one batched decode; the launch
           count of every kernel of that path must be > 0, and the logits
           at every row of a prefill and of the next decode steps are held
           against the plain path
  serve_moe the same for a Mixtral-8x7B-geometry MoE GGUF (full width, 8
           layers), served by two Contexts, bf16 and q8_0 KV, each with
           three generate() requests and one batched decode of 8 sequences;
           the logits gate holds the rows whose expert routing agrees with
           the plain path's, and the rows whose routing differs are counted
  serve_iq4xs  the same for a Llama-3-70B-geometry IQ4_XS GGUF (full width,
           4 layers; u4lut planes), one bf16 Context, then K1 rows on the
           loaded planes of layer 0 and the lm head at M = 1, 8 and 512
  serve_lowbit the same for two Llama-3-8B-geometry files (full width, 8
           layers): Q2_K (u2 planes with a min) and IQ1_S (u2lut, with
           Q4_K attn_v, IQ2_XXS ffn_down, Q5_K output, Q2_K token_embd),
           each served by a Context at the default qmm variant and one at
           "cache", whose prefills must launch K5 (qmm_cache); then K1 rows
           on each file's loaded planes and K5 rows at M = 512

Before the last line it prints the kernels summary and the card's
nvidia-smi name and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Times are medians of per-launch CUDA-event timings with the 50 MB L2
flushed before each launch (the main path finds weights and pages cold).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES = 3.35e12     # H100 SXM HBM3 bytes/s (data sheet)
PEAK_BF16 = 989e12       # H100 SXM dense bf16 tensor-core flop/s
QMM_GATE = 5e-5          # NMSE gate of the qmm suite (tests/test_qmatmul.py)
ATTN_GATE = 2e-4         # NMSE gate of the attention suites
GMM_GATE = 2e-4          # NMSE gate of the gmm suite (tests/test_gmm.py:73)
LOGITS_GATE = 2e-3       # NMSE gate of the engine suite (tests/test_engine.py)

# TinyLlama-1.1B (BASELINE.json config #1) published widths
TINYLLAMA = dict(n_vocab=32000, n_embd=2048, n_head=32, n_head_kv=4,
                 head_dim=64, n_layer=22, n_ff=5632)
# Llama-3-8B (BASELINE.json config #2) published widths
LLAMA3_8B = dict(n_vocab=128256, n_embd=4096, n_head=32, n_head_kv=8,
                 head_dim=128, n_layer=32, n_ff=14336)
# Mixtral-8x7B (BASELINE.json config #4; mistralai/Mixtral-8x7B-v0.1
# config.json) published widths, depth cut from 32 to 8 layers; weights
# at the TinyLlama phase's std (~0.015)
MIXTRAL = dict(n_vocab=32000, n_embd=4096, n_head=32, n_head_kv=8,
               head_dim=128, n_layer=8, n_ff=14336, n_expert=8,
               n_expert_used=2, rope_base=1e6)

# Llama-3-70B (BASELINE.json config #5; meta-llama/Meta-Llama-3-70B
# config.json) published widths, depth cut from 80 to 4 layers
LLAMA3_70B = dict(n_vocab=128256, n_embd=8192, n_head=64, n_head_kv=8,
                  head_dim=128, n_layer=4, n_ff=28672, rope_base=500000.0)
# Llama-3-8B widths for the low-bit files, depth cut from 32 to 8 layers
LLAMA3_8B_LOWBIT = dict(LLAMA3_8B, n_layer=8, rope_base=500000.0)

TPU_KERNELS = {
    "qmm_gemv": ("llama_cpp_test_tpu_torch/csrc/qmm.cu",
                 "llama_cpp_test_tpu/ops/qmatmul.py:145"),
    "qmm_gemm": ("llama_cpp_test_tpu_torch/csrc/qmm.cu",
                 "llama_cpp_test_tpu/ops/qmatmul.py:145"),
    "qmm_cache": ("llama_cpp_test_tpu_torch/csrc/qmm_cache.cu",
                  "llama_cpp_test_tpu/ops/qmatmul.py:276"),
    "flash_prefill": ("llama_cpp_test_tpu_torch/csrc/flash_prefill.cu",
                      "llama_cpp_test_tpu/ops/flash_prefill.py:31"),
    "paged_decode": ("llama_cpp_test_tpu_torch/csrc/paged_attention.cu",
                     "llama_cpp_test_tpu/ops/paged_attention.py:50"),
    "paged_decode_q8": ("llama_cpp_test_tpu_torch/csrc/paged_attention.cu",
                        "llama_cpp_test_tpu/ops/paged_attention.py:50"),
    "gmm_gemv": ("llama_cpp_test_tpu_torch/csrc/gmm.cu",
                 "llama_cpp_test_tpu/ops/gmm.py:118"),
    "gmm_gemm": ("llama_cpp_test_tpu_torch/csrc/gmm.cu",
                 "llama_cpp_test_tpu/ops/gmm.py:118"),
}
# the kernels each serving path must launch
DENSE_PATH = ("qmm_gemv", "qmm_gemm", "flash_prefill", "paged_decode")
MOE_PATH = DENSE_PATH + ("paged_decode_q8", "gmm_gemv", "gmm_gemm")
# the slice whose serve path each kernel's `launches` is read from
OWN_PATH = {"paged_decode_q8": "serve_moe", "gmm_gemv": "serve_moe",
            "gmm_gemm": "serve_moe", "qmm_cache": "serve_lowbit"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nmse(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(((a - b) ** 2).mean() / ((a * a).mean() + 1e-30))


# ---------------------------------------------------------------------------
# timing


class Timer:
    """Median per-launch time in ms from CUDA events, with the L2 flushed
    (a 64 MiB write) before every launch."""

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters: int = 15, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush_buf.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            times.append((s, e))
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in times]))


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / PEAK_BYTES, flops / PEAK_BF16
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


# ---------------------------------------------------------------------------
# synthetic weights: seeded random block bytes with bounded fp16 scales


def _f16_field(raw, off: int, values) -> None:
    raw[:, off:off + 2] = np.asarray(values, np.float16).view(np.uint8) \
        .reshape(-1, 2)


def random_blocks(rng, ggml_type, n: int, k: int) -> np.ndarray:
    """Packed GGUF bytes for an (n, k) weight: random quant bytes with fp16
    scale fields drawn from a bounded range, so every weight is finite.
    Every type aims at a weight std of ~0.015; the scale ranges below come
    from the std of each type's decoded random blocks at d = 1 (measured
    with quant/codecs.dequantize on 20000 blocks), divided into 0.015."""
    from llama_cpp_test_tpu_torch.gguf.constants import GGML_BLOCK_SIZES, GGMLType

    blk, nbytes = GGML_BLOCK_SIZES[ggml_type]
    nb = n * k // blk
    raw = rng.integers(0, 256, size=(nb, nbytes), dtype=np.uint8)
    d = lambda lo, hi: rng.uniform(lo, hi, nb).astype(np.float16)
    if ggml_type == GGMLType.Q4_K:
        # weight std ~0.015. A random 22-layer stack at TinyLlama's trained
        # std (~0.03) amplifies the bf16 weight-rounding difference between
        # kernels and plain path (NMSE ~3e-6 per projection) to logits NMSE
        # up to 2e-3 (measured on an H100); at ~0.015 it stays below 6e-4
        dv = d(0.35e-4, 0.65e-4)
        _f16_field(raw, 0, dv)
        # dmin ~ 7.5 d centers the weights (E[q] = 7.5, scales/mins alike)
        _f16_field(raw, 2, dv.astype(np.float32) * 7.5)
    elif ggml_type == GGMLType.Q5_K:
        # std 528 d with dmin = 15.5 d (E[q] = 15.5 centers the weights)
        dv = d(2.3e-5, 3.4e-5)
        _f16_field(raw, 0, dv)
        _f16_field(raw, 2, dv.astype(np.float32) * 15.5)
    elif ggml_type == GGMLType.Q2_K:
        # std 13.9 d with dmin = 1.5 d (E[q] = 1.5 centers the weights)
        dv = d(0.8e-3, 1.4e-3)
        _f16_field(raw, 80, dv)
        _f16_field(raw, 82, dv.astype(np.float32) * 1.5)
    elif ggml_type == GGMLType.Q8_0:
        _f16_field(raw, 0, d(0.5e-4, 1.5e-4))
    elif ggml_type == GGMLType.Q6_K:
        # int8 sub-block scales in [4, 12] and d ~ 1e-4: q in [-32, 31]
        # gives weight std ~0.015, as the Q4_K blocks above
        raw[:, 192:208] = rng.integers(4, 13, size=(nb, 16), dtype=np.uint8)
        _f16_field(raw, 208, d(0.7e-4, 1.3e-4))
    elif ggml_type == GGMLType.IQ4_XS:
        # std 1246 d (6-bit signed block scales times the IQ4_NL LUT's
        # |values| up to 127); d ~ 1.2e-5 is an fp16 subnormal, still exact
        _f16_field(raw, 0, d(0.9e-5, 1.5e-5))
    elif ggml_type == GGMLType.IQ1_S:
        # std 7.2 d (ternary grid values +- 0.125, scales 2s + 1 <= 15)
        _f16_field(raw, 0, d(1.6e-3, 2.6e-3))
    elif ggml_type == GGMLType.IQ2_XXS:
        # std 53 d (grid magnitudes 8, 25, 43 times (0.5 + s) / 4)
        _f16_field(raw, 0, d(2.2e-4, 3.4e-4))
    else:
        raise ValueError(ggml_type)
    return raw.reshape(-1)


_ROLES = ("token_embd", "output", "attn_q", "attn_k", "attn_v",
          "attn_output", "ffn_gate", "ffn_up", "ffn_down")


def file_types(ftype: str) -> dict:
    """Tensor role -> GGML type of a file of type ftype, by the JAX
    package's per-tensor rules (quant/quantize_model.tensor_target_type):
    an IQ4_XS file is IQ4_XS throughout; a Q2_K file keeps a Q6_K head; an
    IQ1_S file bumps attn_v to Q4_K and ffn_down to IQ2_XXS, keeps a Q5_K
    head and a Q2_K token embedding."""
    from llama_cpp_test_tpu_torch.gguf.constants import GGMLType as T

    base = dict.fromkeys(_ROLES, T[ftype])
    return {"Q4_K": base,
            "IQ4_XS": base,
            "Q2_K": {**base, "output": T.Q6_K},
            "IQ1_S": {**base, "attn_v": T.Q4_K, "ffn_down": T.IQ2_XXS,
                      "output": T.Q5_K, "token_embd": T.Q2_K}}[ftype]


def write_llama_gguf(path: str, hp: dict, seed: int,
                     ftype: str = "Q4_K") -> None:
    """A llama-arch GGUF of geometry hp from seeded random block bytes:
    matmul tensors by file_types(ftype) and F32 norms; with
    hp["n_expert"], Mixtral's layout as llama.cpp writes it (F32 router,
    Q4_K gate/up expert stacks, ffn_down_exps Q6_K on even layers and Q4_K
    on odd ones, as a Q4_K_M file mixes them)."""
    from llama_cpp_test_tpu_torch.gguf.constants import GGMLType
    from llama_cpp_test_tpu_torch.gguf.writer import GGUFWriter

    rng = np.random.default_rng(seed)
    types = file_types(ftype)
    c, hq, hkv, d = hp["n_embd"], hp["n_head"], hp["n_head_kv"], hp["head_dim"]
    v, ff, n_layer = hp["n_vocab"], hp["n_ff"], hp["n_layer"]
    n_exp = hp.get("n_expert", 0)
    w = GGUFWriter(path, arch="llama")
    meta = {"llama.context_length": 2048, "llama.embedding_length": c,
            "llama.block_count": n_layer, "llama.attention.head_count": hq,
            "llama.attention.head_count_kv": hkv,
            "llama.attention.key_length": d, "llama.attention.value_length": d,
            "llama.feed_forward_length": ff, "llama.rope.dimension_count": d,
            "llama.rope.freq_base": hp.get("rope_base", 10000.0),
            "llama.attention.layer_norm_rms_epsilon": 1e-5,
            "llama.vocab_size": v}
    if n_exp:
        meta.update({"llama.expert_count": n_exp,
                     "llama.expert_used_count": hp["n_expert_used"]})
    for key, val in meta.items():
        w.add_kv(key, val)

    def quant(name, n, k, e=1, gt=None):
        gt = gt or types[name.split(".")[-2]]
        shape = (k, n) if e == 1 else (k, n, e)
        w.add_tensor(name, random_blocks(rng, gt, n * e, k),
                     ggml_type=gt, raw_ggml_shape=shape)

    def norm(name):
        w.add_tensor(name, 1.0 + 0.05 * rng.standard_normal(c).astype(np.float32))

    quant("token_embd.weight", v, c)
    norm("output_norm.weight")
    quant("output.weight", v, c)
    for i in range(n_layer):
        p = f"blk.{i}."
        norm(p + "attn_norm.weight")
        quant(p + "attn_q.weight", hq * d, c)
        quant(p + "attn_k.weight", hkv * d, c)
        quant(p + "attn_v.weight", hkv * d, c)
        quant(p + "attn_output.weight", c, hq * d)
        norm(p + "ffn_norm.weight")
        if n_exp:
            # router logits of std ~3 over the experts
            w.add_tensor(p + "ffn_gate_inp.weight", 0.05 * rng.standard_normal(
                (n_exp, c)).astype(np.float32))
            quant(p + "ffn_gate_exps.weight", ff, c, n_exp, GGMLType.Q4_K)
            quant(p + "ffn_up_exps.weight", ff, c, n_exp, GGMLType.Q4_K)
            quant(p + "ffn_down_exps.weight", c, ff, n_exp,
                  GGMLType.Q6_K if i % 2 == 0 else GGMLType.Q4_K)
        else:
            quant(p + "ffn_gate.weight", ff, c)
            quant(p + "ffn_up.weight", ff, c)
            quant(p + "ffn_down.weight", c, ff)
    w.write()


# ---------------------------------------------------------------------------
# phases


def phase_device(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    info = {"phase": "device", "nvidia_smi": line,
            "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "capability": list(torch.cuda.get_device_capability(0)),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0]}
    emit(info)
    return info


def phase_build() -> None:
    from llama_cpp_test_tpu_torch.ops import _cuda

    shutil.rmtree(_cuda.BUILD_DIR, ignore_errors=True)
    t0 = time.time()
    reports = _cuda.build_all()
    secs = time.time() - t0
    summary = {}
    for name, text in reports.items():
        regs = [int(tok) for line in text.splitlines() if "registers" in line
                for tok in [line.split("Used ")[1].split(" registers")[0]]]
        spills = [line.strip() for line in text.splitlines()
                  if "spill" in line and not line.strip().endswith(
                      "0 bytes spill stores, 0 bytes spill loads")]
        summary[name] = {"functions": len(regs), "max_registers": max(regs or [0]),
                         "spill_lines": spills[:4]}
    for name in _cuda.SOURCES:
        _cuda.lib(name)
    emit({"phase": "build", "seconds": round(secs, 3), "kernels": summary})


def _qmm_planes(rng, hp: dict, ggml_type, labels) -> dict:
    """Repacked planes (host) of the listed projections of geometry hp."""
    from llama_cpp_test_tpu_torch.quant.repack import fuse_qtensors, repack

    c, ff, v = hp["n_embd"], hp["n_ff"], hp["n_vocab"]
    nq, nkv = hp["n_head"] * hp["head_dim"], hp["n_head_kv"] * hp["head_dim"]
    mk = lambda n, k, tile_n=256: repack(random_blocks(rng, ggml_type, n, k),
                                         ggml_type, n, k, tile_n=tile_n)
    build = {
        "wqkv": lambda: fuse_qtensors([mk(nq, c), mk(nkv, c), mk(nkv, c)]),
        "wo": lambda: mk(c, nq),
        "gate|up": lambda: fuse_qtensors([mk(ff, c), mk(ff, c)]),
        "down": lambda: mk(c, ff),
        "lm_head": lambda: mk(v, c, tile_n=1024),
    }
    return {label: build[label]() for label in labels}


class KernelChecks:
    """Each kernel against its plain version on the same inputs, timed
    beside a library call computing the same function and its bound."""

    def __init__(self, torch, timer, rng):
        self.torch, self.timer, self.rng = torch, timer, rng
        self.failures = []

    def _row(self, kernel, shape, out_k, out_p, gate, fn_k, fn_p, fn_lib,
             nbytes, flops, library=None):
        torch = self.torch
        a = out_k.float().reshape(out_p.shape)
        b = out_p.float()
        torch.cuda.synchronize()
        err = nmse(b.cpu(), a.cpu())
        b_ms, b_by = bound(nbytes, flops)
        row = {"kernel": kernel, "shape": shape, "nmse": err, "gate": gate,
               "max_abs_err": float((a - b).abs().max()),
               "ms": self.timer(fn_k), "plain_ms": self.timer(fn_p, iters=5),
               "library_ms": self.timer(fn_lib), "bound_ms": b_ms,
               "bound_by": b_by}
        if library:
            row["library"] = library
        emit({"phase": "kernels", **row})
        if not err < gate:
            self.failures.append(shape)
        return row

    def qmm(self, label, kind, qt, m, cache=False):
        """K1 (GEMV for m <= 8, GEMM above), or K5 with cache=True."""
        from llama_cpp_test_tpu_torch.ops import qmatmul

        torch = self.torch
        k, n_full = qt.shape[1], qt.shape[0]
        x = torch.from_numpy(self.rng.standard_normal((m, k)).astype(np.float32)) \
            .to("cuda").to(torch.bfloat16)
        w_lib = qmatmul.dequantize(qt)                     # [K, N] bf16
        if cache:
            name, fn_k = "qmm_cache", lambda: qmatmul._qmm_cache_cuda(x, qt)
        else:
            name = "qmm_gemv" if m <= 8 else "qmm_gemm"
            fn_k = lambda: qmatmul._qmm_planes_cuda(x, qt)
        fn_p = lambda: qmatmul._matmul_f32(x, qmatmul.dequantize(qt))
        plane_bytes = sum(t.numel() * t.element_size()
                          for t in (qt.qs, qt.scale, qt.min_, qt.lut)
                          if t is not None)
        row = self._row(name, f"{label} {kind} M={m} K={k} N={n_full}",
                        fn_k(), fn_p(), QMM_GATE, fn_k, fn_p,
                        lambda: torch.matmul(x, w_lib),
                        x.numel() * 2 + plane_bytes + m * n_full * 4,
                        2.0 * m * k * n_full)
        del w_lib
        return row

    def gmm(self, label, kind, qt, m, top_k=2):
        """K4 on a stacked expert plane at m tokens routed top_k of E by
        softmax over random router logits, as moe_ffn routes them."""
        from llama_cpp_test_tpu_torch.ops import gmm, qmatmul

        torch = self.torch
        e, k, npk = qt.qs.shape
        logits = torch.from_numpy(self.rng.standard_normal((m, e)).astype(
            np.float32)).to("cuda")
        topv, topi = torch.topk(torch.softmax(logits, -1), top_k, dim=-1)
        tile_m = gmm.TILE_GEMV if m * top_k <= 256 else gmm.TILE_GEMM
        rt = gmm.route_tokens(topi, topv / topv.sum(-1, keepdim=True),
                              n_expert_local=e, tile_m=tile_m)
        x = torch.from_numpy(self.rng.standard_normal((m, k)).astype(
            np.float32)).to("cuda").to(torch.bfloat16)
        xs = x[rt.tok_idx.long()].contiguous()
        fn_k = lambda: gmm._planes_cuda(xs, qt, rt, tile_m)
        fn_p = lambda: gmm._planes_plain(xs, qt, rt, tile_m)
        # the bound counts the experts this routing reads, once each
        routed = torch.unique(topi).numel()
        plane_bytes = sum(t.numel() * t.element_size() for t in
                          (qt.qs, qt.scale, qt.min_) if t is not None)
        w_all = torch.stack([qmatmul._dequant_t(
            qt.qs[i], qt.scale[i], None if qt.min_ is None else qt.min_[i],
            None, kind=qt.kind, group=qt.group) for i in range(e)])
        fn_lib, lib_name = _grouped_yardstick(torch, x, topi, w_all)
        row = self._row(
            "gmm_gemv" if tile_m == gmm.TILE_GEMV else "gmm_gemm",
            f"{label} {kind} M={m} top{top_k}/{e} K={k} N={qt.shape[0]} "
            f"tile_m={tile_m} routed={routed}",
            fn_k(), fn_p(), GMM_GATE, fn_k, fn_p, fn_lib,
            m * k * 2 + plane_bytes * routed // e + m * top_k * qt.shape[0] * 4,
            2.0 * m * top_k * k * qt.shape[0], library=lib_name)
        del w_all
        return row

    def _pool(self, kvh, nb, bs, d):
        return torch_bf16(self.torch, self.rng.standard_normal((kvh, nb, bs, d)) * 0.5)

    def paged_decode(self, hp, b, bs=16, nbmax=32, q8=False):
        """K3 over bf16 pages, or over q8_0 pages (int8 + f32 slot
        scales) with q8=True."""
        from llama_cpp_test_tpu_torch.ops import flash_prefill as fp
        from llama_cpp_test_tpu_torch.ops import paged_attention as pa
        from llama_cpp_test_tpu_torch.runtime import kv_cache

        torch, rng = self.torch, self.rng
        h, kvh, d = hp["n_head"], hp["n_head_kv"], hp["head_dim"]
        nb = b * nbmax + 4
        kpool, vpool = self._pool(kvh, nb, bs, d), self._pool(kvh, nb, bs, d)
        scales = {}
        if q8:
            (kq, ks), (vq, vs) = (kv_cache.quantize_q8(kpool),
                                  kv_cache.quantize_q8(vpool))
            scales = {"k_scale": ks, "v_scale": vs}
            kpool, vpool = kq, vq
        table = torch.from_numpy(rng.permutation(nb)[: b * nbmax]
                                 .reshape(b, nbmax).astype(np.int32)).to("cuda")
        lens_np = rng.integers(200, 500, size=b).astype(np.int32)
        lens = torch.from_numpy(lens_np).to("cuda")
        q = torch_bf16(torch, rng.standard_normal((b, h, d)) / 8)
        fn_k = lambda: pa.paged_attention_decode(q, kpool, vpool, lens, table,
                                                 **scales)
        fn_p = lambda: pa.paged_attention_decode_plain(q, kpool, vpool, lens,
                                                       table, **scales)
        s = nbmax * bs
        mask = (torch.arange(s, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
        if q8:
            lk, lv = (kv_cache.gather_kv_q8(p, sc, table).permute(0, 2, 1, 3)
                      .repeat_interleave(h // kvh, dim=1).contiguous()
                      for p, sc in ((kpool, scales["k_scale"]),
                                    (vpool, scales["v_scale"])))
        else:
            lk, lv = _sdpa_kv(fp, kpool, vpool, table, h // kvh)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lq = q[:, :, None, :]
        n_keys = int(lens_np.sum())
        # bytes per key or value row: D elements, plus its f32 scale (q8)
        row_bytes = d + 4 if q8 else 2 * d
        return self._row(
            "paged_decode_q8" if q8 else "paged_decode",
            f"B={b} H={h} KV={kvh} D={d} BS={bs} lens={lens_np.tolist()}",
            fn_k(), fn_p(), ATTN_GATE, fn_k, fn_p,
            lambda: sdpa(lq, lk, lv, attn_mask=mask, scale=1.0),
            2 * q.numel() * 2 + n_keys * kvh * row_bytes * 2,
            4.0 * d * h * n_keys)

    def flash_prefill(self, hp, t=512, start=0, bs=16):
        """A chunk of t tokens at positions start.. over a cache that holds
        start + t tokens (start > 0: a cached prefix)."""
        from llama_cpp_test_tpu_torch.ops import flash_prefill as fp

        torch, rng = self.torch, self.rng
        h, kvh, d = hp["n_head"], hp["n_head_kv"], hp["head_dim"]
        n = start + t
        nbmax = -(-n // bs)
        nb = nbmax + 4
        kpool, vpool = self._pool(kvh, nb, bs, d), self._pool(kvh, nb, bs, d)
        table = torch.from_numpy(rng.permutation(nb)[:nbmax].reshape(1, nbmax)
                                 .astype(np.int32)).to("cuda")
        pos = torch.arange(start, n, dtype=torch.int32, device="cuda")[None]
        kvl = torch.tensor([n], dtype=torch.int32, device="cuda")
        q = torch_bf16(torch, rng.standard_normal((1, t, h, d)) / 8)
        fn_k = lambda: fp.flash_prefill(q, kpool, vpool, pos, kvl, table)
        fn_p = lambda: fp.flash_prefill_plain(q, kpool, vpool, pos, kvl, table)
        mask = fp.prefill_mask(pos, kvl, nbmax * bs)[:, None]
        lk, lv = _sdpa_kv(fp, kpool, vpool, table, h // kvh)
        lq = q.permute(0, 2, 1, 3).contiguous()
        sdpa = torch.nn.functional.scaled_dot_product_attention
        pairs = t * start + t * (t + 1) // 2
        return self._row(
            "flash_prefill",
            f"B=1 T={t} start={start} H={h} KV={kvh} D={d} BS={bs}",
            fn_k(), fn_p(), ATTN_GATE, fn_k, fn_p,
            lambda: sdpa(lq, lk, lv, attn_mask=mask, scale=1.0),
            2 * q.numel() * 2 + n * kvh * d * 2 * 2, 4.0 * d * h * pairs)


def _grouped_yardstick(torch, x, topi, w_all):
    """One library call computing the grouped product on pre-dequantized
    bf16 experts w_all [E, K, N]: torch._grouped_mm over the routed rows
    sorted by expert where the installed torch has it, else the per-expert
    torch.matmul calls (timed together). Returns (callable, label)."""
    e = w_all.shape[0]
    m, top_k = topi.shape
    flat = topi.reshape(-1)
    order = torch.argsort(flat, stable=True)
    a = x[torch.arange(m, device=x.device).repeat_interleave(top_k)[order]]
    counts = torch.bincount(flat, minlength=e)
    offs = torch.cumsum(counts, 0).to(torch.int32)
    gmm_fn = getattr(torch, "_grouped_mm", None)
    if gmm_fn is not None:
        for b in (w_all, w_all.transpose(1, 2).contiguous().transpose(1, 2)):
            fn = lambda b=b: gmm_fn(a, b, offs=offs)
            try:
                fn()
                torch.cuda.synchronize()
                return fn, "torch._grouped_mm"
            except (RuntimeError, TypeError, ValueError):
                continue
    bounds = [0] + torch.cumsum(counts, 0).tolist()
    segs = [(a[bounds[i]:bounds[i + 1]], w_all[i]) for i in range(e)
            if bounds[i + 1] > bounds[i]]
    return (lambda: [torch.matmul(xa, w) for xa, w in segs],
            "sum of per-expert torch.matmul")


def _expert_planes(torch, rng, kind: str, e: int, n: int, k: int):
    """Stacked expert planes [E, ...] on the card with the layout of the
    loader's _repack_3d: 'u4+min' as Q4_K repacks (u4 nibbles, group 32,
    bf16 scale and min), 'int8' as Q6_K (int8 in [-32, 31], group 16).
    Drawn on the device: the kernel checks need the shapes and value
    ranges, and host repacking of 16 Mixtral experts costs minutes."""
    from llama_cpp_test_tpu_torch.quant.repack import QTensor

    g = torch.Generator(device="cuda")
    g.manual_seed(int(rng.integers(1 << 30)))
    pack, group = (2, 32) if kind == "u4+min" else (1, 16)
    npk = n // pack
    if pack == 2:
        qs = torch.randint(0, 256, (e, k, npk), generator=g, device="cuda",
                           dtype=torch.uint8)
    else:
        qs = torch.randint(-32, 32, (e, k, npk), generator=g, device="cuda",
                           dtype=torch.int8)
    planes = (e, pack, k // group, npk)
    scale = (torch.rand(planes, generator=g, device="cuda") * 1e-3 + 5e-4) \
        .to(torch.bfloat16)
    min_ = (scale.float() * 7.5).to(torch.bfloat16) if pack == 2 else None
    return QTensor("u4" if pack == 2 else "int8", (n, k), n, group, qs,
                   scale, min_)


def torch_bf16(torch, a: np.ndarray):
    return torch.from_numpy(a.astype(np.float32)).to("cuda").to(torch.bfloat16)


def _sdpa_kv(fp, kpool, vpool, table, g):
    """Gathered, GQA-expanded K/V [B, H, S, D] for the library yardstick."""
    kk = fp.gather_pages(kpool, table).permute(0, 2, 1, 3)
    vv = fp.gather_pages(vpool, table).permute(0, 2, 1, 3)
    return (kk.repeat_interleave(g, dim=1).contiguous(),
            vv.repeat_interleave(g, dim=1).contiguous())


def phase_kernels(torch, timer) -> dict:
    """TinyLlama-1.1B: the five projections as Q4_K (u4 planes with a min)
    and Q8_0 (int8) at M in {1, 512}, decode attention at B in {1, 8},
    prefill attention at T = 512 and for a chunk after a cached prefix.
    Llama-3-8B (config #2): the widest projections and both attentions at
    D = 128, G = 4. Mixtral-8x7B (config #4): K4 on both expert
    projections, u4+min and int8, and K3 over q8_0 pages."""
    from llama_cpp_test_tpu_torch.gguf.constants import GGMLType
    from llama_cpp_test_tpu_torch.weights import qtensor_to_torch

    rng = np.random.default_rng(1234)
    kc = KernelChecks(torch, timer, rng)
    rep = {}
    labels = ("wqkv", "wo", "gate|up", "down", "lm_head")
    for gt, kind in ((GGMLType.Q4_K, "u4+min"), (GGMLType.Q8_0, "int8")):
        for label, qt in _qmm_planes(rng, TINYLLAMA, gt, labels).items():
            qt = qtensor_to_torch(qt, "cuda")
            # M = 3 and 8: the GEMV's 4- and 8-row variants (batched
            # decode); M = 40: a partial GEMM row tile (short prompts)
            for m in (1, 512) + ((3, 8, 40) if label == "wo" else ()):
                row = kc.qmm(label, kind, qt, m)
                if label == "gate|up" and kind == "u4+min":
                    rep[row["kernel"]] = row
    for b in (1, 8):
        rep["paged_decode"] = kc.paged_decode(TINYLLAMA, b)
    kc.flash_prefill(TINYLLAMA, t=100, start=300)
    rep["flash_prefill"] = kc.flash_prefill(TINYLLAMA)
    for label, qt in _qmm_planes(rng, LLAMA3_8B, GGMLType.Q4_K,
                                 ("gate|up", "down")).items():
        qt = qtensor_to_torch(qt, "cuda")
        for m in (1, 512):
            kc.qmm("8B " + label, "u4+min", qt, m)
    kc.paged_decode(LLAMA3_8B, 8)
    kc.flash_prefill(LLAMA3_8B)
    # Mixtral-8x7B: K4 on the expert stacks of gate/up (K=4096, N=14336)
    # and down (K=14336, N=4096) at M = 1 and 8 (decode, tile_m 8) and 512
    # (prefill, tile_m 64); K3 over q8_0 pages at Mixtral's geometry
    c, ff, e = MIXTRAL["n_embd"], MIXTRAL["n_ff"], MIXTRAL["n_expert"]
    for kind in ("u4+min", "int8"):
        for label, n, k in (("gate/up", ff, c), ("down", c, ff)):
            qt = _expert_planes(torch, rng, kind, e, n, k)
            for m in (1, 8, 512):
                row = kc.gmm("Mixtral " + label, kind, qt, m)
                if label == "gate/up" and kind == "u4+min" and m != 8:
                    rep[row["kernel"]] = row
            del qt
    rep["paged_decode_q8"] = kc.paged_decode(MIXTRAL, 8, q8=True)
    kc.paged_decode(MIXTRAL, 1, q8=True)
    check(not kc.failures, f"kernels outside their gate: {kc.failures}")
    return rep


def _decode_plane_bytes(w, hp) -> int:
    """Bytes one decode token (B = 1) must read: every dense matmul plane
    (the lm head and the layer projections) once, and per MoE layer the
    planes of the n_expert_used routed experts only (top-2 of 8 for
    Mixtral), not the whole stacks. The embedding row gather is ~0."""
    size = lambda qt: sum(t.numel() * t.element_size()
                          for t in (qt.qs, qt.scale, qt.min_) if t is not None)
    total = size(w.output)
    for lw in w.layers:
        for f in ("wqkv", "wq", "wk", "wv", "wo", "w_gateup", "w_gate",
                  "w_up", "w_down", "gate_inp"):
            if getattr(lw, f) is not None:
                total += size(getattr(lw, f))
        for f in ("gate_exps", "up_exps", "down_exps"):
            if getattr(lw, f) is not None:
                qt = getattr(lw, f)
                total += size(qt) * hp.n_expert_used // qt.qs.shape[0]
    return int(total)


def _serve_requests(torch, ctx, prompts, n_vocab, batch: int) -> list:
    """Three generate() requests one after another, then one batched decode
    step of `batch` sequences (short prompts). Returns per-request rates."""
    from llama_cpp_test_tpu_torch.runtime.engine import generate

    requests = []
    for p in prompts:
        t0 = time.time()
        gen = generate(ctx, p, 32)
        toks = [next(gen)]
        t_first = time.time()
        toks.extend(gen)
        t_end = time.time()
        check(len(toks) == 32, f"generate gave {len(toks)} tokens")
        requests.append({"prompt": len(p), "new": len(toks),
                         "prefill_tok_s": len(p) / (t_first - t0),
                         "decode_tok_s": (len(toks) - 1) / (t_end - t_first)})
    seqs = [ctx.new_seq() for _ in range(batch)]
    last = [ctx.prefill(s, prompts[i % 2][: 16 + 8 * i])
            for i, s in enumerate(seqs)]
    t0 = time.time()
    out = ctx.decode(seqs, [int(np.argmax(l)) for l in last])
    torch.cuda.synchronize()
    requests.append({"batched_decode_rows": batch,
                     "step_ms": (time.time() - t0) * 1e3})
    check(out.shape == (batch, n_vocab) and np.isfinite(out).all(),
          "batched decode logits not finite / wrong shape")
    for s in seqs:
        ctx.free_seq(s)
    return requests


@contextlib.contextmanager
def _record_routing():
    """Collect the expert ids (sorted per row) that moe_ffn routes each MoE
    layer's rows to, one [rows, top_k] array per layer call, by wrapping
    models.llama._moe_grouped while the block runs."""
    from llama_cpp_test_tpu_torch.models import llama

    orig, calls = llama._moe_grouped, []

    def record(xf, lw, hp, topi, topv, plain=False):
        calls.append(topi.sort(dim=-1).values.cpu().numpy())
        return orig(xf, lw, hp, topi, topv, plain)

    llama._moe_grouped = record
    try:
        yield calls
    finally:
        llama._moe_grouped = orig


def _trace(ctx, prompt, tokens=None):
    """One prefill (logits at every position) and four decode steps, on the
    given decode tokens or else greedy ones. Returns the logits of each
    step [rows, V], its routing [layers, rows, top_k] (None on a dense
    model) and the decode tokens."""
    s = ctx.new_seq()
    steps, toks = [], []
    with _record_routing() as calls:
        logits = ctx.prefill(s, prompt, all_logits=True)
        for i in range(5):
            if i:
                toks.append(tokens[i - 1] if tokens else
                            int(np.argmax(logits[-1])))
                logits = ctx.decode([s], toks[-1:])
            rows = logits.shape[0]
            steps.append((logits, np.stack(calls)[:, :rows] if calls else None))
            calls.clear()
    ctx.free_seq(s)
    return steps, toks


def _compare(steps_a, steps_b) -> dict:
    """Logits NMSE of b against a per step, over all rows and over the rows
    whose experts agree in every layer, with the count of rows (and of
    layer rows) whose routing differs."""
    out = {}
    for i, ((la, ra), (lb, rb)) in enumerate(zip(steps_a, steps_b)):
        diff = (np.zeros((1, la.shape[0]), bool) if ra is None
                else (ra != rb).any(-1))                  # [layers, rows]
        same = ~diff.any(0)
        out["prefill" if i == 0 else f"decode{i - 1}"] = {
            "rows": int(la.shape[0]), "nmse": nmse(la, lb),
            "nmse_last_row": nmse(la[-1], lb[-1]),
            "routing_changed_rows": int((~same).sum()),
            "routing_changed_layer_rows": int(diff.sum()),
            "first_changed_row": (int(np.argmin(same)) if not same.all()
                                  else None),
            "nmse_same_routing": (nmse(la[same], lb[same]) if same.any()
                                  else None)}
    return out


@contextlib.contextmanager
def _qmm_variant(variant):
    """ops.qmatmul.QMM_VARIANT set to variant (None: left as it is) while
    the block runs, as a user sets LLAMA_TPU_QMM_VARIANT."""
    from llama_cpp_test_tpu_torch.ops import qmatmul

    orig = qmatmul.QMM_VARIANT
    qmatmul.QMM_VARIANT = variant or orig
    try:
        yield
    finally:
        qmatmul.QMM_VARIANT = orig


@contextlib.contextmanager
def _record_kinds():
    """Count the K1 and K5 launches per plane kind ("K1 u2": n, ...) while
    the block runs, by wrapping the two launch wrappers of ops.qmatmul."""
    from llama_cpp_test_tpu_torch.ops import qmatmul

    tally = {}
    names = {"_qmm_planes_cuda": "K1", "_qmm_cache_cuda": "K5"}
    orig = {n: getattr(qmatmul, n) for n in names}

    def wrap(n):
        def launch(x2, qt):
            key = f"{names[n]} {qt.kind}"
            tally[key] = tally.get(key, 0) + 1
            return orig[n](x2, qt)
        return launch

    for n in names:
        setattr(qmatmul, n, wrap(n))
    try:
        yield tally
    finally:
        for n, f in orig.items():
            setattr(qmatmul, n, f)


def _label(kv, variant) -> str:
    return kv if variant is None else f"{kv}/{variant}"


def _kernels_vs_plain(model, prompt, contexts) -> tuple[dict, list]:
    """Logits at every position of one prefill and of four decode steps on
    the same tokens, through the kernels and through the plain path, per
    Context (KV type, qmm variant). Where a MoE router's top-2
    probabilities are near-tied, the kernels' rounding can send a row to
    another expert pair than the plain path does: that row is then another
    computation, not a kernel error. So the routing of every row is
    compared, and the gate holds the rows whose experts agree in every
    layer (and fails if fewer than half of a prefill's rows do). The plain
    path's q8_0 prefill against its bf16 one is recorded beside, as the
    witness of what int8 K/V alone moves. Returns the readings and the
    steps outside the gate."""
    from llama_cpp_test_tpu_torch.runtime.engine import Context

    out, plain, bad = {}, {}, []
    for kv, variant in contexts:
        label = _label(kv, variant)
        ctx = lambda **kw: Context(model, n_ctx=1024, n_seq_max=2,
                                   block_size=16, kv_type=kv, **kw)
        with _qmm_variant(variant):
            steps_k, toks = _trace(ctx(), prompt)
        steps_p, _ = _trace(ctx(plain=True), prompt, toks)
        check(all(np.isfinite(lg).all() for lg, _ in steps_k),
              f"{label}: kernel logits not finite")
        plain[label] = steps_p
        out[label] = _compare(steps_p, steps_k)
        for step, r in out[label].items():
            v = r["nmse_same_routing"]
            if (v is not None and not v < LOGITS_GATE) or (
                    step == "prefill" and 2 * r["routing_changed_rows"]
                    > r["rows"]):
                bad.append((label, step, v, r["routing_changed_rows"]))
    if "q8_0" in plain and "bf16" in plain:
        out["plain_q8_0_vs_bf16"] = _compare(plain["bf16"][:1],
                                             plain["q8_0"][:1])["prefill"]
    return out, bad


def _serve(torch, name, hp, seed, contexts, batch, path_kernels, profile,
           ftype="Q4_K", kinds=(), rows=None):
    """Synthesize the GGUF, load it with Model(path) on cuda, serve every
    Context (KV type, qmm variant) with the launch counts zeroed just
    before and read just after, then hold the kernels against the plain
    path. path_kernels must launch over the phase; a "cache" Context must
    launch K5; every plane kind in `kinds` must reach K1. rows(model), if
    given, runs after the checks (kernel rows on the loaded planes)."""
    from llama_cpp_test_tpu_torch.ops import _cuda
    from llama_cpp_test_tpu_torch.runtime.engine import Context, Model

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        path = os.path.join(tmp, name.replace("/", "_") + ".gguf")
        t0 = time.time()
        write_llama_gguf(path, hp, seed=seed, ftype=ftype)
        write_s = time.time() - t0
        model = Model(path, device="cuda")
        os.remove(path)
        rng = np.random.default_rng(11)
        prompts = [rng.integers(3, hp["n_vocab"], size=n).tolist()
                   for n in (16, 130, 512)]
        requests, by_ctx, kind_launches = {}, {}, {}
        for kv, variant in contexts:
            label = _label(kv, variant)
            torch.cuda.synchronize()
            _cuda.reset_launches()
            with _qmm_variant(variant), _record_kinds() as tally:
                ctx = Context(model, n_ctx=1024, n_seq_max=batch,
                              block_size=16, kv_type=kv)
                requests[label] = _serve_requests(torch, ctx, prompts,
                                                  hp["n_vocab"], batch)
                del ctx
                torch.cuda.synchronize()
            by_ctx[label] = dict(_cuda.LAUNCHES)
            kind_launches[label] = tally
            cache = by_ctx[label]["qmm_cache"]
            check(cache > 0 if variant == "cache" else cache == 0,
                  f"{name}/{label}: qmm_cache launched {cache} times")
        launches = {k: sum(c[k] for c in by_ctx.values())
                    for k in _cuda.LAUNCHES}
        missing = [k for k in path_kernels if launches[k] <= 0]
        check(not missing, f"{name}: kernels not launched on the path: "
                           f"{missing} ({launches})")
        reached = {key.split()[1] for t in kind_launches.values()
                   for key in t if key.startswith("K1")}
        check(set(kinds) <= reached, f"{name}: plane kinds {sorted(kinds)} "
                                     f"should reach K1; reached {reached}")
        checks, bad = _kernels_vs_plain(model, prompts[1], contexts)
        plane_bytes = _decode_plane_bytes(model.weights, model.hp)
        out = {"phase": name, "n_layer": hp["n_layer"], "ftype": ftype,
               "write_gguf_s": write_s, "load_s": model.load_seconds,
               "decode_weight_bytes": plane_bytes,
               "decode_bound_tok_s": PEAK_BYTES / plane_bytes,
               "requests": requests, "launches": launches,
               "launches_by_context": by_ctx,
               "kind_launches": kind_launches,
               "plain_vs_kernel_nmse": checks, "gate": LOGITS_GATE}
        emit(out)
        check(not bad, f"logits outside the gate: {bad}")
        if profile:
            for kv, variant in contexts:
                phase_profile(torch, model, hp["n_vocab"],
                              f"{name}/{_label(kv, variant)}", kv, variant)
        if rows is not None:
            out["rows"] = rows(model)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_serve(torch, profile: bool = False) -> dict:
    return _serve(torch, "serve", TINYLLAMA, 7, [("bf16", None)], 2,
                  DENSE_PATH, profile)


def phase_serve_moe(torch, profile: bool = False) -> dict:
    return _serve(torch, "serve_moe", MIXTRAL, 8,
                  [("bf16", None), ("q8_0", None)], 8, MOE_PATH, profile)


def _projections(model):
    """(label, planes) of layer 0's projections and of the lm head."""
    lw, w = model.weights.layers[0], model.weights
    cand = (("wqkv", lw.wqkv), ("wq", lw.wq), ("wv", lw.wv), ("wo", lw.wo),
            ("gate|up", lw.w_gateup), ("down", lw.w_down),
            ("lm_head", w.output))
    return [(label, qt) for label, qt in cand if qt is not None]


def _model_rows(kc, model, prefix, k5=()):
    """K1 rows at M = 1, 8 and 512 on each projection of the served planes
    whose kind this slice brought to K1 (u2, u4lut, u2lut), and on the
    projections labelled in k5 a K5 row at M = 512 beside K1's GEMM."""
    rows = {}
    for label, qt in _projections(model):
        kind = f"{qt.ggml_type.name}/{qt.kind}" + ("+min" if qt.min_ is not
                                                    None else "")
        new_kind = qt.kind in ("u2", "u4lut", "u2lut")
        for m in (1, 8, 512) if new_kind else (512,) if label in k5 else ():
            rows[f"{label} M={m}"] = kc.qmm(f"{prefix} {label}", kind, qt, m)
        if label in k5:
            rows[f"{label} K5"] = kc.qmm(f"{prefix} {label}", kind, qt, 512,
                                         cache=True)
    check(not kc.failures, f"kernels outside their gate: {kc.failures}")
    return rows


def phase_serve_iq4xs(torch, kc, profile: bool = False) -> dict:
    return _serve(torch, "serve_iq4xs", LLAMA3_70B, 9, [("bf16", None)], 8,
                  DENSE_PATH, profile, ftype="IQ4_XS", kinds=("u4lut",),
                  rows=lambda model: _model_rows(kc, model, "70B"))


def phase_serve_lowbit(torch, kc, profile: bool = False) -> dict:
    """The Q2_K and IQ1_S files, each served at the default variant and at
    "cache"; launches are summed over both files."""
    contexts = [("bf16", None), ("bf16", "cache")]
    k5 = ("wqkv", "wq", "gate|up", "lm_head")
    files = {
        ftype: _serve(torch, f"serve_lowbit/{ftype}", LLAMA3_8B_LOWBIT, seed,
                      contexts, 8, DENSE_PATH + ("qmm_cache",), profile,
                      ftype=ftype, kinds=kinds,
                      rows=lambda model, f=ftype: _model_rows(
                          kc, model, f"8B {f}", k5=k5))
        for ftype, seed, kinds in (("Q2_K", 10, ("u2",)),
                                   ("IQ1_S", 12, ("u2lut", "u4lut")))}
    launches = {k: sum(f["launches"][k] for f in files.values())
                for k in files["Q2_K"]["launches"]}
    return {"launches": launches, "files": files}


_PORT_KERNELS = ("qmm_gemv_kernel", "qmm_gemm_kernel", "qmm_cache_kernel",
                 "flash_prefill_kernel", "paged_decode_kernel",
                 "gmm_gemv_kernel", "gmm_gemm_kernel")


def phase_profile(torch, model, n_vocab, label, kv_type,
                  variant=None) -> dict:
    """torch.profiler over 8 decode steps (after a 130-token prefill) and
    over one 512-token prefill, at the Context's qmm variant: wall time,
    device busy time, idle share, the port's kernels' share and the top
    device kernels."""
    with _qmm_variant(variant):
        return _profile_runs(torch, model, n_vocab, label, kv_type)


def _profile_runs(torch, model, n_vocab, label, kv_type) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from llama_cpp_test_tpu_torch.runtime.engine import Context

    ctx = Context(model, n_ctx=1024, n_seq_max=2, block_size=16,
                  kv_type=kv_type)
    rng = np.random.default_rng(5)
    prompt = rng.integers(3, n_vocab, size=512).tolist()
    s = ctx.new_seq()
    logits = ctx.prefill(s, prompt[:130])
    logits = ctx.decode([s], [int(np.argmax(logits))])[0]   # warm-up
    s2 = ctx.new_seq()
    state = {"logits": logits}

    def decode8():
        for _ in range(8):
            state["logits"] = ctx.decode([s], [int(np.argmax(state["logits"]))])[0]

    runs = {"decode_8_steps": decode8,
            "prefill_512": lambda: ctx.prefill(s2, prompt)}
    out = {"phase": "profile", "path": label}
    for name, fn in runs.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.time() - t0) * 1e3
        dev = []   # device-side events only (kernels, memsets, copies)
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:
                continue
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
            if us > 0:
                dev.append((ev.key, int(ev.count), float(us)))
        busy_ms = sum(us for _, _, us in dev) / 1e3
        port_ms = sum(us for k, _, us in dev
                      if any(p in k for p in _PORT_KERNELS)) / 1e3
        dev.sort(key=lambda e: -e[2])
        out[name] = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                     "idle_share": 1.0 - busy_ms / wall_ms,
                     "port_kernels_ms": port_ms,
                     "device_kernel_launches": sum(c for _, c, _ in dev),
                     "top": [{"name": k[:80], "count": c, "ms": us / 1e3}
                             for k, c, us in dev[:8]]}
    check(out["decode_8_steps"]["device_busy_ms"] > 0,
          "the profiler saw no device time")
    emit(out)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="after each serve phase, profile decode steps and a "
                         "512-token prefill with torch.profiler")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import llama_cpp_test_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script ({e})",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        dev = phase_device(torch)
        phase_build()
        timer = Timer(torch)
        rep = phase_kernels(torch, timer)
        kc = KernelChecks(torch, timer, np.random.default_rng(4321))
        serves = {"serve": phase_serve(torch, args.profile),
                  "serve_moe": phase_serve_moe(torch, args.profile),
                  "serve_iq4xs": phase_serve_iq4xs(torch, kc, args.profile),
                  "serve_lowbit": phase_serve_lowbit(torch, kc, args.profile)}
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    rep["qmm_cache"] = serves["serve_lowbit"]["files"]["Q2_K"]["rows"][
        "gate|up K5"]
    kernels = []
    for name, (src, replaces) in TPU_KERNELS.items():
        r = rep[name]
        # launches: the path of the slice that ported the kernel (dense for
        # K1-K3, MoE for K4 and K3-q8, the low-bit cache Contexts for K5);
        # launches_by_path: every path
        own = OWN_PATH.get(name, "serve")
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "shape": r["shape"],
                        "launches": serves[own]["launches"][name],
                        "launches_by_path": {p: v["launches"][name]
                                             for p, v in serves.items()},
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    emit({"kernels": kernels})
    print(dev["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
