"""Decode-qmm microbenchmark on one GPU (counterpart of tools/kbench.py).

Times M = 8 dequant-matmuls over a Q4_K-like weight, y[8, N] = x[8, K] .
w[K, N] with w = s[k // 32, n] * q[k, n], against the card's HBM roofline:

  E  a raw byte stream (kernel csrc/kbench.cu kbench_stream; kbench's kern):
     column sums of a u8 [rows, 1024] array. One launch: a cluster of 8
     row slabs a 64-byte column group, fed by 2-D TMA boxes, integer sums,
     one store a column. At 12.6 MB it reads at about 1 TB/s on an H100,
     below what torch.matmul reaches over its 46 MB (the launch and the
     first bytes' latency weigh on a small read), so no row is reported as
     a share of it: every row is a share of the roofline
  C  torch.matmul on the weight dequantized to bf16 (2 bytes a weight)
  repo qmm u4+min / u4 no-min: the port's K1 (ops/qmatmul) on Q4_K- and
     Q4_0-shaped planes
  F  N-paired nibbles (kbench's kernel_f), G signed int4 (kernel_g), H int8
     (kernel_h): one GEMV body (csrc/probe_gemv.cuh, entry kbench_gemv): a
     producer warp's TMA ring, x staged in shared memory, mma.sync with the
     weight rounded inside the A operand, K split across a cluster summed
     in distributed shared memory; launch plan tools.probe_plan

Weight layouts (K rows, N columns, q in [0, 16), group 32 along K):

  F  qs [K, N/2] u8: byte (k, j) holds column j in its low nibble and
     column j + N/2 in its high one; scales [2, K/32, N/2] bf16, plane h
     for the columns h*N/2 + j; output [8, 2, N/2] (column h*N/2 + j at
     [:, h, j])
  G  q - 8 as signed int4, two a byte (torch has no int4 tensor): qs
     [K, N/2] u8, byte (k, j) holds column 2j in its low nibble and 2j + 1
     in its high one, each a 4-bit two's complement; scales [K/32, N];
     output [8, N]
  H  q as int8 [K, N]; scales [K/32, N]; output [8, N]

Each kernel rounds w = bf16(bf16(q) * s) per element, as the TPU kernels
do, and accumulates in float32; one launch a call, no memset, no atomics.
Every kernel has its plain PyTorch version here; a CPU tensor takes it, a
CUDA tensor launches the kernel.

Times are medians of single launches (tools.L2FlushedTimer: the 50 MB L2
flushed before each, since the 13-25 MB weights would otherwise be read
from L2), printed beside the timer's floor (one empty kernel). The
roofline is the card's HBM rate (H100 SXM data sheet: 3.35 TB/s). Run on
a machine with a GPU:

    python -m llama_cpp_test_tpu_torch.tools.kbench
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import _cuda
from . import HBM_BW, L2FlushedTimer, card, probe_plan

M, K, N = 8, 2048, 11264   # fused gate+up of TinyLlama-1.1B
GROUP = 32
STREAM_TILE = 512          # kbench's row tile of the stream probe
STREAM_COLS = 128          # columns the stream probe keeps
FORMATS = {"F": 0, "G": 1, "H": 2}
# kbench's stream array: the F weight's bytes (nibbles and bf16 scales) as
# rows of 1024
STREAM_SHAPE = ((K * N // 2 + (K // GROUP) * N * 2) // 1024, 1024)


def make_data(seed: int = 0, k: int = K, n: int = N):
    """kbench's inputs as numpy: x [8, k] f32, q [k, n] u8 in [0, 16), s
    [k/32, n] f32 (x is rounded to bf16 where it is used)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, k)).astype(np.float32)
    q = rng.integers(0, 16, size=(k, n), dtype=np.uint8)
    s = rng.standard_normal((k // GROUP, n)).astype(np.float32) * 0.01
    return x, q, s


def pack(fmt: str, q: np.ndarray, s: np.ndarray):
    """(qs u8/int8, scales f32) of format fmt from q [K, N], s [K/32, N]."""
    k, n = q.shape
    if fmt == "F":
        qs = (q[:, : n // 2] | (q[:, n // 2:] << 4)).astype(np.uint8)
        sgm = s.T.reshape(2, n // 2, k // GROUP).transpose(0, 2, 1)
        return qs, np.ascontiguousarray(sgm)
    if fmt == "G":
        nib = (q.astype(np.int8) - 8).astype(np.uint8) & 0xF
        return (nib[:, 0::2] | (nib[:, 1::2] << 4)).astype(np.uint8), s
    if fmt == "H":
        return q.astype(np.int8), s
    raise ValueError(fmt)


def _rounded_w(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """w = bf16(q * s) as float32, s [K/32, n] repeated over groups of 32
    rows of q [K, n] (q exact in bf16, so bf16(bf16(q) * s) too)."""
    s_rep = torch.repeat_interleave(s.float(), GROUP, dim=0)
    return (q.float() * s_rep).to(torch.bfloat16).float()


def probe_gemv_plain(fmt: str, x: torch.Tensor, qs: torch.Tensor,
                     sc: torch.Tensor) -> torch.Tensor:
    """Plain version of kbench_gemv (formats in the module docstring)."""
    xf = x.to(torch.bfloat16).float()
    if fmt == "F":
        q32 = qs.to(torch.int32)
        return torch.stack([xf @ _rounded_w((q32 >> (4 * h)) & 0xF, sc[h])
                            for h in range(2)], dim=1)
    if fmt == "G":
        q32 = qs.to(torch.int32)
        nib = torch.stack([q32 & 0xF, q32 >> 4], dim=-1).reshape(
            qs.shape[0], -1)
        return xf @ _rounded_w(nib - 16 * (nib >= 8), sc)
    if fmt == "H":
        return xf @ _rounded_w(qs, sc)
    raise ValueError(fmt)


def probe_gemv(fmt: str, x: torch.Tensor, qs: torch.Tensor,
               sc: torch.Tensor) -> torch.Tensor:
    """kbench's kernel_f / kernel_g / kernel_h (fmt "F" / "G" / "H"): on a
    CUDA tensor the kernel, on a CPU tensor its plain version."""
    if x.device.type == "cpu":
        return probe_gemv_plain(fmt, x, qs, sc)
    req = _cuda.require
    req(fmt in FORMATS, f"kbench_gemv: format {fmt!r}")
    k, nbc = qs.shape
    n = 2 * nbc if fmt in "FG" else nbc
    sshape = (2, k // GROUP, nbc) if fmt == "F" else (k // GROUP, n)
    req(x.is_cuda and x.dtype == torch.bfloat16 and x.is_contiguous()
        and tuple(x.shape) == (M, k), f"kbench_gemv: x must be CUDA bf16 "
                                      f"[{M}, {k}]")
    req(qs.device == x.device and qs.is_contiguous()
        and qs.dtype == (torch.int8 if fmt == "H" else torch.uint8),
        f"kbench_gemv {fmt}: bad qs {qs.dtype}")
    req(sc.device == x.device and sc.dtype == torch.bfloat16
        and sc.is_contiguous() and tuple(sc.shape) == sshape,
        f"kbench_gemv {fmt}: scales must be bf16 {sshape}")
    req(k > 0 and k % GROUP == 0 and nbc > 0 and nbc % 128 == 0,
        f"kbench_gemv: unsupported K={k} byte columns={nbc}")
    out = torch.empty((M, 2, nbc) if fmt == "F" else (M, n),
                      dtype=torch.float32, device=x.device)
    plan = probe_plan(fmt, k, nbc, _cuda.sm_count(x.device))
    fn = _cuda.bind("kbench", "kbench_gemv", "ipipippp" "iiiiii")
    _cuda.check(fn(FORMATS[fmt], x.data_ptr(), k, qs.data_ptr(), nbc,
                   sc.data_ptr(), out.data_ptr(), _cuda.stream_ptr(x.device),
                   *plan.args()), "kbench_gemv")
    _cuda.LAUNCHES["kbench_" + fmt.lower()] += 1
    return out


def stream_rows(rows: int) -> int:
    """Rows the stream probe reads: kbench's grid drops the tail tile."""
    return rows // STREAM_TILE * STREAM_TILE


def stream_colsum_plain(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Plain version of kbench_stream: out[0, j] = sum of a[r, j] over the
    rows read + (tiles read) * x[0, 0], j < 128; f32 [1, 128]."""
    used = stream_rows(a.shape[0])
    sums = a[:used].float().sum(0) + (used // STREAM_TILE) * x[0, 0].float()
    return sums[None, :STREAM_COLS]


def stream_colsum(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """kbench's streaming probe (build_e's kern): on a CUDA tensor the
    kernel, which reads every byte of the rows it covers and sums every
    column, keeping the first 128; on a CPU tensor its plain version."""
    if a.device.type == "cpu":
        return stream_colsum_plain(x, a)
    rows, cols = a.shape
    _cuda.require(a.is_cuda and a.dtype == torch.uint8 and a.is_contiguous()
                  and cols > 0 and cols % 128 == 0 and a.data_ptr() % 16 == 0,
                  f"kbench_stream: a must be contiguous 16-byte aligned CUDA "
                  f"u8 [rows, cols] with cols a multiple of 128, got "
                  f"{tuple(a.shape)}")
    _cuda.require(x.device == a.device and x.dtype == torch.float32
                  and x.is_contiguous(), "kbench_stream: x must be f32 on the "
                                         "card")
    out = torch.empty((1, cols), dtype=torch.float32, device=a.device)
    fn = _cuda.bind("kbench", "kbench_stream", "piippp")
    _cuda.check(fn(a.data_ptr(), rows, cols, x.data_ptr(), out.data_ptr(),
                   _cuda.stream_ptr(a.device)), "kbench_stream")
    _cuda.LAUNCHES["kbench_e"] += 1
    return out[:, :STREAM_COLS]


# ---------------------------------------------------------------------------
# timing and the entry point


def report(name: str, ms: float, nbytes: int) -> None:
    """One row: time, achieved rate and its share of the roofline."""
    dt = ms / 1e3
    gbs = nbytes / dt / 1e9
    print(f"{name:44s} {dt * 1e6:9.1f} us  {gbs:7.1f} GB/s  "
          f"({100 * gbs * 1e9 / HBM_BW:5.1f}% of roofline)", flush=True)


def device_tensors(fmt, x, q, s, dev):
    """x as bf16, and format fmt's qs and bf16 scales, on device dev."""
    qs, sc = pack(fmt, q, s)
    return (torch.from_numpy(x).to(dev).to(torch.bfloat16),
            torch.from_numpy(qs).to(dev),
            torch.from_numpy(sc).to(dev).to(torch.bfloat16))


def _repo_qmm(x, q, s, dev, with_min: bool):
    """The port's K1 on kbench's weight as Q4_K-shaped (u4 + min) or
    Q4_0-shaped (u4) planes: (callable, plane bytes)."""
    from ..ops import qmatmul
    from ..quant.repack import QTensor

    xt, qs, sgm = device_tensors("F", x, q, s, dev)
    mgm = (sgm.float() * 0.1).to(torch.bfloat16) if with_min else None
    qt = QTensor("u4", (N, K), N, GROUP, qs, sgm, mgm)
    nbytes = qs.numel() + sgm.numel() * 2 * (2 if with_min else 1)
    return (lambda: qmatmul.qmm(xt, qt)), nbytes


def main() -> int:
    if not torch.cuda.is_available():
        print("kbench: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(f"card: {card()}")
    print(f"shape: M={M} K={K} N={N} group={GROUP}  (median of single "
          f"launches, L2 flushed; roofline {HBM_BW / 1e12:.2f} TB/s)")
    timer = L2FlushedTimer(dev)
    print(f"timer floor (one empty kernel): "
          f"{timer(lambda: torch.cuda._sleep(0)) * 1e3:.1f} us", flush=True)
    x, q, s = make_data()
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    a = torch.randint(0, 256, STREAM_SHAPE, generator=g, dtype=torch.uint8,
                      device=dev)
    x0 = torch.zeros((1, STREAM_COLS), dtype=torch.float32, device=dev)
    e_bytes = stream_rows(a.shape[0]) * a.shape[1]
    report("E: raw HBM stream (kbench_stream)",
           timer(lambda: stream_colsum(x0, a)), e_bytes)

    xt = torch.from_numpy(x).to(dev).to(torch.bfloat16)
    w = torch.from_numpy(q.astype(np.float32)).to(dev).to(torch.bfloat16)
    report("C: dense bf16 matvec (torch.matmul)",
           timer(lambda: torch.matmul(xt, w)), w.numel() * 2)
    del w
    for name, with_min in (("repo: qmm u4+min (Q4_K planes)", True),
                           ("repo: qmm u4 no-min (Q4_0 planes)", False)):
        fn, nbytes = _repo_qmm(x, q, s, dev, with_min)
        report(name, timer(fn), nbytes)
    for fmt, name in (("F", "F: N-paired nibbles (kernel_f)"),
                      ("G", "G: signed int4, two a byte (kernel_g)"),
                      ("H", "H: int8 plane (kernel_h)")):
        xb, qs, sc = device_tensors(fmt, x, q, s, dev)
        nbytes = qs.numel() + sc.numel() * 2
        report(name, timer(lambda: probe_gemv(fmt, xb, qs, sc)), nbytes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
