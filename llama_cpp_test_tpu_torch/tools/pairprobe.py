"""K-paired-nibble dequant probe on one GPU (counterpart of
tools/pairprobe.py).

The probe packs the nibbles of two K-adjacent weight rows in one byte and
builds both bf16 weights 128 + q from it, folding the offset and the
affine min into one f32 term per group:

    qs   [K/2, N] u8: byte row r holds K-row 2r (low nibble) and 2r + 1
         (high nibble)
    w    = bf16(bf16(128 + q) * s[k // 32, n])      s [K/32, N] bf16
    y    = x . w - xsum . fold                      fold [K/32, N] f32,
         xsum[m, g] = sum of x[m, k] over group g

On a CUDA tensor `pairs_qmm` launches csrc/pairprobe.cu (pairs_gemv: the
M = 8 GEMV body of csrc/probe_gemv.cuh, a producer warp's TMA ring of
plane, scale and fold rows, mma.sync with the byte's two nibbles as the K
pair of one A register times (s, s), the fold subtracted per group in f32,
K split across a cluster; launch plan tools.probe_plan at a column tile of
32 * cpl); on a CPU tensor it runs the plain version. The entry point
checks the kernel against the float golden (`correctness_check`, as the
JAX probe does), then times the port's K1 on a Q4_K-like [4096 -> 16384]
weight against the pairs kernel at three block widths, with the 50 MB L2
flushed before each launch and the card's 3.35 TB/s roofline beside:

    python -m llama_cpp_test_tpu_torch.tools.pairprobe
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import _cuda
from . import HBM_BW, L2FlushedTimer, card, probe_plan

C, N = 4096, 16384
GROUP = 32
M = 8
BLOCK_CPL = (2, 4, 8)   # columns a lane: blocks of 64, 128, 256 columns


def pairs_qmm_plain(x: torch.Tensor, qs: torch.Tensor, sc: torch.Tensor,
                    fold: torch.Tensor) -> torch.Tensor:
    """Plain version of pairs_gemv: x [M, K], qs [K/2, N] -> f32 [M, N]."""
    q32 = qs.to(torch.int32)
    q = torch.stack([q32 & 0xF, q32 >> 4], dim=1).reshape(-1, qs.shape[1])
    s_rep = torch.repeat_interleave(sc.float(), GROUP, dim=0)
    w = ((128 + q).float() * s_rep).to(torch.bfloat16).float()
    xf = x.to(torch.bfloat16).float()
    xsum = xf.reshape(x.shape[0], -1, GROUP).sum(-1)
    return xf @ w - xsum @ fold.float()


def pairs_qmm(x: torch.Tensor, qs: torch.Tensor, sc: torch.Tensor,
              fold: torch.Tensor, cpl: int = 4) -> torch.Tensor:
    """The pairs probe: on a CUDA tensor the kernel at a block width of
    32 * cpl columns (cpl in BLOCK_CPL), on a CPU tensor its plain
    version."""
    if x.device.type == "cpu":
        return pairs_qmm_plain(x, qs, sc, fold)
    req = _cuda.require
    kb, n = qs.shape
    k = 2 * kb
    req(cpl in BLOCK_CPL, f"pairs_gemv: cpl {cpl} (takes {BLOCK_CPL})")
    req(x.is_cuda and x.dtype == torch.bfloat16 and x.is_contiguous()
        and tuple(x.shape) == (M, k), f"pairs_gemv: x must be CUDA bf16 "
                                      f"[{M}, {k}]")
    req(qs.device == x.device and qs.dtype == torch.uint8
        and qs.is_contiguous(), "pairs_gemv: qs must be contiguous u8")
    for name, t, dt in (("scales", sc, torch.bfloat16),
                        ("fold", fold, torch.float32)):
        req(t.device == x.device and t.dtype == dt and t.is_contiguous()
            and tuple(t.shape) == (k // GROUP, n),
            f"pairs_gemv: {name} must be {dt} [{k // GROUP}, {n}]")
    req(k > 0 and k % GROUP == 0 and n > 0 and n % (32 * cpl) == 0,
        f"pairs_gemv: unsupported K={k} N={n} cpl={cpl}")
    out = torch.empty((M, n), dtype=torch.float32, device=x.device)
    plan = probe_plan("PAIRS", k, n, _cuda.sm_count(x.device), tile=32 * cpl)
    fn = _cuda.bind("pairprobe", "pairs_gemv", "pipippipp" "iiiiii")
    _cuda.check(fn(x.data_ptr(), k, qs.data_ptr(), n, sc.data_ptr(),
                   fold.data_ptr(), cpl, out.data_ptr(),
                   _cuda.stream_ptr(x.device), *plan.args()), "pairs_gemv")
    _cuda.LAUNCHES["pairs_qmm"] += 1
    return out


def make_data(rng, device, k: int = C, n: int = N):
    """The probe's random operands on device: qs [k/2, n] u8, bf16 scales
    and the f32 fold [k/32, n] (pairprobe's recipe)."""
    qs = torch.from_numpy(rng.integers(0, 256, (k // 2, n), dtype=np.uint8))
    sc = torch.from_numpy((rng.standard_normal((k // GROUP, n)) * 0.01)
                          .astype(np.float32)).to(torch.bfloat16)
    fold = torch.from_numpy((rng.standard_normal((k // GROUP, n)) * 0.01)
                            .astype(np.float32))
    return qs.to(device), sc.to(device), fold.to(device)


def golden_case(k: int = 512, n: int = 512, seed: int = 0):
    """The JAX probe's correctness_check inputs as numpy: x [8, k], the
    K-paired bytes, bf16-rounded scales (f32), the fold and the float
    golden y = x . (s*q - min)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 16, (k, n), dtype=np.uint8)
    s = (rng.standard_normal((k // GROUP, n)) * 0.02).astype(np.float32)
    mn = (rng.standard_normal((k // GROUP, n)) * 0.01).astype(np.float32)
    x = rng.standard_normal((M, k)).astype(np.float32)
    ref = x @ (np.repeat(s, GROUP, 0) * q - np.repeat(mn, GROUP, 0))
    qs = (q[0::2] | (q[1::2] << 4)).astype(np.uint8)
    s_b = torch.from_numpy(s).to(torch.bfloat16).float().numpy()
    fold = (mn + 128.0 * s_b).astype(np.float32)
    return x, qs, s_b, fold, ref


def correctness_check(device="cuda") -> bool:
    """pairs_qmm (the kernel on a CUDA device, else the plain version)
    against the float golden at K = N = 512: max error over max |golden|
    below 0.05 (bf16 rounding of x and of w)."""
    x, qs, s_b, fold, ref = golden_case()
    dv = lambda a: torch.from_numpy(a).to(device)
    bf = lambda a: dv(a).to(torch.bfloat16)
    y = pairs_qmm(bf(x), dv(qs), bf(s_b), dv(fold)).cpu().numpy()
    rel = float(np.abs(y - ref).max() / np.abs(ref).max())
    print(f"pairs correctness: max rel err {rel:.5f} "
          f"(expect ~1e-2 from bf16 x rounding)")
    return rel < 0.05


def mk_q4k(n: int, k: int, rng, device, mult: int = 512):
    """Random Q4_K-like planes (u4 + bf16 scale and min), layout 't', on
    device, and their bytes (tools/dbench.mk_q4k's recipe)."""
    from ..quant.repack import QTensor

    npk = (n + (-n % mult)) // 2
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(device) \
        .to(torch.bfloat16)
    qs = torch.from_numpy(rng.integers(0, 256, (k, npk), dtype=np.uint8)) \
        .to(device)
    sc = bf(rng.standard_normal((2, k // GROUP, npk)) * 0.01)
    mn = bf(rng.standard_normal((2, k // GROUP, npk)) * 0.001)
    qt = QTensor("u4", (npk * 2, k), n, GROUP, qs, sc, mn, None)
    return qt, qs.numel() + sc.numel() * 2 + mn.numel() * 2


def main() -> int:
    if not torch.cuda.is_available():
        print("pairprobe: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from ..ops import qmatmul

    dev = torch.device("cuda")
    print(f"card: {card()}  (median of single launches, L2 flushed; "
          f"roofline {HBM_BW / 1e12:.2f} TB/s)")
    if not correctness_check(dev):
        print("FAIL: pairs kernel wrong")
        return 1
    timer = L2FlushedTimer(dev)
    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(rng.standard_normal((M, C)).astype(np.float32)) \
        .to(dev).to(torch.bfloat16)
    qt, nb = mk_q4k(N, C, rng, dev)
    dt = timer(lambda: qmatmul.qmm(x0, qt)) / 1e3
    print(f"current (K1): {dt * 1e3:7.3f} ms  {nb / dt / 1e9:6.1f} GB/s  "
          f"({100 * nb / dt / HBM_BW:5.1f}% of roofline)", flush=True)

    qs, sc, fold = make_data(rng, dev)
    nb2 = qs.numel() + sc.numel() * 2 + fold.numel() * 4
    for cpl in BLOCK_CPL:
        dt = timer(lambda: pairs_qmm(x0, qs, sc, fold, cpl=cpl)) / 1e3
        print(f"pairs block={32 * cpl:3d} cols: {dt * 1e3:7.3f} ms  "
              f"{nb2 / dt / 1e9:6.1f} GB/s  ({100 * nb2 / dt / HBM_BW:5.1f}% "
              f"of roofline, {nb2 / 1e6:.1f} MB)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
