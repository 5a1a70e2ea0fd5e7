"""The port's kernel probes (llama_cpp_test_tpu_torch/tools: kbench,
pairprobe) against the JAX package's Pallas probes on CPU.

Each probe's plain version (what a CPU tensor runs) is held against the
JAX kernel itself, tools/kbench.py kernel_f / kernel_g / kernel_h, build_e's
kern and tools/pairprobe.py _pairs_kernel, each run through its own
pl.pallas_call(..., interpret=True) at K = N = 512 (two K tiles, so the
kernels' accumulation branch runs) on seeded numpy inputs. Both sides round
w to bf16 per element and accumulate in float32: NMSE <= 1e-5. The pairs
plain version is also held against pairprobe's float golden
(correctness_check: max error over max |golden| < 0.05).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tools import kbench as jkbench
from tools import pairprobe as jpairs

from llama_cpp_test_tpu_torch.tools import kbench, pairprobe

GATE = 1e-5
K = N = 512
TILE_K = 256


def nmse(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(((a - b) ** 2).mean() / ((a * a).mean() + 1e-30))


def _jax_probe(fmt, x, qs, sc):
    """kbench's kernel_f/g/h over its own grid, tiles shrunk to K = N =
    512, interpreted."""
    kern = {"F": jkbench.kernel_f, "G": jkbench.kernel_g,
            "H": jkbench.kernel_h}[fmt]
    k, nc = qs.shape
    tn = 128
    tg = TILE_K // jkbench.GROUP
    grid = (1, nc // tn, k // TILE_K)
    if fmt == "F":
        s_spec = pl.BlockSpec((2, tg, tn), lambda mm, n, kk: (0, kk, n))
        o_spec = pl.BlockSpec((8, 2, tn), lambda mm, n, kk: (mm, 0, n))
        out_shape = (8, 2, nc)
    else:
        s_spec = pl.BlockSpec((tg, tn), lambda mm, n, kk: (kk, n))
        o_spec = pl.BlockSpec((8, tn), lambda mm, n, kk: (mm, n))
        out_shape = (8, nc)
    f = pl.pallas_call(
        kern, grid=grid,
        in_specs=[pl.BlockSpec((8, TILE_K), lambda mm, n, kk: (mm, kk)),
                  pl.BlockSpec((TILE_K, tn), lambda mm, n, kk: (kk, n)),
                  s_spec],
        out_specs=o_spec,
        out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        interpret=True)
    return np.asarray(f(x, qs, sc))


@pytest.mark.parametrize("fmt", ["F", "G", "H"])
def test_probe_gemv_plain_matches_pallas(fmt):
    x, q, s = kbench.make_data(seed=3, k=K, n=N)
    qs, sc = kbench.pack(fmt, q, s)
    xj = jnp.asarray(x, jnp.bfloat16)
    scj = jnp.asarray(sc, jnp.bfloat16)
    if fmt == "F":
        qj = jnp.asarray(qs)
    elif fmt == "G":       # the JAX probe's own layout: native int4 [K, N]
        qj = jnp.asarray(q.astype(np.int8) - 8, jnp.int4)
    else:
        qj = jnp.asarray(qs)
    ref = _jax_probe(fmt, xj, qj, scj)
    sc_t = torch.from_numpy(np.array(scj.astype(jnp.float32))) \
        .to(torch.bfloat16)
    got = kbench.probe_gemv(fmt, torch.from_numpy(x), torch.from_numpy(qs),
                            sc_t).numpy()
    assert got.shape == ref.shape
    assert nmse(ref, got) < GATE, nmse(ref, got)


def test_stream_plain_matches_pallas():
    """build_e's kern (taken from build_e's code, its globals kbench's) over
    1100 rows: two 512-row tiles read, the 76-row tail dropped."""
    code = next(c for c in jkbench.build_e.__code__.co_consts
                if isinstance(c, types.CodeType) and c.co_name == "kern")
    kern = types.FunctionType(code, vars(jkbench))
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, size=(1100, 1024), dtype=np.uint8)
    x = rng.standard_normal((1, 128)).astype(np.float32)
    f = pl.pallas_call(
        kern, grid=(a.shape[0] // 512,),
        in_specs=[pl.BlockSpec((1, 128), lambda i: (0, 0)),
                  pl.BlockSpec((512, 1024), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((1, 128), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((1, 128), jnp.float32),
        interpret=True)
    ref = np.asarray(f(jnp.asarray(x), jnp.asarray(a)))
    got = kbench.stream_colsum(torch.from_numpy(x), torch.from_numpy(a))
    assert got.shape == ref.shape == (1, 128)
    assert nmse(ref, got.numpy()) < GATE, nmse(ref, got.numpy())
    assert kbench.stream_rows(a.shape[0]) == 1024
    assert kbench.STREAM_SHAPE == (12672, 1024)


def test_pairs_plain_matches_pallas():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((8, K)).astype(np.float32)
    qs = rng.integers(0, 256, (K // 2, N), dtype=np.uint8)
    sc = jnp.asarray(rng.standard_normal((K // 32, N)) * 0.01, jnp.bfloat16)
    fold = (rng.standard_normal((K // 32, N)) * 0.01).astype(np.float32)
    tn, tg = 256, TILE_K // 32
    kidx = jax.lax.broadcasted_iota(jnp.int32, (TILE_K, tg), 0)
    gidx = jax.lax.broadcasted_iota(jnp.int32, (TILE_K, tg), 1)
    member = (kidx // 32 == gidx).astype(jnp.bfloat16)
    f = pl.pallas_call(
        jpairs._pairs_kernel, grid=(1, N // tn, K // TILE_K),
        in_specs=[
            pl.BlockSpec((8, TILE_K), lambda mm, nn, kk: (mm, kk)),
            pl.BlockSpec((TILE_K // 2, tn), lambda mm, nn, kk: (kk, nn)),
            pl.BlockSpec((tg, tn), lambda mm, nn, kk: (kk, nn)),
            pl.BlockSpec((tg, tn), lambda mm, nn, kk: (kk, nn)),
            pl.BlockSpec((TILE_K, tg), lambda mm, nn, kk: (0, 0))],
        out_specs=pl.BlockSpec((8, tn), lambda mm, nn, kk: (mm, nn)),
        out_shape=jax.ShapeDtypeStruct((8, N), jnp.float32),
        interpret=True)
    ref = np.asarray(f(jnp.asarray(x, jnp.bfloat16), jnp.asarray(qs), sc,
                       jnp.asarray(fold), member))
    sc_t = torch.from_numpy(np.array(sc.astype(jnp.float32))) \
        .to(torch.bfloat16)
    got = pairprobe.pairs_qmm(torch.from_numpy(x), torch.from_numpy(qs),
                              sc_t, torch.from_numpy(fold)).numpy()
    assert got.shape == ref.shape == (8, N)
    assert nmse(ref, got) < GATE, nmse(ref, got)


def test_pairs_plain_matches_float_golden():
    """pairprobe.correctness_check's case (the JAX probe, interpreted,
    reads 2.77e-2 on it, as the plain version does)."""
    assert pairprobe.correctness_check("cpu")
    x, qs, s_b, fold, ref = pairprobe.golden_case()
    got = pairprobe.pairs_qmm(torch.from_numpy(x), torch.from_numpy(qs),
                              torch.from_numpy(s_b).to(torch.bfloat16),
                              torch.from_numpy(fold)).numpy()
    assert float(np.abs(got - ref).max() / np.abs(ref).max()) < 0.05
