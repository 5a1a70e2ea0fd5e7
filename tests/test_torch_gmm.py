"""Port conformance of the grouped expert matmul (llama_cpp_test_tpu_torch
ops/gmm: route_tokens, combine, gmm_apply(_split), gmm_plain) against the
JAX package's ops/gmm on CPU: the Pallas kernel in interpret mode and its
XLA golden gmm_xla.

The same numpy-seeded routing and activations go to both sides; expert
stacks are quantized and repacked by the JAX package and carried across
with weights.port_qtensor. Routing plans must be equal exactly; products
within NMSE 2e-4 (tests/test_gmm.py:73).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from test_gmm import stacked_qtensor

from llama_cpp_test_tpu.gguf.constants import GGMLType
from llama_cpp_test_tpu.ops import gmm as jgmm
from llama_cpp_test_tpu.quant.repack import fuse_expert_qtensors as jfuse
from llama_cpp_test_tpu_torch.ops import gmm as pgmm
from llama_cpp_test_tpu_torch.quant.repack import fuse_expert_qtensors
from llama_cpp_test_tpu_torch.weights import port_qtensor, qtensor_to_torch

GATE = 2e-4


def nmse(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(((a - b) ** 2).mean() / ((a * a).mean() + 1e-12))


def routing_inputs(m, e_total, ku, seed):
    """Softmax top-k routing of random logits, as numpy."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((m, e_total)).astype(np.float32)
    topi = np.argsort(-logits, axis=1, kind="stable")[:, :ku]
    topv = np.take_along_axis(logits, topi, axis=1)
    topv = np.exp(topv - topv.max(1, keepdims=True))
    topv = (topv / topv.sum(1, keepdims=True)).astype(np.float32)
    return topi.astype(np.int32), topv


def both_routings(topi, topv, e_loc, offset, tile_m):
    jr = jgmm.route_tokens(jnp.asarray(topi), jnp.asarray(topv),
                           n_expert_local=e_loc, expert_offset=offset,
                           tile_m=tile_m)
    pr = pgmm.route_tokens(torch.from_numpy(topi), torch.from_numpy(topv),
                           n_expert_local=e_loc, expert_offset=offset,
                           tile_m=tile_m)
    return jr, pr


@pytest.mark.parametrize("m,tile_m", [(1, 8), (3, 8), (16, 8), (130, 64),
                                      (40, 64)])
@pytest.mark.parametrize("offset,e_loc", [(0, 8), (2, 4)],
                         ids=["all-local", "offset2"])
def test_route_tokens_plan_equals_reference(m, tile_m, offset, e_loc):
    """tok_idx, weight and tile_expert equal the JAX plan exactly, with and
    without assignments that belong to another shard."""
    topi, topv = routing_inputs(m, 8, 2, seed=m + offset)
    jr, pr = both_routings(topi, topv, e_loc, offset, tile_m)
    t = pgmm.num_tiles(m, 2, e_loc, tile_m)
    assert pr.tile_expert.shape == (t,) and pr.tok_idx.shape == (t * tile_m,)
    np.testing.assert_array_equal(np.asarray(jr.tok_idx), pr.tok_idx.numpy())
    np.testing.assert_array_equal(np.asarray(jr.weight), pr.weight.numpy())
    np.testing.assert_array_equal(np.asarray(jr.tile_expert),
                                  pr.tile_expert.numpy())


@pytest.mark.parametrize("m,tile_m,offset,e_loc", [
    (16, 8, 0, 8), (130, 64, 0, 8), (16, 8, 4, 4), (5, 8, 0, 8)])
def test_route_tokens_plan_invariants(m, tile_m, offset, e_loc):
    """tests/test_gmm.py:118's invariants (each local (token, expert) weight
    recovered exactly once, in a tile owned by that expert), and the port's
    tile_rows: live rows lead their tile, dead tiles hold none."""
    topi, topv = routing_inputs(m, 8, 2, seed=3)
    _, rt = both_routings(topi, topv, e_loc, offset, tile_m)
    tok, wgt = rt.tok_idx.numpy(), rt.weight.numpy()
    te, rows = rt.tile_expert.numpy(), rt.tile_rows.numpy()
    seen = {}
    for r in range(tok.shape[0]):
        if wgt[r] == 0:
            continue
        assert r % tile_m < rows[r // tile_m]
        key = (int(tok[r]), int(te[r // tile_m]) + offset)
        seen[key] = seen.get(key, 0.0) + float(wgt[r])
    want = {(i, int(topi[i, j])): float(topv[i, j]) for i in range(m)
            for j in range(2) if offset <= topi[i, j] < offset + e_loc}
    assert set(seen) == set(want)
    for key in want:
        assert abs(seen[key] - want[key]) < 1e-6
    assert rows.sum() == len(want)
    live = np.nonzero(rows)[0]
    assert (np.diff(te[live]) >= 0).all()          # segments sorted by expert
    if len(live) < len(rows):                      # dead tail clamps to last
        assert (te[live[-1] + 1:] == te[live[-1]]).all()
        assert (rows[live[-1] + 1:] == 0).all()


@pytest.mark.parametrize("m,tile_m", [(16, 8), (130, 64)])
@pytest.mark.parametrize("gt", [
    GGMLType.Q4_K, GGMLType.Q8_0, GGMLType.Q6_K, GGMLType.Q4_0,
    GGMLType.Q2_K, GGMLType.IQ4_XS, GGMLType.IQ2_XXS, GGMLType.IQ1_S,
    GGMLType.TQ2_0, GGMLType.F16, GGMLType.BF16], ids=lambda t: t.name)
def test_gmm_plain_matches_reference(gt, m, tile_m):
    """gmm_plain and the CPU gmm (its plain version) against JAX gmm in
    interpret mode and gmm_xla, on every plane kind: int8, u4 (with and
    without a min), u2 with a min (Q2_K), u4lut (IQ4_XS, IQ2_XXS), u2lut
    (IQ1_S; TQ2_0 at group 256) and dense bf16 stacks (F16, BF16)."""
    e, k, n = 4, 256, 256
    rng = np.random.default_rng(int(gt) + m)
    jqt = stacked_qtensor(e, n, k, gt, rng)
    pqt = qtensor_to_torch(port_qtensor(jqt), "cpu")
    x = (rng.standard_normal((m, k)) * 0.3).astype(np.float32)
    topi, topv = routing_inputs(m, e, 2, seed=m)
    jr, pr = both_routings(topi, topv, e, 0, tile_m)
    ref = np.asarray(jgmm.gmm(jnp.asarray(x), jqt, jr, tile_m=tile_m,
                              interpret=True))
    xla = np.asarray(jgmm.gmm_xla(jnp.asarray(x), jqt, jr))
    xt = torch.from_numpy(x)
    got = pgmm.gmm_plain(xt, pqt, pr, tile_m=tile_m).numpy()
    assert got.shape == ref.shape == (m, n)
    assert nmse(ref, got) < GATE, nmse(ref, got)
    assert nmse(xla, got) < GATE, nmse(xla, got)
    np.testing.assert_array_equal(
        pgmm.gmm(xt, pqt, pr, tile_m=tile_m).numpy(), got)


@pytest.mark.parametrize("m,tile_m", [(16, 8), (130, 64)])
@pytest.mark.parametrize("gt", [GGMLType.Q4_K, GGMLType.Q2_K],
                         ids=lambda t: t.name)
def test_gmm_plain_fold_rounds_as_pallas(gt, m, tile_m):
    """With the min folded (rounding "fold") the plain version rounds as
    _gmm_kernel and K4 do: bf16(s*q), then the x-sums . min in f32. It
    meets JAX gmm in interpret mode to float32 summation order, far closer
    than the default joint rounding (gmm_xla's) does."""
    e, k, n = 4, 256, 256
    rng = np.random.default_rng(int(gt) + m)
    jqt = stacked_qtensor(e, n, k, gt, rng)
    pqt = qtensor_to_torch(port_qtensor(jqt), "cpu")
    assert pqt.min_ is not None
    x = (rng.standard_normal((m, k)) * 0.3).astype(np.float32)
    topi, topv = routing_inputs(m, e, 2, seed=m)
    jr, pr = both_routings(topi, topv, e, 0, tile_m)
    ref = np.asarray(jgmm.gmm(jnp.asarray(x), jqt, jr, tile_m=tile_m,
                              interpret=True))
    xt = torch.from_numpy(x)
    xs = xt[pr.tok_idx.long()]
    y3 = pgmm._planes_plain(xs, pqt, pr, tile_m, rounding="fold")
    fold = pgmm.combine(y3.reshape(xs.shape[0], -1)[:, :n], pr, m).numpy()
    joint = pgmm.gmm_plain(xt, pqt, pr, tile_m=tile_m).numpy()
    assert nmse(ref, fold) < 1e-10, nmse(ref, fold)
    assert nmse(ref, fold) < nmse(ref, joint) / 100


def _block_routing(case, rng):
    """(topi, topv, m) of the routings K4's GEMM maps one block per row
    tile onto: every row to one expert (>= 16 tiles of 64), experts with
    no rows, a tail tile of one row, and a spread top-2 routing."""
    if case == "one-expert-16-tiles":
        m = 1024
        return np.full((m, 1), 2, np.int32), np.ones((m, 1), np.float32), m
    if case == "one-row-tail":   # 65 rows to expert 1: tiles of 64 and 1
        m = 66
        topi = np.asarray([1] * 65 + [3], np.int32)[:, None]
        return topi, np.ones((m, 1), np.float32), m
    m = 130
    topi, topv = routing_inputs(m, 2 if case == "empty-experts" else 4, 2,
                                seed=int(rng.integers(1 << 16)))
    return topi, topv, m


@pytest.mark.parametrize("case,gt,n", [
    ("one-expert-16-tiles", GGMLType.Q4_K, 256),
    ("empty-experts", GGMLType.Q4_K, 256),
    ("one-row-tail", GGMLType.Q2_K, 256),
    ("pack4-npk192", GGMLType.Q2_K, 768),
    ("one-row-tail", GGMLType.BF16, 256)])
def test_gmm_plain_matches_reference_on_block_mappings(case, gt, n):
    """The plain K4 path (gmm_plain, and its fold rounding) against JAX gmm
    in interpret mode at tile_m 64 on the routings the GEMM's one block
    per row tile depends on; 'pack4-npk192' is u2 (Q2_K, pack 4) at
    N = 768 repacked in 64-column tiles, so npk = 192 (six of the GEMM's
    32-byte plane boxes). Gates: NMSE < 2e-4 with the joint min rounding
    (gmm_xla's), < 1e-10 with the min folded as _gmm_kernel folds it."""
    e, k = 4, 256
    rng = np.random.default_rng(sum(map(ord, case)) + int(gt))
    jqt = stacked_qtensor(e, n, k, gt, rng,
                          tile_n=64 if case == "pack4-npk192" else 128)
    pqt = qtensor_to_torch(port_qtensor(jqt), "cpu")
    if case == "pack4-npk192":
        assert (pqt.pack, pqt.npk) == (4, 192)
    topi, topv, m = _block_routing(case, rng)
    x = (rng.standard_normal((m, k)) * 0.3).astype(np.float32)
    jr, pr = both_routings(topi, topv, e, 0, 64)
    rows = pr.tile_rows.numpy()
    if case == "one-expert-16-tiles":
        assert (rows == 64).sum() >= 16
    if case == "one-row-tail":
        assert 1 in rows.tolist()
    if case == "empty-experts":
        assert set(pr.tile_expert.numpy()[rows > 0].tolist()) == {0, 1}
    ref = np.asarray(jgmm.gmm(jnp.asarray(x), jqt, jr, tile_m=64,
                              interpret=True))
    xt = torch.from_numpy(x)
    got = pgmm.gmm_plain(xt, pqt, pr, tile_m=64).numpy()
    assert got.shape == ref.shape == (m, n)
    assert nmse(ref, got) < GATE, nmse(ref, got)
    if pqt.min_ is not None:
        xs = xt[pr.tok_idx.long()]
        y3 = pgmm._planes_plain(xs, pqt, pr, 64, rounding="fold")
        fold = pgmm.combine(y3.reshape(xs.shape[0], -1)[:, :n], pr, m).numpy()
        assert nmse(ref, fold) < 1e-10, nmse(ref, fold)


@pytest.mark.parametrize("tile_m,m", [(8, 6), (64, 100)])
def test_gmm_apply_split_matches_reference(tile_m, m):
    """fuse_expert_qtensors + gmm_apply_split: the port's fused planes equal
    the JAX ones, and each constituent's combined output matches JAX gmm
    on that constituent alone."""
    e, k = 4, 256
    rng = np.random.default_rng(tile_m)
    jparts = [stacked_qtensor(e, n, k, GGMLType.Q4_K, rng) for n in (256, 512)]
    pparts = [port_qtensor(q) for q in jparts]
    pfused = fuse_expert_qtensors(pparts)
    jfused = jfuse(jparts)
    assert pfused.parts == jfused.parts
    np.testing.assert_array_equal(pfused.qs, np.asarray(jfused.qs))
    np.testing.assert_array_equal(pfused.scale,
                                  port_qtensor(jfused).scale)
    x = (rng.standard_normal((m, k)) * 0.3).astype(np.float32)
    topi, topv = routing_inputs(m, e, 2, seed=1)
    jr, pr = both_routings(topi, topv, e, 0, tile_m)
    xt = torch.from_numpy(x)
    outs = pgmm.gmm_apply_split(xt[pr.tok_idx.long()],
                                qtensor_to_torch(pfused, "cpu"), pr, tile_m)
    for jqt, y in zip(jparts, outs):
        ref = np.asarray(jgmm.gmm(jnp.asarray(x), jqt, jr, tile_m=tile_m,
                                  interpret=True))
        got = pgmm.combine(y, pr, m).numpy()
        assert got.shape == ref.shape
        assert nmse(ref, got) < GATE, nmse(ref, got)
