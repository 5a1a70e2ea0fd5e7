"""The port's device sampler (llama_cpp_test_tpu_torch/runtime/
device_sampling.py) against the JAX package's, in one process on the
CPU: the same logits, rows, histories, key and positions give the same
tokens at V = 199 (full-vocab penalties), 32000 (exact top-k) and 128256
(segment winners); the hash-Gumbel noise within 1e-6; the key pair equal
to jax.random.key_data; top-k ties broken by the lower index as
jax.lax.top_k breaks them."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_test_tpu.runtime import device_sampling as jds
from llama_cpp_test_tpu.runtime.sampling import SamplerParams as JParams
from llama_cpp_test_tpu_torch.runtime import device_sampling as pds
from llama_cpp_test_tpu_torch.runtime.sampling import SamplerParams as PParams

ROWS = [dict(temp=0.0), dict(temp=0.0, penalty_repeat=1.3,
                            penalty_present=0.5),
        dict(temp=0.8, top_k=40, top_p=0.95, min_p=0.05, penalty_repeat=1.1,
             seed=1),
        dict(temp=1.5, top_k=100, top_p=0.5, min_p=0.0, seed=2),
        dict(temp=0.7, top_k=10, top_p=1.0, min_p=0.2, penalty_freq=0.3,
             penalty_last_n=32, seed=3),
        dict(temp=1.0, top_k=128, top_p=0.99, min_p=0.01, seed=4),
        dict(temp=0.3, top_k=1, seed=5),
        dict(temp=2.0, top_k=64, top_p=0.9, min_p=0.05, penalty_repeat=1.5,
             penalty_last_n=128, seed=2 ** 31 + 6)]


def _inputs(v, seed, ties=False):
    rng = np.random.default_rng(seed)
    b = len(ROWS)
    logits = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    if ties:
        logits = np.round(logits * 2) / 2    # many exact ties
    hists = [rng.integers(0, v, size=int(rng.integers(0, 200))).tolist()
             for _ in range(b)]
    # a few history tokens among each row's best logits, so penalties bite
    for i, h in enumerate(hists):
        h.extend(np.argsort(-logits[i])[:5].tolist())
    pos = (np.arange(b) * 37 + seed).astype(np.int32)
    return logits, jds.make_history(hists, b), pos


@pytest.mark.parametrize("v", [199, 32000, 128256])
@pytest.mark.parametrize("key", [0, 7])
def test_sample_tokens_match_reference(v, key):
    for seed, ties in ((v, False), (v + 1, True)):
        logits, hist, pos = _inputs(v, seed, ties)
        jp = jds.DeviceSamplerParams.from_rows([JParams(**r) for r in ROWS],
                                               len(ROWS))
        pp = pds.DeviceSamplerParams.from_rows([PParams(**r) for r in ROWS],
                                               len(ROWS))
        want = np.asarray(jds.sample_tokens(
            jnp.asarray(logits), jp, jnp.asarray(hist),
            jax.random.PRNGKey(key), jnp.asarray(pos)))
        got = pds.sample_tokens(torch.from_numpy(logits), pp,
                                torch.from_numpy(hist), pds.key_data(key),
                                torch.from_numpy(pos))
        np.testing.assert_array_equal(got.numpy(), want)


def test_padded_rows_sample_greedily():
    logits, hist, pos = _inputs(500, 3)
    pp = pds.DeviceSamplerParams.from_rows([PParams(**ROWS[2])], len(ROWS))
    got = pds.sample_tokens(torch.from_numpy(logits), pp,
                            torch.from_numpy(hist), pds.key_data(0),
                            torch.from_numpy(pos)).numpy()
    assert (pp.temp[1:] == 0).all()
    # rows 1.. are greedy after their (absent) penalties
    np.testing.assert_array_equal(got[1:], logits[1:].argmax(-1))


@pytest.mark.parametrize("seed", [0, 1, 12345, 2 ** 31, 2 ** 40 + 3,
                                  -1, -2 ** 31])
def test_key_data_matches_jax(seed):
    assert pds.key_data(seed) == tuple(
        int(x) for x in jax.random.key_data(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("key", [0, 99, 2 ** 32 - 1])
def test_hash_gumbel_matches_reference(key):
    rng = np.random.default_rng(key % 1000)
    seed = rng.integers(0, 2 ** 31, size=16).astype(np.int32)
    pos = rng.integers(0, 2 ** 20, size=16).astype(np.int32)
    want = np.asarray(jds._hash_gumbel(jax.random.PRNGKey(key),
                                       jnp.asarray(seed), jnp.asarray(pos),
                                       16, 256))
    got = pds._hash_gumbel(pds.key_data(key), torch.from_numpy(seed),
                           torch.from_numpy(pos), 16, 256).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,k", [(7, 7), (300, 256), (5000, 40),
                                 (32000, 256), (128256, 256)])
def test_top_k_breaks_ties_as_lax_top_k(n, k):
    rng = np.random.default_rng(n)
    x = np.round(rng.standard_normal((4, n)) * 2).astype(np.float32)
    x[0, : n // 3] = -np.inf
    x[1, ::5] = 0.0
    x[1, 1::5] = -0.0
    vals, ids = pds.top_k(torch.from_numpy(x), k)
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_segmented_candidates_match_reference():
    logits, _, _ = _inputs(128256, 5, ties=True)
    jv, ji = jds._segmented_top_candidates(jnp.asarray(logits), 256)
    pv, pi = pds._segmented_top_candidates(torch.from_numpy(logits), 256)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


def test_penalties_match_reference():
    logits, hist, _ = _inputs(300, 8)
    rows = [JParams(**r) for r in ROWS]
    jp = jds.DeviceSamplerParams.from_rows(rows, len(rows))
    pp = pds.DeviceSamplerParams.from_rows([PParams(**r) for r in ROWS],
                                           len(rows))
    valid = (np.arange(jds.HIST_LEN)[None, :] >=
             jds.HIST_LEN - np.asarray(jp.penalty_last_n)[:, None])
    want = np.asarray(jds.apply_penalties(jnp.asarray(logits),
                                          jnp.asarray(hist),
                                          jnp.asarray(valid), jp))
    got = pds.apply_penalties(torch.from_numpy(logits),
                              torch.from_numpy(hist),
                              torch.from_numpy(valid), pp).numpy()
    np.testing.assert_array_equal(got, want)
    ids = np.argsort(-logits, -1)[:, :64]
    vals = np.take_along_axis(logits, ids, -1)
    want = np.asarray(jds._penalize_candidates(
        jnp.asarray(vals), jnp.asarray(ids), jnp.asarray(hist),
        jnp.asarray(valid), jp))
    got = pds._penalize_candidates(torch.from_numpy(vals),
                                   torch.from_numpy(ids),
                                   torch.from_numpy(hist),
                                   torch.from_numpy(valid), pp).numpy()
    np.testing.assert_array_equal(got, want)


def test_params_and_history_helpers_match_reference():
    rows = [JParams(**r) for r in ROWS[:5]]
    jp = jds.DeviceSamplerParams.from_rows(rows, 8)
    pp = pds.DeviceSamplerParams.from_rows([PParams(**r) for r in ROWS[:5]],
                                           8)
    for f in dataclasses.fields(pds.DeviceSamplerParams):
        np.testing.assert_array_equal(getattr(pp, f.name).numpy(),
                                      np.asarray(getattr(jp, f.name)))
    lists = [[], [1, 2, 3], list(range(300))]
    np.testing.assert_array_equal(pds.make_history(lists, 4),
                                  jds.make_history(lists, 4))
    h = jds.make_history(lists, 4)
    tok = np.asarray([5, 6, 7, 8], np.int32)
    np.testing.assert_array_equal(
        pds.push_history(torch.from_numpy(h), torch.from_numpy(tok)).numpy(),
        np.asarray(jds.push_history(jnp.asarray(h), jnp.asarray(tok))))


def test_eligibility_matches_reference():
    cases = [dict(), dict(temp=0.0), dict(top_k=0), dict(top_k=200),
             dict(grammar="root ::= \"a\""), dict(mirostat=2),
             dict(logit_bias={1: 1.0}), dict(penalty_repeat=0.9),
             dict(penalty_last_n=256), dict(dry_multiplier=0.5),
             dict(typ_p=0.5), dict(xtc_probability=0.5),
             dict(top_n_sigma=1.0), dict(dynatemp_range=0.2),
             dict(top_k=250, penalty_repeat=1.1)]
    for kw in cases:
        j, p = JParams(**kw), PParams(**kw)
        assert pds.ineligible_reasons(p) == jds.ineligible_reasons(j), kw
        assert pds.eligible(p) == jds.eligible(j)
        assert pds.host_candidates_eligible(p) == \
            jds.host_candidates_eligible(j), kw
