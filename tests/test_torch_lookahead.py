"""The draft-free drafters of the port (llama_cpp_test_tpu_torch/runtime/
lookahead.py and ngram_cache.py, with their CLIs) against the JAX package
on the tiny Q8_0 fixture: LookaheadDecoder and LookupDecoder tokens and
stats equal to the JAX decoders' and to the port's plain greedy
generate() (tests/test_lookahead.py and test_tools.py's checks; the
lookup runs the JAX side op by op: jitted XLA drops some bf16 roundings
and flips a near tie of its 40 tokens, where the op-by-op run, the
port's lookup and the port's greedy decode agree);
NGramCache files byte-equal to the JAX ones, load and merge round trips,
draft_tokens equal to the JAX one on seeded random histories; the CLIs'
stdout (and -lcd cache file) equal to the JAX CLIs'."""
import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from test_engine import make_tiny_gguf

from llama_cpp_test_tpu.cli import lookahead as jla_cli
from llama_cpp_test_tpu.cli import lookup as jlu_cli
from llama_cpp_test_tpu.runtime import engine as jengine
from llama_cpp_test_tpu.runtime import lookahead as jla
from llama_cpp_test_tpu.runtime import ngram_cache as jng
from llama_cpp_test_tpu_torch.cli import lookahead as pla_cli
from llama_cpp_test_tpu_torch.cli import lookup as plu_cli
from llama_cpp_test_tpu_torch.runtime import engine as pengine
from llama_cpp_test_tpu_torch.runtime import lookahead as pla
from llama_cpp_test_tpu_torch.runtime import ngram_cache as png


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the decoders run many small steps, and six
    xdist workers' OpenMP pools would spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("la") / "tiny.gguf")
    make_tiny_gguf(path)
    return path, jengine.Model(path), pengine.Model(path, device="cpu")


def ctxs(models, n_ctx=256):
    kw = dict(n_ctx=n_ctx, n_seq_max=2, block_size=8)
    return jengine.Context(models[1], **kw), pengine.Context(models[2], **kw)


@pytest.mark.parametrize("prompt,n,params", [
    ([3, 17, 42, 9, 3, 17, 42, 9], 24, (4, 3, 4)),
    ([5, 11], 96, (6, 4, 8)),
])
def test_lookahead_matches_reference_and_greedy(models, prompt, n, params):
    jctx, pctx = ctxs(models)
    p = dict(zip("wng", params))
    jd = jla.LookaheadDecoder(jctx, jla.LookaheadParams(**p))
    pd = pla.LookaheadDecoder(pctx, pla.LookaheadParams(**p))
    want = jd.generate(prompt, n)
    got = pd.generate(prompt, n)
    assert got == want
    assert vars(pd.stats) == vars(jd.stats)
    assert got == list(pengine.generate(ctxs(models)[1], prompt, n))
    assert pd.stats.n_generated >= pd.stats.n_forward >= 1
    if n == 96:   # the tiny model loops: the pool lands accepts
        assert pd.stats.n_forward < pd.stats.n_generated
    assert pctx.seqs == {} and pctx.mgr.num_free() == pctx.num_blocks


@pytest.mark.parametrize("n_draft", [3, 6])
def test_lookup_matches_reference_and_greedy(models, n_draft):
    jctx, pctx = ctxs(models, 128)
    prompt = [3, 17, 42, 9]
    dyn_j, dyn_p = jng.NGramCache(1, 4), png.NGramCache(1, 4)
    jd = jng.LookupDecoder(jctx, n_draft=n_draft, nc_dynamic=dyn_j)
    pd = png.LookupDecoder(pctx, n_draft=n_draft, nc_dynamic=dyn_p)
    with jax.disable_jit():
        want = jd.generate(prompt, 40)
    got = pd.generate(prompt, 40)
    assert got == want
    assert (pd.n_drafted, pd.n_accepted) == (jd.n_drafted, jd.n_accepted)
    assert pd.n_accepted > 0
    assert dyn_p.data == dyn_j.data
    assert got == list(pengine.generate(ctxs(models, 128)[1], prompt, 40))
    assert pctx.seqs == {} and pctx.mgr.num_free() == pctx.num_blocks


def random_history(rng, n, vocab=12):
    return [int(t) for t in rng.integers(0, vocab, n)]


def test_ngram_cache_files_and_drafts_match_reference(tmp_path):
    rng = np.random.default_rng(0)
    for trial in range(6):
        lo, hi = (1, 4) if trial % 2 == 0 else (2, 3)
        hist = random_history(rng, 120)
        jc, pc = jng.NGramCache(lo, hi), png.NGramCache(lo, hi)
        jc.update(hist)
        pc.update(hist)
        jc.update(hist + [3, 4], n_new=2)
        pc.update(hist + [3, 4], n_new=2)
        jp = str(tmp_path / f"j{trial}.bin")
        pp = str(tmp_path / f"p{trial}.bin")
        jc.save(jp)
        pc.save(pp)
        with open(jp, "rb") as f, open(pp, "rb") as g:
            assert f.read() == g.read()
        static, jstatic = png.NGramCache.load(jp), jng.NGramCache.load(jp)
        assert static.data == dict(jc.data)
        dyn_hist = random_history(rng, 60)
        jd, pd = jng.NGramCache(lo, hi), png.NGramCache(lo, hi)
        jd.update(dyn_hist)
        pd.update(dyn_hist)
        tiers = [((), ()), ((pd, None), (jd, None)),
                 ((None, static), (None, jstatic)),
                 ((pd, static), (jd, jstatic))]
        for _ in range(20):
            inp = random_history(rng, int(rng.integers(1, 10)))
            nd = int(rng.integers(1, 9))
            for pargs, jargs in tiers:
                assert png.draft_tokens(inp, nd, pc, *pargs) == \
                    jng.draft_tokens(inp, nd, jc, *jargs)
    # merge round trip: merged counts add, and the file reloads the same
    a, b = png.NGramCache(1, 3), png.NGramCache(1, 3)
    a.update([1, 2, 3, 4] * 3)
    b.update([1, 2, 3, 5] * 3)
    want = {k: dict(v) for k, v in a.data.items()}
    for k, d in b.data.items():
        for t, c in d.items():
            want.setdefault(k, {})[t] = want.get(k, {}).get(t, 0) + c
    a.merge(b)
    assert dict(a.data) == want
    path = str(tmp_path / "m.bin")
    a.save(path)
    assert png.NGramCache.load(path).data == want
    # a tie goes to the successor seen first
    c = png.NGramCache(1, 1)
    c.update([7, 1, 7, 2])
    assert c.best((7,)) == (1, 1, 2)


def run(main, argv, **kw):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv, **kw)
    return rc, out.getvalue()


def test_lookahead_cli_prints_the_reference_text(models):
    argv = ["-m", models[0], "-p", "hello world", "-n", "20", "-W", "5",
            "-N", "3", "-G", "4", "-c", "128"]
    want = run(jla_cli.main, argv)
    assert run(pla_cli.main, argv, device="cpu") == want
    assert want[0] == 0 and want[1].strip()


def test_lookup_cli_modes_match_reference(models, tmp_path):
    corpus = str(tmp_path / "corpus.txt")
    with open(corpus, "w") as f:
        f.write("hello world the world of the house " * 6)
    outs = {}
    # the JAX CLI runs op by op, as the decoder test runs it
    for side, main, kw, mode in (
            ("j", jlu_cli.main, {}, jax.disable_jit),
            ("p", plu_cli.main, {"device": "cpu"}, contextlib.nullcontext)):
        st, dyn, mg = (str(tmp_path / f"{side}{k}.bin") for k in "sdm")
        create = run(main, ["-m", models[0], "--create", st, "--text",
                            corpus], **kw)
        with mode():
            gen = run(main, ["-m", models[0], "-p", "hello world the world",
                             "-n", "24", "-c", "128", "--draft", "5", "-lcs",
                             st, "-lcd", dyn], **kw)
        merge = run(main, ["--merge", st, dyn, "-o", mg], **kw)
        assert create[1].endswith(f"-> {st}\n")
        outs[side] = {
            "rc": [create[0], gen[0], merge[0]],
            "text": [create[1].replace(st, "S"), gen[1],
                     merge[1].replace(mg, "M")],
            "files": [open(p, "rb").read() for p in (st, dyn, mg)]}
    assert outs["p"]["rc"] == [0, 0, 0]
    assert outs["p"] == outs["j"]      # stdout and cache files
