"""Perplexity on the port (llama_cpp_test_tpu_torch runtime/engine
Context.prefill_nll, cli/perplexity) against the JAX package, on CPU, in
one process: tests/test_engine.make_tiny_gguf (llama, Q8_0) and the
qwen2vl file of tests/test_torch_multimodal.

Checks: prefill_nll within NMSE 2e-3 of the jitted JAX one (after a
cached prefix too) and equal to the log-softmax of the port's own
all-position logits; its refusals; the CLI's perplexity within 1e-3
relative of the JAX CLI's, strided and not, its --save-nll array and
--compare-nll report; the chunking equal; and the hellaswag, winogrande
and multiple-choice scores equal to the JAX scorers' on the fixture
tasks of tests/test_cli.py (labels set to the JAX model's preference,
then flipped), through the scorer functions and through main.
"""
import io
import json
import sys

import numpy as np
import pytest
import torch

from test_engine import make_tiny_gguf
from test_torch_multimodal import make_tiny_qwen2vl

from llama_cpp_test_tpu.cli import perplexity as jppl
from llama_cpp_test_tpu.runtime import engine as jengine
from llama_cpp_test_tpu_torch.cli import perplexity as pppl
from llama_cpp_test_tpu_torch.runtime import engine as pengine

LOGITS_GATE = 2e-3
CTX = dict(n_ctx=128, n_seq_max=1, block_size=8)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs (pytest-xdist workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nmse(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(((a - b) ** 2).mean() / ((a * a).mean() + 1e-12))


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    root = tmp_path_factory.mktemp("perplexity")
    out = {"llama": str(root / "llama.gguf"),
           "qwen2vl": str(root / "qwen2vl.gguf"),
           "text": str(root / "text.txt")}
    make_tiny_gguf(out["llama"])
    make_tiny_qwen2vl(out["qwen2vl"], seed=21)
    with open(out["text"], "w") as f:
        f.write("hello world the a " * 60)
    return out


_MODELS: dict = {}


def models(paths, name):
    if name not in _MODELS:
        p = paths[name]
        _MODELS[name] = (jengine.Model(p), pengine.Model(p, device="cpu"))
    return _MODELS[name]


def run(main, argv, **kw):
    old = sys.stdout
    sys.stdout = io.StringIO()
    try:
        return main(argv, **kw), sys.stdout.getvalue()
    finally:
        sys.stdout = old


# ---------------------------------------------------------------------------
# Context.prefill_nll


@pytest.mark.parametrize("name", ["llama", "qwen2vl"])
def test_prefill_nll_matches_reference(paths, name):
    """40 tokens from position 0, then 20 more after them (a cached
    prefix): the per-position NLL within 2e-3 of the jitted JAX one."""
    jm, pm = models(paths, name)
    ids = np.random.default_rng(1).integers(3, 288, size=60).tolist()
    out = []
    for eng, model in ((jengine, jm), (pengine, pm)):
        ctx = eng.Context(model, **CTX)
        s = ctx.new_seq()
        out.append([ctx.prefill_nll(s, ids[:40]),
                    ctx.prefill_nll(s, ids[40:])])
        assert s.n_cached == 60 and s.tokens == ids
    for a, b in zip(*out):
        assert b.shape == a.shape and b.dtype == np.float32
        assert np.isfinite(b).all()
        assert nmse(a, b) < LOGITS_GATE, nmse(a, b)


def test_prefill_nll_is_the_log_softmax_of_prefill(paths):
    """prefill_nll is -log_softmax of the port's own all-position logits
    at the next tokens."""
    _, pm = models(paths, "llama")
    ids = np.random.default_rng(2).integers(3, 288, size=33).tolist()
    a = pengine.Context(pm, **CTX)
    nll = a.prefill_nll(a.new_seq(), ids)
    b = pengine.Context(pm, **CTX)
    logits = torch.from_numpy(b.prefill(b.new_seq(), ids, all_logits=True))
    want = -torch.log_softmax(logits[:-1], -1)[torch.arange(32),
                                               torch.tensor(ids[1:])]
    np.testing.assert_allclose(nll, want.numpy(), rtol=1e-5, atol=1e-5)


def test_prefill_nll_refusals(paths):
    """One token, more than the room left and a Self-Extend offset raise;
    nothing is appended then."""
    _, pm = models(paths, "llama")
    ctx = pengine.Context(pm, **CTX)
    s = ctx.new_seq()
    with pytest.raises(ValueError, match=">= 2"):
        ctx.prefill_nll(s, [5])
    with pytest.raises(ValueError, match="exceed"):
        ctx.prefill_nll(s, [5] * 129)
    s.pos_offset = -2
    with pytest.raises(NotImplementedError, match="self_extend"):
        ctx.prefill_nll(s, [5, 6])
    assert s.n_cached == 0 and s.tokens == []


# ---------------------------------------------------------------------------
# cli.perplexity


def test_chunks_match_reference():
    toks = list(range(300))
    for n_ctx, stride in ((32, 16), (64, 32), (64, 48), (512, 256)):
        assert list(pppl.chunks(toks, n_ctx, stride)) == \
            list(jppl.chunks(toks, n_ctx, stride))


@pytest.mark.parametrize("extra", [["--chunks", "2"],
                                   ["--chunks", "3", "--ppl-stride", "24"]])
def test_perplexity_cli_matches_reference(paths, tmp_path, extra):
    """The CLI's JSON: tokens and n_ctx equal, perplexity within 1e-3
    relative of the JAX CLI's; --save-nll writes the reference's array
    within the gate, and --compare-nll against the JAX CLI's saved NLL
    reports a difference within 1e-3."""
    base = str(tmp_path / "base.npz")
    mine = str(tmp_path / "mine.npz")
    argv = ["-m", paths["llama"], "-f", paths["text"], "-c", "32"] + extra
    rc, out = run(jppl.main, argv + ["--save-nll", base])
    assert rc == 0
    want = json.loads(out.strip().splitlines()[-1])
    rc, out = run(pppl.main, argv + ["--save-nll", mine, "--compare-nll",
                                     base], device="cpu")
    assert rc == 0
    got = json.loads(out.strip().splitlines()[-1])
    assert (got["tokens"], got["n_ctx"]) == (want["tokens"], want["n_ctx"])
    assert abs(got["ppl"] / want["ppl"] - 1) < 1e-3, (got, want)
    assert abs(got["delta_nll_vs_base"]) < 1e-3
    a, b = np.load(base)["nll"], np.load(mine)["nll"]
    assert a.shape == b.shape and nmse(a, b) < LOGITS_GATE


def test_perplexity_cli_refuses_a_short_text(paths, tmp_path):
    short = tmp_path / "short.txt"
    short.write_text("hello world")
    argv = ["-m", paths["llama"], "-f", str(short), "-c", "32"]
    assert run(pppl.main, argv, device="cpu")[0] == 1 == \
        run(jppl.main, argv)[0]


# the fixture tasks of tests/test_cli.py
HELLASWAG = [("walking: the dog", ["ran fast", "sat down",
                                   "flew away quickly", "is blue"]),
             ("cooking: the pot", ["boiled over", "sang a song",
                                   "went home", "was hot"])]
WINO = ("the trophy does not fit because ", " is too big", "the trophy",
        "the case")
MC = ("the sky is", ["blue today", "a potato", "running late"])


def _tasks(jm):
    """The three task files with gold labels set to the JAX model's
    preference (test_cli.py's construction), and each with the labels
    moved off it."""
    tok = jm.tokenizer
    ctx = jengine.Context(jm, **CTX)
    enc = lambda text: tok.encode(text, add_special=True)

    def best(pairs):
        """The argmax over (context, full text) pairs of the ending's
        length-normalized log-probability."""
        scores = []
        for context, full in pairs:
            lp, cnt = jppl._ending_logprob(ctx, enc(context), enc(full))
            scores.append(lp / max(cnt, 1))
        return int(np.argmax(scores))

    lines = []
    for context, endings in HELLASWAG:
        gold = best([(context, context + " " + e) for e in endings])
        lines += [context, str(gold)] + endings
    bad = list(lines)
    for i in (1, 7):
        bad[i] = str((int(bad[i]) + 1) % 4)
    first, second, o1, o2 = WINO
    ans = 1 + best([(first + o, first + o + second) for o in (o1, o2)])
    wino = lambda a: f'1,"{first}_{second}","{o1}","{o2}",{a}\n'
    q, choices = MC
    gold = best([(q, q + " " + c) for c in choices])
    mc = lambda g: json.dumps([{"question": q, "choices": choices,
                                "answer": g}])
    return {"hellaswag": ("\n".join(lines), "\n".join(bad)),
            "winogrande": (wino(ans), wino(3 - ans)),
            "multiple-choice": (mc(gold), mc((gold + 1) % 3))}


@pytest.mark.parametrize("task", ["hellaswag", "winogrande",
                                  "multiple-choice"])
def test_scorers_match_reference(paths, tmp_path, task):
    """Each scorer gives the JAX scorer's accuracy on the fixture tasks
    with the labels at the JAX model's preference and moved off it, and
    each CLI mode prints the JAX CLI's JSON."""
    jm, pm = models(paths, "llama")
    fn = {"hellaswag": "hellaswag_score", "winogrande": "winogrande_score",
          "multiple-choice": "multiple_choice_score"}[task]
    jctx = jengine.Context(jm, **CTX)
    pctx = pengine.Context(pm, **CTX)
    for text in _tasks(jm)[task]:
        want = getattr(jppl, fn)(jctx, jm.tokenizer, text)
        assert getattr(pppl, fn)(pctx, pm.tokenizer, text) == want
        f = tmp_path / "tasks.txt"
        f.write_text(text)
        argv = ["-m", paths["llama"], "-f", str(f), "-c", "128",
                f"--{task}"]
        assert run(pppl.main, argv, device="cpu") == run(jppl.main, argv)
    assert [getattr(jppl, fn)(jctx, jm.tokenizer, t)
            for t in _tasks(jm)[task]] == [100.0, 0.0]
