"""Eval tracing (llama_cpp_test_tpu_torch/runtime/tracing.py) and control
vectors (models/cvec.py) against the JAX package on the tiny Q8_0
fixture: every traced tensor within NMSE 2e-3 of the JAX
trace_eval(keep_values=True) and its summaries beside; a trace leaves a
live sequence's cached KV, its blocks and the free list as they were,
and its next decode bit-equal; the generated directions within 1e-4 of
the JAX generator's run op by op (jitted XLA drops some bf16 roundings,
which moves a direction by ~1e-3), unit norm, one per layer; steered
logits within NMSE 2e-3 of the JAX engine's, and detaching restores the
base logits bit for bit; the eval-callback CLI's printout equal to the
JAX one's (run op by op), and the cvector-generator CLI's text equal and
its file's directions within 1e-4."""
import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from test_engine import make_tiny_gguf, nmse

from llama_cpp_test_tpu.models import cvec as jcvec
from llama_cpp_test_tpu.runtime import engine as jengine
from llama_cpp_test_tpu.runtime import tracing as jtracing
from llama_cpp_test_tpu_torch.models import cvec as pcvec
from llama_cpp_test_tpu_torch.runtime import engine as pengine
from llama_cpp_test_tpu_torch.runtime import tracing as ptracing

GATE = 2e-3
PROMPT = [3, 17, 42, 9, 150, 7, 23, 88, 5, 61, 100]
POS = ["happy day", "good stuff"]
NEG = ["sad day", "bad stuff"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist every
    worker's OpenMP pool takes all cores, and these small steps spin
    against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("cv") / "tiny.gguf")
    make_tiny_gguf(p)
    return p


def contexts(path):
    kw = dict(n_ctx=64, n_seq_max=4, block_size=8)
    return (jengine.Context(jengine.Model(path), **kw),
            pengine.Context(pengine.Model(path, device="cpu"), **kw))


def test_trace_eval_matches_reference(path, capsys):
    jctx, pctx = contexts(path)
    want = jtracing.trace_eval(jctx, PROMPT, keep_values=True)
    got = ptracing.trace_eval(pctx, PROMPT, keep_values=True)
    assert [t.name for t in got] == [t.name for t in want] == (
        ["inp_embd", "l_out-0", "l_out-1", "result_output"])
    for w, g in zip(want, got):
        assert g.shape == w.shape == g.values.shape
        assert nmse(w.values, g.values) < GATE, g.name
        np.testing.assert_allclose([g.mean, g.std, g.amax],
                                   [w.mean, w.std, w.amax],
                                   rtol=2e-2, atol=1e-3)
    assert ptracing.trace_eval(pctx, PROMPT)[1].values.size == 0
    ptracing.print_traces(got)
    jtracing.print_traces(want)
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 8 and out[0].split()[:2] == out[4].split()[:2]


def _snapshot(ctx, s):
    blocks = list(s.table.blocks)
    return ([p[:, blocks].clone() for p in ctx.pools.k + ctx.pools.v],
            blocks, list(ctx.mgr._free), list(ctx.mgr._lru))


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
def test_trace_leaves_live_sequences_untouched(path, kv):
    m = pengine.Model(path, device="cpu")
    ctx = pengine.Context(m, n_ctx=64, n_seq_max=4, block_size=8, kv_type=kv)
    other = pengine.Context(m, n_ctx=64, n_seq_max=4, block_size=8,
                            kv_type=kv)
    s, o = ctx.new_seq(), other.new_seq()
    tok = int(np.argmax(ctx.prefill(s, PROMPT)))
    other.prefill(o, PROMPT)
    before = _snapshot(ctx, s)
    ptracing.trace_eval(ctx, PROMPT[:9] * 2)
    after = _snapshot(ctx, s)
    for a, b in zip(before[0], after[0]):
        assert torch.equal(a, b)
    assert before[1:] == after[1:]
    assert len(ctx.seqs) == 1
    np.testing.assert_array_equal(ctx.decode([s], [tok]),
                                  other.decode([o], [tok]))


def test_trace_refuses_to_evict(path):
    m = pengine.Model(path, device="cpu")
    ctx = pengine.Context(m, n_ctx=64, n_seq_max=1, block_size=8,
                          num_blocks=3)
    s = ctx.new_seq()
    ctx.prefill(s, PROMPT)          # two of the three blocks
    with pytest.raises(RuntimeError, match="never evicts"):
        ptracing.trace_eval(ctx, PROMPT)
    assert ctx.mgr.evictions == 0 and ctx.mgr.num_free() == 1


def test_control_vector_matches_reference(path, tmp_path):
    jctx, pctx = contexts(path)
    jout, pout = str(tmp_path / "j.gguf"), str(tmp_path / "p.gguf")
    with jax.disable_jit():
        want = jcvec.generate_control_vector(jctx, POS, NEG, jout)
    got = pcvec.generate_control_vector(pctx, POS, NEG, pout)
    assert sorted(got) == sorted(want) == [1, 2]
    for il in want:
        assert np.abs(got[il] - want[il]).max() < 1e-4
        np.testing.assert_allclose(np.linalg.norm(got[il]), 1.0, rtol=1e-5)
    loaded = pcvec.load_control_vector(pout)
    np.testing.assert_array_equal(loaded[1], got[1])
    assert sorted(jcvec.load_control_vector(pout)) == [1, 2]

    def logits(ctx):
        s = ctx.new_seq()
        try:
            return ctx.prefill(s, PROMPT, all_logits=True)
        finally:
            ctx.free_seq(s)

    base = logits(pctx)
    jcvec.attach_control_vector(jctx.model.weights, loaded, strength=4.0,
                                layer_start=2)
    pcvec.attach_control_vector(pctx.model.weights, loaded, strength=4.0,
                                layer_start=2)
    assert pctx.model.weights.layers[0].cvec is None
    steered = logits(pctx)
    assert nmse(logits(jctx), steered) < GATE
    assert nmse(base, steered) > 100 * GATE
    pcvec.detach_control_vector(pctx.model.weights)
    np.testing.assert_array_equal(logits(pctx), base)


def run(main, argv, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv, **kw)
    return rc, out.getvalue()


def test_eval_callback_cli_prints_the_reference_summaries(path):
    from llama_cpp_test_tpu.cli.eval_callback import main as jmain
    from llama_cpp_test_tpu_torch.cli.eval_callback import main as pmain

    argv = ["-m", path, "-p", "hello world", "-c", "64"]
    with jax.disable_jit():
        want = run(jmain, argv)
    got = run(pmain, argv, device="cpu")
    assert got == want and got[0] == 0
    assert got[1].splitlines()[-1].split()[0] == "result_output"


def test_cvector_generator_cli_matches_reference(path, tmp_path):
    from llama_cpp_test_tpu.cli.cvector_generator import main as jmain
    from llama_cpp_test_tpu_torch.cli.cvector_generator import main as pmain

    pos, neg = str(tmp_path / "pos.txt"), str(tmp_path / "neg.txt")
    with open(pos, "w") as f:
        f.write("\n".join(POS) + "\n\n")
    with open(neg, "w") as f:
        f.write("\n".join(NEG) + "\n")
    jout, pout = str(tmp_path / "j.gguf"), str(tmp_path / "p.gguf")
    args = ["-m", path, "--positive-file", pos, "--negative-file", neg]
    with jax.disable_jit():
        want = run(jmain, args + ["-o", jout])
    got = run(pmain, args + ["-o", pout], device="cpu")
    assert got == (0, want[1].replace(jout, pout))
    j, p = jcvec.load_control_vector(jout), pcvec.load_control_vector(pout)
    assert sorted(p) == sorted(j) == [1, 2]
    for il in j:
        assert np.abs(p[il] - j[il]).max() < 1e-4
