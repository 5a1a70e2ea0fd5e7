"""The port's quantizers (llama_cpp_test_tpu_torch quant/codecs.quantize,
quant/iq_quantize and quant/quantize_model) against the JAX package's, on
the CPU, from seeded numpy inputs.

Checks: every type of the reference's supported_quantize_types() and its
seven codebook encoders write the same bytes, without importance weights,
with seeded ones and at set_refine_iters(0), and so does a tensor large
enough that the port encodes its row spans on threads; quantize_model
writes the same file, tensor types, bytes and metadata, at Q4_K_M, Q8_0
and IQ2_XS with and without an imatrix, on test_engine's tiny Q8_0 file
(rows of 64 and 96, so the K-quant targets fall back to F16) and on a
tiny F32 file of rows of 256 and 512 (where they encode); an imatrix the
port collects loads through both packages' IMatrixCollector.load, and the
reference's .npz through the port's; the port's Model on its own Q4_K_M
file gives logits within NMSE 2e-3 (tests/test_engine.py:225) of the JAX
engine on the JAX-written file, and the same greedy tokens; main() prints
the reference's summary line."""
import io
import re
import types
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest

from __graft_entry__ import _tiny_gguf
from test_engine import make_tiny_gguf, nmse

from llama_cpp_test_tpu.gguf.constants import GGMLType as JT
from llama_cpp_test_tpu.gguf.reader import GGUFReader as JReader
from llama_cpp_test_tpu.quant import codecs as jcodecs
from llama_cpp_test_tpu.quant import quantize_model as jqm
from llama_cpp_test_tpu.quant.iq_quantize import IQ_QUANTIZERS as JIQ
from llama_cpp_test_tpu.runtime import engine as jengine
from llama_cpp_test_tpu.runtime import imatrix as jimatrix
from llama_cpp_test_tpu_torch.gguf.constants import GGMLType as PT
from llama_cpp_test_tpu_torch.gguf.reader import GGUFReader as PReader
from llama_cpp_test_tpu_torch.quant import codecs as pcodecs
from llama_cpp_test_tpu_torch.quant import quantize_model as pqm
from llama_cpp_test_tpu_torch.quant.iq_quantize import IQ_QUANTIZERS as PIQ
from llama_cpp_test_tpu_torch.runtime import engine as pengine
from llama_cpp_test_tpu_torch.runtime import imatrix as pimatrix

LOGITS_GATE = 2e-3
TYPES = [t.name for t in jcodecs.supported_quantize_types()] + \
    [t.name for t in sorted(JIQ, key=int)]
FTYPES = ("Q4_K_M", "Q8_0", "IQ2_XS")


def test_encoder_tables_match_reference():
    assert [t.name for t in pcodecs.supported_quantize_types()] == \
        [t.name for t in jcodecs.supported_quantize_types()]
    assert sorted(t.name for t in PIQ) == sorted(t.name for t in JIQ)
    assert len(TYPES) == 21


@pytest.fixture
def refine():
    """Sets both packages' refinement sweeps; puts back the defaults."""
    def set_(n):
        jcodecs.set_refine_iters(n)
        pcodecs.set_refine_iters(n)
    yield set_
    set_(2)


@pytest.mark.parametrize("setting", ["plain", "weights", "refine0"])
@pytest.mark.parametrize("name", TYPES)
def test_quantize_bytes_match_reference(name, setting, refine):
    rng = np.random.default_rng(TYPES.index(name))
    # the codebook encoders score every sub-block against the whole grid:
    # a few rows of 256 keep them cheap
    rows = 3 if name in {t.name for t in JIQ} else 16
    x = (rng.standard_normal((rows, 512)) * 0.02).astype(np.float32)
    x[0, :40] *= 20.0                       # an outlier run
    w = rng.uniform(0.0, 3.0, 512).astype(np.float32) \
        if setting == "weights" else None
    if setting == "refine0":
        refine(0)
    want = jcodecs.quantize(x, JT[name], weights=w)
    got = pcodecs.quantize(x, PT[name], weights=w)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pcodecs.dequantize(got, PT[name]),
                                  jcodecs.dequantize(want, JT[name]))


@pytest.mark.parametrize("name", ["Q4_K", "Q6_K", "Q2_K", "Q8_0", "IQ4_XS"])
def test_row_spans_on_threads_match_reference(name, monkeypatch):
    """A tensor past PARALLEL_MIN is encoded in row spans on the pool:
    the same bytes as the reference's one call, imatrix weights too."""
    monkeypatch.setattr(pcodecs, "PARALLEL_MIN", 1 << 14)
    monkeypatch.setattr(pcodecs, "SPAN", 3 * 1024)  # spans of 3 rows
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((40, 1024)) * 0.02).astype(np.float32)
    w = rng.uniform(0.0, 3.0, 1024).astype(np.float32)
    np.testing.assert_array_equal(pcodecs.quantize(x, PT[name], weights=w),
                                  jcodecs.quantize(x, JT[name], weights=w))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The two source files, a port-collected imatrix for each (saved by
    the port) and the reference's .npz of the same sums."""
    d = tmp_path_factory.mktemp("quant")
    tiny, f32 = str(d / "tiny.gguf"), str(d / "f32.gguf")
    make_tiny_gguf(tiny)
    _tiny_gguf(f32, qtype=JT.F32)
    rng = np.random.default_rng(3)
    out = {"dir": d, "src": {"tiny": tiny, "f32": f32}, "imatrix": {}}
    for label, path in out["src"].items():
        m = pengine.Model(path, device="cpu")
        coll = pimatrix.IMatrixCollector(m)
        coll.collect([int(t) for t in rng.integers(3, m.hp.n_vocab, 64)],
                     chunk=32)
        port_npz, ref_npz = str(d / f"{label}.npz"), str(d / f"{label}_j.npz")
        coll.save(port_npz)
        jimatrix.IMatrixCollector.save(
            types.SimpleNamespace(sums=coll.sums, counts=coll.counts),
            ref_npz)
        out["imatrix"][label] = (port_npz, ref_npz)
    return out


def test_imatrix_files_load_in_both_packages(files):
    for label, (port_npz, ref_npz) in files["imatrix"].items():
        mine = pimatrix.IMatrixCollector.load(port_npz)
        assert mine and all(v.ndim == 1 and (v > 0).all()
                            for v in mine.values())
        for got in (jimatrix.IMatrixCollector.load(port_npz),
                    pimatrix.IMatrixCollector.load(ref_npz)):
            assert sorted(got) == sorted(mine)
            for k in mine:
                np.testing.assert_array_equal(got[k], mine[k])


def _tensors(path, reader):
    with reader(path) as r:
        return dict(r.metadata), {
            n: (i.ggml_type.name, tuple(i.shape),
                bytes(r.tensor_bytes(n))) for n, i in r.tensors.items()}


@pytest.mark.parametrize("imatrix", [False, True])
@pytest.mark.parametrize("ftype", FTYPES)
@pytest.mark.parametrize("src", ["tiny", "f32"])
def test_quantize_model_matches_reference(files, src, ftype, imatrix):
    d, path = files["dir"], files["src"][src]
    im = pimatrix.IMatrixCollector.load(files["imatrix"][src][0]) \
        if imatrix else None
    tag = f"{src}_{ftype}_{int(imatrix)}"
    mine, ref = str(d / f"p_{tag}.gguf"), str(d / f"j_{tag}.gguf")
    st = pqm.quantize_model(path, mine, ftype, imatrix=im)
    jst = jqm.quantize_model(path, ref, ftype, imatrix=im)
    md, tensors = _tensors(mine, PReader)
    jmd, jtensors = _tensors(ref, JReader)
    assert list(md) == list(jmd)
    for key, val in jmd.items():
        assert np.array_equal(np.asarray(md[key]), np.asarray(val)), key
    assert md["general.file_type"] == list(pqm.FTYPES).index(ftype)
    assert list(tensors) == list(jtensors)
    for name, (t, shape, raw) in jtensors.items():
        assert tensors[name][:2] == (t, shape), name
        assert tensors[name][2] == raw, name
    assert (st.tensors, st.bytes_in, st.bytes_out) == \
        (jst.tensors, jst.bytes_in, jst.bytes_out)
    assert open(mine, "rb").read() == open(ref, "rb").read()
    if src == "f32" and ftype == "Q4_K_M":
        # the K-quant rules: a Q6_K head, attn_v and ffn_down
        assert tensors["output.weight"][0] == "Q6_K"
        assert tensors["blk.0.attn_v.weight"][0] == "Q6_K"
        assert tensors["blk.1.ffn_down.weight"][0] == "Q6_K"
        assert tensors["blk.0.attn_q.weight"][0] == "Q4_K"
    if src == "tiny" and ftype == "Q4_K_M":
        # rows of 64 and 96 are no multiple of 256: F16
        assert tensors["blk.0.attn_q.weight"][0] == "F16"


@pytest.fixture(scope="module")
def q4km(files):
    """The F32 file at Q4_K_M with its imatrix, written by each package;
    the JAX engine (jitted) on the JAX-written file: prefill rows, decode
    steps and greedy tokens."""
    d, src = files["dir"], files["src"]["f32"]
    im = pimatrix.IMatrixCollector.load(files["imatrix"]["f32"][0])
    mine, ref = str(d / "serve_p.gguf"), str(d / "serve_j.gguf")
    pqm.quantize_model(src, mine, "Q4_K_M", imatrix=im)
    jqm.quantize_model(src, ref, "Q4_K_M", imatrix=im)
    jm = jengine.Model(ref)
    return mine, _readings(jengine, jm)


PROMPT = [3, 17, 42, 9, 150, 7, 23, 88]


def _readings(eng, model):
    ctx = eng.Context(model, n_ctx=64, n_seq_max=2, block_size=8)
    s = ctx.new_seq()
    logits = [ctx.prefill(s, PROMPT[:5], all_logits=True)]
    for t in PROMPT[5:]:
        logits.append(ctx.decode([s], [t])[0])
    ctx = eng.Context(model, n_ctx=64, n_seq_max=2, block_size=8)
    return logits, list(eng.generate(ctx, [3, 17, 42], 12))


def test_port_serves_its_q4km_file_like_reference(q4km):
    mine, (ref_logits, ref_tokens) = q4km
    m = pengine.Model(mine, device="cpu")
    assert m.weights.layers[0].w_down.ggml_type == PT.Q6_K
    logits, tokens = _readings(pengine, m)
    for i, (a, b) in enumerate(zip(ref_logits, logits)):
        assert np.isfinite(b).all()
        assert nmse(a, b) < LOGITS_GATE, (i, nmse(a, b))
    assert tokens == ref_tokens


def test_main_prints_reference_summary(files, refine):
    d, src = files["dir"], files["src"]["f32"]
    npz = files["imatrix"]["f32"][1]       # the reference's .npz
    outs = []
    for mod, dst in ((pqm, d / "main_p.gguf"), (jqm, d / "main_j.gguf")):
        out, err = io.StringIO(), io.StringIO()
        with redirect_stdout(out), redirect_stderr(err):
            assert mod.main([src, str(dst), "q4_k_m", "--imatrix", npz,
                             "--fast"]) == 0
        outs.append((out.getvalue(), err.getvalue()))
    seconds = re.compile(r"in [0-9.]+s$", re.M)
    (p_out, p_err), (j_out, j_err) = outs
    assert seconds.sub("in Xs", p_out) == seconds.sub("in Xs", j_out)
    assert p_out.startswith("quantized 21 tensors: ")
    assert p_err == j_err
    assert open(d / "main_p.gguf", "rb").read() == \
        open(d / "main_j.gguf", "rb").read()
    assert pcodecs.REFINE_ITERS == 2   # (the reference's --fast leaves 0)
