"""T5 of the port (llama_cpp_test_tpu_torch models/t5.py, cli/main.py's
T5 branch, tokenizer/ugm.py) against the JAX package, on CPU, in one
process, from numpy seeds.

The fixtures are tests/test_t5's HF checkpoints (width 48, 4 heads of
d_kv 16, FFN 96, 2 + 2 layers, 8 buckets, vocab 256): relu with the
tied, scaled head and gated-gelu with an untied one, converted once by
the reference's converter (F32), their BPE vocab swapped for a T5
unigram one (chip_smoke.t5_vocab), and a t5encoder file of the gated
encoder.

Checks: the relative buckets equal for rel in [-4096, 4096] both ways at
8 and 32 buckets; encode within NMSE 1e-8 of T5Context.encode at n = 5,
9 and 17 (three of the reference's token buckets); teacher-forced decode
logits within 1e-8 at every step; generate()'s tokens equal; the
t5encoder's encode; decode before encode and a full context refused as
the reference refuses them; a prompt past 2048 tokens refused by both;
port_t5_from_reference equal to the port's loader; the port's
UGMTokenizer giving the JAX ids (</s> appended); cli.main's printout
equal to the JAX CLI's; and T5Model asking for CUDA by default.
"""
import io
import pathlib
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from test_t5 import _build

from llama_cpp_test_tpu.cli.main import main as jmain
from llama_cpp_test_tpu.models import t5 as jt5
from llama_cpp_test_tpu.tokenizer import load_tokenizer as jload
from llama_cpp_test_tpu.tokenizer.vocab import (Tokenizer as JTokenizer,
                                                TokenType, Vocab as JVocab)
from llama_cpp_test_tpu_torch.cli.main import main as pmain
from llama_cpp_test_tpu_torch.gguf.reader import GGUFReader as PReader
from llama_cpp_test_tpu_torch.gguf.writer import GGUFWriter as PWriter
from llama_cpp_test_tpu_torch.models import t5 as pt5
from llama_cpp_test_tpu_torch.tokenizer import load_tokenizer as pload
from llama_cpp_test_tpu_torch.tokenizer.vocab import (Tokenizer as PTokenizer,
                                                      Vocab as PVocab)
from llama_cpp_test_tpu_torch.weights import port_t5_from_reference

GATE = 1e-8              # f32 hidden states and logits against the JAX run
N_CTX = 64               # every Context's (and the CLI's -n 16) decoder ctx
SRC = [3, 17, 42, 9, 150, 7, 88, 21, 5, 201, 64, 33, 12, 99, 180, 4, 70]
DEC_IN = [0, 7, 22, 100, 3, 250]       # starts with decoder_start_token
CONFIGS = {"relu_tied": (False, True, 51), "gated_untied": (True, False, 52)}
TEXT = "the people of the world could find water in a little house"


def nmse(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(((a - b) ** 2).mean() / ((b * b).mean() + 1e-30))


def rewrite(src, dst, vocab=None, arch=None):
    """A copy of the GGUF src (F32 tensors) with its tokenizer keys
    replaced by vocab; with arch, as that arch: its keys renamed and,
    for t5encoder, the decoder's tensors and the head left out."""
    r = PReader(src)
    old = r.metadata["general.architecture"]
    arch = arch or old
    w = PWriter(dst, arch=arch)
    for k, v in r.metadata.items():
        if k.startswith(("tokenizer.", "general.architecture")) and vocab:
            continue
        if k != "general.architecture":
            w.add_kv(k.replace(f"{old}.", f"{arch}.", 1), v)
    for k, v in (vocab or {}).items():
        w.add_kv(k, v)
    for name, info in r.tensors.items():
        if arch == "t5encoder" and name.startswith(("dec.", "output.")):
            continue
        w.add_tensor(name, r.dequantize(name, np.float32).reshape(
            tuple(reversed(info.shape))))
    w.write()
    r.close()
    return dst


def t5_file(tmp, name: str = "relu_tied", arch: str = "t5") -> str:
    """The CONFIGS[name] fixture as a t5 GGUF with a T5 unigram vocab in
    directory tmp; with arch "t5encoder", its encoder alone."""
    gated, tied, seed = CONFIGS[name]
    tmp = pathlib.Path(tmp)
    path = rewrite(_build(tmp, gated, tied, seed)[1], str(tmp / "t5.gguf"),
                   chip_smoke.t5_vocab(256, seed, n_extra=4))
    if arch == "t5encoder":
        path = rewrite(path, str(tmp / "t5encoder.gguf"), arch=arch)
    return path


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    out = {name: t5_file(tmp_path_factory.mktemp(name), name)
           for name in CONFIGS}
    out["encoder"] = rewrite(out["gated_untied"],
                             str(tmp_path_factory.mktemp("enc") / "e.gguf"),
                             arch="t5encoder")
    return out


@pytest.fixture(scope="module")
def models(paths):
    """name -> (JAX T5Model, port T5Model on the CPU)."""
    return {k: (jt5.T5Model(p), pt5.T5Model(p, device="cpu"))
            for k, p in paths.items()}


@pytest.mark.parametrize("n_buckets", [8, 32])
@pytest.mark.parametrize("bidirectional", [True, False])
def test_rel_bucket_matches_reference(n_buckets, bidirectional):
    import jax.numpy as jnp

    rel = np.arange(-4096, 4097)
    want = np.asarray(jt5._rel_bucket(jnp.asarray(rel),
                                      bidirectional=bidirectional,
                                      n_buckets=n_buckets))
    got = pt5.rel_bucket(torch.as_tensor(rel), bidirectional=bidirectional,
                         n_buckets=n_buckets).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [5, 9, 17])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_encode_matches_reference(models, name, n):
    jm, pm = models[name]
    assert pm.hp == pt5.T5HParams(**vars(jm.hp))
    want = jt5.T5Context(jm, n_ctx=N_CTX).encode(SRC[:n])
    got = pt5.T5Context(pm, n_ctx=N_CTX).encode(SRC[:n])
    assert got.shape == want.shape == (n, 48)
    assert nmse(got, want) < GATE, nmse(got, want)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_teacher_forced_decode_matches_reference(models, name):
    jm, pm = models[name]
    jc, pc = jt5.T5Context(jm, n_ctx=N_CTX), pt5.T5Context(pm, n_ctx=N_CTX)
    jc.encode(SRC[:9])
    pc.encode(SRC[:9])
    for i, t in enumerate(DEC_IN):
        want, got = jc.decode(t), pc.decode(t)
        assert nmse(got, want) < GATE, (i, nmse(got, want))
    assert pc.n_past == jc.n_past == len(DEC_IN)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_generate_matches_reference(models, name):
    jm, pm = models[name]
    want = list(jt5.generate(jt5.T5Context(jm, n_ctx=N_CTX), SRC[:9], 16))
    got = list(pt5.generate(pt5.T5Context(pm, n_ctx=N_CTX), SRC[:9], 16))
    assert got == want and len(got) > 0


def test_t5encoder_encode_matches_reference(models):
    jm, pm = models["encoder"]
    assert pm.hp.arch == "t5encoder" and pm.dec is None and jm.dec is None
    want = jt5.T5Context(jm, n_ctx=N_CTX).encode(SRC[:9])
    got = pt5.T5Context(pm, n_ctx=N_CTX).encode(SRC[:9])
    assert nmse(got, want) < GATE, nmse(got, want)
    # the t5encoder file holds the t5 file's encoder
    full = pt5.T5Context(models["gated_untied"][1]).encode(SRC[:9])
    np.testing.assert_array_equal(got, full)


def test_decode_errors_match_reference(models):
    jm, pm = models["relu_tied"]
    for ctx in (jt5.T5Context(jm, n_ctx=N_CTX),
                pt5.T5Context(pm, n_ctx=N_CTX)):
        with pytest.raises(RuntimeError, match="encode.. must run before"):
            ctx.decode(0)
    for ctx in (jt5.T5Context(jm, n_ctx=N_CTX),
                pt5.T5Context(pm, n_ctx=N_CTX)):
        ctx.encode(SRC[:5])
        ctx.n_past = N_CTX             # as after N_CTX decode steps
        with pytest.raises(RuntimeError, match="decoder context full"):
            ctx.decode(0)


def test_prompt_past_the_largest_bucket_refused(models):
    """The reference pads a prompt to its token bucket; past 2048 tokens
    the copy into the bucket fails. The port refuses it by name."""
    jm, pm = models["relu_tied"]
    long = [5] * (pt5.MAX_PROMPT + 1)
    with pytest.raises(ValueError):
        jt5.T5Context(jm, n_ctx=N_CTX).encode(long)
    with pytest.raises(ValueError, match="at most 2048"):
        pt5.T5Context(pm, n_ctx=N_CTX).encode(long)


def test_port_from_reference_equals_loader(models):
    jm, pm = models["gated_untied"]
    ported = port_t5_from_reference(jm, device="cpu")
    assert ported.hp == pm.hp and ported.output is not None
    for a, b in ((ported.tok_embd, pm.tok_embd), (ported.output, pm.output),
                 (ported.enc[1].w_gate, pm.enc[1].w_gate),
                 (ported.dec[0].rel_b, pm.dec[0].rel_b),
                 (ported.dec[1].cross_wo, pm.dec[1].cross_wo)):
        assert torch.equal(a, b)
    assert ported.dec[1].rel_b is None and pm.dec[1].rel_b is None
    ctx = pt5.T5Context(ported, n_ctx=N_CTX)
    ctx.encode(SRC[:5])
    want = pt5.T5Context(pm, n_ctx=N_CTX)
    want.encode(SRC[:5])
    np.testing.assert_array_equal(ctx.decode(0), want.decode(0))


UGM_TEXTS = ["hello world", "hello Q world", "  two  spaces ", "",
             "The people of the world, could find water!", "über 中文 x"]


def _hand_vocab(cls, tt_cls):
    """tests/test_tokenizer.py's hand-made unigram vocab."""
    tokens = ["<unk>", "<s>", "</s>", "▁", "▁he", "▁hello", "llo", "▁hell",
              "o", "l", "h", "e", "▁wor", "ld", "▁world"]
    scores = np.array([0, 0, 0, -5, -4, -2, -3, -3.5, -1.5, -2, -2, -2,
                       -3, -2, -2.5], np.float32)
    tt = np.full(len(tokens), int(TokenType.NORMAL), np.int32)
    tt[0] = TokenType.UNKNOWN
    tt[1] = tt[2] = TokenType.CONTROL
    return cls(model="t5", pre="default", tokens=tokens, scores=scores,
               token_types=tt, bos_id=1, eos_id=2, unk_id=0,
               add_bos=False, add_eos=True, add_space_prefix=True)


@pytest.mark.parametrize("vocab", ["hand", "t5_vocab"])
def test_ugm_tokenizer_matches_reference(vocab):
    if vocab == "hand":
        jt = JTokenizer(_hand_vocab(JVocab, TokenType))
        pt = PTokenizer(_hand_vocab(PVocab, TokenType))
    else:
        md = chip_smoke.t5_vocab(3000, 9)
        jt, pt = jload(md), pload(md)
    for text in UGM_TEXTS + [TEXT]:
        for special in (True, False):
            ids = pt.encode(text, add_special=special)
            assert ids == jt.encode(text, add_special=special), text
            assert (ids[-1:] == [pt.vocab.eos_id]) == special
        assert [pt.token_to_piece(i) for i in ids] == \
            [jt.token_to_piece(i) for i in ids]
    assert pt.encode("hello world", add_special=False) != [0]


def run(main, argv, **kw):
    old, err = sys.stdout, sys.stderr
    sys.stdout, sys.stderr = io.StringIO(), io.StringIO()
    try:
        rc = main(argv, **kw)
        return rc, sys.stdout.getvalue(), sys.stderr.getvalue()
    finally:
        sys.stdout, sys.stderr = old, err


@pytest.mark.parametrize("name", list(CONFIGS))
def test_cli_matches_reference(paths, name):
    argv = ["-m", paths[name], "-p", TEXT, "-n", "16"]
    rc, want, _ = run(jmain, argv)
    got, out, err = run(pmain, argv, device="cpu")
    assert (got, out) == (rc, want) == (0, want)
    assert want.strip() and "# t5 model loaded" in err


def test_cli_t5encoder_is_embedding_only(paths):
    argv = ["-m", paths["encoder"], "-p", TEXT, "-n", "4"]
    want = run(jmain, argv)
    got = run(pmain, argv, device="cpu")
    assert got[:2] == want[:2] == (1, "")
    msg = "error: t5encoder GGUFs are embedding-only — use llama-embedding"
    assert msg in got[2] and msg in want[2]


def test_cli_refuses_paged_options(paths):
    for flags in (["--prompt-cache", "x.bin"], ["-tp", "2"]):
        with pytest.raises(ValueError, match="encoder-decoder"):
            run(pmain, ["-m", paths["relu_tied"], "-p", "hi", "-n", "2"]
                + flags, device="cpu")


def test_default_device_is_cuda(paths):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        pt5.T5Model(paths["relu_tied"])
    with pytest.raises(RuntimeError, match="CUDA"):
        run(pmain, ["-m", paths["relu_tied"], "-p", "hi", "-n", "2"])
