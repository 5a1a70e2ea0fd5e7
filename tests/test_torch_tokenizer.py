"""The port's tokenizer (llama_cpp_test_tpu_torch/tokenizer) against the
JAX package's, on the same vocabularies in one process: the SPM vocab of
the tiny engine fixture (tests/test_engine.make_tiny_gguf), and SPM,
gpt-2 and Llama-3 (llama-bpe) vocabs synthesized as chip_smoke.py
writes them into its files, at a small size. Ids, pieces and decoded
text must be equal over fixed texts and hypothesis strings; the
pretokenizer fragments of every pre type must equal the `regex` splits
the JAX package makes; and the port must tokenize with `regex` made
unimportable."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
# imported while the workers collect, before tests/oracle.py can put its
# stand-in `gguf` module (no __spec__) in sys.modules, which breaks a first
# import of transformers later in the same worker (ROADMAP §3, the oracle
# leak; tests/test_qwen2vl_vision.py imports transformers in its tests)
import transformers  # noqa: F401
from hypothesis import given, settings, strategies as st

from test_engine import make_tiny_gguf

import chip_smoke
from llama_cpp_test_tpu.gguf.reader import GGUFReader
from llama_cpp_test_tpu.tokenizer import bpe as jbpe
from llama_cpp_test_tpu.tokenizer import load_tokenizer as jload
from llama_cpp_test_tpu_torch.gguf.reader import GGUFReader as PGGUFReader
from llama_cpp_test_tpu_torch.tokenizer import bpe as pbpe
from llama_cpp_test_tpu_torch.tokenizer import load_tokenizer as pload

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TEXTS = [
    "Hello, world! The people of the world could find water.",
    "  leading spaces and\ttabs\nnew lines\r\n and 1234567 digits 3.14",
    "üñïçødé: Grüße, 中文, 한국어, русский, ελληνικά, emoji \U0001f600!",
    "<s>special</s> tokens <|begin_of_text|> inside <|eot_id|> text",
    "don't can't I'M we'll they'd You're it's",
    "",
    "a",
]


def _vocab_md(kind: str) -> dict:
    if kind == "spm":
        return chip_smoke.spm_vocab(3000, 5)
    md = chip_smoke.bpe_vocab(3000, 5, n_special=16)
    if kind == "gpt2":
        md["tokenizer.ggml.pre"] = "gpt-2"
    return md


@pytest.fixture(scope="module", params=["fixture", "spm", "gpt2", "llama-bpe"])
def tokenizers(request, tmp_path_factory):
    """(JAX tokenizer, port tokenizer) over one vocabulary."""
    if request.param == "fixture":
        path = str(tmp_path_factory.mktemp("tok") / "tiny.gguf")
        make_tiny_gguf(path)
        with GGUFReader(path) as r:
            jtok = jload(r)
        return jtok, pload(PGGUFReader(path))
    md = _vocab_md(request.param)
    return jload(md), pload(md)


def _same(jtok, ptok, text):
    for add_special, parse_special in ((True, True), (False, False)):
        ids = jtok.encode(text, add_special=add_special,
                          parse_special=parse_special)
        assert ptok.encode(text, add_special=add_special,
                           parse_special=parse_special) == ids, text
    assert [ptok.token_to_piece(i) for i in ids] == \
        [jtok.token_to_piece(i) for i in ids]
    assert ptok.decode(ids) == jtok.decode(ids)
    assert ptok.decode(ids, special=True) == jtok.decode(ids, special=True)


@pytest.mark.parametrize("text", TEXTS)
def test_ids_pieces_decode_match_reference(tokenizers, text):
    _same(*tokenizers, text)


# assigned code points of this Python's Unicode tables (the `regex` module
# carries newer ones; the port takes unicodedata's)
_TEXT = st.text(alphabet=st.characters(
    blacklist_categories=("Cs", "Cn")), max_size=40)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(text=_TEXT)
def test_hypothesis_texts_match_reference(tokenizers, text):
    _same(*tokenizers, text)


def test_every_token_piece_matches_reference(tokenizers):
    jtok, ptok = tokenizers
    n = jtok.vocab.n_tokens
    for special in (False, True):
        assert [ptok.token_to_piece(i, special) for i in range(n)] == \
            [jtok.token_to_piece(i, special) for i in range(n)]


@pytest.mark.parametrize("pre", sorted(jbpe._PRE_REGEX))
def test_pretokenizer_fragments_match_regex(pre):
    """Every pre type's patterns, compiled for `re`, split like the JAX
    package's `regex` patterns, on fixed texts and seeded strings of
    assigned code points (letters, marks, digits, punctuation, symbols,
    every kind of space)."""
    import unicodedata

    pool = [chr(c) for c in range(0x30000)
            if unicodedata.category(chr(c)) not in ("Cn", "Cs")]
    rng = np.random.default_rng(7)
    ascii_ = list(" \t\n\r\x0b\x0c\x1c\x1f\x85\xa0 abcXYZ019'sS,.!?-_")
    texts = TEXTS + ["IMGIMGABZ <sentinel:12> 1234 1,234,567"]
    for _ in range(150):
        n = int(rng.integers(0, 40))
        texts.append("".join(
            pool[rng.integers(len(pool))] if rng.random() < 0.4
            else ascii_[rng.integers(len(ascii_))] for _ in range(n)))
    v = jbpe.Vocab(model="gpt2", pre=pre, tokens=["a"], scores=None,
                   token_types=None, merges=[])
    jt, pt = jbpe.BPETokenizer(v), pbpe.BPETokenizer(v)
    for text in texts:
        assert pt._pretokenize(text) == jt._pretokenize(text), (pre, text)


_NO_REGEX = r"""
import json, sys
sys.modules["regex"] = None
sys.path.insert(0, sys.argv[1])
import chip_smoke
from llama_cpp_test_tpu_torch.tokenizer import load_tokenizer
out = {}
for pre in ("llama-bpe", "gpt-2", "deepseek3-llm", "falcon"):
    md = chip_smoke.bpe_vocab(1000, 3, n_special=16)
    md["tokenizer.ggml.pre"] = pre
    tok = load_tokenizer(md)
    out[pre] = tok.encode(sys.argv[2], add_special=True, parse_special=True)
bad = sorted(k for k in sys.modules if k == "regex" and sys.modules[k])
print(json.dumps({"ids": out, "bad": bad}))
"""


def test_port_tokenizes_without_regex(tmp_path):
    """With `regex` unimportable, the port's BPE tokenizer gives the ids
    the JAX tokenizer gives with it."""
    text = TEXTS[2] + " " + TEXTS[4]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _NO_REGEX, ROOT, text],
                         env=env, capture_output=True, text=True,
                         timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for pre, ids in res["ids"].items():
        md = chip_smoke.bpe_vocab(1000, 3, n_special=16)
        md["tokenizer.ggml.pre"] = pre
        assert ids == jload(md).encode(text, add_special=True,
                                       parse_special=True), pre
