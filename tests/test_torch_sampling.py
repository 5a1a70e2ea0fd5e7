"""The port's host sampler chain, grammars, JSON-schema grammars and flag
registry (llama_cpp_test_tpu_torch/runtime/{sampling,grammar,json_schema},
common/{args,log}) against the JAX package's, in one process: the same
seeded logits through the same chain give the same tokens, step by step
with accept(), on full logits and on top-k candidate sets."""
import dataclasses

import numpy as np
import pytest

from test_engine import make_tiny_gguf

from llama_cpp_test_tpu.common import args as jargs
from llama_cpp_test_tpu.gguf.reader import GGUFReader
from llama_cpp_test_tpu.runtime import grammar as jgrammar
from llama_cpp_test_tpu.runtime import json_schema as jjson
from llama_cpp_test_tpu.runtime import sampling as jsampling
from llama_cpp_test_tpu.tokenizer import load_tokenizer as jload
from llama_cpp_test_tpu_torch.common import args as pargs
from llama_cpp_test_tpu_torch.common import log as plog
from llama_cpp_test_tpu_torch.gguf.reader import GGUFReader as PGGUFReader
from llama_cpp_test_tpu_torch.runtime import grammar as pgrammar
from llama_cpp_test_tpu_torch.runtime import json_schema as pjson
from llama_cpp_test_tpu_torch.runtime import sampling as psampling
from llama_cpp_test_tpu_torch.tokenizer import load_tokenizer as pload

V = 200

CHAINS = {
    "greedy": dict(temp=0.0),
    "default": dict(seed=3),
    "top_k_only": dict(top_k=5, top_p=1.0, min_p=0.0, temp=1.2, seed=4),
    "typical": dict(typ_p=0.6, seed=5),
    "xtc": dict(xtc_probability=0.7, xtc_threshold=0.05, seed=6),
    "top_n_sigma": dict(top_n_sigma=1.5, seed=7),
    "dynatemp": dict(dynatemp_range=0.5, dynatemp_exponent=1.3, seed=8),
    "mirostat_v1": dict(mirostat=1, seed=9),
    "mirostat_v2": dict(mirostat=2, mirostat_tau=4.0, seed=10),
    "dry": dict(dry_multiplier=0.8, dry_allowed_length=1, seed=11),
    "penalties": dict(penalty_repeat=1.3, penalty_freq=0.2,
                      penalty_present=0.4, penalty_last_n=16, seed=12),
    "logit_bias": dict(logit_bias={3: 5.0, 7: -100.0, 11: 2.5}, seed=13),
}


def _logits(rng, n):
    # a peaked, repetitive model so penalties, DRY and mirostat engage
    base = rng.standard_normal(V).astype(np.float32) * 2
    return [(base + rng.standard_normal(V).astype(np.float32)).astype(
        np.float32) for _ in range(n)]


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_chain_tokens_match_reference(name):
    kw = CHAINS[name]
    jc = jsampling.SamplerChain.from_params(jsampling.SamplerParams(**kw),
                                            n_vocab=V)
    pc = psampling.SamplerChain.from_params(psampling.SamplerParams(**kw),
                                            n_vocab=V)
    got, want = [], []
    for lg in _logits(np.random.default_rng(1), 40):
        a, b = jc.sample(lg.copy()), pc.sample(lg.copy())
        jc.accept(a)
        pc.accept(b)
        want.append(a)
        got.append(b)
    assert got == want


@pytest.mark.parametrize("name", ["greedy", "default", "penalties",
                                  "top_k_only"])
def test_candidate_sampling_matches_reference(name):
    """sample_candidates on a top-64 download, as the scheduler's
    candidate path calls it."""
    kw = CHAINS[name]
    jc = jsampling.SamplerChain.from_params(jsampling.SamplerParams(**kw),
                                            n_vocab=V)
    pc = psampling.SamplerChain.from_params(psampling.SamplerParams(**kw),
                                            n_vocab=V)
    for lg in _logits(np.random.default_rng(2), 30):
        ids = np.argsort(-lg, kind="stable")[:64].astype(np.int32)
        vals = lg[ids]
        a = jc.sample_candidates(vals.copy(), ids.copy())
        b = pc.sample_candidates(vals.copy(), ids.copy())
        assert a == b
        if a is not None:
            jc.accept(a)
            pc.accept(b)


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("g") / "tiny.gguf")
    make_tiny_gguf(path)
    with GGUFReader(path) as r:
        jtok = jload(r)
    return jtok, pload(PGGUFReader(path))


GRAMMARS = [
    'root ::= [a-z ]+ "."',
    'root ::= "yes" | "no" | "maybe"',
    'root ::= item ("," item)*\nitem ::= [0-9]+',
]


@pytest.mark.parametrize("gi", range(len(GRAMMARS)))
def test_grammar_constrained_tokens_match_reference(tokenizers, gi):
    jtok, ptok = tokenizers
    n = jtok.vocab.n_tokens
    sp = dict(seed=21, temp=0.9)
    jc = jsampling.SamplerChain.from_params(
        jsampling.SamplerParams(**sp), n_vocab=n,
        grammar_sampler=jgrammar.GrammarSampler(GRAMMARS[gi], jtok))
    pc = psampling.SamplerChain.from_params(
        psampling.SamplerParams(**sp), n_vocab=n,
        grammar_sampler=pgrammar.GrammarSampler(GRAMMARS[gi], ptok))
    rng = np.random.default_rng(gi)
    got, want = [], []
    for _ in range(12):
        lg = rng.standard_normal(n).astype(np.float32)
        a, b = jc.sample(lg.copy()), pc.sample(lg.copy())
        jc.accept(a)
        pc.accept(b)
        want.append(a)
        got.append(b)
    assert got == want


SCHEMAS = [
    {"type": "object", "properties": {"name": {"type": "string"},
                                      "age": {"type": "integer"}},
     "required": ["name"]},
    {"type": "array", "items": {"enum": ["a", "b", 3, None]},
     "minItems": 1, "maxItems": 3},
    {"oneOf": [{"type": "number"}, {"type": "boolean"},
               {"const": "x\"y"}]},
    {},
]


@pytest.mark.parametrize("si", range(len(SCHEMAS)))
def test_json_schema_grammar_matches_reference(si):
    text = pjson.schema_to_gbnf(SCHEMAS[si])
    assert text == jjson.schema_to_gbnf(SCHEMAS[si])
    pgrammar.GrammarParser(text).parse()


ARGV = ["-m", "x.gguf", "--temp", "0.7", "--top-k", "30", "--top-p", "0.9",
        "--repeat-penalty", "1.2", "--seed", "42", "--mirostat", "2",
        "-l", "5+1.5", "-l", "7-inf", "--dry-multiplier", "0.5",
        "--json-schema", '{"type": "integer"}', "-n", "12", "-c", "256",
        "-ctk", "q8_0", "--override-kv", "llama.context_length=int:4096"]


def test_flag_registry_and_sampler_params_match_reference(monkeypatch):
    monkeypatch.setenv("LLAMA_ARG_CTX_SIZE", "512")
    monkeypatch.setenv("LLAMA_ARG_N_PREDICT", "9")
    for argv in (ARGV, ["-m", "y.gguf"]):
        pa = pargs.build_parser("p", examples=("main", "sampling")).parse_args(argv)
        ja = jargs.build_parser("p", examples=("main", "sampling")).parse_args(argv)
        assert vars(pa) == vars(ja)
        assert dataclasses.asdict(pargs.sampler_params_from_args(pa)) == \
            dataclasses.asdict(jargs.sampler_params_from_args(ja))
        assert pargs.parse_kv_overrides(pa.override_kv) == \
            jargs.parse_kv_overrides(ja.override_kv)
    assert pargs.env_docs() == jargs.env_docs()


def test_logger_levels_and_sink(monkeypatch):
    import io

    from llama_cpp_test_tpu.common import log as jlog

    assert plog.LEVELS == jlog.LEVELS
    monkeypatch.setenv("LLAMA_LOG_LEVEL", "warn")
    sink = io.StringIO()
    lg = plog.Logger(sink)
    lg.info("hidden %d", 1)
    lg.warn("shown %d", 2)
    lg.flush()
    assert "shown 2" in sink.getvalue() and "hidden" not in sink.getvalue()
