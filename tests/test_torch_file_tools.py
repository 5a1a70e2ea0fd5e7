"""The port's host-only file tools (llama_cpp_test_tpu_torch/cli:
quantize_stats, gguf_hash, gguf_split, tokenize, gbnf_validator) against
the JAX package's CLIs on the same inputs, on the CPU: each prints what
the reference prints and returns what it returns; gguf_split's shards are
the reference's shards byte for byte, merge back to the same tensor
digests, and a split file serves in the port's Model with the unsplit
file's logits and greedy tokens (after tests/test_tools.py:65-126)."""
import io
import os
from contextlib import redirect_stdout

import numpy as np
import pytest

from __graft_entry__ import _tiny_gguf
from test_engine import make_tiny_gguf

from llama_cpp_test_tpu.cli import gbnf_validator as jgbnf
from llama_cpp_test_tpu.cli import gguf_hash as jhash
from llama_cpp_test_tpu.cli import gguf_split as jsplit
from llama_cpp_test_tpu.cli import quantize_stats as jstats
from llama_cpp_test_tpu.cli import tokenize as jtok
from llama_cpp_test_tpu.gguf.constants import GGMLType as JT
from llama_cpp_test_tpu_torch.cli import gbnf_validator as pgbnf
from llama_cpp_test_tpu_torch.cli import gguf_hash as phash
from llama_cpp_test_tpu_torch.cli import gguf_split as psplit
from llama_cpp_test_tpu_torch.cli import quantize_stats as pstats
from llama_cpp_test_tpu_torch.cli import tokenize as ptok
from llama_cpp_test_tpu_torch.runtime import engine as pengine


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("tools")
    tiny, f32 = str(d / "tiny.gguf"), str(d / "f32.gguf")
    make_tiny_gguf(tiny)                    # Q8_0, SPM vocab
    _tiny_gguf(f32, qtype=JT.F32)           # rows of 256 and 512
    return {"dir": d, "tiny": tiny, "f32": f32}


def both(pmain, jmain, argv):
    """(port rc, port stdout), (reference rc, reference stdout)."""
    out = []
    for main in (pmain, jmain):
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = main(list(argv))
        out.append((rc, buf.getvalue()))
    return out


@pytest.mark.parametrize("argv", [
    ["-t", "Q4_K", "-l", "blk.0"],
    ["--per-layer", "-t", "Q6_K", "-t", "IQ4_XS", "-l", "blk.1.ffn",
     "-l", "output"],
    [],                                  # Q4_0 Q4_K Q6_K Q8_0 over all
], ids=["one_type", "per_layer", "defaults"])
def test_quantize_stats_prints_reference(paths, argv):
    mine, ref = both(pstats.main, jstats.main, ["-m", paths["f32"], *argv])
    assert mine == ref and mine[0] == 0
    assert "overall rmse" in mine[1]


def test_quantize_stats_without_compatible_tensors(paths):
    """The tiny Q8_0 file's rows of 64 and 96 take no K-quant."""
    mine, ref = both(pstats.main, jstats.main,
                     ["-m", paths["tiny"], "-t", "Q4_K"])
    assert mine == ref == (0, "Q4_K     no compatible tensors\n")


@pytest.mark.parametrize("flags", [[], ["--uuid"], ["--no-per-tensor"]])
def test_gguf_hash_prints_reference(paths, flags):
    mine, ref = both(phash.main, jhash.main, [*flags, paths["tiny"]])
    assert mine == ref and mine[0] == 0
    assert phash.hash_gguf(paths["tiny"]) == jhash.hash_gguf(paths["tiny"])


@pytest.mark.parametrize("how", [["--split-max-tensors", "5"],
                                 ["--split-max-size", "1M"]],
                         ids=["tensors", "size"])
def test_gguf_split_and_merge_match_reference(paths, how):
    d = paths["dir"]
    src = paths["f32"]
    out = {}
    for label, main in (("p", psplit.main), ("j", jsplit.main)):
        prefix = str(d / f"{label}_{how[0][14:]}" / "shard")
        os.makedirs(os.path.dirname(prefix), exist_ok=True)
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert main([*how, src, prefix]) == 0
        out[label] = (prefix, buf.getvalue())
    (pp, ptext), (jp, jtext) = out["p"], out["j"]
    assert ptext.replace(pp, "P") == jtext.replace(jp, "P")
    shards = sorted(os.listdir(os.path.dirname(pp)))
    assert shards == sorted(os.listdir(os.path.dirname(jp)))
    assert len(shards) > 1 and shards[0].endswith(
        "-00001-of-%05d.gguf" % len(shards))
    for f in shards:
        assert open(os.path.join(os.path.dirname(pp), f), "rb").read() == \
            open(os.path.join(os.path.dirname(jp), f), "rb").read(), f
    first = os.path.join(os.path.dirname(pp), shards[0])
    merged = {}
    for label, main in (("p", psplit.main), ("j", jsplit.main)):
        path = str(d / f"merged_{label}_{how[0][14:]}.gguf")
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert main(["--merge", first, path]) == 0
        merged[label] = (path, buf.getvalue())
    assert merged["p"][1].replace(merged["p"][0], "M") == \
        merged["j"][1].replace(merged["j"][0], "M")
    assert open(merged["p"][0], "rb").read() == \
        open(merged["j"][0], "rb").read()
    assert phash.hash_gguf(merged["p"][0]) == phash.hash_gguf(src) == \
        phash.hash_gguf(first)


def test_split_file_serves_like_the_whole(paths):
    d = paths["dir"]
    prefix = str(d / "serve" / "shard")
    os.makedirs(os.path.dirname(prefix))
    with redirect_stdout(io.StringIO()):
        shards = psplit.split(paths["f32"], prefix, max_tensors=7)
    assert len(shards) == 3
    runs = []
    for path in (shards[0], paths["f32"]):
        m = pengine.Model(path, device="cpu")
        ctx = pengine.Context(m, n_ctx=64, n_seq_max=1, block_size=8)
        logits = ctx.prefill(ctx.new_seq(), [3, 17, 42, 9], all_logits=True)
        ctx = pengine.Context(m, n_ctx=64, n_seq_max=1, block_size=8)
        runs.append((logits, list(pengine.generate(ctx, [3, 17, 42], 8))))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    assert runs[0][1] == runs[1][1]


@pytest.mark.parametrize("argv", [
    ["-p", "hello world the people"],
    ["-p", "hello world", "--ids", "--show-count"],
    ["-p", "<s>hello</s> world", "--no-bos", "--no-parse-special"],
], ids=["pieces", "ids", "no_special"])
def test_tokenize_prints_reference(paths, argv):
    mine, ref = both(ptok.main, jtok.main, ["-m", paths["tiny"], *argv])
    assert mine == ref and mine[0] == 0 and mine[1]


GRAMMAR = r'''root ::= "{" ws pair ("," ws pair)* ws "}"
pair ::= key ":" ws num
key ::= "\"" [a-z]+ "\""
num ::= "-"? [0-9]+
ws ::= [ \t\n]*
'''


@pytest.mark.parametrize("text,rc", [
    ('{"a": 1, "bc": -22}', 0),
    ('{"a": 1, "B": 2}', 1),     # refused at the capital
    ('{"a": 1', 1),              # incomplete
], ids=["valid", "invalid", "incomplete"])
def test_gbnf_validator_prints_reference(paths, text, rc):
    d = paths["dir"]
    g, t = str(d / "g.gbnf"), str(d / f"in_{len(text)}.txt")
    with open(g, "w") as f:
        f.write(GRAMMAR)
    with open(t, "w") as f:
        f.write(text)
    mine, ref = both(pgbnf.main, jgbnf.main, [g, t])
    assert mine == ref
    assert mine[0] == rc
    assert pgbnf.validate(GRAMMAR, text) == jgbnf.validate(GRAMMAR, text)
