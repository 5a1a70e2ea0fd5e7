"""The port's llama-cli (llama_cpp_test_tpu_torch/cli/main.py, the llama
branch) against the JAX CLI: the same argv on the tiny fixture prints the
same text, greedy (the JAX engine jitted) and seeded (the JAX engine op
by op, whose bf16 roundings the port keeps), and with LoRA adapters and
control vectors attached (against the JAX engine op by op: jitted XLA
flips a near tie of the adapted model); what the port does not carry
yet raises NotImplementedError instead of running something else."""
import contextlib
import io
import sys

import jax
import numpy as np
import pytest
import torch

from test_engine import make_tiny_gguf

from llama_cpp_test_tpu.cli.main import main as jmain
from llama_cpp_test_tpu_torch.cli.main import main as pmain
from llama_cpp_test_tpu_torch.gguf.writer import GGUFWriter
from llama_cpp_test_tpu_torch.runtime.engine import Model


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist every
    worker's OpenMP pool takes all cores, and the small steps these
    scenarios run by the hundred spin against each other (a 13 s module
    took minutes beside five other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cli") / "tiny.gguf")
    make_tiny_gguf(path)
    return path


def run(main, argv, **kw):
    old = sys.stdout
    sys.stdout = io.StringIO()
    try:
        rc = main(argv, **kw)
        return rc, sys.stdout.getvalue()
    finally:
        sys.stdout = old


@pytest.mark.parametrize("extra,op_by_op", [
    (["--temp", "0"], False),
    (["--temp", "0", "-ctk", "q8_0", "-r", "ab"], False),
    # past n_ctx: the jitted JAX K-shift rounds the re-rotated K otherwise
    (["--temp", "0", "-c", "32", "--keep", "2", "-n", "24"], True),
])
def test_greedy_text_matches_reference(model_path, extra, op_by_op):
    argv = ["-m", model_path, "-p", "hello world", "-n", "14"] + extra
    with jax.disable_jit() if op_by_op else contextlib.nullcontext():
        want = run(jmain, argv)
    got = run(pmain, argv, device="cpu")
    assert got == want and got[0] == 0
    assert got[1].startswith("hello world")


def test_seeded_text_matches_reference_op_by_op(model_path):
    argv = ["-m", model_path, "-p", "the world", "-n", "6", "--temp", "0.8",
            "--seed", "5", "--repeat-penalty", "1.2"]
    with jax.disable_jit():
        want = run(jmain, argv)
    assert run(pmain, argv, device="cpu") == want


@pytest.mark.parametrize("extra", [[], ["--prompt-cache-all"]])
def test_prompt_cache_restores_and_prints_the_same(model_path, tmp_path,
                                                   extra):
    """--prompt-cache run twice (reference cli/main.py:236-301): the first
    run saves the session, the second restores it, prefills only what the
    file does not hold and prints the same text as the JAX CLI; a
    --prompt-cache-ro run leaves the file as it was."""
    import numpy as np

    sess = str(tmp_path / "session.npz")
    argv = ["-m", model_path, "-p", "hello world", "-n", "10", "--temp", "0",
            "--prompt-cache", sess] + extra
    want = run(jmain, argv[:-2 - len(extra)])
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        first = run(pmain, argv, device="cpu")
        saved = json_meta(sess)
        second = run(pmain, argv, device="cpu")
        run(pmain, argv + ["--prompt-cache-ro", "-p", "other"], device="cpu")
    assert first == want and second == want
    assert err.getvalue().count("session restored") == 2
    n_prompt = len(Model(model_path, device="cpu").tokenizer.encode(
        "hello world", add_special=True, parse_special=True))
    assert saved["n_cached"] == len(saved["tokens"])
    if extra:
        assert saved["n_cached"] > n_prompt
    else:
        assert saved["n_cached"] == n_prompt
    assert json_meta(sess) == saved
    assert np.load(sess)["k0"].shape[1] == saved["n_cached"]


def json_meta(path):
    import json

    import numpy as np

    return json.loads(str(np.load(path)["meta"]))


def test_empty_prompt_errors(model_path):
    assert run(pmain, ["-m", model_path, "-n", "4"], device="cpu")[0] == 1


@pytest.fixture(scope="module")
def adapters(tmp_path_factory):
    """Two LoRA adapters over the tiny fixture (all seven targets of every
    layer, and attn_q/ffn_down only) and a control vector for both layers."""
    from test_torch_lora import TINY_DIMS, write_adapter

    d = tmp_path_factory.mktemp("adapters")
    cv = str(d / "cv.gguf")
    w = GGUFWriter(cv, arch="controlvector")
    rng = np.random.default_rng(9)
    for il in (1, 2):
        w.add_tensor(f"direction.{il}",
                     rng.standard_normal(64).astype(np.float32))
    w.write()
    return {"a1": write_adapter(str(d / "a1.gguf"), TINY_DIMS, 2, seed=1),
            "a2": write_adapter(str(d / "a2.gguf"), TINY_DIMS, 2, rank=2,
                                seed=2, targets=("attn_q", "ffn_down")),
            "cv": cv}


@pytest.mark.parametrize("flags", [
    ["--lora", "a1"], ["--lora-scaled", "a1", "0.6"],
    ["--control-vector", "cv"],
    ["--control-vector-scaled", "cv", "0.5", "--lora", "a2"]])
def test_adapter_text_matches_reference(model_path, adapters, flags):
    flags = [adapters.get(f, f) for f in flags]
    argv = ["-m", model_path, "-p", "hello world", "-n", "14",
            "--temp", "0"] + flags
    with jax.disable_jit():
        want = run(jmain, argv)
    got = run(pmain, argv, device="cpu")
    assert got == want and got[0] == 0
    assert got != run(pmain, argv[:8], device="cpu")   # the adapter acts


def test_several_loras_all_apply(model_path, adapters):
    """Reference fault 9 (ROADMAP §3): the JAX CLI's --lora loop keeps only
    the last adapter; the port stacks them all (attach_loras)."""
    argv = ["-m", model_path, "-p", "hello world", "-n", "14", "--temp", "0"]
    both = ["--lora", adapters["a1"], "--lora", adapters["a2"]]
    last = ["--lora-scaled", adapters["a2"], "1.0"]
    assert run(jmain, argv + both) == run(jmain, argv + last)
    got = run(pmain, argv + both, device="cpu")
    assert got[0] == 0
    assert got != run(pmain, argv + last, device="cpu")


@pytest.mark.parametrize("flags", [["-tp", "2"]])
def test_unported_options_raise(model_path, flags):
    with pytest.raises(NotImplementedError, match="ROADMAP item"):
        run(pmain, ["-m", model_path, "-p", "hi", "-n", "2"] + flags,
            device="cpu")


@pytest.mark.parametrize("arch", ["t5", "t5encoder", "wavtokenizer-dec"])
def test_other_families_raise(tmp_path, arch):
    """The families of ROADMAP item 9 through the CLI, as the reference's
    CLI takes them: a t5 file prints its greedy pieces, a t5encoder file
    is embedding-only (return 1), a wavtokenizer-dec file raises the
    reference's ValueError naming its loader (the tts CLI drives it)."""
    from test_torch_t5 import TEXT, t5_file

    from llama_cpp_test_tpu_torch.models import t5 as pt5

    if arch == "wavtokenizer-dec":
        path = str(tmp_path / f"{arch}.gguf")
        GGUFWriter(path, arch=arch).write()
        with pytest.raises(ValueError, match="load_wavtokenizer"):
            run(pmain, ["-m", path, "-p", "hi", "-n", "2"], device="cpu")
        return
    path = t5_file(tmp_path, arch=arch)
    rc, out = run(pmain, ["-m", path, "-p", TEXT, "-n", "8"], device="cpu")
    if arch == "t5encoder":
        assert (rc, out) == (1, "")
        return
    m = pt5.T5Model(path, device="cpu")
    toks = list(pt5.generate(pt5.T5Context(m, n_ctx=64), m.tokenizer.encode(
        TEXT, add_special=True), 8, eos_id=m.tokenizer.vocab.eos_id))
    assert rc == 0 and toks
    assert out == "".join(m.tokenizer.token_to_piece(t) for t in toks) + "\n"


def test_default_device_is_cuda(model_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        run(pmain, ["-m", model_path, "-p", "hi", "-n", "2"])
