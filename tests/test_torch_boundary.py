"""Import boundary and device rules of the port (llama_cpp_test_tpu_torch):
it loads no JAX, nothing of the JAX package and no ml_dtypes, on the dense
path, on the MoE + q8_0-KV path, on an IQ4_XS file, in its kernel probes
(which load nothing of the JAX package's tools/ either) and through the
CLI, the scheduler, device sampling and the tokenizers (which load no
`regex` either), through LoRA, control vectors, tracing, imatrix,
lookahead, prompt lookup and their CLIs, through T5 (its Context and the
CLI's T5 branch) and the vocoder (cli.tts --codes), through the
quantizers, the native repack and the host-only file tools, and asking
for CUDA where there is none raises instead of running on the CPU."""
import json
import os
import subprocess
import sys

import pytest
import torch

from test_engine import make_tiny_gguf

from __graft_entry__ import _tiny_gguf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RUN = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
from llama_cpp_test_tpu_torch.runtime.engine import Context, Model
m = Model(sys.argv[2], device="cpu")
ctx = Context(m, n_ctx=64, n_seq_max=2, block_size=8)
logits = ctx.prefill(ctx.new_seq(), [3, 17, 42, 9])
if len(sys.argv) > 3:    # a MoE file, served over q8_0 pools
    moe = Model(sys.argv[3], device="cpu")
    mctx = Context(moe, n_ctx=64, n_seq_max=2, block_size=8, kv_type="q8_0")
    s = mctx.new_seq()
    mctx.prefill(s, [3, 17, 42, 9])
    logits = np.concatenate([logits, mctx.decode([s], [5])[0]])
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "jaxlib", "ml_dtypes",
                                             "llama_cpp_test_tpu."))
             or k == "llama_cpp_test_tpu")
print(json.dumps({"finite": bool(np.isfinite(logits).all()),
                  "shape": list(logits.shape), "bad": bad}))
"""


def _run_port(tmp_path, *paths):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _RUN, ROOT, *paths], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax_reference_or_ml_dtypes(tmp_path):
    path = str(tmp_path / "tiny.gguf")
    make_tiny_gguf(path)
    res = _run_port(tmp_path, path)
    assert res["bad"] == []
    assert res["finite"] and res["shape"] == [288]


def test_moe_q8_path_imports_no_jax_reference_or_ml_dtypes(tmp_path):
    """The same after a MoE prefill and decode over q8_0 pools."""
    path = str(tmp_path / "tiny.gguf")
    make_tiny_gguf(path)
    moe = _tiny_gguf(str(tmp_path / "moe.gguf"), n_expert=4, n_expert_used=2)
    res = _run_port(tmp_path, path, moe)
    assert res["bad"] == []
    assert res["finite"] and res["shape"] == [288 + 256]


def test_iq4xs_path_imports_no_jax_reference_or_ml_dtypes(tmp_path):
    """The same after loading and prefilling an IQ4_XS file (u4lut planes,
    the i-quant codecs and their grid tables)."""
    from llama_cpp_test_tpu.gguf.constants import GGMLType
    from llama_cpp_test_tpu.quant.quantize_model import quantize_model

    src, path = str(tmp_path / "f32.gguf"), str(tmp_path / "iq4xs.gguf")
    _tiny_gguf(src, qtype=GGMLType.F32)
    quantize_model(src, path, "IQ4_XS")
    res = _run_port(tmp_path, path)
    assert res["bad"] == []
    assert res["finite"] and res["shape"] == [256]


_PROBES = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from llama_cpp_test_tpu_torch.tools import kbench, pairprobe
x, q, s = kbench.make_data(k=256, n=256)
outs = [kbench.probe_gemv(f, torch.from_numpy(x), *(torch.from_numpy(a)
        for a in kbench.pack(f, q, s))) for f in "FGH"]
a = torch.randint(0, 256, (1024, 1024), dtype=torch.uint8)
outs.append(kbench.stream_colsum(torch.zeros(1, 128), a))
ok = pairprobe.correctness_check("cpu")
bad = sorted(k for k in sys.modules
             if k in ("jax", "llama_cpp_test_tpu", "tools", "ml_dtypes")
             or k.startswith(("jax.", "jaxlib", "ml_dtypes.",
                              "llama_cpp_test_tpu.", "tools.")))
print(json.dumps({"finite": ok and all(bool(torch.isfinite(o).all())
                                       for o in outs), "bad": bad}))
"""


def test_probe_tools_import_no_jax_reference_or_tools(tmp_path):
    """The probes' plain versions and the pairs correctness check run on
    the CPU without JAX, the JAX package or its tools/ package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBES, ROOT], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"finite": True, "bad": []}


def test_cuda_device_raises_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-GPU rule is moot")
    from llama_cpp_test_tpu_torch.device import resolve_device
    from llama_cpp_test_tpu_torch.runtime.engine import Model

    path = str(tmp_path / "tiny.gguf")
    make_tiny_gguf(path)
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(path, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(path)          # the default device is CUDA
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


_SERVE = r"""
import importlib.abc, io, json, sys
from contextlib import redirect_stdout
sys.path.insert(0, sys.argv[1])


class _Blocked(importlib.abc.MetaPathFinder):
    # any import of these fails, as on a machine that lacks them
    NAMES = ("jax", "jaxlib", "llama_cpp_test_tpu", "ml_dtypes", "regex",
             "aiohttp")

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in self.NAMES:
            raise ImportError(f"{name} is blocked")
        return None


sys.meta_path.insert(0, _Blocked())
from llama_cpp_test_tpu_torch.cli.main import main
from llama_cpp_test_tpu_torch.runtime import speculative, state
from llama_cpp_test_tpu_torch.server import app, chat
from llama_cpp_test_tpu_torch.runtime.engine import Context, Model
from llama_cpp_test_tpu_torch.runtime.sampling import SamplerParams
from llama_cpp_test_tpu_torch.runtime.scheduler import GenRequest, Scheduler
from llama_cpp_test_tpu_torch.tokenizer import load_tokenizer
buf = io.StringIO()
with redirect_stdout(buf):
    rc = main(["-m", sys.argv[2], "-p", "hello", "-n", "4", "--temp", "0",
               "--json-schema", '{"type": "integer"}'], device="cpu")
m = Model(sys.argv[2], device="cpu")
sched = Scheduler(Context(m, n_ctx=64, n_seq_max=2, block_size=8), n_slots=2)
reqs = [sched.submit(GenRequest([3, 17, 42], max_tokens=6, ignore_eos=True,
                                sampling=SamplerParams(seed=i)))
        for i in range(2)]
sched.run()
ctx = Context(m, n_ctx=64, n_seq_max=4, block_size=8, kv_type="q8_0")
s = ctx.new_seq()
ctx.prefill(s, [3, 17, 42, 9])
state.save_seq_state(ctx, s, "seq.npz")
restored = state.load_seq_state(ctx, "seq.npz").tokens == s.tokens
emb = ctx.embed([3, 17, 42], causal=False)
spec = speculative.SpeculativeDecoder(
    Context(m, n_ctx=64, n_seq_max=1, block_size=8),
    Context(m, n_ctx=64, n_seq_max=1, block_size=8),
    speculative.SpecParams(n_draft=3, p_min=0.0)).generate([3, 17, 42], 6)
served = {"web": app.web is None, "restored": restored,
          "emb": list(emb.shape), "spec": len(spec),
          "chat": chat.apply_chat_template({}, [
              {"role": "user", "content": "hi"}]).endswith("assistant\n"),
          "temp": app._sampling_from_body({"temperature": 0.5}).temp}
bpe = load_tokenizer({"tokenizer.ggml.model": "gpt2",
                      "tokenizer.ggml.pre": "llama-bpe",
                      "tokenizer.ggml.tokens": ["a", "b", "ab"],
                      "tokenizer.ggml.merges": ["a b"]})
bad = sorted(k for k in sys.modules
             if k in ("jax", "llama_cpp_test_tpu", "ml_dtypes", "regex")
             or k.startswith(("jax.", "jaxlib", "ml_dtypes.",
                              "llama_cpp_test_tpu.", "regex.")))
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in _Blocked.NAMES) or bad
print(json.dumps({"rc": rc, "text": buf.getvalue(), "served": served,
                  "tokens": [len(r.output_tokens) for r in reqs],
                  "bpe": bpe.encode("ab", add_special=False), "bad": bad}))
"""


def test_serving_path_imports_no_jax_reference_ml_dtypes_or_regex(tmp_path):
    """The CLI (with a JSON-schema grammar), the scheduler's windows over
    device sampling, a BPE tokenizer, the server's modules (server.app
    without aiohttp), a q8_0 session file, an embedding and speculative
    decoding run with JAX, the JAX package, ml_dtypes, regex and aiohttp
    blocked, and load none of them."""
    path = str(tmp_path / "tiny.gguf")
    make_tiny_gguf(path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _SERVE, ROOT, path], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert res["rc"] == 0 and res["text"].startswith("hello")
    assert res["tokens"] == [6, 6] and res["bpe"] == [2]
    assert res["served"] == {"web": True, "restored": True, "emb": [64],
                             "spec": 6, "chat": True, "temp": 0.5}


_ADAPTERS = r"""
import importlib.abc, io, json, sys
from contextlib import redirect_stdout
sys.path.insert(0, sys.argv[1])


class _Blocked(importlib.abc.MetaPathFinder):
    NAMES = ("jax", "jaxlib", "llama_cpp_test_tpu", "ml_dtypes", "regex")

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in self.NAMES:
            raise ImportError(f"{name} is blocked")
        return None


sys.meta_path.insert(0, _Blocked())
import numpy as np
from llama_cpp_test_tpu_torch.cli import (cvector_generator, eval_callback,
                                          export_lora, lookahead, lookup)
from llama_cpp_test_tpu_torch.cli.main import main
from llama_cpp_test_tpu_torch.gguf.writer import GGUFWriter
from llama_cpp_test_tpu_torch.models import cvec, lora
from llama_cpp_test_tpu_torch.runtime import (imatrix, lookahead as la,
                                              ngram_cache, tracing)
from llama_cpp_test_tpu_torch.runtime.engine import Context, Model
path = sys.argv[2]
rng = np.random.default_rng(0)
w = GGUFWriter("a.gguf", arch="llama")
w.add_kv("adapter.lora.alpha", 8.0)
for t, (n, k) in {"attn_q": (64, 64), "ffn_down": (64, 96)}.items():
    w.add_tensor(f"blk.0.{t}.weight.lora_a",
                 rng.standard_normal((4, k)).astype(np.float32) * 0.1)
    w.add_tensor(f"blk.0.{t}.weight.lora_b",
                 rng.standard_normal((n, 4)).astype(np.float32) * 0.1)
w.write()
m = Model(path, device="cpu")
lora.attach_lora(m.weights, lora.load_lora("a.gguf", m.hp))
ctx = Context(m, n_ctx=64, n_seq_max=2, block_size=8)
traces = tracing.trace_eval(ctx, [3, 17, 42])
dirs = cvec.generate_control_vector(ctx, ["good day"], ["bad day"], "c.gguf")
coll = imatrix.IMatrixCollector(m)
coll.collect([int(t) for t in rng.integers(3, 280, 32)], chunk=32)
coll.save("im.npz")
toks = la.LookaheadDecoder(ctx).generate([3, 17, 42], 6)
toks += ngram_cache.LookupDecoder(ctx).generate([3, 17, 42], 6)
ngram_cache.NGramCache().save("n.bin")
buf = io.StringIO()
with redirect_stdout(buf):
    rcs = [main(["-m", path, "-p", "hi", "-n", "3", "--temp", "0",
                 "--lora", "a.gguf", "--control-vector", "c.gguf"],
                device="cpu"),
           export_lora.main(["-m", path, "--lora", "a.gguf", "-o", "x.gguf"]),
           eval_callback.main(["-m", path, "-p", "hi"], device="cpu"),
           lookup.main(["--merge", "n.bin", "n.bin", "-o", "m.bin"])]
bad = sorted(k for k in sys.modules if k.split(".")[0] in _Blocked.NAMES)
print(json.dumps({"rcs": rcs, "names": [t.name for t in traces],
                  "dirs": sorted(dirs), "sums": len(coll.sums),
                  "tokens": len(toks), "bad": bad}))
"""


def test_adapter_and_drafter_modules_import_no_jax_or_reference(tmp_path):
    """LoRA, control vectors, tracing, imatrix, lookahead, prompt lookup
    and their CLIs run with JAX, the JAX package, ml_dtypes and regex
    blocked, and load none of them."""
    path = str(tmp_path / "tiny.gguf")
    make_tiny_gguf(path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _ADAPTERS, ROOT, path],
                         env=env, capture_output=True, text=True, timeout=300,
                         cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"rcs": [0, 0, 0, 0],
                   "names": ["inp_embd", "l_out-0", "l_out-1",
                             "result_output"],
                   "dirs": [1, 2], "sums": 15, "tokens": 12, "bad": []}


@pytest.mark.parametrize("entry", ["cli.lookahead", "cli.lookup",
                                   "cli.eval_callback",
                                   "cli.cvector_generator",
                                   "runtime.imatrix"])
def test_new_entry_points_default_to_cuda(tmp_path, entry):
    """Each entry point that runs the model asks for CUDA unless the
    caller passes device=, and raises where there is none."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-GPU rule is moot")
    path = str(tmp_path / "tiny.gguf")
    make_tiny_gguf(path)
    text = str(tmp_path / "t.txt")
    with open(text, "w") as f:
        f.write("hello world\n")
    argv = {"cli.lookahead": ["-m", path, "-p", "hi"],
            "cli.lookup": ["-m", path, "-p", "hi"],
            "cli.eval_callback": ["-m", path],
            "cli.cvector_generator": ["-m", path, "--positive-file", text,
                                      "--negative-file", text],
            "runtime.imatrix": ["-m", path, "-f", text]}[entry]
    main = importlib.import_module(f"llama_cpp_test_tpu_torch.{entry}").main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)


_T5_TTS = r"""
import importlib.abc, io, json, sys
from contextlib import redirect_stdout
sys.path.insert(0, sys.argv[1])


class _Blocked(importlib.abc.MetaPathFinder):
    NAMES = ("jax", "jaxlib", "llama_cpp_test_tpu", "ml_dtypes", "regex")

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in self.NAMES:
            raise ImportError(f"{name} is blocked")
        return None


sys.meta_path.insert(0, _Blocked())
import numpy as np
from llama_cpp_test_tpu_torch.cli import main as cli, tts
from llama_cpp_test_tpu_torch.models import t5, wavtokenizer
m = t5.T5Model(sys.argv[2], device="cpu")
ctx = t5.T5Context(m, n_ctx=16)
enc = ctx.encode([3, 17, 42, 9])
logits = [ctx.decode(t) for t in (0, 7, 22)]
buf = io.StringIO()
with redirect_stdout(buf):
    rc = cli.main(["-m", sys.argv[2], "-p", "hello world", "-n", "4"],
                  device="cpu")
rc_tts = tts.main(["-mv", sys.argv[3], "--codes", "1,2,3,4,5", "-o", "o.wav"],
                  device="cpu")
voc = wavtokenizer.load_wavtokenizer(sys.argv[3], device="cpu")
bad = sorted(k for k in sys.modules if k.split(".")[0] in _Blocked.NAMES)
print(json.dumps({"enc": list(enc.shape), "finite": bool(
    np.isfinite(np.stack(logits)).all()), "rc": [rc, rc_tts],
    "text": bool(buf.getvalue().strip()), "n_fft": voc.n_fft, "bad": bad}))
"""


def test_t5_and_tts_import_no_jax_or_reference(tmp_path):
    """T5 encode + decode, cli.main's T5 branch and cli.tts --codes (the
    vocoder alone) run with JAX, the JAX package, ml_dtypes and regex
    blocked, and load none of them."""
    from test_torch_t5 import t5_file
    from test_tts import make_vocoder

    import numpy as np

    path = t5_file(tmp_path, "gated_untied")
    voc = str(tmp_path / "voc.gguf")
    make_vocoder(voc, np.random.default_rng(0))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _T5_TTS, ROOT, path, voc],
                         env=env, capture_output=True, text=True, timeout=300,
                         cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"enc": [4, 48], "finite": True, "rc": [0, 0],
                   "text": True, "n_fft": 64, "bad": []}


_QUANT_TOOLS = r"""
import importlib.abc, io, json, sys
from contextlib import redirect_stderr, redirect_stdout
sys.path.insert(0, sys.argv[1])


class _Blocked(importlib.abc.MetaPathFinder):
    NAMES = ("jax", "jaxlib", "llama_cpp_test_tpu", "ml_dtypes", "regex")

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in self.NAMES:
            raise ImportError(f"{name} is blocked")
        return None


sys.meta_path.insert(0, _Blocked())
import numpy as np
from llama_cpp_test_tpu_torch import native
from llama_cpp_test_tpu_torch.cli import (gbnf_validator, gguf_hash, gguf_split,
                                          quantize_stats, tokenize)
from llama_cpp_test_tpu_torch.quant import codecs, iq_quantize, quantize_model
from llama_cpp_test_tpu_torch.runtime import imatrix
from llama_cpp_test_tpu_torch.runtime.engine import Context, Model
path = sys.argv[2]
m = Model(path, device="cpu")
coll = imatrix.IMatrixCollector(m)
coll.collect(list(range(3, 67)), chunk=32)
coll.save("im.npz")
x = np.random.default_rng(0).standard_normal((2, 256)).astype(np.float32)
iq = codecs.quantize(x, codecs.GGMLType.IQ2_XS)
with open("g.gbnf", "w") as f:
    f.write('root ::= [a-z]+')
with open("in.txt", "w") as f:
    f.write("abc")
buf = io.StringIO()
with redirect_stdout(buf), redirect_stderr(io.StringIO()):
    rcs = [quantize_model.main([path, "q.gguf", "Q8_0", "--imatrix", "im.npz"]),
           quantize_stats.main(["-m", path, "-t", "Q8_0"]),
           gguf_hash.main(["q.gguf"]),
           gguf_split.main(["--split-max-tensors", "8", "q.gguf", "s"]),
           tokenize.main(["-m", path, "-p", "hello", "--ids"]),
           gbnf_validator.main(["g.gbnf", "in.txt"])]
split = Model("s-00001-of-00003.gguf", device="cpu")     # native repack
ctx = Context(split, n_ctx=64, n_seq_max=1, block_size=8)
logits = ctx.prefill(ctx.new_seq(), [3, 17, 42])
bad = sorted(k for k in sys.modules if k.split(".")[0] in _Blocked.NAMES)
print(json.dumps({"rcs": rcs, "iq": list(iq.shape), "libs": len(native._libs),
                  "finite": bool(np.isfinite(logits).all()), "bad": bad}))
"""


def test_quantize_and_file_tools_import_no_jax_or_reference(tmp_path):
    """The quantizers (quantize_model with an imatrix the port collected,
    an i-quant encoder), the native repack of a split Q8_0 file and the
    host-only CLIs (quantize_stats, gguf_hash, gguf_split, tokenize,
    gbnf_validator) run with JAX, the JAX package, ml_dtypes and regex
    blocked, and load none of them."""
    path = str(tmp_path / "tiny.gguf")
    make_tiny_gguf(path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _QUANT_TOOLS, ROOT, path],
                         env=env, capture_output=True, text=True, timeout=300,
                         cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"rcs": [0, 0, 0, 0, 0, 0], "iq": [2, 74], "libs": 1,
                   "finite": True, "bad": []}
