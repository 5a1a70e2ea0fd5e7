"""Import boundary and device rules of the port (llama_cpp_test_tpu_torch):
it loads no JAX, nothing of the JAX package and no ml_dtypes, on the dense
path, on the MoE + q8_0-KV path and on an IQ4_XS file, and asking for CUDA
where there is none raises instead of running on the CPU."""
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
