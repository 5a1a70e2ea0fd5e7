"""The port's native repack (llama_cpp_test_tpu_torch/native/ggufio.cpp,
bound by native/__init__.py) against its numpy repack (quant/repack.py
with NATIVE off), on the CPU.

Checks, after tests/test_native_repack.py: for Q8_0, Q4_0, Q4_1, Q4_K and
Q6_K at (256, 512), (100, 256) (padded rows) and TinyLlama's ffn_gate
width (5632, 2048), in both layouts ("t" and "rows"), the planes are bit
for bit the numpy repack's (qs, and the scales and mins as bf16 bits or
f32), and equal the JAX package's numpy repack; the port's Model on a Q4_K
file gives the same planes and logits either way; a source that does not
compile raises with g++'s output (no quiet numpy fallback), and three
processes that build at once leave one library that loads."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_gguf

from llama_cpp_test_tpu.gguf.constants import GGMLType as JT
from llama_cpp_test_tpu.quant import repack as jrepack
from llama_cpp_test_tpu_torch import native
from llama_cpp_test_tpu_torch.gguf.constants import GGMLType as PT
from llama_cpp_test_tpu_torch.quant import codecs, repack
from llama_cpp_test_tpu_torch.runtime import engine as pengine
from llama_cpp_test_tpu_torch.weights import host_array

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TYPES = ("Q8_0", "Q4_0", "Q4_1", "Q4_K", "Q6_K")
SHAPES = ((256, 512), (100, 256), (5632, 2048))


def _raw(name, n, k):
    rng = np.random.default_rng(n + k)
    w = (rng.standard_normal((n, k)) * 0.3).astype(np.float32)
    w[:, :5] += 0.5                          # a nonzero min per row
    return codecs.quantize(w, PT[name], weights=None)


def _repack(raw, name, n, k, layout, native_on, mp):
    mp.setattr(repack, "NATIVE", native_on)
    return repack.repack(raw, PT[name], n, k, layout=layout)


def _planes(qt):
    return {f: getattr(qt, f) for f in ("qs", "scale", "min_", "lut")}


@pytest.mark.parametrize("n,k", SHAPES, ids=lambda v: str(v))
@pytest.mark.parametrize("name", TYPES)
def test_native_planes_equal_numpy(name, n, k, monkeypatch):
    raw = _raw(name, n, k)
    for layout in ("t", "rows"):
        got = _repack(raw, name, n, k, layout, True, monkeypatch)
        want = _repack(raw, name, n, k, layout, False, monkeypatch)
        assert (got.kind, got.shape, got.n_orig, got.group, got.layout,
                got.ggml_type) == (want.kind, want.shape, want.n_orig,
                                   want.group, want.layout, want.ggml_type)
        for f, a in _planes(want).items():
            b = getattr(got, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert (b.dtype, b.shape) == (a.dtype, a.shape), f
                np.testing.assert_array_equal(b, a, err_msg=f"{layout} {f}")
                assert b.flags.c_contiguous
        if layout == "t" and k == 256:
            # and the JAX package's numpy repack (bf16 planes as bits)
            monkeypatch.setattr(jrepack, "USE_NATIVE", False)
            ref = jrepack.repack(raw, JT[name], n, k, layout="t")
            np.testing.assert_array_equal(got.qs, ref.qs)
            np.testing.assert_array_equal(got.scale, host_array(ref.scale))


def test_model_loads_the_same_either_way(tmp_path, monkeypatch):
    """A Q4_K file (Q4_K planes, a Q4_K embedding in rows layout) loads to
    the same planes and logits through either repack."""
    path = str(tmp_path / "q4k.gguf")
    _tiny_gguf(path)
    runs = []
    for native_on in (True, False):
        monkeypatch.setattr(repack, "NATIVE", native_on)
        m = pengine.Model(path, device="cpu")
        ctx = pengine.Context(m, n_ctx=64, n_seq_max=1, block_size=8)
        runs.append((m, ctx.prefill(ctx.new_seq(), [3, 17, 42, 9],
                                    all_logits=True)))
    (a, la), (b, lb) = runs
    assert a.weights.tok_embd.layout == "rows"
    for qa, qb in ((a.weights.tok_embd, b.weights.tok_embd),
                   (a.weights.layers[1].w_down, b.weights.layers[1].w_down)):
        assert qa.ggml_type == PT.Q4_K
        for f in ("qs", "scale", "min_"):
            ta, tb = getattr(qa, f), getattr(qb, f)
            assert ta.dtype == tb.dtype and torch.equal(ta, tb), f
    np.testing.assert_array_equal(la, lb)


def test_bad_sizes_raise():
    raw = _raw("Q8_0", 4, 64)
    with pytest.raises(ValueError, match="no 5 rows"):
        native.native_planes(raw, PT.Q8_0, 5, 64, 256)


def test_broken_source_raises_and_does_not_fall_back(tmp_path, monkeypatch):
    src = str(tmp_path / "ggufio.cpp")
    shutil.copy(native.SOURCE, src)
    with open(src, "a") as f:
        f.write("\nthis is not C++;\n")
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(repack, "NATIVE", True)
    raw = _raw("Q8_0", 4, 64)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        repack.repack(raw, PT.Q8_0, 4, 64)
    assert "error" in str(e.value)
    assert not [f for f in os.listdir(tmp_path / "build")
                if f.endswith(".so")]


_BUILD = r"""
import sys
sys.path.insert(0, sys.argv[1])
from llama_cpp_test_tpu_torch import native
native.BUILD_DIR = sys.argv[2]
print(native.get_lib().ggufio_supports(12), native.get_lib().ggufio_supports(16))
"""


def test_concurrent_builds_leave_one_library(tmp_path):
    build = str(tmp_path / "build")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, ROOT, build],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0, 0], outs
    assert [o.split() for o, _ in outs] == [["1", "0"]] * 3
    assert sorted(os.listdir(build)) == \
        [os.path.basename(native.lib_path(native.SOURCE, build))]
