"""Importance-matrix collection in the port (llama_cpp_test_tpu_torch/
runtime/imatrix.py) against the JAX package run op by op (jitted XLA
drops some bf16 roundings, 1.7e-3 apart on ffn_down): every tensor's sums
within a relative error (max abs difference over max abs) of 1e-3 on the
dense tiny fixture, and of 1e-2 on the tiny MoE fixture, router and
expert inputs included (there two of the 8192 bf16 attention outputs of
layer 0 round one ulp apart, and the difference grows to 2.5e-3 at the
output norm); the saved
file read by the JAX IMatrixCollector.load and used by the JAX
quantize_model; the entry point's file; and reference fault 8: the JAX
__counts__ column changes with PYTHONHASHSEED, the port's does not."""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from test_engine import make_tiny_gguf

from __graft_entry__ import _tiny_gguf
from llama_cpp_test_tpu.runtime import engine as jengine
from llama_cpp_test_tpu.runtime import imatrix as jimatrix
from llama_cpp_test_tpu_torch.runtime import engine as pengine
from llama_cpp_test_tpu_torch.runtime import imatrix as pimatrix

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-3
REL_MOE = 1e-2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist every
    worker's OpenMP pool takes all cores, and these small steps spin
    against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(a).max())


def tokens(n, seed=0, hi=280):
    return [int(t) for t in np.random.default_rng(seed).integers(3, hi, n)]


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("im") / "tiny.gguf")
    make_tiny_gguf(p)
    return p


def test_sums_match_reference_and_file_reads_back(path, tmp_path):
    jm, pm = jengine.Model(path), pengine.Model(path, device="cpu")
    toks = tokens(96)
    jc, pc = jimatrix.IMatrixCollector(jm), pimatrix.IMatrixCollector(pm)
    with jax.disable_jit():
        jc.collect(toks, chunk=32)
    pc.collect(toks, chunk=32)
    assert set(pc.sums) == set(jc.sums) and len(pc.sums) == 15
    for name, want in jc.sums.items():
        assert pc.sums[name].shape == want.shape
        assert rel_err(want, pc.sums[name]) < REL, name
    assert pc.counts == jc.counts == {n: 96 for n in jc.sums}
    out = str(tmp_path / "im.npz")
    pc.save(out)
    loaded = jimatrix.IMatrixCollector.load(out)
    assert set(loaded) == set(pc.sums)
    for name, v in loaded.items():
        np.testing.assert_array_equal(v, pc.sums[name])
    assert pimatrix.IMatrixCollector.load(out).keys() == loaded.keys()
    counts = np.load(out)["__counts__"]
    names = str(np.load(out)["__names__"]).split("\n")
    assert counts.tolist() == [[i, pc.counts[n]] for i, n in enumerate(names)]


def test_reference_quantize_model_takes_the_ports_imatrix(path, tmp_path):
    from llama_cpp_test_tpu.quant.quantize_model import quantize_model

    pc = pimatrix.IMatrixCollector(pengine.Model(path, device="cpu"))
    pc.collect(tokens(64, seed=1), chunk=32)
    out = str(tmp_path / "im.npz")
    pc.save(out)
    dst = str(tmp_path / "q.gguf")
    st = quantize_model(path, dst, "Q4_0",
                        imatrix=jimatrix.IMatrixCollector.load(out))
    assert st.tensors > 0
    assert pengine.Model(dst, device="cpu").hp.n_layer == 2


def test_moe_sums_match_reference_op_by_op(tmp_path):
    path = _tiny_gguf(str(tmp_path / "moe.gguf"), n_expert=4,
                      n_expert_used=2)
    jm, pm = jengine.Model(path), pengine.Model(path, device="cpu")
    toks = tokens(32, seed=2, hi=250)
    with jax.disable_jit():
        want = jimatrix._imatrix_step(jm.weights, np.asarray([toks], np.int32),
                                      hp=jm.hp)
    pc = pimatrix.IMatrixCollector(pm)
    pc.collect(toks, chunk=32)
    assert "blk.1.ffn_gate_exps.weight" in pc.sums
    assert set(pc.sums) == set(want)
    for name, v in want.items():
        assert rel_err(v, pc.sums[name]) < REL_MOE, name


def test_entry_point_writes_the_file(path, tmp_path):
    text = str(tmp_path / "calib.txt")
    with open(text, "w") as f:
        f.write("the world of the little house and the water " * 8)
    out = str(tmp_path / "cli.npz")
    assert pimatrix.main(["-m", path, "-f", text, "-o", out, "--chunk", "32"],
                         device="cpu") == 0
    m = pengine.Model(path, device="cpu")
    ids = m.tokenizer.encode(open(text).read(), add_special=True)
    pc = pimatrix.IMatrixCollector(m)
    pc.collect(ids, chunk=32)
    got = pimatrix.IMatrixCollector.load(out)
    assert set(got) == set(pc.sums)
    for name, v in got.items():
        np.testing.assert_array_equal(v, pc.sums[name])


_SAVE = r"""
import json, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
if sys.argv[2] == "jax":
    from llama_cpp_test_tpu.runtime.imatrix import IMatrixCollector
else:
    from llama_cpp_test_tpu_torch.runtime.imatrix import IMatrixCollector
c = IMatrixCollector(None)
for i, name in enumerate(["blk.0.attn_q.weight", "blk.0.ffn_down.weight",
                          "output.weight"]):
    c.sums[name] = np.full(4, float(i), np.float32)
    c.counts[name] = 32 * (i + 1)
c.save(sys.argv[3])
print(json.dumps(np.load(sys.argv[3])["__counts__"].tolist()))
"""


def test_counts_do_not_depend_on_the_hash_seed(tmp_path):
    """Reference fault 8 (ROADMAP §3): the JAX save keys __counts__ by
    hash(name), which Python salts per process; the port's rows are
    [index in __names__, count] under any seed."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    runs = {}
    for impl in ("jax", "torch"):          # four processes at once
        for seed in (1, 2):
            runs[impl, seed] = subprocess.Popen(
                [sys.executable, "-c", _SAVE, ROOT, impl,
                 str(tmp_path / f"{impl}{seed}.npz")],
                env={**env, "PYTHONHASHSEED": str(seed)},
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                cwd=str(tmp_path))
    got = {}
    for key, proc in runs.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-2000:]
        got[key] = json.loads(out.strip().splitlines()[-1])
    j1, j2 = got["jax", 1], got["jax", 2]
    assert [r[1] for r in j1] == [r[1] for r in j2] == [32, 64, 96]
    assert [r[0] for r in j1] != [r[0] for r in j2]
    assert got["torch", 1] == got["torch", 2] == [[0, 32], [1, 64], [2, 96]]
