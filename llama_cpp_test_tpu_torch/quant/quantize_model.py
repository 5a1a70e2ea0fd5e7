"""Requantize a GGUF model (the llama-quantize analogue).

Counterpart of llama_cpp_test_tpu/quant/quantize_model.py: streams a GGUF
tensor by tensor and encodes each weight by the target file type's
per-tensor rules (llama_tensor_get_type in llama.cpp's
src/llama-quant.cpp): a Q4_K_M file upgrades ffn_down and attn_v to Q6_K
and keeps a Q6_K head, the IQ2/IQ1 files keep higher types for the
embedding, the head, attn_v and ffn_down, and norms, biases and vectors
stay F32. An importance matrix (runtime/imatrix.py's .npz) weights the
fits of the tensors it names. Host only: numpy, no device.

    python -m llama_cpp_test_tpu_torch.quant.quantize_model src.gguf \\
        dst.gguf Q4_K_M [--imatrix imatrix.npz] [--fast]
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Callable

import numpy as np

from ..gguf.constants import GGML_BLOCK_SIZES, GGMLType
from ..gguf.reader import GGUFReader
from ..gguf.writer import GGUFWriter
from . import codecs

# file-type presets (LLAMA_FTYPE_MOSTLY_* of llama.cpp's include/llama.h);
# general.file_type is written as the preset's index in this table, as
# the reference writes it
FTYPES = {
    "Q4_0": GGMLType.Q4_0,
    "Q4_1": GGMLType.Q4_1,
    "Q5_0": GGMLType.Q5_0,
    "Q5_1": GGMLType.Q5_1,
    "Q8_0": GGMLType.Q8_0,
    "Q2_K": GGMLType.Q2_K,
    "Q3_K_S": GGMLType.Q3_K, "Q3_K_M": GGMLType.Q3_K, "Q3_K_L": GGMLType.Q3_K,
    "Q4_K_S": GGMLType.Q4_K, "Q4_K_M": GGMLType.Q4_K,
    "Q5_K_S": GGMLType.Q5_K, "Q5_K_M": GGMLType.Q5_K,
    "Q6_K": GGMLType.Q6_K,
    "IQ4_NL": GGMLType.IQ4_NL,
    "IQ4_XS": GGMLType.IQ4_XS,
    "IQ2_XXS": GGMLType.IQ2_XXS,
    "IQ2_XS": GGMLType.IQ2_XS,
    "IQ2_S": GGMLType.IQ2_S, "IQ2_M": GGMLType.IQ2_S,
    "IQ3_XXS": GGMLType.IQ3_XXS,
    "IQ3_S": GGMLType.IQ3_S, "IQ3_M": GGMLType.IQ3_S,
    "IQ1_S": GGMLType.IQ1_S,
    "IQ1_M": GGMLType.IQ1_M,
    "F16": GGMLType.F16,
    "BF16": GGMLType.BF16,
}


def tensor_target_type(name: str, ftype: str, base: GGMLType,
                       n_expert: int = 0) -> GGMLType:
    """The type of one tensor of an ftype file whose base type is base
    (the reference's rules, its *_M upgrades and its i-quant rules)."""
    if name == "output_norm.weight" or name.endswith("_norm.weight") or \
            name.endswith(".bias"):
        return GGMLType.F32
    if name == "output.weight":
        # the head takes at least Q6_K in a K-quant file, Q5_K in an
        # i-quant one
        if base in (GGMLType.IQ2_XXS, GGMLType.IQ2_XS, GGMLType.IQ3_XXS,
                    GGMLType.IQ1_S):
            return GGMLType.Q5_K
        if base in (GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q4_K,
                    GGMLType.Q5_K, GGMLType.Q4_0, GGMLType.Q4_1):
            return GGMLType.Q6_K
        return base
    if name == "token_embd.weight":
        if base in (GGMLType.IQ2_XXS, GGMLType.IQ2_XS, GGMLType.IQ1_S):
            return GGMLType.Q2_K
        if base == GGMLType.IQ3_XXS:
            return GGMLType.Q3_K
        return base
    if ftype in ("IQ2_XXS", "IQ2_XS", "IQ2_S", "IQ2_M", "IQ1_S"):
        if ".attn_v.weight" in name:
            return GGMLType.Q4_K
        if ".ffn_down" in name:
            return GGMLType.IQ3_XXS if ftype != "IQ1_S" else GGMLType.IQ2_XXS
    if ftype in ("Q4_K_M", "Q5_K_M"):
        if ".attn_v.weight" in name or ".ffn_down" in name:
            return GGMLType.Q6_K
    if ftype == "Q3_K_M":
        if ".attn_v.weight" in name or ".ffn_down" in name:
            return GGMLType.Q4_K
        if ".attn_output.weight" in name:
            return GGMLType.Q4_K
    if ftype == "Q3_K_L":
        if ".attn_v.weight" in name or ".ffn_down" in name:
            return GGMLType.Q5_K
    return base


@dataclasses.dataclass
class QuantizeStats:
    tensors: int = 0
    bytes_in: int = 0
    bytes_out: int = 0
    seconds: float = 0.0


def _dense_type(target: GGMLType, k: int) -> GGMLType:
    """target, or F16 where its block does not divide the row length k."""
    if target in (GGMLType.F32, GGMLType.F16, GGMLType.BF16):
        return target
    return target if k % GGML_BLOCK_SIZES[target][0] == 0 else GGMLType.F16


def quantize_model(src_path: str, dst_path: str, ftype: str,
                   imatrix: dict[str, np.ndarray] | None = None,
                   progress: Callable[[str, int, int], None] | None = None,
                   ) -> QuantizeStats:
    """src_path's tensors requantized as ftype into dst_path, its metadata
    copied with general.file_type set. imatrix: tensor name -> column
    importance [K]; a tensor whose entry has another length (a stacked
    expert tensor's) is fitted without it, as in the reference."""
    if ftype not in FTYPES:
        raise ValueError(f"unknown ftype {ftype}; known: {sorted(FTYPES)}")
    base = FTYPES[ftype]
    stats = QuantizeStats()
    t0 = time.time()
    with GGUFReader(src_path) as r:
        w = GGUFWriter(dst_path)
        for key, val in r.metadata.items():
            if key != "general.file_type":
                w.add_kv(key, val)
        w.add_kv("general.file_type", list(FTYPES).index(ftype))
        names = list(r.tensors)
        arch = r.metadata.get("general.architecture", "llama")
        n_expert = int(r.metadata.get(f"{arch}.expert_count", 0) or 0)
        for i, name in enumerate(names):
            info = r.tensors[name]
            if progress:
                progress(name, i, len(names))
            target = GGMLType.F32 if len(info.shape) < 2 else \
                tensor_target_type(name, ftype, base, n_expert)
            target = _dense_type(target, info.shape[0])
            dense = r.dequantize(name)      # numpy order [..., row]
            if target in (GGMLType.F32, GGMLType.F16, GGMLType.BF16):
                # BF16 goes to the writer as float32, which keeps the top
                # half of each value's bits
                w.add_tensor(name, dense.astype(
                    np.float16 if target == GGMLType.F16 else np.float32),
                    ggml_type=target)
            else:
                iw = None if imatrix is None else imatrix.get(name)
                if iw is not None and iw.size != info.shape[0]:
                    iw = None
                packed = codecs.quantize(
                    dense.reshape(-1, info.shape[0]).astype(np.float32),
                    target, weights=iw)
                w.add_tensor(name, packed, ggml_type=target,
                             raw_ggml_shape=info.shape)
            stats.tensors += 1
            stats.bytes_in += info.nbytes
            del dense
        w.write()
    stats.bytes_out = os.path.getsize(dst_path)
    stats.seconds = time.time() - t0
    return stats


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser("llama-quantize (cuda port, host only)")
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("ftype", help="e.g. Q4_K_M, Q8_0, Q6_K, IQ2_XS")
    ap.add_argument("--imatrix", default=None,
                    help="importance matrix .npz from llama-imatrix")
    ap.add_argument("--fast", action="store_true",
                    help="skip the iterative scale refinement")
    args = ap.parse_args(argv)
    imatrix = None
    if args.imatrix:
        from ..runtime.imatrix import IMatrixCollector

        imatrix = IMatrixCollector.load(args.imatrix)

    def progress(name, i, n):
        print(f"[{i+1}/{n}] {name}", file=sys.stderr)

    iters = codecs.REFINE_ITERS
    if args.fast:
        codecs.set_refine_iters(0)
    try:
        st = quantize_model(args.src, args.dst, args.ftype.upper(),
                            imatrix=imatrix, progress=progress)
    finally:
        codecs.set_refine_iters(iters)
    print(f"quantized {st.tensors} tensors: "
          f"{st.bytes_in/1e6:.1f} MB -> {st.bytes_out/1e6:.1f} MB "
          f"in {st.seconds:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
