"""Control vectors (the llama_adapter_cvec analogue) and their generator.

Counterpart of llama_cpp_test_tpu/models/cvec.py. A control-vector GGUF
carries per-layer direction tensors `direction.<layer>` (1-based layer
index, [n_embd] f32). At inference the scaled direction is added to the
hidden state after each decoder layer (models/llama._forward_layer_ffn);
an encoder's post-norm layer takes none, as in the reference and
llama.cpp's bert graph.

generate_control_vector is the cvector-generator: the dominant principal
component of the per-layer hidden-state differences between positive and
negative prompts (runtime/tracing.trace_eval gives the hidden states; the
SVD runs in numpy on the host).
"""
from __future__ import annotations

import numpy as np
import torch

from ..gguf.reader import open_gguf
from ..gguf.writer import GGUFWriter
from .llama import LlamaWeights


def load_control_vector(path: str) -> dict[int, np.ndarray]:
    """layer (1-based) -> direction [n_embd] f32."""
    out: dict[int, np.ndarray] = {}
    with open_gguf(path) as r:
        for name in r.tensors:
            if not name.startswith("direction."):
                continue
            il = int(name.split(".")[1])
            out[il] = r.dequantize(name, np.float32).reshape(-1)
    if not out:
        raise ValueError(f"{path}: no direction.<layer> tensors")
    return out


def attach_control_vector(weights: LlamaWeights,
                          directions: dict[int, np.ndarray],
                          strength: float = 1.0,
                          layer_start: int = 1,
                          layer_end: int = 0) -> LlamaWeights:
    """Set per-layer control vectors on the weights' device (layer ids
    1-based; layer_end <= 0 means the last layer, as
    --control-vector-layer-range takes them)."""
    dev = weights.rope_inv_freq.device
    if layer_end <= 0:
        layer_end = len(weights.layers)
    for li, lw in enumerate(weights.layers):
        il = li + 1
        d = directions.get(il)
        if d is not None and layer_start <= il <= layer_end:
            lw.cvec = torch.as_tensor(
                np.asarray(d * strength, np.float32)).to(dev)
        else:
            lw.cvec = None
    return weights


def detach_control_vector(weights: LlamaWeights) -> LlamaWeights:
    for lw in weights.layers:
        lw.cvec = None
    return weights


def generate_control_vector(ctx, positive_prompts: list[str],
                            negative_prompts: list[str],
                            out_path: str) -> dict[int, np.ndarray]:
    """PCA control-vector extraction: for each layer, the dominant principal
    component of the (positive - negative) mean hidden states across the
    prompt pairs, sign-aligned with the mean difference, unit norm; written
    to out_path as a controlvector GGUF."""
    from ..runtime.tracing import trace_eval

    tok = ctx.model.tokenizer
    n_layer = ctx.model.hp.n_layer
    diffs: list[list[np.ndarray]] = [[] for _ in range(n_layer)]
    for pos_p, neg_p in zip(positive_prompts, negative_prompts):
        tp = trace_eval(ctx, tok.encode(pos_p), keep_values=True)
        tn = trace_eval(ctx, tok.encode(neg_p), keep_values=True)
        for li in range(n_layer):
            diffs[li].append(tp[1 + li].values.mean(axis=0)
                             - tn[1 + li].values.mean(axis=0))
    directions: dict[int, np.ndarray] = {}
    for li in range(n_layer):
        d = np.stack(diffs[li])  # [n_pairs, C]
        mean_diff = d.mean(axis=0)
        if d.shape[0] == 1:
            v = mean_diff
        else:
            dc = d - d.mean(axis=0, keepdims=True)
            _, _, vt = np.linalg.svd(dc, full_matrices=False)
            v = vt[0]
            if np.dot(v, mean_diff) < 0:
                v = -v
        nrm = np.linalg.norm(v)
        if nrm > 0:
            v = v / nrm
        directions[li + 1] = v.astype(np.float32)
    w = GGUFWriter(out_path, arch="controlvector")
    w.add_kv("general.architecture", "controlvector")
    w.add_kv("controlvector.model_hint", ctx.model.hp.arch)
    w.add_kv("controlvector.layer_count", n_layer)
    for il, v in directions.items():
        w.add_tensor(f"direction.{il}", v)
    w.write()
    return directions
