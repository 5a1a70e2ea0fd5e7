"""LLaMA-family model (dense or Mixtral-style MoE): GGUF weight loading +
forward pass.

Counterpart of the llama and Mixtral paths of
llama_cpp_test_tpu/models/llama.py: per layer RMSNorm -> fused QKV -> RoPE
-> paged attention -> residual -> RMSNorm -> FFN -> residual; final norm +
lm head. The FFN is fused gate|up -> SwiGLU -> down, or, in a MoE layer,
softmax top-k routing over the experts (moe_ffn) with the grouped expert
matmul of ops/gmm. Loading is numpy (host planes); weights.py moves them
to a device.

Every dense projection goes through ops/qmatmul (kernel K1 on CUDA), every
expert projection through ops/gmm (kernel K4). `plain=True` selects the
plain PyTorch version of every kernel instead; it exists so a run on the
card can be held against the plain path.
"""
from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np
import torch

from ..gguf.reader import GGUFReader
from ..ops import gmm as gmm_mod
from ..ops import layers
from ..ops.qmatmul import qgather, qmm, qmm_plain, qmm_split, qmm_split_plain
from ..quant.repack import QTensor, fuse_qtensors, repack
from .hparams import HParams, hparams_from_metadata


@dataclasses.dataclass
class LayerWeights:
    attn_norm: Any
    wo: QTensor
    ffn_norm: Any
    w_down: QTensor | None = None
    # fused q|k|v and gate|up planes, built at load when the source tensors
    # share a quant type; the separate planes otherwise
    wqkv: QTensor | None = None
    wq: QTensor | None = None
    wk: QTensor | None = None
    wv: QTensor | None = None
    w_gateup: QTensor | None = None
    w_gate: QTensor | None = None
    w_up: QTensor | None = None
    # MoE (Mixtral): router [n_expert, n_embd] and expert stacks whose
    # planes carry a leading E axis; gate and up stay separate, as the
    # reference keeps them by default
    gate_inp: QTensor | None = None
    gate_exps: QTensor | None = None
    up_exps: QTensor | None = None
    down_exps: QTensor | None = None


@dataclasses.dataclass
class LlamaWeights:
    tok_embd: QTensor        # layout 'rows' (row gathers)
    output_norm: Any
    output: QTensor          # lm head (token_embd planes when tied)
    layers: list[LayerWeights]
    rope_inv_freq: Any
    rope_mscale: float


# ---------------------------------------------------------------------------
# loading

_DENSE_FFN = {"ffn_gate.weight", "ffn_up.weight", "ffn_down.weight"}
_MOE_FFN = {"ffn_gate_inp.weight", "ffn_gate_exps.weight",
            "ffn_up_exps.weight", "ffn_down_exps.weight"}
_LAYER_TENSORS = {"attn_norm.weight", "attn_q.weight", "attn_k.weight",
                  "attn_v.weight", "attn_output.weight",
                  "ffn_norm.weight"} | _DENSE_FFN | _MOE_FFN
_TOP_TENSORS = {"token_embd.weight", "output_norm.weight", "output.weight"}


def _repack_2d(reader: GGUFReader, name: str,
               row_perm: np.ndarray | None = None,
               layout: str = "t", tile_n: int = 256) -> QTensor:
    info = reader.tensors[name]
    # ggml ne = (K, N): ne[0] is the contraction dim (row length)
    k, n = info.shape[0], info.shape[1] if len(info.shape) > 1 else 1
    raw = reader.tensor_bytes(name)
    if row_perm is not None:
        # block quantization is per-row, so permuting output rows is a pure
        # byte-row shuffle of the packed data
        row_bytes = raw.size // n
        raw = np.ascontiguousarray(raw.reshape(n, row_bytes)[row_perm])
    return repack(raw, info.ggml_type, n, k, layout=layout, tile_n=tile_n)


def _repack_3d(reader: GGUFReader, name: str) -> QTensor:
    """Expert-stacked tensor, ggml ne = (K, N, E) -> one QTensor whose
    planes are stacked on a leading E axis."""
    info = reader.tensors[name]
    k, n, e = info.shape
    raw = reader.tensor_bytes(name)
    per = raw.size // e
    qts = [repack(raw[i * per:(i + 1) * per], info.ggml_type, n, k)
           for i in range(e)]
    q0 = qts[0]
    stack = lambda xs: None if xs[0] is None else np.stack(xs)
    return QTensor(q0.kind, q0.shape, q0.n_orig, q0.group,
                   stack([q.qs for q in qts]), stack([q.scale for q in qts]),
                   stack([q.min_ for q in qts]), q0.lut, q0.ggml_type)


def _unpermute_rows(n_head: int, head_dim: int,
                    rope_dim: int | None = None) -> np.ndarray:
    """GGUF NORM-layout Q/K rows -> half-split layout, so half-split rope
    applies: out_row[h*d + j] = in_row[h*d + 2j],
    out_row[h*d + d/2 + j] = in_row[h*d + 2j + 1]."""
    d = head_dim
    rd = rope_dim if rope_dim else d
    idx = np.empty(n_head * d, np.int64)
    for h in range(n_head):
        base = h * d
        idx[base:base + rd // 2] = base + 2 * np.arange(rd // 2)
        idx[base + rd // 2:base + rd] = base + 2 * np.arange(rd // 2) + 1
        idx[base + rd:base + d] = base + np.arange(rd, d)
    return idx


def _f32(reader: GGUFReader, name: str) -> np.ndarray:
    return reader.dequantize(name, np.float32)


def _check_supported(reader: GGUFReader, hp: HParams) -> None:
    """Refuse what this port does not carry, instead of running another
    model than the file describes."""
    if hp.arch != "llama":
        raise NotImplementedError(
            f"arch {hp.arch!r}: this port carries the llama decoder (dense "
            "or Mixtral-style MoE)")
    if hp.n_expert and (hp.expert_gating != "softmax" or hp.n_expert_shared
                        or not hp.norm_topk):
        raise NotImplementedError(
            f"MoE with {hp.expert_gating} gating, {hp.n_expert_shared} shared "
            f"experts, norm_topk={hp.norm_topk}: this port carries softmax "
            "top-k routing with renormalized weights only")
    if hp.n_expert and not 0 < hp.n_expert_used <= hp.n_expert:
        raise ValueError(f"expert_used_count {hp.n_expert_used} of "
                         f"{hp.n_expert} experts")
    if hp.sliding_window or hp.attn_softcap or hp.final_softcap:
        raise NotImplementedError("sliding window / softcap llama variants "
                                  "are not ported yet")
    unknown = []
    ffn = [set() for _ in range(hp.n_layer)]
    for name in reader.tensors:
        if name in _TOP_TENSORS:
            continue
        parts = name.split(".", 2)
        if parts[0] == "blk" and len(parts) == 3 and parts[2] in _LAYER_TENSORS:
            if parts[2] in _DENSE_FFN | _MOE_FFN and int(parts[1]) < hp.n_layer:
                ffn[int(parts[1])].add(parts[2])
            continue
        unknown.append(name)
    if unknown:
        raise NotImplementedError(
            f"tensors outside the llama / Mixtral layout: {sorted(unknown)[:5]}")
    want = _MOE_FFN if hp.n_expert else _DENSE_FFN
    for i, have in enumerate(ffn):
        if have != want:
            raise NotImplementedError(
                f"blk.{i} FFN tensors {sorted(have)}: this port carries "
                + ("the Mixtral expert set" if hp.n_expert else
                   "the dense SwiGLU set") + " in every layer")


def load_weights(reader: GGUFReader, hp: HParams | None = None
                 ) -> tuple[HParams, LlamaWeights]:
    """Load + repack all tensors of a llama / Mixtral GGUF into host planes."""
    if hp is None:
        hp = hparams_from_metadata(reader.metadata)
    _check_supported(reader, hp)
    q_perm = _unpermute_rows(hp.n_head, hp.head_dim, hp.rope_dim)
    k_perm = _unpermute_rows(hp.n_head_kv, hp.head_dim, hp.rope_dim)

    def layer(i: int) -> LayerWeights:
        p = f"blk.{i}."
        lw = LayerWeights(
            attn_norm=_f32(reader, p + "attn_norm.weight"),
            wo=_repack_2d(reader, p + "attn_output.weight"),
            ffn_norm=_f32(reader, p + "ffn_norm.weight"),
            wq=_repack_2d(reader, p + "attn_q.weight", q_perm),
            wk=_repack_2d(reader, p + "attn_k.weight", k_perm),
            wv=_repack_2d(reader, p + "attn_v.weight"),
        )
        lw.wqkv = fuse_qtensors([lw.wq, lw.wk, lw.wv])
        if lw.wqkv is not None:
            lw.wq = lw.wk = lw.wv = None  # fused plane replaces them
        if hp.n_expert:
            # an F32 router gives a 'dense' QTensor (a plain product)
            lw.gate_inp = _repack_2d(reader, p + "ffn_gate_inp.weight")
            lw.gate_exps = _repack_3d(reader, p + "ffn_gate_exps.weight")
            lw.up_exps = _repack_3d(reader, p + "ffn_up_exps.weight")
            lw.down_exps = _repack_3d(reader, p + "ffn_down_exps.weight")
            return lw
        lw.w_down = _repack_2d(reader, p + "ffn_down.weight")
        lw.w_gate = _repack_2d(reader, p + "ffn_gate.weight")
        lw.w_up = _repack_2d(reader, p + "ffn_up.weight")
        lw.w_gateup = fuse_qtensors([lw.w_gate, lw.w_up])
        if lw.w_gateup is not None:
            lw.w_gate = lw.w_up = None
        return lw

    t = reader.tensors
    # layers are independent: repack them in parallel (numpy releases the GIL)
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        f_embd = ex.submit(_repack_2d, reader, "token_embd.weight", None,
                           "rows")
        # the lm head pads N to tile_n=1024 multiples, as the reference does
        head = "output.weight" if "output.weight" in t else "token_embd.weight"
        f_out = ex.submit(_repack_2d, reader, head, None, "t", 1024)
        layer_list = list(ex.map(layer, range(hp.n_layer)))
        tok_embd = f_embd.result()
        output = f_out.result()
    inv_freq, mscale = layers.rope_freqs(hp)
    w = LlamaWeights(
        tok_embd=tok_embd,
        output_norm=_f32(reader, "output_norm.weight"),
        output=output,
        layers=layer_list,
        rope_inv_freq=np.asarray(inv_freq),
        rope_mscale=float(mscale),
    )
    return hp, w


# ---------------------------------------------------------------------------
# forward


def linear(x: torch.Tensor, qt: QTensor, plain: bool = False,
           out_dtype=torch.float32) -> torch.Tensor:
    return (qmm_plain if plain else qmm)(x, qt, out_dtype=out_dtype)


def embed(w: LlamaWeights, tokens: torch.Tensor) -> torch.Tensor:
    return qgather(tokens, w.tok_embd, dtype=torch.bfloat16)


def qkv_proj(cur: torch.Tensor, lw: LayerWeights, plain: bool = False):
    """Q/K/V projections, via the fused wqkv plane when available."""
    if lw.wqkv is not None:
        split = qmm_split_plain if plain else qmm_split
        return split(cur, lw.wqkv)
    return (linear(cur, lw.wq, plain), linear(cur, lw.wk, plain),
            linear(cur, lw.wv, plain))


def gateup_proj(cur: torch.Tensor, lw: LayerWeights, plain: bool = False):
    """SwiGLU gate/up projections, fused when available."""
    if lw.w_gateup is not None:
        split = qmm_split_plain if plain else qmm_split
        return split(cur, lw.w_gateup)
    return linear(cur, lw.w_gate, plain), linear(cur, lw.w_up, plain)


def forward_layer(x: torch.Tensor, lw: LayerWeights, hp: HParams,
                  positions: torch.Tensor, inv_freq: torch.Tensor,
                  mscale: float, attend, plain: bool = False) -> torch.Tensor:
    """One decoder layer. x [B, T, C] bf16; attend(q, k, v) writes the KV
    and returns [B, T, H, D]."""
    b, tdim, _ = x.shape
    h, kvh, d = hp.n_head, hp.n_head_kv, hp.head_dim
    cur = layers.rms_norm(x, lw.attn_norm, hp.rms_eps)
    q, k, v = qkv_proj(cur, lw, plain)
    q = layers.apply_rope(q.reshape(b, tdim, h, d), positions, inv_freq, mscale)
    k = layers.apply_rope(k.reshape(b, tdim, kvh, d), positions, inv_freq,
                          mscale)
    v = v.reshape(b, tdim, kvh, d)
    attn_out = attend(q.to(torch.bfloat16), k.to(torch.bfloat16),
                      v.to(torch.bfloat16)).reshape(b, tdim, h * d)
    o = linear(attn_out, lw.wo, plain)
    x = x + o.to(x.dtype)
    return _forward_layer_ffn(x, lw, hp, plain)


def moe_ffn(x: torch.Tensor, lw: LayerWeights, hp: HParams,
            plain: bool = False) -> torch.Tensor:
    """Mixtral-style routing: softmax over the router logits, top-k
    experts, weights renormalized and scaled; the experts run
    through the grouped matmul (_moe_grouped). x [B, T, C] -> [B, T, C]
    float32."""
    b, tdim = x.shape[0], x.shape[1]
    xf = x.reshape(-1, x.shape[-1])
    router = linear(xf, lw.gate_inp, plain)               # [M, E]
    probs = torch.softmax(router, dim=-1)
    topv, topi = torch.topk(probs, hp.n_expert_used, dim=-1)
    topv = topv / topv.sum(dim=-1, keepdim=True)
    if hp.expert_weights_scale != 1.0:
        topv = topv * hp.expert_weights_scale
    out = _moe_grouped(xf, lw, hp, topi, topv, plain)
    return out.reshape(b, tdim, hp.n_embd)


def _moe_grouped(xf, lw, hp, topi, topv, plain: bool = False):
    """Route once, reuse the plan for gate/up/down: one gather into
    scratch-row space, gate -> SwiGLU -> down there, one weighted
    scatter-add back per token."""
    m = xf.shape[0]
    tile_m = (gmm_mod.TILE_GEMV if m * hp.n_expert_used <= 256
              else gmm_mod.TILE_GEMM)
    routing = gmm_mod.route_tokens(topi, topv, n_expert_local=hp.n_expert,
                                   expert_offset=0, tile_m=tile_m)
    xs = xf[routing.tok_idx.long()]
    g = gmm_mod.gmm_apply(xs, lw.gate_exps, routing, tile_m, plain)
    u = gmm_mod.gmm_apply(xs, lw.up_exps, routing, tile_m, plain)
    h = layers.swiglu(g, u)
    y = gmm_mod.gmm_apply(h, lw.down_exps, routing, tile_m, plain)
    return gmm_mod.combine(y, routing, m)


def _forward_layer_ffn(x: torch.Tensor, lw: LayerWeights, hp: HParams,
                       plain: bool = False) -> torch.Tensor:
    """FFN half of the layer: RMSNorm -> gate|up -> SwiGLU -> down, or the
    routed experts of a MoE layer."""
    cur = layers.rms_norm(x, lw.ffn_norm, hp.rms_eps)
    if lw.gate_inp is not None:
        ffn = moe_ffn(cur, lw, hp, plain)
    else:
        g, u = gateup_proj(cur, lw, plain)
        ffn = linear(layers.swiglu(g, u), lw.w_down, plain)
    return x + ffn.to(x.dtype)


def final_norm(w: LlamaWeights, hp: HParams, x: torch.Tensor) -> torch.Tensor:
    return layers.rms_norm(x, w.output_norm, hp.rms_eps)


def lm_head(w: LlamaWeights, hp: HParams, x: torch.Tensor,
            plain: bool = False) -> torch.Tensor:
    """Final norm + output projection -> float32 logits [..., n_vocab]."""
    return linear(final_norm(w, hp, x), w.output, plain)
