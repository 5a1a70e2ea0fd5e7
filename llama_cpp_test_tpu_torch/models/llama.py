"""LLaMA-family model (dense or Mixtral-style MoE, and the gemma and qwen
quirk axes): GGUF weight loading + forward pass.

Counterpart of the sequential pre-norm body of
llama_cpp_test_tpu/models/llama.py for the archs of models/registry.PORTED:
per layer RMSNorm -> fused QKV (+ Q/K/V biases) -> per-head QK RMSNorm ->
RoPE (the layer's table: sliding-window layers may have their own base)
-> paged attention (window, softcap) -> post-attention norm -> residual
-> RMSNorm -> FFN -> post-FFN norm -> residual; final norm + lm head +
final softcap. The embedding is scaled (gemma), the FFN is fused gate|up
-> SwiGLU or GeGLU -> down, or, in a MoE layer, softmax top-k routing over
the experts (moe_ffn) with the grouped expert matmul of ops/gmm. Loading
is numpy (host planes); weights.py moves them to a device.

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
from .registry import check_arch


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
    # Q/K/V biases (qwen2) and per-head Q/K RMSNorm weights [head_dim]
    # (qwen3, gemma3), float32
    bq: Any = None
    bk: Any = None
    bv: Any = None
    attn_q_norm: Any = None
    attn_k_norm: Any = None
    # sandwich norms on the attention and FFN branch outputs before the
    # residual adds (gemma2, gemma3)
    attn_post_norm: Any = None
    ffn_post_norm: Any = None
    # LoRA pairs: field name (wq, wk, wv, wo, w_gate, w_up, w_down) ->
    # (A [r, K], B [N, r], scale), A and B float32 holding bf16 values
    # (models/lora.py)
    lora: dict = dataclasses.field(default_factory=dict)
    # control vector: [n_embd] float32 added to the layer output
    # (models/cvec.py)
    cvec: Any = None


@dataclasses.dataclass
class LlamaWeights:
    tok_embd: QTensor        # layout 'rows' (row gathers)
    output_norm: Any
    output: QTensor          # lm head (token_embd planes when tied)
    layers: list[LayerWeights]
    rope_inv_freq: Any
    rope_mscale: float
    # the sliding-window layers' table where their base differs (gemma3:
    # 10000 beside the global 1e6), else None
    rope_inv_freq_swa: Any = None

    def inv_freq_for(self, window: int):
        """The rope table of a layer with sliding window `window` (0 =
        global)."""
        if window > 0 and self.rope_inv_freq_swa is not None:
            return self.rope_inv_freq_swa
        return self.rope_inv_freq


# ---------------------------------------------------------------------------
# loading

_DENSE_FFN = {"ffn_gate.weight", "ffn_up.weight", "ffn_down.weight"}
_MOE_FFN = {"ffn_gate_inp.weight", "ffn_gate_exps.weight",
            "ffn_up_exps.weight", "ffn_down_exps.weight"}
_BIASES = {"attn_q.bias": "bq", "attn_k.bias": "bk", "attn_v.bias": "bv"}
# the per-head QK norms and the sandwich norms, under both GGUF names
_QUIRK_NORMS = {"attn_q_norm.weight": "attn_q_norm",
                "attn_k_norm.weight": "attn_k_norm",
                "attn_post_norm.weight": "attn_post_norm",
                "post_attention_norm.weight": "attn_post_norm",
                "ffn_post_norm.weight": "ffn_post_norm",
                "post_ffw_norm.weight": "ffn_post_norm"}
_LAYER_TENSORS = {"attn_norm.weight", "attn_q.weight", "attn_k.weight",
                  "attn_v.weight", "attn_output.weight",
                  "ffn_norm.weight"} | _DENSE_FFN | _MOE_FFN | \
    set(_BIASES) | set(_QUIRK_NORMS)
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
    planes are stacked on a leading E axis. The experts repack in parallel
    (numpy releases the GIL): a Mixtral layer holds 24 of them."""
    info = reader.tensors[name]
    k, n, e = info.shape
    raw = reader.tensor_bytes(name)
    per = raw.size // e
    with ThreadPoolExecutor(max_workers=min(e, os.cpu_count() or 1)) as ex:
        qts = list(ex.map(lambda i: repack(raw[i * per:(i + 1) * per],
                                           info.ggml_type, n, k), range(e)))
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
    check_arch(hp.arch)
    if hp.n_expert and (hp.expert_gating != "softmax" or hp.n_expert_shared
                        or not hp.norm_topk):
        raise NotImplementedError(
            f"MoE with {hp.expert_gating} gating, {hp.n_expert_shared} shared "
            f"experts, norm_topk={hp.norm_topk}: this port carries softmax "
            "top-k routing with renormalized weights only")
    if hp.n_expert and not 0 < hp.n_expert_used <= hp.n_expert:
        raise ValueError(f"expert_used_count {hp.n_expert_used} of "
                         f"{hp.n_expert} experts")
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
            "tensors outside the llama, Mixtral, gemma and qwen layouts: "
            f"{sorted(unknown)[:5]}")
    for name, info in reader.tensors.items():
        if name.endswith(("attn_q_norm.weight", "attn_k_norm.weight")):
            if tuple(info.shape) != (hp.head_dim,):
                raise NotImplementedError(
                    f"{name} of shape {tuple(info.shape)}: this port carries "
                    f"per-head QK norms of shape ({hp.head_dim},)")
            if hp.rope_type == "norm":
                raise NotImplementedError(
                    f"{name} in a NORM-rope file: this port carries QK "
                    "norms on NEOX-rope archs")
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
    # NORM-rope Q/K rows (and biases) are un-permuted to half-split; NEOX
    # rows are half-split already
    q_perm = k_perm = None
    if hp.rope_type == "norm":
        q_perm = _unpermute_rows(hp.n_head, hp.head_dim, hp.rope_dim)
        k_perm = _unpermute_rows(hp.n_head_kv, hp.head_dim, hp.rope_dim)
    t = reader.tensors

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
        for name, perm in (("attn_q.bias", q_perm), ("attn_k.bias", k_perm),
                           ("attn_v.bias", None)):
            if p + name in t:
                bias = _f32(reader, p + name)
                setattr(lw, _BIASES[name],
                        bias if perm is None else bias[perm])
        for name, field in _QUIRK_NORMS.items():
            if p + name in t:
                setattr(lw, field, _f32(reader, p + name))
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

    # layers are independent: repack them in parallel (numpy releases the GIL)
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        f_embd = ex.submit(_repack_2d, reader, "token_embd.weight", None,
                           "rows")
        # the lm head pads N to tile_n=1024 multiples, as the reference
        # does; a file without output.weight (gemma) ties it to the
        # embedding
        head = "output.weight" if "output.weight" in t else "token_embd.weight"
        f_out = ex.submit(_repack_2d, reader, head, None, "t", 1024)
        layer_list = list(ex.map(layer, range(hp.n_layer)))
        tok_embd = f_embd.result()
        output = f_out.result()
    inv_freq, mscale = layers.rope_freqs(hp)
    inv_freq_swa = None
    if hp.rope_freq_base_swa > 0 and \
            hp.rope_freq_base_swa != hp.rope_freq_base:
        # the sliding-window layers' own base, unscaled (reference
        # load_weights builds it with rope_scaling "none")
        inv_freq_swa = np.asarray(layers.rope_freqs(dataclasses.replace(
            hp, rope_freq_base=hp.rope_freq_base_swa,
            rope_scaling="none"))[0])
    w = LlamaWeights(
        tok_embd=tok_embd,
        output_norm=_f32(reader, "output_norm.weight"),
        output=output,
        layers=layer_list,
        rope_inv_freq=np.asarray(inv_freq),
        rope_mscale=float(mscale),
        rope_inv_freq_swa=inv_freq_swa,
    )
    return hp, w


# ---------------------------------------------------------------------------
# forward


def linear(x: torch.Tensor, qt: QTensor, plain: bool = False,
           out_dtype=torch.float32) -> torch.Tensor:
    return (qmm_plain if plain else qmm)(x, qt, out_dtype=out_dtype)


def lora_delta(x: torch.Tensor, lora) -> torch.Tensor | None:
    """scale * (x A^T) B^T, the low-rank update, rounded as the reference
    rounds it: bf16 operands, products accumulated in float32, the first
    product rounded to bf16 before the second. A and B hold bf16 values
    in float32, so both products are float32 matmuls of bf16-rounded
    operands (with TF32 off, as torch leaves it by default)."""
    if lora is None:
        return None
    a, b, sc = lora
    u = torch.matmul(x.to(torch.bfloat16).float(), a.t())
    d = torch.matmul(u.to(torch.bfloat16).float(), b.t())
    return d * sc


def linear_lora(x: torch.Tensor, qt: QTensor, lora, plain: bool = False,
                out_dtype=torch.float32) -> torch.Tensor:
    """linear() plus the optional low-rank update."""
    y = linear(x, qt, plain, out_dtype)
    d = lora_delta(x, lora)
    return y if d is None else y + d.to(y.dtype)


def embed(w: LlamaWeights, tokens: torch.Tensor,
          scale: float = 1.0) -> torch.Tensor:
    """Embedding rows in bf16; a scale (gemma: sqrt(n_embd), not exact in
    bf16) multiplies in float32 before the bf16 rounding, as the
    reference orders it."""
    e = qgather(tokens, w.tok_embd, dtype=torch.bfloat16)
    if scale != 1.0:
        e = (e.float() * scale).to(torch.bfloat16)
    return e


def qkv_proj(cur: torch.Tensor, lw: LayerWeights, plain: bool = False):
    """Q/K/V projections, via the fused wqkv plane when available, each
    with its LoRA update when one is attached."""
    lora = lw.lora
    if lw.wqkv is not None:
        split = qmm_split_plain if plain else qmm_split
        outs = split(cur, lw.wqkv)
        deltas = [lora_delta(cur, lora.get(f)) for f in ("wq", "wk", "wv")]
        return tuple(o if d is None else o + d for o, d in zip(outs, deltas))
    return tuple(linear_lora(cur, getattr(lw, f), lora.get(f), plain)
                 for f in ("wq", "wk", "wv"))


def gateup_proj(cur: torch.Tensor, lw: LayerWeights, plain: bool = False):
    """SwiGLU gate/up projections, fused when available, each with its
    LoRA update when one is attached."""
    lora = lw.lora
    if lw.w_gateup is not None:
        split = qmm_split_plain if plain else qmm_split
        outs = split(cur, lw.w_gateup)
        deltas = [lora_delta(cur, lora.get(f)) for f in ("w_gate", "w_up")]
        return tuple(o if d is None else o + d for o, d in zip(outs, deltas))
    return tuple(linear_lora(cur, getattr(lw, f), lora.get(f), plain)
                 for f in ("w_gate", "w_up"))


def forward_layer(x: torch.Tensor, lw: LayerWeights, hp: HParams,
                  positions: torch.Tensor, inv_freq: torch.Tensor,
                  mscale: float, attend, plain: bool = False,
                  tap=None) -> torch.Tensor:
    """One decoder layer. x [B, T, C] bf16; attend(q, k, v) writes the KV
    and returns [B, T, H, D]; inv_freq is the layer's rope table. tap, if
    given, is called as tap(role, activation) with the input of each
    projection: "attn_in" (q, k, v), "attn_out" (wo), "ffn_in" (gate and
    up, or the router and experts), "ffn_act" (down)."""
    b, tdim, _ = x.shape
    h, kvh, d = hp.n_head, hp.n_head_kv, hp.head_dim
    cur = layers.rms_norm(x, lw.attn_norm, hp.rms_eps)
    if tap is not None:
        tap("attn_in", cur)
    q, k, v = qkv_proj(cur, lw, plain)
    if lw.bq is not None:
        q = q + lw.bq
    if lw.bk is not None:
        k = k + lw.bk
    if lw.bv is not None:
        v = v + lw.bv
    q = q.reshape(b, tdim, h, d)
    k = k.reshape(b, tdim, kvh, d)
    v = v.reshape(b, tdim, kvh, d)
    if lw.attn_q_norm is not None:     # per-head QK norms, before rope
        q = layers.rms_norm(q, lw.attn_q_norm, hp.rms_eps)
    if lw.attn_k_norm is not None:
        k = layers.rms_norm(k, lw.attn_k_norm, hp.rms_eps)
    q = layers.apply_rope(q, positions, inv_freq, mscale)
    k = layers.apply_rope(k, positions, inv_freq, mscale)
    attn_out = attend(q.to(torch.bfloat16), k.to(torch.bfloat16),
                      v.to(torch.bfloat16)).reshape(b, tdim, h * d)
    if tap is not None:
        tap("attn_out", attn_out)
    o = linear_lora(attn_out, lw.wo, lw.lora.get("wo"), plain)
    if lw.attn_post_norm is not None:  # sandwich norm on the branch
        o = layers.rms_norm(o, lw.attn_post_norm, hp.rms_eps)
    x = x + o.to(x.dtype)
    return _forward_layer_ffn(x, lw, hp, plain, tap)


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
                       plain: bool = False, tap=None) -> torch.Tensor:
    """FFN half of the layer: RMSNorm -> gate|up -> SwiGLU or GeGLU ->
    down, or the routed experts of a MoE layer; the post-FFN norm, if
    any; then the control vector, if any."""
    cur = layers.rms_norm(x, lw.ffn_norm, hp.rms_eps)
    if tap is not None:
        tap("ffn_in", cur)
    if lw.gate_inp is not None:
        ffn = moe_ffn(cur, lw, hp, plain)
    else:
        g, u = gateup_proj(cur, lw, plain)
        act = layers.swiglu(g, u, hp.act_fn)
        if tap is not None:
            tap("ffn_act", act)
        ffn = linear_lora(act, lw.w_down, lw.lora.get("w_down"), plain)
    if lw.ffn_post_norm is not None:
        ffn = layers.rms_norm(ffn, lw.ffn_post_norm, hp.rms_eps)
    x = x + ffn.to(x.dtype)
    if lw.cvec is not None:
        x = x + lw.cvec.to(x.dtype)
    return x


def final_norm(w: LlamaWeights, hp: HParams, x: torch.Tensor) -> torch.Tensor:
    return layers.rms_norm(x, w.output_norm, hp.rms_eps)


def lm_head(w: LlamaWeights, hp: HParams, x: torch.Tensor,
            plain: bool = False) -> torch.Tensor:
    """Final norm + output projection (+ the final softcap, gemma2) ->
    float32 logits [..., n_vocab]."""
    logits = linear(final_norm(w, hp, x), w.output, plain)
    if hp.final_softcap > 0:
        logits = torch.tanh(logits / hp.final_softcap) * hp.final_softcap
    return logits
