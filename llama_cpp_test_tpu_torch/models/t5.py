"""T5 encoder-decoder family (reference llm_build_t5_enc / llm_build_t5_dec,
llama-model.cpp; arches t5 + t5encoder, llama-arch.cpp T5 tensor table).

Counterpart of llama_cpp_test_tpu/models/t5.py. The reference serves T5
through llama_encode() (the encoder pass, its output kept as the
cross-attention source) followed by llama_decode() steps whose blocks
interleave self-attention, cross-attention over the encoder output and
the FFN. This module is that surface:

  - encoder: bidirectional self-attention with the learned relative
    position bucket bias (layer 0's table shared by every block, as in HF
    where only block 0 has_relative_attention_bias), RMS norms, NO
    1/sqrt(d) attention scale (T5's convention), a relu or tanh-GELU-gated
    FFN (v1.1), d_kv decoupled from d_model / n_head.
  - decoder: the cross K/V are projected from the encoder output once at
    encode time; each step appends its K/V to a preallocated f32 cache
    [L, n_ctx, H, d_kv] and attends over the positions written so far,
    with the unidirectional bucket bias.

Plain f32 torch on an explicit device, as the reference computes T5 in
f32 outside any Pallas kernel. The encoder runs at the prompt's own
length (the reference pads it to a TOKEN_BUCKETS size and masks the pad
with -1e9, which changes no valid row); a prompt past the largest bucket,
2048 tokens, raises as the reference's does. The relative buckets are
computed on the host in float32 (HF's _relative_position_bucket as the
reference writes it), so every device indexes the same table.

Scope mirrors the reference's T5 support: llama-cli-style encode + greedy
decode and encoder-only embeddings (t5encoder). The paged engine and the
server do not host encoder-decoder models (the reference's do not either).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..gguf.reader import open_gguf
from ..ops import layers
from ..tokenizer import load_tokenizer
from ..weights import host_tensor, to_tensor

MAX_PROMPT = 2048            # the reference's largest TOKEN_BUCKETS size


@dataclasses.dataclass(frozen=True)
class T5HParams:
    arch: str                 # "t5" | "t5encoder"
    n_vocab: int
    n_embd: int               # d_model
    n_layer: int
    n_head: int
    d_kv: int                 # per-head dim (decoupled from d_model)
    n_ff: int
    n_buckets: int
    rms_eps: float
    dec_start_token: int
    gated: bool               # v1.1 gated-gelu vs original relu


@dataclasses.dataclass
class T5Block:
    attn_norm: Any
    wq: Any                   # [H*dkv, C]
    wk: Any
    wv: Any
    wo: Any                   # [C, H*dkv]
    rel_b: Any                # [n_buckets, H] (layer 0; shared) or None
    # decoder-only cross attention
    cross_norm: Any = None
    cross_wq: Any = None
    cross_wk: Any = None
    cross_wv: Any = None
    cross_wo: Any = None
    ffn_norm: Any = None
    w_gate: Any = None        # v1.1 wi_0
    w_up: Any = None          # wi / wi_1
    w_down: Any = None        # wo


def _block_on(b, device) -> T5Block:
    """A T5Block with every array field of b (a T5Block of either package)
    a float32 tensor on device."""
    return T5Block(**{f.name: to_tensor(getattr(b, f.name), device)
                      for f in dataclasses.fields(T5Block)})


class T5Model:
    """Loaded t5/t5encoder GGUF (the reference converter's naming:
    enc.blk.* / dec.blk.* / token_embd): hparams, dense f32 weights on a
    device (the reference dequantizes every tensor to f32 too; an F16 or
    BF16 tensor crosses in its own type and widens there) and the
    tokenizer."""

    def __init__(self, path: str, device=None):
        self.device = resolve_device(device)
        self.path = path
        r = open_gguf(path)
        self.reader = r
        md = r.metadata
        arch = md.get("general.architecture")
        if arch not in ("t5", "t5encoder"):
            raise ValueError(f"not a t5 GGUF (arch {arch!r})")

        def g(key, default=None):
            v = md.get(f"{arch}.{key}", default)
            if v is None:
                raise KeyError(f"t5 GGUF missing {arch}.{key}")
            return v

        toks = md.get("tokenizer.ggml.tokens")
        n_vocab = int(md.get(f"{arch}.vocab_size",
                             len(toks) if toks is not None else 0))
        gated = "enc.blk.0.ffn_gate.weight" in r.tensors or \
            "dec.blk.0.ffn_gate.weight" in r.tensors
        self.hp = T5HParams(
            arch=arch,
            n_vocab=n_vocab,
            n_embd=int(g("embedding_length")),
            n_layer=int(g("block_count")),
            n_head=int(g("attention.head_count")),
            d_kv=int(g("attention.key_length")),
            n_ff=int(g("feed_forward_length")),
            n_buckets=int(g("attention.relative_buckets_count", 32)),
            rms_eps=float(g("attention.layer_norm_rms_epsilon", 1e-6)),
            dec_start_token=int(g("decoder_start_token_id", 0)),
            gated=gated,
        )
        t = lambda name: to_tensor(host_tensor(r, name), self.device)
        opt = lambda name: t(name) if name in r.tensors else None

        def blocks(prefix, dec):
            out = []
            for i in range(self.hp.n_layer):
                p = f"{prefix}.blk.{i}."
                b = T5Block(
                    attn_norm=t(p + "attn_norm.weight"),
                    wq=t(p + "attn_q.weight"),
                    wk=t(p + "attn_k.weight"),
                    wv=t(p + "attn_v.weight"),
                    wo=t(p + "attn_o.weight"),
                    rel_b=opt(p + "attn_rel_b.weight"),
                    ffn_norm=t(p + "ffn_norm.weight"),
                    w_gate=opt(p + "ffn_gate.weight"),
                    w_up=t(p + "ffn_up.weight"),
                    w_down=t(p + "ffn_down.weight"),
                )
                if dec:
                    b.cross_norm = t(p + "cross_attn_norm.weight")
                    b.cross_wq = t(p + "cross_attn_q.weight")
                    b.cross_wk = t(p + "cross_attn_k.weight")
                    b.cross_wv = t(p + "cross_attn_v.weight")
                    b.cross_wo = t(p + "cross_attn_o.weight")
                out.append(b)
            return out

        self.tok_embd = t("token_embd.weight")
        self.enc = blocks("enc", dec=False)
        self.enc_norm = t("enc.output_norm.weight")
        self.dec = self.dec_norm = self.output = None
        if arch == "t5":
            self.dec = blocks("dec", dec=True)
            self.dec_norm = t("dec.output_norm.weight")
            # tied head (original T5) scales hidden by d_model^-0.5
            self.output = opt("output.weight")
        try:
            self.tokenizer = load_tokenizer(r)
        except Exception:
            self.tokenizer = None

    @classmethod
    def from_weights(cls, hp: T5HParams, src, device=None) -> "T5Model":
        """A T5Model over weights loaded elsewhere (any object with
        T5Model's weight fields: tok_embd, enc, enc_norm, dec, dec_norm,
        output; the reference's T5Model too), every array a float32
        tensor on device, with no file and no tokenizer behind it."""
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self.path = self.reader = self.tokenizer = None
        self.hp = hp
        dev = self.device
        self.tok_embd = to_tensor(src.tok_embd, dev)
        self.enc = [_block_on(b, dev) for b in src.enc]
        self.enc_norm = to_tensor(src.enc_norm, dev)
        self.dec = None if src.dec is None else [_block_on(b, dev)
                                                 for b in src.dec]
        self.dec_norm = to_tensor(src.dec_norm, dev)
        self.output = to_tensor(src.output, dev)
        return self


def rel_bucket(rel, *, bidirectional: bool, n_buckets: int,
               max_distance: int = 128) -> torch.Tensor:
    """HF T5Attention._relative_position_bucket in float32, as the
    reference writes it (the + 1e-9 and its f32 log ratio included). rel
    = mem_pos - query_pos, an integer tensor."""
    rel = torch.as_tensor(rel)
    nb = n_buckets
    b = 0
    if bidirectional:
        nb = nb // 2
        b = torch.where(rel > 0, nb, 0)
        rel = rel.abs()
    else:
        rel = -torch.clamp(rel, max=0)
    max_exact = nb // 2
    is_small = rel < max_exact
    ratio = torch.tensor(np.float32(np.log(max_distance / max_exact)))
    large = max_exact + (
        torch.log(rel.to(torch.float32) / max_exact + 1e-9) / ratio
        * (nb - max_exact)).to(torch.int32)
    large = torch.clamp(large, max=nb - 1)
    return b + torch.where(is_small, rel, large)


def _bias(rel_b, rel, bidirectional: bool, hp: T5HParams) -> torch.Tensor:
    """The bucket bias [H, *rel.shape] of relative positions rel (host
    integers), its buckets computed on the host."""
    buckets = rel_bucket(torch.as_tensor(rel), bidirectional=bidirectional,
                         n_buckets=hp.n_buckets)
    bias = rel_b[buckets.to(device=rel_b.device, dtype=torch.long)]
    return bias.movedim(-1, 0)


def _block_attn(x, b: T5Block, hp: T5HParams, bias):
    """Self-attention half of a T5 block over a full [T, C] x (the
    encoder). bias [H, T, T]."""
    h, dkv = hp.n_head, hp.d_kv
    cur = layers.rms_norm(x, b.attn_norm, hp.rms_eps)
    q = (cur @ b.wq.T).reshape(-1, h, dkv)
    k = (cur @ b.wk.T).reshape(-1, h, dkv)
    v = (cur @ b.wv.T).reshape(-1, h, dkv)
    # T5 applies NO 1/sqrt(d) scale (folded into init)
    logits = torch.einsum("qhd,khd->hqk", q, k) + bias
    att = torch.softmax(logits, dim=-1)
    o = torch.einsum("hqk,khd->qhd", att, v).reshape(-1, h * dkv)
    return x + o @ b.wo.T


def _ffn(x, b: T5Block, hp: T5HParams):
    """The FFN half of a block over x [..., C]: relu, or tanh-GELU gated
    (v1.1)."""
    cur = layers.rms_norm(x, b.ffn_norm, hp.rms_eps)
    if hp.gated:
        cur = F.gelu(cur @ b.w_gate.T, approximate="tanh") * (cur @ b.w_up.T)
    else:
        cur = torch.relu(cur @ b.w_up.T)
    return x + cur @ b.w_down.T


def encode_hidden(model: T5Model, tokens) -> torch.Tensor:
    """The encoder over tokens -> hidden [T, C] on the model's device."""
    hp = model.hp
    n = len(tokens)
    if n > MAX_PROMPT:
        raise ValueError(f"prompt of {n} tokens: the encoder takes at most "
                         f"{MAX_PROMPT} (the reference's largest token "
                         "bucket)")
    ids = torch.as_tensor(np.asarray(tokens, np.int64)).to(model.device)
    x = model.tok_embd[ids]
    pos = np.arange(n)
    rel_b = next(b.rel_b for b in model.enc if b.rel_b is not None)
    bias = _bias(rel_b, pos[None, :] - pos[:, None], True, hp)
    for b in model.enc:
        x = _ffn(_block_attn(x, b, hp, bias), b, hp)
    return layers.rms_norm(x, model.enc_norm, hp.rms_eps)


class T5Context:
    """encode + stepwise decode over one sequence (llama-cli's T5 flow:
    llama_encode then the decode loop seeded with decoder_start_token)."""

    def __init__(self, model: T5Model, n_ctx: int = 512):
        self.model = model
        self.n_ctx = n_ctx
        self.enc_out = None
        if model.dec is not None:
            rel_b = next(b.rel_b for b in model.dec if b.rel_b is not None)
            # the unidirectional bias of query position t over keys 0..t
            # is table[:, t - pos]: one host computation a Context
            self._dec_bias = _bias(rel_b, -np.arange(n_ctx), False, model.hp)
        self.reset_decoder()

    # -- encoder -----------------------------------------------------------

    def encode(self, tokens: list[int]) -> np.ndarray:
        """Run the encoder (llama_encode). Returns [n, C] embeddings and
        keeps the output as the decoder's cross-attention source."""
        m, hp = self.model, self.model.hp
        out = encode_hidden(m, tokens)
        self.enc_out = out
        if m.dec is not None:
            # project the encoder output into per-layer cross k/v once
            shape = (-1, hp.n_head, hp.d_kv)
            self._ck_cross = [(out @ b.cross_wk.T).reshape(shape)
                              for b in m.dec]
            self._cv_cross = [(out @ b.cross_wv.T).reshape(shape)
                              for b in m.dec]
        return out.cpu().numpy()

    # -- decoder -----------------------------------------------------------

    def reset_decoder(self) -> None:
        hp = self.model.hp
        self.n_past = 0
        if self.model.dec is not None:
            z = lambda: torch.zeros((hp.n_layer, self.n_ctx, hp.n_head,
                                     hp.d_kv), dtype=torch.float32,
                                    device=self.model.device)
            self._cache = (z(), z())

    def decode(self, token: int) -> np.ndarray:
        if self.enc_out is None:
            raise RuntimeError("encode() must run before decode()")
        if self.n_past >= self.n_ctx:
            raise RuntimeError("decoder context full")
        logits = self._step(int(token), self.n_past)
        self.n_past += 1
        return logits.cpu().numpy()

    def _step(self, tok: int, t: int) -> torch.Tensor:
        """One decoder token at position t -> logits [V] on the device."""
        m, hp = self.model, self.model.hp
        h, dkv = hp.n_head, hp.d_kv
        ck, cv = self._cache
        x = m.tok_embd[tok]
        bias = self._dec_bias[:, :t + 1].flip(1)        # [H, t + 1]
        for li, b in enumerate(m.dec):
            # self-attention with the K/V append
            cur = layers.rms_norm(x, b.attn_norm, hp.rms_eps)
            q = (b.wq @ cur).reshape(h, dkv)
            ck[li, t] = (b.wk @ cur).reshape(h, dkv)
            cv[li, t] = (b.wv @ cur).reshape(h, dkv)
            logits = torch.einsum("hd,thd->ht", q, ck[li, :t + 1]) + bias
            att = torch.softmax(logits, dim=-1)
            o = torch.einsum("ht,thd->hd", att, cv[li, :t + 1])
            x = x + b.wo @ o.reshape(h * dkv)
            # cross-attention over the encoder output
            cur = layers.rms_norm(x, b.cross_norm, hp.rms_eps)
            q = (b.cross_wq @ cur).reshape(h, dkv)
            att = torch.softmax(torch.einsum(
                "hd,shd->hs", q, self._ck_cross[li]), dim=-1)
            o = torch.einsum("hs,shd->hd", att, self._cv_cross[li])
            x = x + b.cross_wo @ o.reshape(h * dkv)
            x = _ffn(x, b, hp)
        xn = layers.rms_norm(x, m.dec_norm, hp.rms_eps)
        if m.output is None:
            # tied head: T5 scales hidden by d_model^-0.5 before the shared
            # embedding matmul (HF T5ForConditionalGeneration tie path)
            return m.tok_embd @ (xn * (hp.n_embd ** -0.5))
        return m.output @ xn


def generate(ctx: T5Context, prompt: list[int],
             max_new_tokens: int, eos_id: int = 1) -> Iterator[int]:
    """Encode the prompt, then greedy-decode from decoder_start_token
    (the reference main.cpp T5 flow: encode -> seed decoder)."""
    ctx.encode(prompt)
    ctx.reset_decoder()
    tok = ctx.model.hp.dec_start_token
    for _ in range(max_new_tokens):
        logits = ctx.decode(tok)
        tok = int(np.argmax(logits))
        if tok == eos_id:
            return
        yield tok
