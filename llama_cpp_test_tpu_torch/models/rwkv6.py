"""RWKV6 (linear-attention RNN) architecture — the reference
llm_build_rwkv6 analogue (llama-model.cpp:10340-10647; tensor names
llama-arch.cpp LLM_ARCH_RWKV6 block; wkv kernel semantics
ggml/src/ggml-cpu/ggml-cpu.c ggml_compute_forward_rwkv_wkv6_f32), and
rwkv6qwen2 (QRWKV, llm_build_rwkv6qwen2 + ggml_gated_linear_attn).

Counterpart of llama_cpp_test_tpu/models/rwkv6.py. An RWKV layer carries
three recurrent states instead of a KV cache: the TIME-MIX token shift
(last token's attn-norm output, [C]), the CHANNEL-MIX token shift (last
token's ffn-norm output, [C]) and the per-head wkv matrix state ([H, D,
D] with D = wkv head_size). Rwkv6Model/Rwkv6Context provide load +
prefill + decode; runtime/recurrent.py serves the model behind the
Scheduler over a state pool.

Math per layer (original RWKV-v6 "finch"):

  time mix (att):
    xa   = LN(x, ln1);  sx = shift_a - xa
    xxx  = xa + sx * lerp_x
    five = w2[i] @ tanh(w1 @ xxx)            # 5 token-dependent lerps
    x_i  = xa + sx * (five_i + lerp_i)        for i in (w, k, v, r, g)
    r, k, v = Wr x_r, Wk x_k, Wv x_v;  g = silu(Wg x_g)
    w    = exp(-exp(decay_w2 @ tanh(decay_w1 @ x_w) + decay))
    per head h:  out_j = sum_i r_i (first_i k_i v_j + S_ij)
                 S_ij <- S_ij * w_i + k_i v_j
    out  = groupnorm_per_head(out, eps 64e-5) * ln_x_w + ln_x_b
    x   += Wo (out * g)
  channel mix (ffn):
    xf   = LN(x, ln2);  sx = shift_f - xf
    x_k  = xf + sx * cm_lerp_k;  x_r = xf + sx * cm_lerp_r
    x   += sigmoid(Wr x_r) * (Wv relu(Wk x_k)^2)
  every rescale_every_n_layers layers: x *= 0.5 (the weights were
  pre-divided by 2^(il//rescale) at convert, so the composition equals
  the unscaled model).

qrwkv (rwkv6qwen2): RMS norms and a SwiGLU FFN (the qwen body), GQA
repeat of the k/v heads, a sigmoid gate, k scaled by (1 - w), the state
read AFTER its update with a D^-0.5 scale, no first bonus and no group
norm, ONE token shift (shift_f passes through), no rescale.

Plain f32 torch on an explicit device, as the reference computes it;
every step takes a leading batch axis (B = 1 in Rwkv6Context).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..gguf.reader import open_gguf
from ..tokenizer import load_tokenizer
from ..weights import host_tensor
from .mamba import (RecurrentArch, SeqContext, convert_weights,  # noqa: F401
                    generate)


@dataclasses.dataclass(frozen=True)
class Rwkv6HParams:
    arch: str                # rwkv6 | rwkv6qwen2
    n_vocab: int
    n_embd: int
    n_layer: int
    head_size: int           # wkv.head_size (D); H = n_embd // D
    n_ff: int
    ln_eps: float
    rescale_every: int       # 0 = no activation rescaling
    n_head_kv: int = 0       # rwkv6qwen2 GQA kv heads (0 = n_head)

    @property
    def n_head(self) -> int:
        return self.n_embd // self.head_size

    @property
    def qrwkv(self) -> bool:
        return self.arch == "rwkv6qwen2"


@dataclasses.dataclass
class Rwkv6Layer:
    ln1_w: Any                   # attn_norm (LayerNorm w/b; rms for qrwkv)
    ln1_b: Any
    ln2_w: Any                   # attn_norm_2 (rwkv6) / ffn_norm (qrwkv)
    ln2_b: Any
    lerp_x: Any                  # [C]
    lerp_fused: Any              # [5, C] (w, k, v, r, g order)
    w1: Any                      # [5*extra, C]
    w2: Any                      # [5, C, extra]
    decay: Any                   # [C] bias
    decay_w1: Any                # [extra_d, C]
    decay_w2: Any                # [C, extra_d]
    first: Any                   # time_mix_first [H, D]; None for qrwkv
    key_w: Any                   # [C or KV*D, C]
    value_w: Any
    recept_w: Any
    gate_w: Any
    key_b: Any = None            # qrwkv qwen-style biases
    value_b: Any = None
    recept_b: Any = None
    ln_x_w: Any = None           # per-head groupnorm affine [C]
    ln_x_b: Any = None
    out_w: Any = None            # [C, C]
    cm_lerp_k: Any = None        # [C]
    cm_lerp_r: Any = None
    cm_key_w: Any = None         # [FF, C]
    cm_recept_w: Any = None      # [C, C]
    cm_value_w: Any = None       # [C, FF]
    ffn_gate: Any = None         # qrwkv swiglu ffn
    ffn_up: Any = None
    ffn_down: Any = None


@dataclasses.dataclass
class Rwkv6Weights:
    tok_embd: Any
    tok_norm_w: Any
    tok_norm_b: Any
    output_norm_w: Any
    output_norm_b: Any
    output: Any
    layers: list


class Rwkv6Model:
    """Loaded rwkv6 / rwkv6qwen2 GGUF: hparams + dense f32 weights on a
    device + tokenizer. Takes fused or separate time_mix_lerp tensors."""

    def __init__(self, path: str, device=None):
        self.device = resolve_device(device)
        self.path = path
        r = open_gguf(path)
        self.reader = r
        md = r.metadata
        arch = md.get("general.architecture")
        if arch not in ("rwkv6", "rwkv6qwen2"):
            raise ValueError(f"not a rwkv6/rwkv6qwen2 GGUF (arch {arch!r})")
        toks = md.get("tokenizer.ggml.tokens")
        n_vocab = int(md.get(f"{arch}.vocab_size",
                             len(toks) if toks is not None else 0))
        eps_key = (f"{arch}.attention.layer_norm_rms_epsilon"
                   if arch == "rwkv6qwen2"
                   else f"{arch}.attention.layer_norm_epsilon")
        self.hp = Rwkv6HParams(
            arch=arch,
            n_vocab=n_vocab,
            n_embd=int(md[f"{arch}.embedding_length"]),
            n_layer=int(md[f"{arch}.block_count"]),
            head_size=int(md[f"{arch}.wkv.head_size"]),
            n_ff=int(md.get(f"{arch}.feed_forward_length", 0)),
            ln_eps=float(md.get(eps_key, 1e-5)),
            rescale_every=int(md.get(f"{arch}.rescale_every_n_layers", 0)),
            n_head_kv=int(md.get(f"{arch}.attention.head_count_kv", 0)),
        )
        C, D, H = self.hp.n_embd, self.hp.head_size, self.hp.n_head
        t = lambda name: host_tensor(r, name)
        opt = lambda name: t(name) if name in r.tensors else None
        vec = lambda name: None if name not in r.tensors else \
            t(name).reshape(C)
        lys = []
        for i in range(self.hp.n_layer):
            p = f"blk.{i}."
            if p + "time_mix_lerp_fused.weight" in r.tensors:
                fused = t(p + "time_mix_lerp_fused.weight").reshape(5, C)
            else:   # separate lerp tensors (w, k, v, r, g)
                fused = torch.stack([
                    torch.as_tensor(t(p + f"time_mix_lerp_{s}.weight"))
                    .float().reshape(C) for s in "wkvrg"])
            extra = t(p + "time_mix_w1.weight").shape[0] // 5
            first = opt(p + "time_mix_first.weight")
            lys.append(Rwkv6Layer(
                ln1_w=t(p + "attn_norm.weight"),
                ln1_b=opt(p + "attn_norm.bias"),
                ln2_w=(t(p + "attn_norm_2.weight")
                       if p + "attn_norm_2.weight" in r.tensors
                       else opt(p + "ffn_norm.weight")),
                ln2_b=opt(p + "attn_norm_2.bias"),
                lerp_x=t(p + "time_mix_lerp_x.weight").reshape(C),
                lerp_fused=fused,
                w1=t(p + "time_mix_w1.weight"),
                w2=t(p + "time_mix_w2.weight").reshape(5, C, extra),
                decay=t(p + "time_mix_decay.weight").reshape(C),
                decay_w1=t(p + "time_mix_decay_w1.weight"),
                decay_w2=t(p + "time_mix_decay_w2.weight"),
                first=None if first is None else first.reshape(H, D),
                key_w=t(p + "time_mix_key.weight"),
                value_w=t(p + "time_mix_value.weight"),
                recept_w=t(p + "time_mix_receptance.weight"),
                gate_w=t(p + "time_mix_gate.weight"),
                key_b=opt(p + "time_mix_key.bias"),
                value_b=opt(p + "time_mix_value.bias"),
                recept_b=opt(p + "time_mix_receptance.bias"),
                ln_x_w=opt(p + "time_mix_ln.weight"),
                ln_x_b=opt(p + "time_mix_ln.bias"),
                out_w=t(p + "time_mix_output.weight"),
                cm_lerp_k=vec(p + "channel_mix_lerp_k.weight"),
                cm_lerp_r=vec(p + "channel_mix_lerp_r.weight"),
                cm_key_w=opt(p + "channel_mix_key.weight"),
                cm_recept_w=opt(p + "channel_mix_receptance.weight"),
                cm_value_w=opt(p + "channel_mix_value.weight"),
                ffn_gate=opt(p + "ffn_gate.weight"),
                ffn_up=opt(p + "ffn_up.weight"),
                ffn_down=opt(p + "ffn_down.weight"),
            ))
        embd = t("token_embd.weight")
        self.weights = convert_weights(Rwkv6Weights(
            tok_embd=embd,
            tok_norm_w=opt("token_embd_norm.weight"),
            tok_norm_b=opt("token_embd_norm.bias"),
            output_norm_w=t("output_norm.weight"),
            output_norm_b=opt("output_norm.bias"),
            output=(t("output.weight") if "output.weight" in r.tensors
                    else embd),
            layers=lys), self.device, Rwkv6Weights, Rwkv6Layer)
        try:
            self.tokenizer = load_tokenizer(r)
        except Exception:
            self.tokenizer = None

    @classmethod
    def from_weights(cls, hp: Rwkv6HParams, w, device=None) -> "Rwkv6Model":
        """An Rwkv6Model over weights loaded elsewhere (any object with
        Rwkv6Weights' fields), with no file and no tokenizer behind it."""
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self.path = self.reader = self.tokenizer = None
        self.hp = hp
        self.weights = convert_weights(w, self.device, Rwkv6Weights,
                                       Rwkv6Layer)
        return self


def _ln(x, w, b, eps):
    """LayerNorm over the last axis (population variance), as the
    reference's; w and b may be python scalars, b None."""
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) * (x - mu)).mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps) * w
    return y if b is None else y + b


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def _norm1(x, ly, hp):
    if hp.qrwkv:   # rms, no bias
        return _rms(x, ly.ln1_w, hp.ln_eps)
    return _ln(x, ly.ln1_w, ly.ln1_b, hp.ln_eps)


def _lin(x, w, b=None):
    """x [B, K] @ w.T (+ b)."""
    y = x @ w.T
    return y if b is None else y + b


def _layer_step(ly: Rwkv6Layer, shift_a, shift_f, S, x, *,
                hp: Rwkv6HParams, rescale: bool):
    """One token of B sequences through one rwkv6/rwkv6qwen2 layer. x
    [B, C]; shift_a/shift_f [B, C]; S [B, H, D, D] indexed (key, value).
    Returns (x', shift_a', shift_f', S')."""
    H, D = hp.n_head, hp.head_size
    KV = hp.n_head_kv or H
    B = x.shape[0]

    # ---- time mix -------------------------------------------------------
    xa = _norm1(x, ly, hp)
    sx = shift_a - xa
    xxx = xa + sx * ly.lerp_x
    tmp = torch.tanh(xxx @ ly.w1.T).reshape(B, 5, -1)     # [B, 5, extra]
    five = torch.einsum("sce,bse->bsc", ly.w2, tmp)       # [B, 5, C]
    xi = xa[:, None] + sx[:, None] * (five + ly.lerp_fused)
    xw, xk, xv, xr, xg = xi.unbind(1)
    r = _lin(xr, ly.recept_w, ly.recept_b).reshape(B, H, D)
    k = _lin(xk, ly.key_w, ly.key_b)
    v = _lin(xv, ly.value_w, ly.value_b)
    if KV != H:   # qrwkv GQA: repeat kv heads (build_rwkv6_time_mix)
        k = k.reshape(B, KV, D).repeat_interleave(H // KV, dim=1)
        v = v.reshape(B, KV, D).repeat_interleave(H // KV, dim=1)
    else:
        k = k.reshape(B, H, D)
        v = v.reshape(B, H, D)
    g = xg @ ly.gate_w.T
    g = torch.sigmoid(g) if hp.qrwkv else F.silu(g)
    w = _lin(torch.tanh(xw @ ly.decay_w1.T), ly.decay_w2) + ly.decay
    w = torch.exp(-torch.exp(w)).reshape(B, H, D)
    if hp.qrwkv:
        # gated linear attention (ggml_gated_linear_attn scalar loop):
        # k scaled by (1-w); S <- diag(w) S + k v^T read AFTER the update;
        # out = scale * r^T S
        k = k - k * w
        S = S * w[..., None] + k[..., :, None] * v[..., None, :]
        out = torch.einsum("bhi,bhij->bhj", r, S) * (D ** -0.5)
        out = out.reshape(B, H * D)
    else:
        # wkv6: out_j = sum_i r_i (first_i k_i v_j + S_ij);
        #       S_ij <- S_ij w_i + k_i v_j  (ggml_rwkv_wkv6 scalar loop)
        kv = k[..., :, None] * v[..., None, :]            # [B, H, D, D]
        out = torch.einsum("bhi,bhij->bhj", r,
                           ly.first[:, :, None] * kv + S)
        S = S * w[..., None] + kv
        # per-head groupnorm (ggml_norm eps 64e-5 on the [D]-head view)
        out = _ln(out, 1.0, 0.0, 64e-5).reshape(B, H * D)
        out = out * ly.ln_x_w + ly.ln_x_b
    x = x + (out * g) @ ly.out_w.T

    # ---- ffn ------------------------------------------------------------
    if hp.qrwkv:
        # qwen swiglu FFN on an rms norm; no ffn token shift
        cur = _rms(x, ly.ln2_w, hp.ln_eps)
        act = F.silu(cur @ ly.ffn_gate.T) * (cur @ ly.ffn_up.T)
        return x + act @ ly.ffn_down.T, xa, shift_f, S
    xf = _ln(x, ly.ln2_w, ly.ln2_b, hp.ln_eps)
    sx2 = shift_f - xf
    xk2 = xf + sx2 * ly.cm_lerp_k
    xr2 = xf + sx2 * ly.cm_lerp_r
    rr = torch.sigmoid(xr2 @ ly.cm_recept_w.T)
    kk = torch.square(torch.relu(xk2 @ ly.cm_key_w.T))
    x = x + rr * (kk @ ly.cm_value_w.T)
    if rescale:
        x = x * 0.5
    return x, xa, xf, S


def rescales(hp: Rwkv6HParams, li: int) -> bool:
    """Whether layer li halves its output: every rescale_every layers
    (counted from 1), never on qrwkv."""
    return not hp.qrwkv and hp.rescale_every > 0 and \
        (li + 1) % hp.rescale_every == 0


def weights_t(model) -> tuple:
    """(tok_embd, tok_norm_w, tok_norm_b, output_norm_w, output_norm_b,
    output, layers): what token_chain and head take (rwkv7's too)."""
    w = model.weights
    return (w.tok_embd, w.tok_norm_w, w.tok_norm_b, w.output_norm_w,
            w.output_norm_b, w.output, tuple(w.layers))


def token_chain(weights_t, state, toks, *, hp: Rwkv6HParams):
    """One token of B sequences through all layers. toks [B]; state =
    (shift_a [B, L, C], shift_f [B, L, C], wkv [B, L, H, D, D]). Returns
    (hidden [B, C], state'); the LM head is head()."""
    tok_embd, tnw, tnb, _, _, _, lys = weights_t
    sa, sf, S = state
    x = tok_embd[toks]
    if tnw is not None:
        x = _ln(x, tnw, tnb, hp.ln_eps)
    new_a, new_f, new_s = [], [], []
    for li, ly in enumerate(lys):
        x, a1, f1, S1 = _layer_step(ly, sa[:, li], sf[:, li], S[:, li], x,
                                    hp=hp, rescale=rescales(hp, li))
        new_a.append(a1)
        new_f.append(f1)
        new_s.append(S1)
    return x, (torch.stack(new_a, 1), torch.stack(new_f, 1),
               torch.stack(new_s, 1))


def head(weights_t, x, *, hp: Rwkv6HParams):
    """Final norm + LM head over hidden x [..., C] -> [..., V]."""
    _, _, _, onw, onb, out_w, _ = weights_t
    xn = _rms(x, onw, hp.ln_eps) if hp.qrwkv else _ln(x, onw, onb,
                                                       hp.ln_eps)
    return xn @ out_w.T


def zero_state(hp, device, rows: int = 1) -> tuple:
    """Zero recurrent state of `rows` sequences (rwkv6's and rwkv7's
    shapes): the two token shifts and the wkv matrices."""
    H, D = hp.n_head, hp.head_size
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return (z(rows, hp.n_layer, hp.n_embd), z(rows, hp.n_layer, hp.n_embd),
            z(rows, hp.n_layer, H, D, D))


class Rwkv6Context(SeqContext):
    """Minimal recurrent-state context (prefill / decode / greedy
    generation) for RWKV6: the token shifts and wkv states of one
    sequence."""

    arch = RecurrentArch(weights_t, zero_state, token_chain, head)
