"""RWKV7 "goose" + ARWKV7 hybrid architectures — the reference
llm_build_rwkv7 / llm_build_arwkv7 analogue (llama-model.cpp:10736-11100;
wkv kernel ggml-cpu.c ggml_compute_forward_rwkv_wkv7_f32).

Counterpart of llama_cpp_test_tpu/models/rwkv7.py. RWKV7 replaces
rwkv6's data-dependent-decay outer-product update with a DeltaNet-style
rank-1 state transition ("in-context learning rate"):

  time mix:
    x_i  = xa + (shift - xa) * lerp_i       for i in (r, w, k, v, a[, g])
    r    = Wr x_r
    w    = exp(-0.606531 * sigmoid(w2 @ tanh(w1 @ x_w) + w0))
    k, v = Wk x_k, Wv x_v
    v    = v + (v_first - v) * sigmoid(v2 @ (v1 @ x_v) + v0)   (layers > 0;
           v_first is layer 0's raw v for the SAME token)
    a    = sigmoid(a2 @ (a1 @ x_a) + a0)     # per-channel ICL rate
    g    = g2 @ sigmoid(g1 @ x_g)            # optional output gate
    kk   = l2norm_per_head(k * k_k)
    k    = k * (1 + k_a * (a - 1))
    per head, S [D_v, D_k] (kernel a-input = -kk, b-input = kk*a):
      sa_i   = sum_j (-kk_j) S_ij
      S_ij  <- S_ij w_j + v_i k_j + sa_i (kk_j a_j)
      out_i  = sum_j S_ij r_j
    out  = groupnorm_per_head(out, 64e-5) * ln_x_w + ln_x_b   (if present)
    out += v * sum_per_head(k * r * r_k)     # bonus term
    x   += Wo (out * g)
  channel mix (rwkv7 only — NO receptance):
    x_k  = xf + (shift_f - xf) * cm_lerp_k
    x   += Wv relu(Wk x_k)^2

arwkv7 (RwkvHybridForCausalLM, qwen-distilled): the same time mix inside
an RMS-norm llama body — no embedding norm, ONE token shift per layer,
and a gated SwiGLU FFN instead of channel mix.

Plain f32 torch on an explicit device, as the reference computes it;
every step takes a leading batch axis (B = 1 in Rwkv7Context).
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
from .rwkv6 import _ln, _rms, weights_t, zero_state


@dataclasses.dataclass(frozen=True)
class Rwkv7HParams:
    arch: str                # rwkv7 | arwkv7
    n_vocab: int
    n_embd: int
    n_layer: int
    head_size: int
    n_ff: int
    ln_eps: float

    @property
    def n_head(self) -> int:
        return self.n_embd // self.head_size

    @property
    def rms(self) -> bool:
        return self.arch == "arwkv7"


@dataclasses.dataclass
class Rwkv7Layer:
    ln1_w: Any
    ln1_b: Any
    ln2_w: Any                   # rwkv7 channel-mix norm / arwkv7 ffn_norm
    ln2_b: Any
    lerp_fused: Any              # [6 or 5, C] (r, w, k, v, a[, g])
    w0: Any                      # [C]
    w1: Any                      # [rank, C]
    w2: Any                      # [C, rank]
    a0: Any
    a1: Any
    a2: Any
    v0: Any                      # None on layer 0
    v1: Any
    v2: Any
    g1: Any                      # optional gate
    g2: Any
    k_k: Any                     # [C]
    k_a: Any
    r_k: Any
    key_w: Any
    value_w: Any
    recept_w: Any
    ln_x_w: Any
    ln_x_b: Any
    out_w: Any
    # rwkv7 channel mix
    cm_lerp_k: Any
    cm_key_w: Any
    cm_value_w: Any
    # arwkv7 swiglu ffn
    ffn_gate: Any = None
    ffn_up: Any = None
    ffn_down: Any = None


@dataclasses.dataclass
class Rwkv7Weights:
    tok_embd: Any
    tok_norm_w: Any              # rwkv7 only
    tok_norm_b: Any
    output_norm_w: Any
    output_norm_b: Any
    output: Any
    layers: list


class Rwkv7Model:
    """Loaded rwkv7 / arwkv7 GGUF: hparams + dense f32 weights on a device
    + tokenizer. The low-rank dims come from the tensor shapes."""

    def __init__(self, path: str, device=None):
        self.device = resolve_device(device)
        self.path = path
        r = open_gguf(path)
        self.reader = r
        md = r.metadata
        arch = md.get("general.architecture")
        if arch not in ("rwkv7", "arwkv7"):
            raise ValueError(f"not a rwkv7/arwkv7 GGUF (arch {arch!r})")
        toks = md.get("tokenizer.ggml.tokens")
        n_vocab = int(md.get(f"{arch}.vocab_size",
                             len(toks) if toks is not None else 0))
        eps_key = (f"{arch}.attention.layer_norm_rms_epsilon"
                   if arch == "arwkv7"
                   else f"{arch}.attention.layer_norm_epsilon")
        self.hp = Rwkv7HParams(
            arch=arch,
            n_vocab=n_vocab,
            n_embd=int(md[f"{arch}.embedding_length"]),
            n_layer=int(md[f"{arch}.block_count"]),
            head_size=int(md[f"{arch}.wkv.head_size"]),
            n_ff=int(md.get(f"{arch}.feed_forward_length", 0)),
            ln_eps=float(md.get(eps_key, 1e-5)),
        )
        C = self.hp.n_embd
        t = lambda name: host_tensor(r, name)
        opt = lambda name: t(name) if name in r.tensors else None
        vec = lambda name: t(name).reshape(C)
        lys = []
        for i in range(self.hp.n_layer):
            p = f"blk.{i}."
            # layer 0 carries dummy v0/v1/v2 in reference GGUFs (unused:
            # v_first IS layer 0's v): not loaded
            late = opt if i > 0 else (lambda name: None)
            v0 = late(p + "time_mix_v0.weight")
            lys.append(Rwkv7Layer(
                ln1_w=t(p + "attn_norm.weight"),
                ln1_b=opt(p + "attn_norm.bias"),
                ln2_w=opt(p + "attn_norm_2.weight") if arch == "rwkv7"
                else opt(p + "ffn_norm.weight"),
                ln2_b=opt(p + "attn_norm_2.bias"),
                lerp_fused=t(p + "time_mix_lerp_fused.weight").reshape(-1, C),
                w0=vec(p + "time_mix_w0.weight"),
                w1=t(p + "time_mix_w1.weight"),
                w2=t(p + "time_mix_w2.weight"),
                a0=vec(p + "time_mix_a0.weight"),
                a1=t(p + "time_mix_a1.weight"),
                a2=t(p + "time_mix_a2.weight"),
                v0=None if v0 is None else v0.reshape(C),
                v1=late(p + "time_mix_v1.weight"),
                v2=late(p + "time_mix_v2.weight"),
                g1=opt(p + "time_mix_g1.weight"),
                g2=opt(p + "time_mix_g2.weight"),
                k_k=vec(p + "time_mix_k_k.weight"),
                k_a=vec(p + "time_mix_k_a.weight"),
                r_k=vec(p + "time_mix_r_k.weight"),
                key_w=t(p + "time_mix_key.weight"),
                value_w=t(p + "time_mix_value.weight"),
                recept_w=t(p + "time_mix_receptance.weight"),
                ln_x_w=opt(p + "time_mix_ln.weight"),
                ln_x_b=opt(p + "time_mix_ln.bias"),
                out_w=t(p + "time_mix_output.weight"),
                cm_lerp_k=opt(p + "channel_mix_lerp_k.weight"),
                cm_key_w=opt(p + "channel_mix_key.weight"),
                cm_value_w=opt(p + "channel_mix_value.weight"),
                ffn_gate=opt(p + "ffn_gate.weight"),
                ffn_up=opt(p + "ffn_up.weight"),
                ffn_down=opt(p + "ffn_down.weight"),
            ))
        embd = t("token_embd.weight")
        self.weights = convert_weights(Rwkv7Weights(
            tok_embd=embd,
            tok_norm_w=opt("token_embd_norm.weight"),
            tok_norm_b=opt("token_embd_norm.bias"),
            output_norm_w=t("output_norm.weight"),
            output_norm_b=opt("output_norm.bias"),
            output=(t("output.weight") if "output.weight" in r.tensors
                    else embd),
            layers=lys), self.device, Rwkv7Weights, Rwkv7Layer)
        try:
            self.tokenizer = load_tokenizer(r)
        except Exception:
            self.tokenizer = None

    @classmethod
    def from_weights(cls, hp: Rwkv7HParams, w, device=None) -> "Rwkv7Model":
        """An Rwkv7Model over weights loaded elsewhere (any object with
        Rwkv7Weights' fields), with no file and no tokenizer behind it."""
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self.path = self.reader = self.tokenizer = None
        self.hp = hp
        self.weights = convert_weights(w, self.device, Rwkv7Weights,
                                       Rwkv7Layer)
        return self


def _time_mix(ly, shift_a, S, x, v_first, *, hp: Rwkv7HParams):
    """rwkv7 time mix for one token of B sequences: x, shift_a [B, C];
    S [B, H, D_v, D_k]; v_first [B, C] or None (layer 0). Returns (dx,
    xa, S', v_first')."""
    H, D, C = hp.n_head, hp.head_size, hp.n_embd
    B = x.shape[0]
    xa_n = (_rms(x, ly.ln1_w, hp.ln_eps) if hp.rms
            else _ln(x, ly.ln1_w, ly.ln1_b, hp.ln_eps))
    sx = shift_a - xa_n
    xi = xa_n[:, None] + sx[:, None] * ly.lerp_fused   # [B, 5 or 6, C]
    xr, xw, xk, xv, x_a = xi[:, 0], xi[:, 1], xi[:, 2], xi[:, 3], xi[:, 4]
    r = xr @ ly.recept_w.T
    w = torch.exp(-0.606531 * torch.sigmoid(
        torch.tanh(xw @ ly.w1.T) @ ly.w2.T + ly.w0))
    k = xk @ ly.key_w.T
    v = xv @ ly.value_w.T
    if v_first is None:
        v_first = v
    else:
        v = v + (v_first - v) * torch.sigmoid(
            (xv @ ly.v1.T) @ ly.v2.T + ly.v0)
    a = torch.sigmoid((x_a @ ly.a1.T) @ ly.a2.T + ly.a0)
    g = None
    if ly.g1 is not None:
        g = torch.sigmoid(xi[:, 5] @ ly.g1.T) @ ly.g2.T
    kk = (k * ly.k_k).reshape(B, H, D)
    kk = kk / torch.sqrt((kk * kk).sum(dim=-1, keepdim=True) + 1e-12)
    k = k * (1.0 + ly.k_a * (a - 1.0))
    rh, wh = r.reshape(B, H, D), w.reshape(B, H, D)
    kh, vh, ah = k.reshape(B, H, D), v.reshape(B, H, D), a.reshape(B, H, D)
    # wkv7 step (S [B, H, D_v, D_k]; kernel inputs a=-kk, b=kk*a):
    #   sa_i = sum_j (-kk_j) S_ij;  S_ij <- S_ij w_j + v_i k_j + sa_i b_j
    #   out_i = sum_j S_ij r_j
    sa = torch.einsum("bhij,bhj->bhi", S, -kk)
    S = S * wh[:, :, None, :] + vh[..., :, None] * kh[..., None, :] \
        + sa[..., :, None] * (kk * ah)[..., None, :]
    out = torch.einsum("bhij,bhj->bhi", S, rh)
    if ly.ln_x_w is not None:
        out = _ln(out, 1.0, 0.0, 64e-5).reshape(B, C)
        out = out * ly.ln_x_w + ly.ln_x_b
    else:
        out = out.reshape(B, C)
    rk = (kh * rh * ly.r_k.reshape(H, D)).sum(dim=-1)     # [B, H]
    out = out + (vh * rk[..., None]).reshape(B, C)
    if g is not None:
        out = out * g
    return out @ ly.out_w.T, xa_n, S, v_first


def _layer_step(ly, shift_a, shift_f, S, x, v_first, *,
                hp: Rwkv7HParams):
    """One token of B sequences through one layer. Returns (x', shift_a',
    shift_f', S', v_first')."""
    dx, xa_n, S, v_first = _time_mix(ly, shift_a, S, x, v_first, hp=hp)
    x = x + dx
    if hp.arch == "rwkv7":
        xf = _ln(x, ly.ln2_w, ly.ln2_b, hp.ln_eps)
        xk2 = xf + (shift_f - xf) * ly.cm_lerp_k.reshape(-1)
        x = x + torch.square(torch.relu(xk2 @ ly.cm_key_w.T)) \
            @ ly.cm_value_w.T
        return x, xa_n, xf, S, v_first
    # arwkv7: gated swiglu FFN, rms norms, no ffn token shift
    cur = _rms(x, ly.ln2_w, hp.ln_eps)
    act = F.silu(cur @ ly.ffn_gate.T) * (cur @ ly.ffn_up.T)
    return x + act @ ly.ffn_down.T, xa_n, shift_f, S, v_first


def token_chain(weights_t, state, toks, *, hp: Rwkv7HParams):
    """One token of B sequences through all layers (v_first threads
    through the layers of the token). state = (shift_a [B, L, C], shift_f
    [B, L, C], wkv [B, L, H, D, D]). Returns (hidden [B, C], state'); the
    LM head is head()."""
    tok_embd, tnw, tnb, _, _, _, lys = weights_t
    sa, sf, S = state
    x = tok_embd[toks]
    if tnw is not None:
        x = _ln(x, tnw, tnb, hp.ln_eps)
    v_first = None
    new_a, new_f, new_s = [], [], []
    for li, ly in enumerate(lys):
        x, a1, f1, S1, v_first = _layer_step(
            ly, sa[:, li], sf[:, li], S[:, li], x, v_first, hp=hp)
        new_a.append(a1)
        new_f.append(f1)
        new_s.append(S1)
    return x, (torch.stack(new_a, 1), torch.stack(new_f, 1),
               torch.stack(new_s, 1))


def head(weights_t, x, *, hp: Rwkv7HParams):
    """Final norm + LM head over hidden x [..., C] -> [..., V]."""
    _, _, _, onw, onb, out_w, _ = weights_t
    xn = (_rms(x, onw, hp.ln_eps) if hp.rms
          else _ln(x, onw, onb, hp.ln_eps))
    return xn @ out_w.T


class Rwkv7Context(SeqContext):
    """Recurrent-state context for rwkv7/arwkv7 (prefill / decode / greedy
    generation): the token shifts and wkv7 states of one sequence."""

    arch = RecurrentArch(weights_t, zero_state, token_chain, head)
