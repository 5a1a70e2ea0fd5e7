"""Mamba (selective state-space) architecture — the reference
llm_build_mamba analogue (llama-model.cpp MAMBA; tensor names
llama-arch.cpp:817-827, hparams llama-arch.cpp:151-154).

Counterpart of llama_cpp_test_tpu/models/mamba.py. A state-space layer
carries RECURRENT state (a depthwise-conv tail and a [d_inner, d_state]
SSM state per layer) instead of a KV cache, so it does not ride the
paged-KV engine: MambaModel/MambaContext below provide the load +
prefill + decode surface (llama-cli-style generation), and
runtime/recurrent.py's RecurrentContext serves it behind the same
Scheduler over a state pool.

Math per layer (HF MambaMixer slow path):

    h, z = split(in_proj(x))                  # [d_in] each
    h    = silu(causal_depthwise_conv(h))     # kernel d_conv, per channel
    dt, B, C = split(x_proj(h))               # [dt_rank | d_state | d_state]
    dt   = softplus(dt_proj(dt))              # [d_in]
    dA   = exp(dt ⊗ A)                        # A = -exp(A_log), [d_in, N]
    s_t  = dA * s_{t-1} + (dt ⊗ B_t) * h_t    # selective scan
    y_t  = s_t · C_t + D * h_t
    out  = out_proj(y * silu(z))

Plain f32 torch on an explicit device, as the reference computes it in
f32 outside any Pallas kernel. Every step takes a leading batch axis: the
single-sequence Context runs it at B = 1, the pooled scheduler context at
the batch's rows. Prefill is a loop over the tokens (the reference's
lax.scan); decode is one step.
"""
from __future__ import annotations

import dataclasses
import typing
from typing import Any, Iterator

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..gguf.reader import open_gguf
from ..ops import layers
from ..tokenizer import load_tokenizer
from ..weights import convert_fields, host_tensor


@dataclasses.dataclass(frozen=True)
class MambaHParams:
    arch: str
    n_vocab: int
    n_embd: int          # d_model
    n_layer: int
    d_inner: int
    d_conv: int
    d_state: int
    dt_rank: int
    rms_eps: float


@dataclasses.dataclass
class MambaLayer:
    norm: Any            # [d_model]
    in_w: Any            # [2*d_inner, d_model]
    conv_w: Any          # [d_inner, d_conv] (depthwise taps)
    conv_b: Any          # [d_inner] or None
    x_w: Any             # [dt_rank + 2*d_state, d_inner]
    dt_w: Any            # [d_inner, dt_rank]
    dt_b: Any            # [d_inner] or None
    a: Any               # [d_inner, d_state] (= -exp(A_log), stored)
    d: Any               # [d_inner]
    out_w: Any           # [d_model, d_inner]


@dataclasses.dataclass
class MambaWeights:
    tok_embd: Any        # [V, d_model]
    output_norm: Any
    output: Any          # [V, d_model] (possibly the tied embedding)
    layers: list


def convert_weights(w, device, weights_cls=MambaWeights,
                    layer_cls=MambaLayer):
    """weights_cls (MambaWeights, or an rwkv family's) with every array a
    float32 tensor on device, from any object with its fields, its layers
    as layer_cls. A tied head stays one tensor with the embedding."""
    out = convert_fields(w, weights_cls, device)
    if w.output is w.tok_embd:
        out.output = out.tok_embd
    out.layers = [convert_fields(ly, layer_cls, device) for ly in w.layers]
    return out


class MambaModel:
    """Loaded mamba GGUF: hparams + dense f32 weights on a device +
    tokenizer (the reference dequantizes every tensor to f32 too)."""

    def __init__(self, path: str, device=None):
        self.device = resolve_device(device)
        self.path = path
        r = open_gguf(path)
        self.reader = r          # server chat-template/metadata access
        md = r.metadata
        arch = md.get("general.architecture")
        if arch != "mamba":
            raise ValueError(f"not a mamba GGUF (arch {arch!r})")

        def g(key, default=None):
            v = md.get(f"{arch}.{key}", default)
            if v is None:
                raise KeyError(f"mamba GGUF missing {arch}.{key}")
            return int(v)

        toks = md.get("tokenizer.ggml.tokens")
        n_vocab = int(md.get(f"{arch}.vocab_size",
                             len(toks) if toks is not None else 0))
        self.hp = MambaHParams(
            arch="mamba",
            n_vocab=n_vocab,
            n_embd=g("embedding_length"),
            n_layer=g("block_count"),
            d_inner=g("ssm.inner_size"),
            d_conv=g("ssm.conv_kernel"),
            d_state=g("ssm.state_size"),
            dt_rank=g("ssm.time_step_rank"),
            rms_eps=float(md.get(
                f"{arch}.attention.layer_norm_rms_epsilon", 1e-5)),
        )
        t = lambda name: host_tensor(r, name)
        opt = lambda name: t(name) if name in r.tensors else None
        di, n = self.hp.d_inner, self.hp.d_state
        lys = []
        for i in range(self.hp.n_layer):
            p = f"blk.{i}."
            lys.append(MambaLayer(
                norm=t(p + "attn_norm.weight"),
                in_w=t(p + "ssm_in.weight"),
                # ggml stores the conv taps ne=(d_conv, d_inner): row-major
                # [d_inner, d_conv]
                conv_w=t(p + "ssm_conv1d.weight").reshape(di, -1),
                conv_b=opt(p + "ssm_conv1d.bias"),
                x_w=t(p + "ssm_x.weight"),
                dt_w=t(p + "ssm_dt.weight"),
                dt_b=opt(p + "ssm_dt.bias"),
                a=t(p + "ssm_a.weight").reshape(di, n),
                d=t(p + "ssm_d.weight"),
                out_w=t(p + "ssm_out.weight"),
            ))
        embd = t("token_embd.weight")
        self.weights = convert_weights(MambaWeights(
            tok_embd=embd,
            output_norm=t("output_norm.weight"),
            output=(t("output.weight") if "output.weight" in r.tensors
                    else embd),
            layers=lys), self.device)
        try:
            self.tokenizer = load_tokenizer(r)
        except Exception:
            self.tokenizer = None

    @classmethod
    def from_weights(cls, hp: MambaHParams, w, device=None) -> "MambaModel":
        """A MambaModel over weights loaded elsewhere (any object with
        MambaWeights' fields), with no file and no tokenizer behind it."""
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self.path = self.reader = self.tokenizer = None
        self.hp = hp
        self.weights = convert_weights(w, self.device)
        return self


def _layer_ws(ly: MambaLayer) -> tuple:
    """A layer's tensors in _mixer_step's order; an absent conv or dt bias
    is zeros."""
    zeros = lambda ref: torch.zeros(ref.shape[0], dtype=torch.float32,
                                    device=ref.device)
    return (ly.norm, ly.in_w, ly.conv_w,
            ly.conv_b if ly.conv_b is not None else zeros(ly.conv_w),
            ly.x_w, ly.dt_w,
            ly.dt_b if ly.dt_b is not None else zeros(ly.dt_w),
            ly.a, ly.d, ly.out_w)


def weights_t(model: MambaModel) -> tuple:
    """(tok_embd, output_norm, output, per-layer _layer_ws tuples): what
    token_chain and head take."""
    w = model.weights
    return (w.tok_embd, w.output_norm, w.output,
            tuple(_layer_ws(ly) for ly in w.layers))


def _mixer_step(ws, conv_state, ssm_state, x, *, hp: MambaHParams):
    """One token of B sequences through one mixer. x [B, d_model];
    conv_state [B, d_inner, d_conv-1]; ssm_state [B, d_inner, d_state].
    Returns (x' [B, d_model], conv_state', ssm_state')."""
    (norm, in_w, conv_w, conv_b, x_w, dt_w, dt_b, a, d_skip, out_w) = ws
    di, n, r = hp.d_inner, hp.d_state, hp.dt_rank
    xn = layers.rms_norm(x, norm, hp.rms_eps)
    proj = xn @ in_w.T                                # [B, 2*d_inner]
    h, z = proj[:, :di], proj[:, di:]
    # causal depthwise conv: taps over [state..., h]
    win = torch.cat([conv_state, h[:, :, None]], dim=2)   # [B, di, d_conv]
    hc = F.silu((win * conv_w).sum(dim=2) + conv_b)
    sp = hc @ x_w.T                                   # [B, dt_rank + 2N]
    dt = F.softplus(sp[:, :r] @ dt_w.T + dt_b)        # [B, di]
    b, c = sp[:, r:r + n], sp[:, r + n:]              # [B, N]
    da = torch.exp(dt[:, :, None] * a)                # [B, di, N]
    new_state = da * ssm_state + (dt[:, :, None] * b[:, None, :]) \
        * hc[:, :, None]
    y = (new_state @ c[:, :, None])[:, :, 0] + d_skip * hc
    y = y * F.silu(z)
    return x + y @ out_w.T, win[:, :, 1:], new_state


def token_chain(wt, state, toks, *, hp: MambaHParams):
    """One token of B sequences through all layers. toks [B] (int64 on the
    weights' device); state = (conv [B, L, di, K-1], ssm [B, L, di, N]).
    Returns (hidden [B, d_model], state')."""
    tok_embd, _, _, layer_ws = wt
    conv, ssm = state
    x = tok_embd[toks]
    new_conv, new_ssm = [], []
    for li, ws in enumerate(layer_ws):
        x, c1, s1 = _mixer_step(ws, conv[:, li], ssm[:, li], x, hp=hp)
        new_conv.append(c1)
        new_ssm.append(s1)
    return x, (torch.stack(new_conv, 1), torch.stack(new_ssm, 1))


def head(wt, x, *, hp: MambaHParams):
    """Final RMS norm + LM head over hidden x [..., d_model] -> [..., V]."""
    _, out_norm, out_w, _ = wt
    return layers.rms_norm(x, out_norm, hp.rms_eps) @ out_w.T


def zero_state(hp: MambaHParams, device, rows: int = 1) -> tuple:
    """Zero recurrent state of `rows` sequences: conv tails and SSM
    states."""
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return (z(rows, hp.n_layer, hp.d_inner, hp.d_conv - 1),
            z(rows, hp.n_layer, hp.d_inner, hp.d_state))


class RecurrentArch(typing.NamedTuple):
    """A recurrent family's recipe, shared by its single-sequence Context
    and the pooled runtime/recurrent.RecurrentContext: its weights tuple,
    per-sequence zero state, per-token chain over all layers (with a
    leading batch axis) and final norm + LM head."""
    weights_t: typing.Callable   # model -> wt
    zero_state: typing.Callable  # (hp, device, rows) -> state tuple
    chain: typing.Callable       # (wt, state, toks [B], hp=) -> (x, state')
    head: typing.Callable        # (wt, x [..., C], hp=) -> logits [..., V]


def run_tokens(arch: RecurrentArch, wt, state, tokens, hp, device,
               all_logits: bool = False):
    """tokens through arch's chain one at a time from state (B = 1): the
    reference's lax.scan as a loop. Returns (logits [T, V] or [V] of the
    last token, on device; state')."""
    toks = torch.as_tensor(np.asarray(tokens, np.int64)).to(device)
    xs = []
    for t in range(toks.shape[0]):
        x, state = arch.chain(wt, state, toks[t:t + 1], hp=hp)
        xs.append(x)
    if all_logits:
        return arch.head(wt, torch.cat(xs), hp=hp), state
    return arch.head(wt, xs[-1], hp=hp)[0], state


class SeqContext:
    """One sequence's recurrent state and the llama-cli surface over it:
    prefill / decode (greedy generation through generate()). `states`
    holds the state with a leading batch axis of 1, O(1) in sequence
    length. A family's Context sets `arch`, its RecurrentArch."""

    arch: RecurrentArch = None

    def __init__(self, model):
        self.model = model
        self._wt = self.arch.weights_t(model)
        self.reset()

    def reset(self) -> None:
        self.states = self.arch.zero_state(self.model.hp, self.model.device)
        self.n_past = 0

    def prefill(self, tokens: list[int],
                all_logits: bool = False) -> np.ndarray:
        if not len(tokens):
            raise ValueError("prefill: empty token list")
        logits, self.states = run_tokens(
            self.arch, self._wt, self.states, tokens, self.model.hp,
            self.model.device, all_logits)
        self.n_past += len(tokens)
        return logits.cpu().numpy()

    def decode(self, token: int) -> np.ndarray:
        return self.prefill([int(token)])


class MambaContext(SeqContext):
    """Minimal recurrent-state context for mamba: the per-layer conv tail
    + SSM state of one sequence."""

    arch = RecurrentArch(weights_t, zero_state, token_chain, head)


def generate(ctx, prompt: list[int],
             max_new_tokens: int) -> Iterator[int]:
    """Greedy generation on any of the single-sequence recurrent Contexts
    (MambaContext, Rwkv6Context, Rwkv7Context)."""
    logits = ctx.prefill(prompt)
    for _ in range(max_new_tokens):
        tok = int(np.argmax(logits))
        yield tok
        logits = ctx.decode(tok)
