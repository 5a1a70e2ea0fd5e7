"""Transformer building blocks in plain PyTorch: RMSNorm, LayerNorm, RoPE
(with linear/YaRN scaling; partial when rope_dim < head_dim),
SwiGLU/GeGLU, the non-gated activations (tanh and erf GELU, squared
ReLU), the ALiBi slopes, and masked attention over gathered KV (with an
optional ALiBi bias, causal or symmetric).

Counterpart of llama_cpp_test_tpu/ops/layers.py. Dtypes follow the
reference: norms return the input dtype, rope and the activation compute
in float32 and return the input dtype.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..models.hparams import HParams


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor | None,
               bias: torch.Tensor | None, eps: float) -> torch.Tensor:
    """Mean-centered LayerNorm with float32 statistics, weight and bias
    each optional (olmo's norm has neither), cast back to x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) * (xf - mu)).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def _yarn_ramp(low: float, high: float, dim: int) -> np.ndarray:
    i = np.arange(dim // 2, dtype=np.float32)
    y = (i - low) / max(high - low, 1e-3)
    return 1.0 - np.clip(y, 0.0, 1.0)


def rope_freqs(hp: HParams) -> tuple[np.ndarray, float]:
    """Per-pair inverse frequencies (rope_dim/2,) and magnitude scale
    (YaRN mscale). numpy, on the load path."""
    half = hp.rope_dim // 2
    i = np.arange(half, dtype=np.float32)
    inv_freq = hp.rope_freq_base ** (-2.0 * i / hp.rope_dim)
    mscale = float(hp.rope_attn_factor or 1.0)
    scaling = (hp.rope_scaling or "none").lower()
    factor = hp.rope_scale_factor or 1.0
    if scaling == "linear" and factor != 1.0:
        inv_freq = inv_freq / factor
    elif scaling == "yarn" and factor != 1.0:
        orig = hp.rope_orig_ctx or hp.n_ctx_train

        def corr_dim(n_rot):
            return (hp.rope_dim * math.log(orig / (n_rot * 2 * math.pi))
                    / (2 * math.log(hp.rope_freq_base)))
        low = max(0.0, math.floor(corr_dim(hp.yarn_beta_fast)))
        high = min(half - 1.0, math.ceil(corr_dim(hp.yarn_beta_slow)))
        ramp = _yarn_ramp(low, high, hp.rope_dim)
        inv_freq = inv_freq / factor * (1 - ramp) + inv_freq * ramp
        if hp.arch != "deepseek2":
            # deepseek2 folds the YaRN magnitude into its attention scale
            # (hparams.attn_scale); its rope runs at magnitude 1
            mscale *= 1.0 + 0.1 * math.log(factor)
    return np.asarray(inv_freq, np.float32), mscale


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor, mscale: float = 1.0) -> torch.Tensor:
    """NEOX-style (half-split) rotary embedding, partial when rope_dim <
    head_dim. x: [..., T, H, D]; positions: [..., T]."""
    d = x.shape[-1]
    half = inv_freq.shape[-1]
    rot = 2 * half
    theta = positions[..., None].float() * inv_freq          # [..., T, half]
    cos = (torch.cos(theta) * mscale)[..., None, :]          # [..., T, 1, half]
    sin = (torch.sin(theta) * mscale)[..., None, :]
    x1 = x[..., :half].float()
    x2 = x[..., half:rot].float()
    parts = [x1 * cos - x2 * sin, x2 * cos + x1 * sin]
    if rot < d:
        parts.append(x[..., rot:].float())
    return torch.cat(parts, dim=-1).to(x.dtype)


def apply_mrope(x: torch.Tensor, pos3: torch.Tensor, inv_freq: torch.Tensor,
                sections: tuple, mscale: float = 1.0) -> torch.Tensor:
    """Multi-stream (M-RoPE) rotary embedding for qwen2vl image tokens, in
    float32. x: [..., T, H, D]; pos3: [..., T, 3] (t, h, w) position
    streams; sections (s_t, s_h, s_w) partition the D/2 frequencies, each
    rotating with its section's stream (GGML_ROPE_TYPE_MROPE). Equal
    streams give apply_rope's result bit for bit: each angle is the same
    product."""
    half = inv_freq.shape[-1]
    s_t, s_h, s_w = sections
    if s_t + s_h + s_w != half:
        raise ValueError(f"M-RoPE sections {sections} do not cover the "
                         f"{half} rope frequencies")
    p = pos3.float()
    theta = torch.cat([p[..., 0:1] * inv_freq[:s_t],
                       p[..., 1:2] * inv_freq[s_t:s_t + s_h],
                       p[..., 2:3] * inv_freq[s_t + s_h:]], dim=-1)
    d = x.shape[-1]
    rot = 2 * half
    cos = (torch.cos(theta) * mscale)[..., None, :]
    sin = (torch.sin(theta) * mscale)[..., None, :]
    x1 = x[..., :half].float()
    x2 = x[..., half:rot].float()
    parts = [x1 * cos - x2 * sin, x2 * cos + x1 * sin]
    if rot < d:
        parts.append(x[..., rot:].float())
    return torch.cat(parts, dim=-1).to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor,
           act: str = "silu") -> torch.Tensor:
    """Gated FFN activation act(gate) * up, computed in float32: act
    "silu" (SwiGLU), "gelu" the tanh approximation (gemma's GeGLU) or
    "gelu_erf" the exact GELU (jina-bert-v2's GeGLU; the reference's
    swiglu takes SiLU there, ROADMAP §3 fault 17)."""
    g = gate.float()
    if act == "gelu":
        a = torch.nn.functional.gelu(g, approximate="tanh")
    elif act == "gelu_erf":
        a = torch.nn.functional.gelu(g)
    else:
        a = torch.nn.functional.silu(g)
    return (a * up.float()).to(gate.dtype)


def activation(u: torch.Tensor, act: str) -> torch.Tensor:
    """A non-gated FFN's activation in float32: "gelu" the tanh
    approximation (phi2, falcon, gptneox, starcoder2, gpt2, bloom),
    "gelu_erf" the exact GELU (mpt), "relu2" the squared ReLU (nemotron),
    else SiLU."""
    u = u.float()
    if act == "gelu":
        return torch.nn.functional.gelu(u, approximate="tanh")
    if act == "gelu_erf":
        return torch.nn.functional.gelu(u)
    if act == "relu2":
        return torch.square(torch.relu(u))
    return torch.nn.functional.silu(u)


def alibi_slopes(n_head: int, max_bias: float = 8.0,
                 style: str = "bloom") -> np.ndarray:
    """Per-head ALiBi slopes, float32 [n_head]. "bloom" (and ggml's
    soft_max max_bias): the largest power of two n <= n_head takes
    2^(-max_bias (i + 1) / n), the other heads the odd steps of half that
    base. "mpt": the slopes of the next power of two, odd-indexed ones
    first where n_head is not one."""
    if style == "mpt":
        n = 2 ** int(math.ceil(math.log2(n_head)))
        slopes = [2.0 ** (-(i + 1) * max_bias / n) for i in range(n)]
        if n != n_head:
            slopes = slopes[1::2] + slopes[::2]
        return np.asarray(slopes[:n_head], np.float32)
    n = 2 ** int(math.floor(math.log2(n_head)))
    base = 2.0 ** (-max_bias / n)
    slopes = [base ** (i + 1) for i in range(n)]
    if n < n_head:
        base2 = 2.0 ** (-(max_bias / 2.0) / n)
        slopes += [base2 ** (2 * i + 1) for i in range(n_head - n)]
    return np.asarray(slopes[:n_head], np.float32)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: torch.Tensor, scale: float, softcap: float = 0.0,
              alibi: torch.Tensor | None = None,
              alibi_sym_pos: torch.Tensor | None = None) -> torch.Tensor:
    """Masked multi-head attention with GQA broadcast, in float32.

    q: [B, T, H, D]; k/v: [B, S, KV, D]; mask: [B, T, S] bool (True =
    attend). alibi: optional [H] slopes, slope_h * s added to the logit of
    key index s after the softcap and before the mask, as the reference
    adds it (for a causal row the same as slope_h * (s - pos) up to a
    constant). alibi_sym_pos: the true query positions [B, T], which make
    the bias symmetric, -slope_h * |pos - s| (jina-bert-v2, whose rows are
    not causal). Rows with nothing to attend give zeros. Returns
    [B, T, H, D] in q's dtype."""
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    rep = h // kv
    qf = q.float().reshape(b, t, kv, rep, d)
    logits = torch.einsum("btgrd,bsgd->bgrts", qf, k.float()) * scale
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    if alibi is not None:
        sl = alibi.float().reshape(kv, rep)
        idx = torch.arange(s, dtype=torch.float32, device=q.device)
        if alibi_sym_pos is not None:
            dist = -(alibi_sym_pos.float()[:, :, None] - idx).abs()
            logits = logits + sl[None, :, :, None, None] * \
                dist[:, None, None, :, :]
        else:
            logits = logits + (sl[:, :, None, None] * idx)[None]
    m = mask[:, None, None, :, :]
    logits = logits.masked_fill(~m, torch.finfo(torch.float32).min)
    p = torch.softmax(logits, dim=-1)
    p = torch.where(m.any(dim=-1, keepdim=True), p, torch.zeros_like(p))
    out = torch.einsum("bgrts,bsgd->btgrd", p, v.float())
    return out.reshape(b, t, h, d).to(q.dtype)
