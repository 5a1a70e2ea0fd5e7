"""WavTokenizer-dec vocoder — the TTS audio decoder (reference
llm_build_wavtokenizer_dec, src/llama-model.cpp:11265-11400, and
examples/tts/tts.cpp embd_to_audio).

Counterpart of llama_cpp_test_tpu/models/wavtokenizer.py. Graph (per the
reference): token-embedding gather -> conv1d(k=7, same) -> posnet (resnet
blocks with GroupNorm+swish+conv3 at layers 0/1/3/4, a 1x1-conv
self-attention block at layer 2, final GroupNorm at 5) -> token-wise
LayerNorm -> convnext stack (depthwise conv7 + LN + pw1-GELU-pw2 * gamma,
residual) -> final LayerNorm -> output head to n_fft+2 channels
(log-magnitude ; phase) -> the iSTFT (hann window, overlap-add fold,
envelope normalization) at 24kHz.

The network is plain f32 torch on an explicit device, as the reference
computes it in f32 outside any Pallas kernel; its convolutions run with
cuDNN's TF32 off (cuDNN allows TF32 by default, the reference's numbers
are f32), set for the forward only. The iSTFT runs in numpy on the host,
as the reference's embd_to_audio does. A code past the vocoder's rows
raises on the host before any launch: the reference's gather clamps it to
the last row (ROADMAP §3, fault 26), and a CUDA gather would end the
process on a device-side assert.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..gguf.reader import open_gguf
from ..weights import host_tensor, to_tensor


@dataclasses.dataclass
class WavTokenizer:
    n_embd_features: int
    posnet_embd: int
    posnet_layers: int
    convnext_embd: int
    convnext_layers: int
    n_ff: int
    group_eps: float
    n_groups: int
    ln_eps: float
    tensors: dict = dataclasses.field(default_factory=dict)
    device: torch.device = torch.device("cpu")

    @property
    def n_fft(self) -> int:
        return self.tensors["output.weight"].shape[0] - 2

    @property
    def n_codes(self) -> int:
        """The codebook's rows: the codes decode_codes takes."""
        return self.tensors["token_embd.weight"].shape[0]


def load_wavtokenizer(path: str, device=None) -> WavTokenizer:
    """A wavtokenizer-dec GGUF as f32 tensors on device (CUDA unless the
    caller asks for the CPU); F16 and BF16 tensors cross in their own type
    and widen there."""
    dev = resolve_device(device)
    r = open_gguf(path)
    md = r.metadata
    a = "wavtokenizer-dec"

    def g(k, default=None):
        return md.get(f"{a}.{k}", default)

    return WavTokenizer(
        n_embd_features=int(g("features_length", 512)),
        posnet_embd=int(g("posnet.embedding_length", 768)),
        posnet_layers=int(g("posnet.block_count", 6)),
        convnext_embd=int(g("convnext.embedding_length", 768)),
        convnext_layers=int(g("convnext.block_count", 12)),
        n_ff=int(g("feed_forward_length", 2304)),
        group_eps=float(g("attention.group_norm_epsilon", 1e-6)),
        n_groups=int(g("attention.group_norm_groups", 32)),
        ln_eps=float(g("attention.layer_norm_epsilon", 1e-6)),
        tensors={name: to_tensor(host_tensor(r, name), dev)
                 for name in r.tensors},
        device=dev,
    )


def convert(m, device=None) -> WavTokenizer:
    """A WavTokenizer (either package's: the reference's numpy tensors too)
    with every tensor float32 on device."""
    dev = resolve_device(device)
    fields = {f.name: getattr(m, f.name)
              for f in dataclasses.fields(WavTokenizer)
              if f.name not in ("tensors", "device")}
    return WavTokenizer(**fields, device=dev, tensors={
        k: to_tensor(v, dev) for k, v in m.tensors.items()})


def _conv1d_same(x, w, b):
    """x [C_in, T], w [C_out, C_in, K] (ggml ne (K, C_in, C_out)), 'same'."""
    return F.conv1d(x[None], w, padding=w.shape[-1] // 2)[0] + b[:, None]


def _dw_conv1d_same(x, w, b):
    """Depthwise conv: x [C, T], w [C, 1, K]."""
    return F.conv1d(x[None], w, padding=w.shape[-1] // 2,
                    groups=x.shape[0])[0] + b[:, None]


def _group_norm(x, w, b, groups, eps):
    """x [C, T], per-group over (C/groups, T) (ggml_group_norm)."""
    c, t = x.shape
    xg = x.reshape(groups, c // groups, t)
    mu = xg.mean(dim=(1, 2), keepdim=True)
    var = ((xg - mu) ** 2).mean(dim=(1, 2), keepdim=True)
    y = ((xg - mu) * torch.rsqrt(var + eps)).reshape(c, t)
    return y * w[:, None] + b[:, None]


def _ln(x, w, b, eps):
    """LayerNorm over the last axis."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def _swish(x):
    return x * torch.sigmoid(x)


def _f32_convs():
    """cuDNN's flags as they stand, with TF32 off for the block's
    convolutions."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


def forward(m: WavTokenizer, codes: torch.Tensor) -> torch.Tensor:
    """codes [T] (int64 on m's device) -> spectrum embeddings [T, n_fft+2]
    f32."""
    t = m.tensors
    ge, ng, le = m.group_eps, m.n_groups, m.ln_eps
    cur = t["token_embd.weight"][codes].T               # [C, T]
    cur = _conv1d_same(cur, t["conv1d.weight"], t["conv1d.bias"])
    for il in range(m.posnet_layers):
        p = f"posnet.{il}."
        inp = cur
        if il == 2:                                     # 1x1-conv attention
            h = _group_norm(cur, t[p + "attn_norm.weight"],
                            t[p + "attn_norm.bias"], ng, ge)
            q = _conv1d_same(h, t[p + "attn_q.weight"], t[p + "attn_q.bias"])
            k = _conv1d_same(h, t[p + "attn_k.weight"], t[p + "attn_k.bias"])
            v = _conv1d_same(h, t[p + "attn_v.weight"], t[p + "attn_v.bias"])
            att = torch.softmax(
                (q.T @ k) / np.sqrt(float(m.posnet_embd)), dim=-1)
            h = v @ att.T                               # [C, T]
            h = _conv1d_same(h, t[p + "attn_output.weight"],
                             t[p + "attn_output.bias"])
            cur = h + inp
        elif il == m.posnet_layers - 1:                 # final group norm
            cur = _group_norm(cur, t[p + "norm.weight"], t[p + "norm.bias"],
                              ng, ge)
        else:                                           # resnet block
            h = _swish(_group_norm(cur, t[p + "norm1.weight"],
                                   t[p + "norm1.bias"], ng, ge))
            h = _conv1d_same(h, t[p + "conv1.weight"], t[p + "conv1.bias"])
            h = _swish(_group_norm(h, t[p + "norm2.weight"],
                                   t[p + "norm2.bias"], ng, ge))
            h = _conv1d_same(h, t[p + "conv2.weight"], t[p + "conv2.bias"])
            cur = h + inp
    # token-wise LayerNorm over channels
    cur = _ln(cur.T, t["token_embd_norm.weight"], t["token_embd_norm.bias"],
              le).T
    for il in range(m.convnext_layers):
        p = f"convnext.{il}."
        inp = cur
        h = _dw_conv1d_same(cur, t[p + "dw.weight"], t[p + "dw.bias"])
        h = _ln(h.T, t[p + "norm.weight"], t[p + "norm.bias"], le)  # [T, C]
        h = h @ t[p + "pw1.weight"].T + t[p + "pw1.bias"]
        h = F.gelu(h, approximate="tanh")
        h = h @ t[p + "pw2.weight"].T + t[p + "pw2.bias"]
        h = h * t[p + "gamma"]
        cur = h.T + inp
    out = _ln(cur.T, t["output_norm.weight"], t["output_norm.bias"], le)
    return out @ t["output.weight"].T + t["output.bias"]  # [T, n_fft + 2]


def decode_codes(m: WavTokenizer, codes) -> np.ndarray:
    """codes [T] int -> spectrum embeddings [T, n_fft+2] (f32 numpy). A
    code outside [0, n_codes) raises ValueError before anything runs."""
    codes = np.asarray(codes, np.int64).reshape(-1)
    bad = codes[(codes < 0) | (codes >= m.n_codes)]
    if bad.size:
        raise ValueError(f"audio codes outside the vocoder's {m.n_codes} "
                         f"rows: {bad[:8].tolist()}")
    ids = torch.from_numpy(codes).to(m.device)
    with torch.no_grad(), _f32_convs():
        return forward(m, ids).cpu().numpy()


def embd_to_audio(embd: np.ndarray, n_fft: int = 1280,
                  n_hop: int = 320) -> np.ndarray:
    """[T, n_fft+2] (log-mag ; phase) -> waveform (tts.cpp embd_to_audio:
    hann-windowed iSTFT with overlap-add fold and envelope division), in
    numpy on the host as the reference runs it."""
    n_codes, n_embd = embd.shape
    half = n_embd // 2
    n_win = n_fft
    n_pad = (n_win - n_hop) // 2
    n_out = (n_codes - 1) * n_hop + n_win
    mag = np.minimum(np.exp(embd[:, :half]), 1e2)
    phi = embd[:, half:]
    spec = mag * np.cos(phi) + 1j * mag * np.sin(phi)   # [T, half]
    frames = np.fft.irfft(spec, n=n_fft, axis=1)        # [T, n_fft]
    hann = 0.5 * (1 - np.cos(2 * np.pi * np.arange(n_fft) / n_fft))
    res = frames * hann
    env_f = np.broadcast_to(hann * hann, frames.shape)
    audio = np.zeros(n_out)
    env = np.zeros(n_out)
    for l in range(n_codes):
        audio[l * n_hop: l * n_hop + n_win] += res[l]
        env[l * n_hop: l * n_hop + n_win] += env_f[l]
    audio = audio[n_pad: n_out - n_pad]
    env = np.maximum(env[n_pad: n_out - n_pad], 1e-12)
    return (audio / env).astype(np.float32)


def write_wav(path: str, audio: np.ndarray, rate: int = 24000) -> None:
    """16-bit mono WAV (tts.cpp save_wav16): clipped to +-1, x 32767,
    truncated."""
    import wave

    pcm = np.clip(audio, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(rate)
        f.writeframes(pcm.tobytes())
