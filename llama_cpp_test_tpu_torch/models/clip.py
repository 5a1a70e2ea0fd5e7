"""CLIP vision encoder and its projectors (the clip.cpp analogue).

Counterpart of llama_cpp_test_tpu/models/clip.py. Loads the mmproj GGUF
the llava converters write (`clip.vision.*` metadata, `v.blk.N.*`
tensors, the `mm.*` projector, `resampler.*`) and runs the ViT as plain
torch on an explicit device, in float32 as the reference does (TF32 left
off, torch's default), or in float64 through ClipModel.to(dtype=): the
encoder is a few hundred GFLOP an image, dense matmuls the JAX package
leaves to XLA, so no kernel of the port's runs here.

Forward (llava's legacy graph, clip_image_build_graph_legacy):
  non-overlapping patch conv (== unfold + matmul) -> [class_embd] + pos_embd
  -> pre-LN -> N x (LN1 -> biased MHA -> res -> LN2 -> GELU MLP -> res)
  -> drop CLS -> projector -> [n_patches, C_llm]

Projectors: llava's MLP (mm.0 -> tanh GELU -> mm.2); gemma3's (average
pool of the patch grid by projector.scale_factor, RMS norm, one
projection); MiniCPM-V's perceiver resampler (learned queries
cross-attending the kv-projected features, keys carrying a 2D sincos
table).

Preprocessing mirrors clip_image_preprocess's llava-1.5 "pad" mode:
pad-to-square with the mean colour, bicubic resize to image_size,
normalize by clip.vision.image_mean/std. PIL is imported there only.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..gguf.reader import open_gguf

# the reference's default normalization (OpenAI CLIP's)
_MEAN = [0.48145466, 0.4578275, 0.40821073]
_STD = [0.26862954, 0.26130258, 0.27577711]


@dataclasses.dataclass
class ClipLayer:
    ln1_w: Any
    ln1_b: Any
    wq: Any
    bq: Any
    wk: Any
    bk: Any
    wv: Any
    bv: Any
    wo: Any
    bo: Any
    ln2_w: Any
    ln2_b: Any
    ffn_up_w: Any
    ffn_up_b: Any
    ffn_down_w: Any
    ffn_down_b: Any


@dataclasses.dataclass
class ClipModel:
    """Hyperparameters and weights (tensors on one device and dtype)."""
    image_size: int
    patch_size: int
    hidden: int
    n_head: int
    n_layer: int
    n_ff: int
    eps: float
    use_gelu: bool
    image_mean: np.ndarray
    image_std: np.ndarray
    proj_type: str
    patch_w: Any           # [hidden, 3*P*P]
    patch_b: Any
    class_embd: Any
    pos_embd: Any          # [n_pos, hidden]
    pre_ln_w: Any
    pre_ln_b: Any
    post_ln_w: Any
    post_ln_b: Any
    layers: list = dataclasses.field(default_factory=list)
    # llava MLP projector
    mm0_w: Any = None
    mm0_b: Any = None
    mm2_w: Any = None
    mm2_b: Any = None
    # gemma3 projector (mm.input_projection, mm.soft_emb_norm) and its
    # pooling factor (projector.scale_factor)
    mm_input_proj: Any = None
    mm_soft_emb_norm: Any = None
    proj_scale: int = 4
    # MiniCPM-V resampler: dict of the resampler.* tensors, or None
    resampler: Any = None

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def device(self) -> torch.device:
        return self.patch_w.device

    @property
    def dtype(self) -> torch.dtype:
        return self.patch_w.dtype

    def to(self, device=None, dtype=None) -> "ClipModel":
        """A copy with every weight on `device` and in `dtype` (float64
        for a reference run)."""
        return convert(self, device or self.device, dtype)


def _tensor(a, device, dtype=None) -> torch.Tensor | None:
    """A weight (numpy or tensor) as a float tensor on device."""
    if a is None:
        return None
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.array(a, np.float32, copy=True))
    return t.to(device=device, dtype=dtype or torch.float32)


def convert(m, device, dtype=None) -> ClipModel:
    """A ClipModel from any object with its fields (the reference's loaded
    model too), every weight a float tensor on device (float32 unless
    dtype says otherwise): the layers, the projectors and the resampler's
    dict included."""
    conv = lambda a: _tensor(a, device, dtype)
    weights = ("patch_w", "patch_b", "class_embd", "pos_embd", "pre_ln_w",
               "pre_ln_b", "post_ln_w", "post_ln_b", "mm0_w", "mm0_b",
               "mm2_w", "mm2_b", "mm_input_proj", "mm_soft_emb_norm")
    out = {}
    for f in dataclasses.fields(ClipModel):
        v = getattr(m, f.name)
        if f.name in weights:
            v = conv(v)
        elif f.name == "layers":
            v = [ClipLayer(**{g.name: conv(getattr(lw, g.name))
                              for g in dataclasses.fields(ClipLayer)})
                 for lw in v]
        elif f.name == "resampler" and v is not None:
            v = {k: conv(a) for k, a in v.items()}
        elif f.name in ("image_mean", "image_std"):
            v = np.asarray(v, np.float32)
        out[f.name] = v
    return ClipModel(**out)


def load_clip(path: str, device=None) -> ClipModel:
    """Load an mmproj GGUF (clip.cpp key and tensor naming) onto device
    (CUDA unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    r = open_gguf(path)
    md = r.metadata

    def key(name, default=None):
        return md.get(f"clip.vision.{name}", default)

    def t(name, required=True):
        if name not in r.tensors:
            if required:
                raise KeyError(f"mmproj missing tensor {name}")
            return None
        info = r.tensors[name]
        a = r.dequantize(name, np.float32)
        return a.reshape(tuple(reversed(info.shape))) if len(info.shape) > 1 \
            else a.reshape(-1)

    n_layer = int(key("block_count"))
    hidden = int(key("embedding_length"))
    patch = int(key("patch_size"))
    m = ClipModel(
        image_size=int(key("image_size")),
        patch_size=patch,
        hidden=hidden,
        n_head=int(key("attention.head_count")),
        n_layer=n_layer,
        n_ff=int(key("feed_forward_length")),
        eps=float(key("attention.layer_norm_epsilon", 1e-5)),
        use_gelu=bool(md.get("clip.use_gelu", True)),
        image_mean=np.asarray(key("image_mean", _MEAN), np.float32),
        image_std=np.asarray(key("image_std", _STD), np.float32),
        proj_type=str(md.get("clip.projector_type", "mlp")),
        # ggml conv2d weight ne = (P, P, 3, hidden) -> [hidden, 3*P*P]
        patch_w=t("v.patch_embd.weight").reshape(hidden, 3 * patch * patch),
        patch_b=t("v.patch_embd.bias", False),
        class_embd=t("v.class_embd", False),
        pos_embd=t("v.position_embd.weight"),
        pre_ln_w=t("v.pre_ln.weight", False),
        pre_ln_b=t("v.pre_ln.bias", False),
        post_ln_w=t("v.post_ln.weight", False),
        post_ln_b=t("v.post_ln.bias", False),
    )
    for i in range(n_layer):
        p = f"v.blk.{i}."
        m.layers.append(ClipLayer(
            ln1_w=t(p + "ln1.weight"), ln1_b=t(p + "ln1.bias"),
            wq=t(p + "attn_q.weight"), bq=t(p + "attn_q.bias"),
            wk=t(p + "attn_k.weight"), bk=t(p + "attn_k.bias"),
            wv=t(p + "attn_v.weight"), bv=t(p + "attn_v.bias"),
            wo=t(p + "attn_out.weight"), bo=t(p + "attn_out.bias"),
            ln2_w=t(p + "ln2.weight"), ln2_b=t(p + "ln2.bias"),
            ffn_up_w=t(p + "ffn_up.weight"), ffn_up_b=t(p + "ffn_up.bias"),
            ffn_down_w=t(p + "ffn_down.weight"),
            ffn_down_b=t(p + "ffn_down.bias")))
    m.mm0_w, m.mm0_b = t("mm.0.weight", False), t("mm.0.bias", False)
    m.mm2_w, m.mm2_b = t("mm.2.weight", False), t("mm.2.bias", False)
    m.mm_input_proj = t("mm.input_projection.weight", False)
    m.mm_soft_emb_norm = t("mm.soft_emb_norm.weight", False)
    m.proj_scale = int(key("projector.scale_factor", 4))
    if md.get("clip.has_minicpmv_projector") or m.proj_type == "resampler":
        # the perceiver resampler's tensors (clip.cpp:1828-1846)
        m.resampler = {short: t(f"resampler.{name}") for short, name in (
            ("query", "query"), ("proj", "proj.weight"),
            ("kv_proj", "kv.weight"), ("q_w", "attn.q.weight"),
            ("k_w", "attn.k.weight"), ("v_w", "attn.v.weight"),
            ("q_b", "attn.q.bias"), ("k_b", "attn.k.bias"),
            ("v_b", "attn.v.bias"), ("o_w", "attn.out.weight"),
            ("o_b", "attn.out.bias"), ("ln_q_w", "ln_q.weight"),
            ("ln_q_b", "ln_q.bias"), ("ln_kv_w", "ln_kv.weight"),
            ("ln_kv_b", "ln_kv.bias"), ("ln_post_w", "ln_post.weight"),
            ("ln_post_b", "ln_post.bias"))}
    return convert(m, dev)


def sincos_pos_embed_2d(dim: int, side: int) -> np.ndarray:
    """The resampler's 2D sincos key table [side*side, dim], as clip.cpp's
    get_2d_sincos_pos_embed flattens it (column-major): at row-major index
    i the first half encodes i % side, the second half i // side."""
    if dim % 4:
        raise ValueError(f"sincos table width {dim} is no multiple of 4")
    quarter = dim // 4
    omega = 1.0 / (10000.0 ** (np.arange(quarter) / quarter))
    pos = np.arange(side, dtype=np.float32)
    first = np.tile(pos, side)[:, None] * omega[None]
    second = np.repeat(pos, side)[:, None] * omega[None]
    return np.concatenate(
        [np.sin(first), np.cos(first), np.sin(second), np.cos(second)],
        axis=1).astype(np.float32)


def _ln(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps) * w
    return y if b is None else y + b


def _linear(x, w, b=None):
    y = x @ w.T
    return y if b is None else y + b


def _gelu(x):
    return torch.nn.functional.gelu(x, approximate="tanh")


def _mha(q, k, v, n_head: int):
    """Full (bidirectional) attention; q [B, Tq, C] already scaled, k and
    v [B, Tk, C]; the heads split C."""
    b, tq, c = q.shape
    d = c // n_head
    split = lambda y: y.reshape(y.shape[0], y.shape[1], n_head, d) \
        .transpose(1, 2)
    att = torch.softmax(split(q) @ split(k).transpose(-1, -2), dim=-1)
    return (att @ split(v)).transpose(1, 2).reshape(b, tq, c)


def clip_forward(m: ClipModel, pixels: torch.Tensor) -> torch.Tensor:
    """pixels [B, 3, S, S] normalized -> features [B, n_patches (+1 CLS),
    hidden] after the encoder (before any projector)."""
    b, c, s, _ = pixels.shape
    p = m.patch_size
    side = s // p
    # unfold: the non-overlapping conv is a matmul over patches flattened
    # in (channel, py, px) order, as ggml_conv_2d + reshape
    x = pixels.reshape(b, c, side, p, side, p).permute(0, 2, 4, 1, 3, 5) \
        .reshape(b, side * side, c * p * p)
    x = _linear(x, m.patch_w, m.patch_b)
    if m.class_embd is not None:
        x = torch.cat([m.class_embd.expand(b, 1, m.hidden), x], dim=1)
    x = x + m.pos_embd[None, : x.shape[1]]
    if m.pre_ln_w is not None:
        x = _ln(x, m.pre_ln_w, m.pre_ln_b, m.eps)
    scale = 1.0 / np.sqrt(m.hidden // m.n_head)
    for lw in m.layers:
        cur = _ln(x, lw.ln1_w, lw.ln1_b, m.eps)
        q = _linear(cur, lw.wq, lw.bq) * scale
        k = _linear(cur, lw.wk, lw.bk)
        v = _linear(cur, lw.wv, lw.bv)
        x = x + _linear(_mha(q, k, v, m.n_head), lw.wo, lw.bo)
        cur = _ln(x, lw.ln2_w, lw.ln2_b, m.eps)
        cur = _linear(cur, lw.ffn_up_w, lw.ffn_up_b)
        cur = _gelu(cur) if m.use_gelu else torch.nn.functional.silu(cur)
        x = x + _linear(cur, lw.ffn_down_w, lw.ffn_down_b)
    return x


def _resample(m: ClipModel, x: torch.Tensor) -> torch.Tensor:
    """The perceiver resampler (clip.cpp:1243-1308) on features x
    [B, N, hidden]: LN'd learned queries attend the kv-projected, LN'd
    features, whose keys carry the 2D sincos table; 128-wide heads; output
    LN and the final projection."""
    rs, eps = m.resampler, m.eps
    side = int(round(x.shape[1] ** 0.5))
    hr = rs["kv_proj"].shape[0]
    pe = torch.from_numpy(sincos_pos_embed_2d(hr, side)).to(x.device, x.dtype)
    q = _ln(rs["query"], rs["ln_q_w"], rs["ln_q_b"], eps)     # [Q, Hr]
    v = _ln(_linear(x, rs["kv_proj"]), rs["ln_kv_w"], rs["ln_kv_b"], eps)
    k = v + pe[None]
    d_head = 128
    qp = _linear(q, rs["q_w"], rs["q_b"]) * (1.0 / np.sqrt(d_head))
    out = _mha(qp[None].expand(x.shape[0], -1, -1),
               _linear(k, rs["k_w"], rs["k_b"]),
               _linear(v, rs["v_w"], rs["v_b"]), hr // d_head)
    out = _ln(_linear(out, rs["o_w"], rs["o_b"]), rs["ln_post_w"],
              rs["ln_post_b"], eps)
    return _linear(out, rs["proj"])


def _gemma3_project(m: ClipModel, x: torch.Tensor) -> torch.Tensor:
    """gemma3's projector (clip.cpp build_gemma3): the patch grid average
    pooled by proj_scale, RMS-normed, projected to the text width."""
    if m.mm_soft_emb_norm is None:
        raise ValueError("gemma3 mmproj: mm.soft_emb_norm.weight missing "
                         "alongside mm.input_projection")
    b, n, hdim = x.shape
    side = int(round(n ** 0.5))
    kp = m.proj_scale
    if side * side != n or side % kp:
        raise ValueError(f"gemma3 projector: patch grid {n} (side {side}) "
                         f"is not divisible by scale_factor {kp}")
    g = x.reshape(b, side // kp, kp, side // kp, kp, hdim)
    pooled = g.mean(dim=(2, 4)).reshape(b, -1, hdim)
    rms = torch.rsqrt((pooled * pooled).mean(-1, keepdim=True) + m.eps)
    return _linear(pooled * rms * m.mm_soft_emb_norm, m.mm_input_proj)


def encode_image(m: ClipModel, pixels) -> torch.Tensor:
    """[3, S, S] or [B, 3, S, S] normalized pixels (numpy or tensor) ->
    the projected embeddings [B*tokens, C_llm] on m's device and in its
    dtype, ready for Context.prefill_embeds."""
    if not isinstance(pixels, torch.Tensor):
        pixels = torch.from_numpy(np.asarray(pixels, np.float32))
    pixels = pixels.to(m.device, m.dtype)
    if pixels.ndim == 3:
        pixels = pixels[None]
    with torch.inference_mode():
        x = clip_forward(m, pixels)
        if m.class_embd is not None:
            x = x[:, 1:]                      # drop CLS for the projector
        if m.resampler is not None:
            x = _resample(m, x)
        elif m.proj_type == "gemma3" and m.mm_input_proj is not None:
            x = _gemma3_project(m, x)
        elif m.mm0_w is not None:             # llava MLP projector
            x = _linear(_gelu(_linear(x, m.mm0_w, m.mm0_b)), m.mm2_w,
                        m.mm2_b)
        return x.reshape(-1, x.shape[-1])


def preprocess_image(m: ClipModel, img) -> np.ndarray:
    """A PIL image or [H, W, 3] uint8 array -> [3, S, S] normalized
    float32 (llava-1.5 pad-to-square + bicubic resize,
    clip_image_preprocess)."""
    from PIL import Image

    if isinstance(img, np.ndarray):
        img = Image.fromarray(img)
    img = img.convert("RGB")
    w, h = img.size
    if w != h:
        side = max(w, h)
        bg = tuple(int(round(255 * x)) for x in m.image_mean)
        sq = Image.new("RGB", (side, side), bg)
        sq.paste(img, ((side - w) // 2, (side - h) // 2))
        img = sq
    img = img.resize((m.image_size, m.image_size), Image.BICUBIC)
    a = np.asarray(img, np.float32) / 255.0            # [S, S, 3]
    a = (a - m.image_mean) / m.image_std
    return a.transpose(2, 0, 1)                        # [3, S, S]
