"""Qwen2-VL vision tower and merger (clip.cpp's qwen2vl branches), and the
text model's M-RoPE position helpers.

Counterpart of llama_cpp_test_tpu/models/qwen2vl_vision.py, plain torch
on an explicit device, in float32 as the reference computes it (TF32
left off), or float64 through Qwen2VLVision.to(dtype=).

Structure (HF Qwen2VisionTransformerPretrainedModel):
  patch_embed  Conv3d(3, embed, k=(2, 14, 14)) == a bias-free linear on
               the processor's flattened [N, 3*2*14*14] patches
  blocks       pre-LN ViT blocks: x += attn(ln1(x)); x += mlp(ln2(x));
               biased q/k/v, full (bidirectional) attention over the
               image's patches, 2D vision rope (the first D/4 frequencies
               turn with the patch's row, the next D/4 with its column;
               half-split layout)
  merger       ln_q, then each 2x2 merge group's four embeddings
               concatenated -> mm.0 -> GELU (erf) -> mm.2 -> text width

The patch sequence is in the processor's merged-group order (row group,
then column group, then the 2x2 patches inside one); vision_patch_hw
gives each patch's (row, column) as HF's rot_pos_emb does.

On-disk names follow llama.cpp's qwen2_vl_surgery.py, so its mmproj
files load: v.patch_embd.weight and .weight.1 (the two temporal conv
frames), v.blk.N.{ln1,ln2,attn_q/k/v,attn_out}, and the SWAPPED MLP
names: "ffn_down" is fc1 (the up projection) and "ffn_up" fc2 (the down
projection). Merger: v.post_ln (HF's ln_q), mm.0, mm.2.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..gguf.reader import open_gguf
from .clip import _MEAN, _STD, _tensor


@dataclasses.dataclass
class Qwen2VLVisionLayer:
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
    fc1_w: Any   # on-disk "ffn_down" (the surgery script's names)
    fc1_b: Any
    fc2_w: Any   # on-disk "ffn_up"
    fc2_b: Any


_TOP = ("patch_w", "post_ln_w", "post_ln_b", "mm0_w", "mm0_b", "mm2_w",
        "mm2_b")


@dataclasses.dataclass
class Qwen2VLVision:
    embed: int
    n_head: int
    n_layer: int
    out_dim: int          # the text model's width (projection_dim)
    patch_size: int
    merge_size: int
    temporal: int
    eps: float
    act: str              # quick_gelu | gelu | silu
    patch_w: Any          # [embed, 3*temporal*P*P] (the conv3d as a linear)
    post_ln_w: Any
    post_ln_b: Any
    mm0_w: Any
    mm0_b: Any
    mm2_w: Any
    mm2_b: Any
    image_mean: np.ndarray
    image_std: np.ndarray
    layers: list = dataclasses.field(default_factory=list)

    @property
    def head_dim(self) -> int:
        return self.embed // self.n_head

    @property
    def device(self) -> torch.device:
        return self.patch_w.device

    @property
    def dtype(self) -> torch.dtype:
        return self.patch_w.dtype

    def to(self, device=None, dtype=None) -> "Qwen2VLVision":
        """A copy with every weight on `device` and in `dtype`."""
        return convert(self, device or self.device, dtype)


def convert(m, device, dtype=None) -> Qwen2VLVision:
    """A Qwen2VLVision from any object with its fields (the reference's
    loaded tower too), every weight a float tensor on device (float32
    unless dtype says otherwise)."""
    conv = lambda a: _tensor(a, device, dtype)
    out = {f.name: getattr(m, f.name) for f in dataclasses.fields(
        Qwen2VLVision) if f.name != "layers"}
    out.update({k: conv(out[k]) for k in _TOP})
    out["image_mean"] = np.asarray(out["image_mean"], np.float32)
    out["image_std"] = np.asarray(out["image_std"], np.float32)
    out["layers"] = [Qwen2VLVisionLayer(**{
        f.name: conv(getattr(ly, f.name))
        for f in dataclasses.fields(Qwen2VLVisionLayer)}) for ly in m.layers]
    return Qwen2VLVision(**out)


def load_qwen2vl_vision(path: str, device=None) -> Qwen2VLVision:
    """Load a qwen2vl mmproj GGUF (the surgery script's names) onto device
    (CUDA unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    r = open_gguf(path)
    md = r.metadata
    if not md.get("clip.has_qwen2vl_merger"):
        raise ValueError("not a qwen2vl mmproj (clip.has_qwen2vl_merger "
                         "missing): use models.clip.load_clip")

    def key(name, default=None):
        return md.get(f"clip.vision.{name}", default)

    def t(name):
        if name not in r.tensors:
            raise KeyError(f"qwen2vl mmproj missing tensor {name}")
        info = r.tensors[name]
        return r.dequantize(name, np.float32).reshape(
            tuple(reversed(info.shape)))

    embed = int(key("embedding_length"))
    patch = int(key("patch_size"))
    n_layer = int(key("block_count"))
    # the surgery writes the Conv3d as two per-frame conv2d tensors;
    # rebuild the [embed, 3, T, P, P] linear in the processor's
    # (C, T, ph, pw) flatten order
    frames = [t(name).reshape(embed, 3, patch, patch)
              for name in ("v.patch_embd.weight", "v.patch_embd.weight.1")]
    act = ("silu" if md.get("clip.use_silu") else
           "gelu" if md.get("clip.use_gelu") else "quick_gelu")
    m = Qwen2VLVision(
        embed=embed,
        n_head=int(key("attention.head_count")),
        n_layer=n_layer,
        out_dim=int(key("projection_dim")),
        patch_size=patch, merge_size=2, temporal=2,
        eps=float(key("attention.layer_norm_epsilon", 1e-6)),
        act=act,
        patch_w=np.stack(frames, axis=2).reshape(embed, -1),
        post_ln_w=t("v.post_ln.weight"), post_ln_b=t("v.post_ln.bias"),
        mm0_w=t("mm.0.weight"), mm0_b=t("mm.0.bias"),
        mm2_w=t("mm.2.weight"), mm2_b=t("mm.2.bias"),
        image_mean=np.asarray(key("image_mean", _MEAN), np.float32),
        image_std=np.asarray(key("image_std", _STD), np.float32))
    for i in range(n_layer):
        p = f"v.blk.{i}."
        m.layers.append(Qwen2VLVisionLayer(
            ln1_w=t(p + "ln1.weight"), ln1_b=t(p + "ln1.bias"),
            wq=t(p + "attn_q.weight"), bq=t(p + "attn_q.bias"),
            wk=t(p + "attn_k.weight"), bk=t(p + "attn_k.bias"),
            wv=t(p + "attn_v.weight"), bv=t(p + "attn_v.bias"),
            wo=t(p + "attn_out.weight"), bo=t(p + "attn_out.bias"),
            ln2_w=t(p + "ln2.weight"), ln2_b=t(p + "ln2.bias"),
            fc1_w=t(p + "ffn_down.weight"), fc1_b=t(p + "ffn_down.bias"),
            fc2_w=t(p + "ffn_up.weight"), fc2_b=t(p + "ffn_up.bias")))
    return convert(m, dev)


def vision_patch_hw(grid_h: int, grid_w: int,
                    merge: int = 2) -> tuple[np.ndarray, np.ndarray]:
    """Each patch's (row, column) in the processor's merged-group sequence
    order (HF Qwen2VisionTransformer.rot_pos_emb)."""
    h = np.arange(grid_h)[:, None] + np.zeros((1, grid_w), np.int64)
    w = np.arange(grid_w)[None, :] + np.zeros((grid_h, 1), np.int64)

    def grp(a):
        return (a.reshape(grid_h // merge, merge, grid_w // merge, merge)
                 .transpose(0, 2, 1, 3).reshape(-1))

    return grp(h), grp(w)


def _act(x, kind):
    if kind == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if kind == "silu":
        return torch.nn.functional.silu(x)
    return torch.nn.functional.gelu(x)


def _ln(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def encode_image(m: Qwen2VLVision, patches, grid_h: int,
                 grid_w: int) -> torch.Tensor:
    """Flattened patches [N, 3*T*P*P] (numpy or tensor, processor order)
    -> the merged image embeddings [grid_h*grid_w/4, out_dim] on m's
    device and in its dtype."""
    dev, dt = m.device, m.dtype
    if not isinstance(patches, torch.Tensor):
        patches = torch.from_numpy(np.asarray(patches, np.float32))
    hp, wp = vision_patch_hw(grid_h, grid_w, m.merge_size)
    d, nh, eps = m.head_dim, m.n_head, m.eps
    with torch.inference_mode():
        x = patches.to(dev, dt) @ m.patch_w.T                 # [N, embed]
        n = x.shape[0]
        # 2D vision rope: theta = [row * f | column * f], f = 1e4^(-4i/D)
        inv = 10000.0 ** (-torch.arange(d // 4, dtype=dt, device=dev)
                          * 4.0 / d)
        pos = lambda a: torch.from_numpy(a).to(dev, dt)[:, None] * inv
        theta = torch.cat([pos(hp), pos(wp)], dim=-1)
        cos, sin = torch.cos(theta)[:, None], torch.sin(theta)[:, None]

        def rope(v):                                          # [N, H, D]
            v1, v2 = v[..., :d // 2], v[..., d // 2:]
            return torch.cat([v1 * cos - v2 * sin, v2 * cos + v1 * sin], -1)

        scale = 1.0 / np.sqrt(d)
        for ly in m.layers:
            h = _ln(x, ly.ln1_w, ly.ln1_b, eps)
            q = rope((h @ ly.wq.T + ly.bq).reshape(n, nh, d))
            k = rope((h @ ly.wk.T + ly.bk).reshape(n, nh, d))
            v = (h @ ly.wv.T + ly.bv).reshape(n, nh, d)
            att = torch.softmax(torch.einsum("qhd,khd->hqk", q, k) * scale,
                                dim=-1)
            o = torch.einsum("hqk,khd->qhd", att, v).reshape(n, m.embed)
            x = x + (o @ ly.wo.T + ly.bo)
            h = _ln(x, ly.ln2_w, ly.ln2_b, eps)
            x = x + (_act(h @ ly.fc1_w.T + ly.fc1_b, m.act) @ ly.fc2_w.T
                     + ly.fc2_b)
        # merger: ln_q, then each 2x2 group concatenated -> mm.0 -> GELU
        # (erf) -> mm.2
        g = m.merge_size * m.merge_size
        y = _ln(x, m.post_ln_w, m.post_ln_b, eps).reshape(n // g, g * m.embed)
        y = torch.nn.functional.gelu(y @ m.mm0_w.T + m.mm0_b)
        return y @ m.mm2_w.T + m.mm2_b


def mrope_image_positions(t0: int, grid_h: int, grid_w: int,
                          merge: int = 2) -> np.ndarray:
    """The text model's M-RoPE streams [(grid_h*grid_w)/merge^2, 3] for
    one image's merged tokens from text position t0: t stays t0, h and w
    walk the merged grid row-major (HF get_rope_index; qwen2vl-cli.cpp)."""
    gh, gw = grid_h // merge, grid_w // merge
    h = np.repeat(np.arange(gh), gw)
    w = np.tile(np.arange(gw), gh)
    out = np.stack([np.full(gh * gw, 0), h, w], axis=1).astype(np.int32)
    return out + t0


def mrope_delta_after_image(t0: int, grid_h: int, grid_w: int,
                            merge: int = 2) -> int:
    """The next text rope position after the image, t0 + max(merged grid)
    (callers derive pos_offset = next - n_cached)."""
    return t0 + max(grid_h // merge, grid_w // merge)


def smart_resize(height: int, width: int, factor: int = 28,
                 min_pixels: int = 56 * 56,
                 max_pixels: int = 14 * 14 * 4 * 1280) -> tuple[int, int]:
    """HF Qwen2VLImageProcessor.smart_resize: each side rounded to the
    patch*merge factor, the pixel count kept within its bounds."""
    if max(height, width) / min(height, width) > 200:
        raise ValueError("absolute aspect ratio must be < 200")
    h_bar = max(factor, round(height / factor) * factor)
    w_bar = max(factor, round(width / factor) * factor)
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = math.floor(height / beta / factor) * factor
        w_bar = math.floor(width / beta / factor) * factor
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def preprocess_image(m: Qwen2VLVision, img) -> tuple[np.ndarray, int, int]:
    """A PIL image -> (flattened patches [N, 3*T*P*P] float32, grid_h,
    grid_w) in the HF processor's merged-group order."""
    import PIL.Image

    if not isinstance(img, PIL.Image.Image):
        raise TypeError("preprocess_image expects a PIL image")
    img = img.convert("RGB")
    p, mg = m.patch_size, m.merge_size
    h, w = smart_resize(img.height, img.width, factor=p * mg)
    img = img.resize((w, h), PIL.Image.BICUBIC)
    a = np.asarray(img, np.float32) / 255.0              # [H, W, 3]
    a = ((a - m.image_mean) / m.image_std).transpose(2, 0, 1)
    frames = np.stack([a] * m.temporal)                  # [T, 3, H, W]
    gh, gw = h // p, w // p
    pt = frames.reshape(m.temporal, 3, gh // mg, mg, p, gw // mg, mg, p)
    # (row group, column group, mh, mw, C, T, ph, pw), then flattened
    pt = pt.transpose(2, 5, 3, 6, 1, 0, 4, 7)
    return pt.reshape(gh * gw, 3 * m.temporal * p * p), gh, gw
