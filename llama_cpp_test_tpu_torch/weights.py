"""Host planes -> device tensors (counterpart of the reference's
models/llama.device_put_weights), and the reference's loaded parameters
carried across as host planes.

The dense families' loaders (mamba, the rwkv families, T5, the vocoder)
read a GGUF tensor to the host with host_tensor and move it as float32
with to_tensor, or a whole dataclass of arrays with convert_fields.

to_device takes LlamaWeights whose QTensor planes and norm vectors are
numpy arrays: the port's own loader output, or port_weights_from_reference
of the reference's parameters (every LayerWeights field by name: the
biases, QK norms and sandwich norms of the gemma and qwen archs, the
LayerNorm biases, falcon-40B's second norm, the projection and gate
biases, bitnet's sub-norms, chameleon's QK-norm biases and the encoders'
post-norms, the shared experts and their gate, the selection bias,
arctic's MoE-branch norm and the MLA planes and norms too; every
LlamaWeights field likewise: the sliding-window and
long-rope tables, the final norm's and lm head's biases, the learned
position rows, the token-type rows, the embedding LayerNorm and
cohere2's nope_global flag; the per-layer geometry rides the HParams and
the planes' own shapes). bf16 bit patterns (uint16) become
torch.bfloat16, int8/uint8 planes keep their type, float arrays become
float32. Expert stacks (a leading E axis on every plane) move the same
way; a reference that fused gate|up expert stacks into one plane (its
LLAMA_TPU_MOE_FUSE load) has them split back into the separate stacks
the port's loader makes.
Attached adapters move too: each LoRA pair (A, B, scale) as float32
tensors holding A and B rounded to bf16, a control vector as float32.

The vision towers' parameters cross the same way
(port_clip_from_reference, port_qwen2vl_vision_from_reference): the
reference's loaded float arrays as the port's models on a device; so do
the recurrent families' (port_mamba_from_reference,
port_rwkv6_from_reference, port_rwkv7_from_reference), T5's
(port_t5_from_reference) and the vocoder's
(port_wavtokenizer_from_reference).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .gguf.constants import GGMLType
from .models.llama import LayerWeights, LlamaWeights
from .quant.repack import QTensor


def to_tensor(a, device) -> torch.Tensor | None:
    """A float array (numpy or tensor) as a float32 tensor on device. A
    half-precision tensor moves in its own type and widens there (exact),
    so a file's F16 weights cross to the card at half the bytes."""
    if a is None:
        return None
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.array(a, np.float32, copy=True))
    return t.to(device=device).to(dtype=torch.float32)


def convert_fields(obj, cls, device):
    """An instance of dataclass cls from any object with its fields (the
    reference's loaded numpy arrays too), every array field a float32
    tensor on device; a `layers` field is passed as it is."""
    out = {}
    for f in dataclasses.fields(cls):
        v = getattr(obj, f.name)
        out[f.name] = v if f.name == "layers" else to_tensor(v, device)
    return cls(**out)


_RAW = {GGMLType.F32: torch.float32, GGMLType.F16: torch.float16,
        GGMLType.BF16: torch.bfloat16}


def host_tensor(r, name: str):
    """A GGUF tensor on the host in numpy's row-major order (ggml lists the
    fastest axis first, so the shape reverses): an F32, F16 or BF16 tensor
    as a torch tensor of its own type (to_tensor widens it to f32, exact),
    any other type dequantized to f32 numpy."""
    info = r.tensors[name]
    dtype = _RAW.get(info.ggml_type)
    if dtype is None:
        return r.dequantize(name, np.float32)
    raw = torch.from_numpy(np.array(r.tensor_bytes(name)))  # off the mmap
    return raw.view(dtype).reshape(tuple(reversed(info.shape)))


def array_to_torch(a, device: torch.device | str) -> torch.Tensor | None:
    if a is None:
        return None
    a = np.array(a, copy=True, order="C")   # owned + writable for from_numpy
    if a.dtype == np.uint16:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    elif a.dtype in (np.int8, np.uint8):
        t = torch.from_numpy(a)
    else:
        t = torch.from_numpy(a.astype(np.float32))
    return t.to(device)


def qtensor_to_torch(qt: QTensor, device: torch.device | str) -> QTensor:
    conv = lambda a: array_to_torch(a, device)
    return dataclasses.replace(qt, qs=conv(qt.qs), scale=conv(qt.scale),
                               min_=conv(qt.min_), lut=conv(qt.lut))


def host_array(a):
    """A reference plane as numpy; 2-byte non-numeric planes (bf16) as their
    uint16 bit patterns, so no bf16 numpy type is needed here."""
    if a is None:
        return None
    a = np.asarray(a)
    if a.dtype.itemsize == 2 and a.dtype.kind not in "iuf":
        return a.view(np.uint16)
    return a


def port_qtensor(jqt) -> QTensor:
    """A reference QTensor (read by attribute) as a host-plane QTensor."""
    return QTensor(jqt.kind, tuple(jqt.shape), jqt.n_orig, jqt.group,
                   host_array(jqt.qs), host_array(jqt.scale),
                   host_array(jqt.min_), host_array(jqt.lut), None,
                   jqt.layout, jqt.parts)


def lora_to_torch(pair, device: torch.device | str) -> tuple:
    """A LoRA pair (A, B, scale) on device: A and B (float arrays, or bf16
    bit patterns as uint16) rounded to bf16 and widened back to float32,
    the operands models.llama.lora_delta takes."""
    a, b, scale = pair
    conv = lambda x: (x if isinstance(x, torch.Tensor) else array_to_torch(
        x, device)).to(device, torch.bfloat16).float()
    return conv(a), conv(b), float(scale)


def _top_fields(w, conv, layers) -> LlamaWeights:
    """A LlamaWeights with conv applied to every plane and vector field of
    w (any object with its attributes), `layers` as its layers; the rope
    magnitude and nope_global carried as they are."""
    keep = ("rope_mscale", "nope_global")
    out = {f.name: (getattr(w, f.name) if f.name in keep
                    else conv(getattr(w, f.name)))
           for f in dataclasses.fields(LlamaWeights) if f.name != "layers"}
    return LlamaWeights(layers=layers, **out)


def _layer_fields(lw, conv, conv_lora) -> LayerWeights:
    """A LayerWeights with conv applied to every plane and norm field,
    conv_lora to each LoRA pair; the control vector goes through conv."""
    out = {f.name: conv(getattr(lw, f.name))
           for f in dataclasses.fields(LayerWeights) if f.name != "lora"}
    out["lora"] = {k: conv_lora(v) for k, v in
                   (lw.lora or {}).items()}
    return LayerWeights(**out)


def split_expert_stacks(qt: QTensor) -> tuple[QTensor, QTensor]:
    """A fused gate|up expert stack (host planes; parts ((npk, n_orig) of
    gate, of up), every plane's columns concatenated on its last axis) as
    the separate gate and up stacks."""
    (npk_g, n_g), (npk_u, n_u) = qt.parts
    cut = lambda a, lo, hi: None if a is None else np.ascontiguousarray(
        a[..., lo:hi])
    return tuple(
        QTensor(qt.kind, (npk * qt.pack, qt.shape[1]), n, qt.group,
                cut(qt.qs, lo, lo + npk), cut(qt.scale, lo, lo + npk),
                cut(qt.min_, lo, lo + npk), qt.lut, qt.ggml_type, qt.layout)
        for lo, npk, n in ((0, npk_g, n_g), (npk_g, npk_u, n_u)))


def port_weights_from_reference(jw) -> LlamaWeights:
    """The reference's loaded parameters (any object with the attributes
    of its LlamaWeights, planes as arrays) as the port's host planes: every
    LayerWeights field by name, the expert stacks and the router
    included, and the LoRA pairs and control vector attached to it. An
    encoder's lm head, which the reference points at the embedding rows
    and never dispatches, becomes None, as the port's loader leaves it.
    Fused gate|up expert stacks (the reference's LLAMA_TPU_MOE_FUSE load)
    are split back into the gate and up stacks (split_expert_stacks)."""
    conv = lambda x: None if x is None else (
        port_qtensor(x) if hasattr(x, "kind") else np.asarray(x, np.float32))
    conv_lora = lambda p: (host_array(p[0]), host_array(p[1]), float(p[2]))
    layers = [_layer_fields(lw, conv, conv_lora) for lw in jw.layers]
    for lw, jl in zip(layers, jw.layers):
        fused = getattr(jl, "gateup_exps", None)
        if fused is not None:
            lw.gate_exps, lw.up_exps = split_expert_stacks(conv(fused))
    out = _top_fields(jw, conv, layers)
    if getattr(jw.output, "layout", "t") == "rows":
        out.output = None
    return out


def port_clip_from_reference(jm, device=None):
    """The reference's loaded ClipModel (numpy float arrays: the layers,
    every projector and the resampler's dict) as the port's, float32 on
    device (CUDA unless the caller asks for the CPU)."""
    from .device import resolve_device
    from .models import clip

    return clip.convert(jm, resolve_device(device))


def port_qwen2vl_vision_from_reference(jm, device=None):
    """The reference's loaded Qwen2VLVision (numpy float arrays) as the
    port's, float32 on device (CUDA unless the caller asks for the
    CPU)."""
    from .device import resolve_device
    from .models import qwen2vl_vision as qv

    return qv.convert(jm, resolve_device(device))


def _port_recurrent(jm, model_cls, hp_cls, device):
    """The reference's loaded recurrent model (its hparams and numpy
    weights) as the port's model_cls on device: the same hparams fields,
    every array float32 on the device, no file and no tokenizer behind
    it."""
    from .device import resolve_device

    hp = hp_cls(**{f.name: getattr(jm.hp, f.name)
                   for f in dataclasses.fields(hp_cls)})
    return model_cls.from_weights(hp, jm.weights, resolve_device(device))


def port_mamba_from_reference(jm, device=None):
    """The reference's loaded MambaModel as the port's (models/mamba.py),
    float32 on device (CUDA unless the caller asks for the CPU)."""
    from .models import mamba

    return _port_recurrent(jm, mamba.MambaModel, mamba.MambaHParams,
                           device)


def port_rwkv6_from_reference(jm, device=None):
    """The reference's loaded Rwkv6Model (rwkv6 or rwkv6qwen2) as the
    port's (models/rwkv6.py), float32 on device."""
    from .models import rwkv6

    return _port_recurrent(jm, rwkv6.Rwkv6Model, rwkv6.Rwkv6HParams,
                           device)


def port_rwkv7_from_reference(jm, device=None):
    """The reference's loaded Rwkv7Model (rwkv7 or arwkv7) as the port's
    (models/rwkv7.py), float32 on device."""
    from .models import rwkv7

    return _port_recurrent(jm, rwkv7.Rwkv7Model, rwkv7.Rwkv7HParams,
                           device)


def port_t5_from_reference(jm, device=None):
    """The reference's loaded T5Model (t5 or t5encoder) as the port's
    (models/t5.py), float32 on device (CUDA unless the caller asks for the
    CPU)."""
    from .device import resolve_device
    from .models import t5

    hp = t5.T5HParams(**{f.name: getattr(jm.hp, f.name)
                         for f in dataclasses.fields(t5.T5HParams)})
    return t5.T5Model.from_weights(hp, jm, resolve_device(device))


def port_wavtokenizer_from_reference(jm, device=None):
    """The reference's loaded WavTokenizer (numpy tensors) as the port's
    (models/wavtokenizer.py), float32 on device."""
    from .models import wavtokenizer

    return wavtokenizer.convert(jm, device)


def to_device(w: LlamaWeights, device: torch.device | str) -> LlamaWeights:
    """Move every plane and norm vector of w to device."""
    def conv(x):
        if x is None:
            return None
        if isinstance(x, QTensor):
            return qtensor_to_torch(x, device)
        return array_to_torch(x, device)

    layers = [_layer_fields(lw, conv, lambda p: lora_to_torch(p, device))
              for lw in w.layers]
    return _top_fields(w, conv, layers)
