"""Host planes -> device tensors (counterpart of the reference's
models/llama.device_put_weights), and the reference's loaded parameters
carried across as host planes.

to_device takes LlamaWeights whose QTensor planes and norm vectors are
numpy arrays: the port's own loader output, or port_weights_from_reference
of the reference's parameters. bf16 bit patterns (uint16) become
torch.bfloat16, int8/uint8 planes keep their type, float arrays become
float32. Expert stacks (a leading E axis on every plane) move the same way.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.llama import LayerWeights, LlamaWeights
from .quant.repack import QTensor


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


def port_weights_from_reference(jw) -> LlamaWeights:
    """The reference's loaded parameters (any object with the attributes
    of its LlamaWeights, planes as arrays) as the port's host planes: every
    LayerWeights field by name, the expert stacks and the router
    included. A reference that fused gate|up expert stacks into one plane
    (its LLAMA_TPU_MOE_FUSE load) is refused: the port keeps them apart."""
    for i, lw in enumerate(jw.layers):
        if getattr(lw, "gate_inp", None) is not None and (
                lw.gate_exps is None or lw.up_exps is None):
            raise NotImplementedError(
                f"layer {i}: fused gate|up expert stacks; the port carries "
                "separate gate and up stacks")
    conv = lambda x: None if x is None else (
        port_qtensor(x) if hasattr(x, "kind") else np.asarray(x, np.float32))
    layers = [LayerWeights(**{f.name: conv(getattr(lw, f.name))
                              for f in dataclasses.fields(LayerWeights)})
              for lw in jw.layers]
    return LlamaWeights(
        tok_embd=conv(jw.tok_embd), output_norm=conv(jw.output_norm),
        output=conv(jw.output), layers=layers,
        rope_inv_freq=np.asarray(jw.rope_inv_freq, np.float32),
        rope_mscale=jw.rope_mscale)


def to_device(w: LlamaWeights, device: torch.device | str) -> LlamaWeights:
    """Move every plane and norm vector of w to device."""
    def conv(x):
        if x is None:
            return None
        if isinstance(x, QTensor):
            return qtensor_to_torch(x, device)
        return array_to_torch(x, device)

    layers = [LayerWeights(**{f.name: conv(getattr(lw, f.name))
                              for f in dataclasses.fields(LayerWeights)})
              for lw in w.layers]
    return LlamaWeights(
        tok_embd=conv(w.tok_embd), output_norm=conv(w.output_norm),
        output=conv(w.output), layers=layers,
        rope_inv_freq=conv(w.rope_inv_freq), rope_mscale=w.rope_mscale)
