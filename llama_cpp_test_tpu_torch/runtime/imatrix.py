"""Importance-matrix collection (the examples/imatrix analogue).

Counterpart of llama_cpp_test_tpu/runtime/imatrix.py, rewritten in torch.
For every weight, the per-column sums of squares of the activations that
feed it, over a calibration text: the normed attention input (wq, wk,
wv, or a fused attn_qkv), the attention output (wo), the normed FFN input
(gate and up, a fused gate|up or a non-gated up; the router and expert
stacks of a MoE layer), the FFN activation (ffn_down) and the
final-normed hidden state (output, where the file has an LM head). Each
sum is keyed by the name of the tensor the file holds. One forward per
chunk through the model's own layers (models/llama.forward_layer, which
taps those inputs, sequential, parallel or post-norm, at each layer's
own head counts, deci's linear-attention input under attn_output; K1 on
CUDA, K4 for the experts), after the embedding's token-type row, learned
position rows and LayerNorm where the file has them, with dense
attention in torch (ops/layers.attention, with the ALiBi bias of an ALiBi
file, symmetric on jina-bert-v2), causal as the reference has it, or
bidirectional on an encoder, as the encoder serves.

The reference re-implements the layer inline with RMS norms, a
sequential residual and a gated FFN, and leaves out the quirk axes (the
embedding scale, the biases and QK norms, the windows and softcaps, the
post norms, GeGLU, the LayerNorms and their biases, the parallel
residual, the sub-norms, the gate bias, the position rows and ALiBi), so
on those archs it collects the statistics of another model
or, on a non-gated FFN, an encoder or deci's layers that do not attend,
raises (ROADMAP §3, fault 11); on the llama archs both give the same
sums.

Saved as .npz: sum::<tensor> [K] f32 per tensor, __names__ (the names
joined by newlines) and __counts__. The reference keys each __counts__ row
by hash(name) & 0x7FFFFFFF, which Python salts per process, so no reader
can match a count to its tensor (ROADMAP §3, fault 8); here row i is
[i, count] for the i-th name of __names__. The reference's
IMatrixCollector.load and quantize_model --imatrix read the file.

  python -m llama_cpp_test_tpu_torch.runtime.imatrix -m f.gguf -f text.txt
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..models import llama as llama_mod
from ..models.hparams import HParams, attn_scale_of, layer_window
from ..models.llama import LlamaWeights
from ..ops import layers
from ..ops.flash_prefill import prefill_mask


# the tensors each activation forward_layer taps feeds
def _fed_by(role: str, lw, names) -> tuple:
    """The tensors the activation of `role` feeds in layer weights lw, by
    the names of the layer's file tensors (`names`: a set of suffixes,
    or None for weights that came without a file)."""
    if role == "attn_in":
        if lw.wkv_a is not None:       # MLA
            return ("attn_q_a.weight" if lw.wq_a is not None
                    else "attn_q.weight", "attn_kv_a_mqa.weight")
        if names is not None and "attn_qkv.weight" in names:
            return ("attn_qkv.weight",)
        return ("attn_q.weight", "attn_k.weight", "attn_v.weight")
    if role == "attn_out":
        return ("attn_output.weight",)
    if role == "ffn_in":
        # arctic's tap is its dense MLP's input (the experts read another)
        if lw.gate_inp is not None and lw.ffn_norm_exps is None:
            shared = (("ffn_gate_shexp.weight", "ffn_up_shexp.weight")
                      if lw.up_shexp is not None else ())
            return ("ffn_gate_inp.weight", "ffn_gate_exps.weight",
                    "ffn_up_exps.weight") + shared
        if lw.w_gate is None and lw.w_gateup is None:
            return ("ffn_up.weight",)
        if names is not None and "ffn_gate.weight" not in names:
            return ("ffn_up.weight",)          # phi3's fused gate|up
        return ("ffn_gate.weight", "ffn_up.weight")
    return ("ffn_down.weight",)


def _imatrix_step(w: LlamaWeights, tokens: torch.Tensor, *, hp: HParams,
                  plain: bool = False,
                  names: set | None = None) -> dict[str, torch.Tensor]:
    """tokens [1, T] -> name -> per-column sum of squares [K] f32, on the
    weights' device. The model's own layers (forward_layer) run, and tap
    the input of each projection; attention is dense and causal (every
    key on an encoder), with each layer's window and the softcap. names:
    the file's tensor names (None: the separate q/k/v and gate/up
    names)."""
    b, t = tokens.shape
    dev = tokens.device
    pos = torch.arange(t, dtype=torch.int32, device=dev)[None, :]
    x = llama_mod.embed_input(w, hp, tokens, pos)
    kv_len = torch.full((b,), t, dtype=torch.int32, device=dev)
    mask_pos = pos if hp.causal else torch.full_like(pos, t - 1)
    scale = attn_scale_of(hp)
    alibi = llama_mod.alibi_of(hp, dev)
    al_sym = pos if hp.alibi_sym else None
    stats: dict[str, torch.Tensor] = {}

    def record(names, act):
        v = (act.float() ** 2).sum(dim=tuple(range(act.ndim - 1)))
        for name in names:
            stats[name] = v

    for li, lw in enumerate(w.layers):
        window = layer_window(hp, li)
        mask = prefill_mask(mask_pos, kv_len, t, window)

        def attend(q, k, v, _mask=mask):
            return layers.attention(q, k, v, _mask, scale,
                                    softcap=hp.attn_softcap, alibi=alibi,
                                    alibi_sym_pos=al_sym)

        layer_names = None if names is None else {
            n.split(".", 2)[2] for n in names if n.startswith(f"blk.{li}.")}

        def tap(role, act, _p=f"blk.{li}.", _lw=lw, _names=layer_names):
            record([_p + n for n in _fed_by(role, _lw, _names)], act)

        x = llama_mod.forward_layer(x, lw, hp, pos, w.inv_freq_for(window),
                                    w.rope_mscale, attend, plain, tap, li)
    if w.output is not None:
        record(["output.weight"], llama_mod.final_norm(w, hp, x))
    return stats


class IMatrixCollector:
    """Accumulates the sums over chunks of a token stream. plain=True runs
    the plain version of every kernel (the check a run on the card is held
    against)."""

    def __init__(self, model, plain: bool = False):
        self.model = model
        self.plain = plain
        self.sums: dict[str, np.ndarray] = {}
        self.counts: dict[str, int] = {}
        reader = getattr(model, "reader", None)
        self._names = None if reader is None else set(reader.tensors)

    def collect(self, tokens: list[int], chunk: int = 512) -> None:
        """Chunks of `chunk` tokens, stopping at the first shorter than 16
        (the reference's rule); one download a chunk."""
        dev = self.model.device
        for i in range(0, len(tokens) - 1, chunk):
            part = tokens[i:i + chunk]
            if len(part) < 16:
                break
            arr = torch.as_tensor(np.asarray(part, np.int32)[None]).to(dev)
            with torch.inference_mode():
                stats = _imatrix_step(self.model.weights, arr,
                                      hp=self.model.hp, plain=self.plain,
                                      names=self._names)
                names = list(stats)
                flat = torch.cat([stats[n] for n in names]).cpu().numpy()
            off = 0
            for name in names:
                n = stats[name].shape[0]
                v = flat[off:off + n]
                off += n
                if name in self.sums:
                    self.sums[name] += v
                else:
                    self.sums[name] = v.copy()
                self.counts[name] = self.counts.get(name, 0) + len(part)

    def save(self, path: str) -> None:
        names = list(self.sums)
        arrays = {f"sum::{k}": v for k, v in self.sums.items()}
        arrays["__counts__"] = np.asarray(
            [[i, self.counts[k]] for i, k in enumerate(names)])
        np.savez(path, **arrays,
                 __names__=np.array("\n".join(names), dtype="U"))

    @staticmethod
    def load(path: str) -> dict[str, np.ndarray]:
        data = np.load(path)
        names = str(data["__names__"]).split("\n")
        return {n: data[f"sum::{n}"] for n in names if f"sum::{n}" in data}


def main(argv=None, device=None) -> int:
    import argparse

    ap = argparse.ArgumentParser("llama-imatrix (cuda)")
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-f", "--file", required=True, help="calibration text")
    ap.add_argument("-o", "--output", default="imatrix.npz")
    ap.add_argument("--chunk", type=int, default=512)
    args = ap.parse_args(argv)

    from .engine import Model

    model = Model(args.model, device=device)
    with open(args.file, encoding="utf-8") as f:
        text = f.read()
    tokens = model.tokenizer.encode(text, add_special=True)
    coll = IMatrixCollector(model)
    coll.collect(tokens, chunk=args.chunk)
    coll.save(args.output)
    print(f"collected imatrix for {len(coll.sums)} tensors over "
          f"{len(tokens)} tokens -> {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
