"""Importance-matrix collection (the examples/imatrix analogue).

Counterpart of llama_cpp_test_tpu/runtime/imatrix.py, rewritten in torch.
For every weight, the per-column sums of squares of the activations that
feed it, over a calibration text: the RMS-normed attention input (wq, wk,
wv), the attention output (wo), the RMS-normed FFN input (gate, up; the
router and expert stacks of a MoE layer), the SwiGLU activation
(ffn_down) and the final-normed hidden state (output). One forward per
chunk over the model's own projections (K1 on CUDA, K4 for the experts),
dense causal attention in torch (ops/layers.attention) as the reference
has it.

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
from ..models.hparams import HParams, attn_scale_of
from ..models.llama import LlamaWeights, gateup_proj, linear, qkv_proj
from ..ops import layers


def _imatrix_step(w: LlamaWeights, tokens: torch.Tensor, *, hp: HParams,
                  plain: bool = False) -> dict[str, torch.Tensor]:
    """tokens [1, T] -> name -> per-column sum of squares [K] f32, on the
    weights' device."""
    b, t = tokens.shape
    dev = tokens.device
    x = llama_mod.embed(w, tokens)
    pos = torch.arange(t, dtype=torch.int32, device=dev)[None, :]
    scale = attn_scale_of(hp)
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=dev))[None]
    stats: dict[str, torch.Tensor] = {}

    def record(names, act):
        v = (act.float() ** 2).sum(dim=tuple(range(act.ndim - 1)))
        for name in names:
            stats[name] = v

    h, kvh, d = hp.n_head, hp.n_head_kv, hp.head_dim
    for li, lw in enumerate(w.layers):
        p = f"blk.{li}."
        cur = layers.rms_norm(x, lw.attn_norm, hp.rms_eps)
        record([p + "attn_q.weight", p + "attn_k.weight",
                p + "attn_v.weight"], cur)
        q, k, v = qkv_proj(cur, lw, plain)
        q = layers.apply_rope(q.reshape(b, t, h, d), pos, w.rope_inv_freq,
                              w.rope_mscale)
        k = layers.apply_rope(k.reshape(b, t, kvh, d), pos, w.rope_inv_freq,
                              w.rope_mscale)
        v = v.reshape(b, t, kvh, d)
        att = layers.attention(q.to(torch.bfloat16), k.to(torch.bfloat16),
                               v.to(torch.bfloat16), mask, scale
                               ).reshape(b, t, h * d)
        record([p + "attn_output.weight"], att)
        x = x + linear(att, lw.wo, plain).to(x.dtype)

        cur = layers.rms_norm(x, lw.ffn_norm, hp.rms_eps)
        if lw.gate_inp is not None:
            record([p + "ffn_gate_inp.weight", p + "ffn_gate_exps.weight",
                    p + "ffn_up_exps.weight"], cur)
            x = x + llama_mod.moe_ffn(cur, lw, hp, plain).to(x.dtype)
        else:
            record([p + "ffn_gate.weight", p + "ffn_up.weight"], cur)
            g, u = gateup_proj(cur, lw, plain)
            act = layers.swiglu(g, u)
            record([p + "ffn_down.weight"], act)
            x = x + linear(act, lw.w_down, plain).to(x.dtype)
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
                                      hp=self.model.hp, plain=self.plain)
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
