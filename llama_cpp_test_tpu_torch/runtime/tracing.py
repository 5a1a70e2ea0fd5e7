"""Per-layer activation tracing (the eval-callback analogue).

Counterpart of llama_cpp_test_tpu/runtime/tracing.py. The engine's own
forward (engine._forward) takes a tap, a list it appends the embedding and
every layer's output to; trace_eval runs one prefill of a throwaway
sequence through it (bidirectional on an encoder, as Context.embed runs
it), adds the logits (an encoder's final hidden state, result_embd, as it
has no LM head), and summarizes each tensor on the host. The prefill runs
the same kernels as Context.prefill (K1, K2).

The port's KV writes are in place, so the throwaway sequence takes blocks
from the free list and gives them back: no live sequence's blocks are
written, and the free list ends in its old order. A trace that would need
more blocks than are free raises instead of evicting a live sequence.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import llama as llama_mod
from .engine import TOKEN_BUCKETS, Context, _bucket


@dataclasses.dataclass
class TensorTrace:
    name: str
    shape: tuple
    mean: float
    std: float
    amax: float
    values: np.ndarray  # the tensor itself (float32), when kept


def trace_eval(ctx: Context, tokens: list[int],
               keep_values: bool = False) -> list[TensorTrace]:
    """Run one traced prefill of `tokens` on a throwaway sequence and return
    the summaries of inp_embd, l_out-{i} for every layer and result_output
    (result_embd on an encoder; eval-callback's printout, structured)."""
    hp = ctx.model.hp
    n = len(tokens)
    tb = _bucket(n, TOKEN_BUCKETS)
    if n == 0 or n > tb:
        raise ValueError(f"trace_eval: {n} tokens (1..{TOKEN_BUCKETS[-1]})")
    need = -(-n // ctx.block_size)
    if ctx.mgr.num_free() < need:
        raise RuntimeError(
            f"trace_eval: {need} free KV blocks needed, {ctx.mgr.num_free()} "
            "free; a trace never evicts a live sequence")
    s = ctx.new_seq()
    try:
        slots = s.table.append_tokens(n)
        tok = np.zeros((1, tb), np.int32)
        tok[0, :n] = tokens
        pos = np.zeros((1, tb), np.int32)
        pos[0, :n] = np.arange(n)
        slot_arr = np.full((1, tb), -1, np.int32)
        slot_arr[0, :n] = slots
        taps: list[torch.Tensor] = []
        with torch.inference_mode():
            ctx._step(tok, pos, ctx._table_arr([s]), slot_arr,
                      np.asarray([n], np.int32), False, causal=hp.causal,
                      tap=taps)
            encoder = ctx.w.output is None
            taps.append(llama_mod.final_norm(ctx.w, hp, taps[-1]) if encoder
                        else ctx._logits(taps[-1]))
            host = [t[0, :n].float().cpu().numpy() for t in taps]
        names = ["inp_embd"] + [f"l_out-{i}" for i in range(hp.n_layer)] + \
            ["result_embd" if encoder else "result_output"]
        return [TensorTrace(name=name, shape=tuple(a.shape),
                            mean=float(a.mean()), std=float(a.std()),
                            amax=float(np.abs(a).max()),
                            values=a if keep_values
                            else np.empty(0, np.float32))
                for name, a in zip(names, host)]
    finally:
        ctx.free_seq(s)


def print_traces(traces: list[TensorTrace], file=None) -> None:
    for t in traces:
        print(f"{t.name:>16} {str(t.shape):>18}  mean={t.mean:+.4f} "
              f"std={t.std:.4f} absmax={t.amax:.4f}", file=file)
