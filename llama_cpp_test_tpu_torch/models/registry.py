"""Architecture registry: the GGUF `general.architecture` strings the
port's paged engine serves, and the model class or loader that takes each
of the others.

Counterpart of llama_cpp_test_tpu/models/registry.py, trimmed to the
archs of the llama body the port carries (models/llama.py): llama,
mistral and mixtral (NORM rope, dense or Mixtral-style MoE), the gemma
family (GeGLU, sqrt(n_embd) embedding scale; gemma2's sandwich norms,
softcaps and alternating sliding windows; gemma3's per-head QK norms and
5:1 local/global windows with their own rope base), qwen2 and qwen3
(NEOX rope; Q/K/V biases, per-head QK norms); the LayerNorm, non-gated
FFN and partial-rope archs stablelm, starcoder2, nemotron and olmo
(non-parametric LN, QKV clamping); granite (the mup scales), olmo2
(post norms only, flat QK norms) and phi3 (fused q|k|v and gate|up, the
long-rope tables); the parallel-residual archs phi2, falcon, gptneox,
command-r, cohere2 (3:1 sliding windows, no rope on the global layers)
and plamo (RMS norms), one or two norms feeding attention and the FFN
side by side; the llama-body archs that need only small switches:
minicpm (the mup scales), internlm2, baichuan, xverse, orion, qwen,
exaone, codeshell, chatglm (partial rope, fused [gate|up]) and bitnet
(RMS sub-norms before wo and ffn_down); and the position axes: learned
absolute positions (gpt2, starcoder) and ALiBi (bloom with its embedding
LayerNorm, mpt, jais with its gate bias, refact, and the 13B-class
baichuan); the bert-family encoders: bert (post-norm layers, learned
positions, the token-type row, CLS pooling), nomic-bert (post-norm with
NEOX rope and a SwiGLU FFN) and jina-bert-v2 (symmetric ALiBi, GeGLU),
non-causal and without an LM head; per-layer geometry: openelm (per-layer
query and KV heads and FFN widths, shared per-head QK RMS norms) and deci
(per-layer KV heads, attention-free and linear-attention layers); and
chameleon (per-head QK LayerNorms with biases, the 34B's swin norms);
the other MoE forms: qwen2moe (a sigmoid-gated shared expert), qwen3moe,
olmoe and granitemoe (softmax top-k, renormalized or not), deepseek
(leading dense layers, ungated shared experts), deepseek2 (the same with
MLA attention, sigmoid gating and the selection bias of V3), phimoe (the
sparsemixer), dbrx, grok (GELU experts, post-branch norms, an attention
softcap) and arctic (a dense MLP beside the experts), and minicpm3 (MLA
with a q LoRA at head dim 96); and qwen2vl (qwen2's body, whose image
tokens rope by their M-RoPE streams). The recurrent families (RECURRENT:
mamba, rwkv6, rwkv6qwen2, rwkv7, arwkv7) carry state instead of a KV
cache: they load through their own model classes (models/mamba.py,
rwkv6.py, rwkv7.py) and serve through runtime/recurrent.RecurrentContext,
and the paged engine refuses them naming that class. The encoder-decoder
and audio families (NOT_PAGED: t5 and t5encoder, models/t5.py;
wavtokenizer-dec, the vocoder of cli/tts.py, models/wavtokenizer.py) load
through their own loaders, and the paged engine refuses them naming the
loader, as the reference's does. So every arch the reference registers is
served.
"""
from __future__ import annotations

PORTED = ("llama", "mistral", "mixtral", "gemma", "gemma2", "gemma3",
          "qwen2", "qwen3", "phi3", "granite", "stablelm", "olmo2",
          "command-r", "starcoder2", "nemotron", "olmo", "gptneox", "phi2",
          "falcon", "minicpm", "internlm2", "baichuan", "xverse", "orion",
          "qwen", "exaone", "codeshell", "chatglm", "cohere2", "plamo",
          "bitnet", "gpt2", "starcoder", "bloom", "mpt", "jais", "refact",
          "bert", "nomic-bert", "jina-bert-v2", "openelm", "deci",
          "chameleon", "qwen2moe", "qwen3moe", "olmoe", "deepseek2",
          "deepseek", "phimoe", "dbrx", "arctic", "grok", "granitemoe",
          "minicpm3", "qwen2vl")

# arch -> the class that loads it
RECURRENT = {"mamba": "models.mamba.MambaModel / MambaContext",
             "rwkv6": "models.rwkv6.Rwkv6Model / Rwkv6Context",
             "rwkv6qwen2": "models.rwkv6.Rwkv6Model / Rwkv6Context",
             "rwkv7": "models.rwkv7.Rwkv7Model / Rwkv7Context",
             "arwkv7": "models.rwkv7.Rwkv7Model / Rwkv7Context"}

# arch -> the loader of a family the paged engine does not host, with the
# reference's refusal (llama_cpp_test_tpu/models/llama.py:311-318)
_T5 = ("is an encoder-decoder arch: load it with models.t5.T5Model / "
       "T5Context (llama_encode + decode flow)")
NOT_PAGED = {"t5": _T5, "t5encoder": _T5,
             "wavtokenizer-dec": "is an audio-codec decoder: load it with "
                                 "models.wavtokenizer.load_wavtokenizer "
                                 "(llama-tts CLI)"}


def check_arch(arch: str) -> None:
    """Raise unless the paged engine serves `arch`: ValueError naming the
    model class of a recurrent arch or the loader of an encoder-decoder or
    audio one, ValueError for one neither package registers."""
    if arch in PORTED:
        return
    if arch in RECURRENT:
        raise ValueError(
            f"{arch} is a recurrent arch with no KV cache: load it with "
            f"{RECURRENT[arch]} (served by runtime.recurrent."
            "RecurrentContext)")
    if arch in NOT_PAGED:
        raise ValueError(f"{arch} {NOT_PAGED[arch]}")
    raise ValueError(f"architecture {arch!r} has no implemented forward "
                     f"pass; the port serves {list(PORTED)}")
