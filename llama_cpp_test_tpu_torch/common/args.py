"""Copy of llama_cpp_test_tpu/common/args.py (pure Python: the port keeps its
own copy and imports nothing of the JAX package).

Declarative argument registry with environment mirrors.

The common/arg.h analogue (reference common/arg.h:13-77, arg.cpp ~234
add_opt entries): every flag is ONE registry entry carrying its aliases,
type, default, help, the examples (CLIs) it applies to, and an env-var
mirror (`LLAMA_ARG_*`, same convention as the reference's
common_params_parse) — so each CLI front-end declares which domains it
needs instead of re-spelling argparse boilerplate, and launchers can
configure everything through the environment.

Precedence: command line > environment > default (matches the reference).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Any, Callable, Sequence


@dataclasses.dataclass(frozen=True)
class Arg:
    flags: tuple[str, ...]           # ("-m", "--model")
    dest: str
    type: Any = str                  # str | int | float | "store_true"
    default: Any = None
    help: str = ""
    env: str | None = None           # LLAMA_ARG_* mirror
    choices: tuple | None = None
    examples: tuple[str, ...] = ("common",)   # which CLIs include it
    nargs: Any = None
    action: str | None = None        # "append" etc.
    metavar: tuple | str | None = None
    required: bool = False


def _env_default(a: Arg):
    if a.env and a.env in os.environ:
        raw = os.environ[a.env]
        if a.type == "store_true":
            return raw not in ("", "0", "false", "off")
        if a.action == "append":
            return [a.type(x) for x in raw.split(",") if x]
        return a.type(raw)
    if a.type == "store_true":
        return bool(a.default)
    return a.default


REGISTRY: list[Arg] = [
    # -- model / context (common) -------------------------------------------
    Arg(("-m", "--model"), "model", str, None, "GGUF model path",
        env="LLAMA_ARG_MODEL", required=True),
    Arg(("-c", "--ctx-size"), "ctx_size", int, 2048,
        "context window size", env="LLAMA_ARG_CTX_SIZE"),
    Arg(("-n", "--n-predict"), "n_predict", int, 128,
        "tokens to generate", env="LLAMA_ARG_N_PREDICT",
        examples=("main", "llava")),
    Arg(("-ctk", "--cache-type-kv"), "cache_type_kv", str, "bf16",
        "KV cache data type", env="LLAMA_ARG_CACHE_TYPE_K",
        choices=("bf16", "f16", "q8_0")),
    Arg(("--keep",), "keep", int, 0,
        "tokens pinned at the head on context shift", env="LLAMA_ARG_KEEP",
        examples=("main",)),
    # -- adapters ------------------------------------------------------------
    Arg(("--lora",), "lora", str, None, "LoRA adapter GGUF (repeatable)",
        action="append", examples=("common",)),
    Arg(("--lora-scaled",), "lora_scaled", str, None,
        "LoRA adapter with scale", action="append", nargs=2,
        metavar=("PATH", "SCALE"), examples=("common",)),
    Arg(("--control-vector",), "control_vector", str, None,
        "control vector GGUF (repeatable)", action="append",
        examples=("main",)),
    Arg(("--control-vector-scaled",), "control_vector_scaled", str, None,
        "control vector with strength", action="append", nargs=2,
        metavar=("PATH", "STRENGTH"), examples=("main",)),
    # -- parallel / distributed ---------------------------------------------
    Arg(("-tp", "--tensor-parallel"), "tensor_parallel", int, 0,
        "tensor-parallel width (0 = all devices when distributed)",
        env="LLAMA_ARG_TENSOR_PARALLEL"),
    Arg(("--coordinator",), "coordinator", str, None,
        "jax.distributed coordinator host:port", env="LLAMA_COORDINATOR"),
    Arg(("--num-procs",), "num_procs", int, 0,
        "total distributed processes", env="LLAMA_NUM_PROCS"),
    Arg(("--process-id",), "process_id", int, 0,
        "this process's rank", env="LLAMA_PROC_ID"),
    # -- sampling (is_sparam analogues) -------------------------------------
    Arg(("--temp",), "temp", float, 0.8, "sampling temperature",
        env="LLAMA_ARG_TEMP", examples=("sampling",)),
    Arg(("--top-k",), "top_k", int, 40, "top-k", env="LLAMA_ARG_TOP_K",
        examples=("sampling",)),
    Arg(("--top-p",), "top_p", float, 0.95, "top-p",
        env="LLAMA_ARG_TOP_P", examples=("sampling",)),
    Arg(("--min-p",), "min_p", float, 0.05, "min-p",
        env="LLAMA_ARG_MIN_P", examples=("sampling",)),
    Arg(("--typical",), "typical", float, 1.0, "typical-p",
        examples=("sampling",)),
    Arg(("--repeat-penalty",), "repeat_penalty", float, 1.0,
        "repetition penalty", examples=("sampling",)),
    Arg(("--repeat-last-n",), "repeat_last_n", int, 64,
        "penalty window", examples=("sampling",)),
    Arg(("--frequency-penalty",), "frequency_penalty", float, 0.0,
        "frequency penalty", examples=("sampling",)),
    Arg(("--presence-penalty",), "presence_penalty", float, 0.0,
        "presence penalty", examples=("sampling",)),
    Arg(("--mirostat",), "mirostat", int, 0, "mirostat mode (0/1/2)",
        examples=("sampling",)),
    Arg(("--mirostat-tau",), "mirostat_tau", float, 5.0, "mirostat tau",
        examples=("sampling",)),
    Arg(("--mirostat-eta",), "mirostat_eta", float, 0.1, "mirostat eta",
        examples=("sampling",)),
    Arg(("-s", "--seed"), "seed", int, 0, "RNG seed",
        env="LLAMA_ARG_SEED", examples=("sampling",)),
    Arg(("--xtc-probability",), "xtc_probability", float, 0.0,
        "XTC exclusion probability", examples=("sampling",)),
    Arg(("--xtc-threshold",), "xtc_threshold", float, 0.1,
        "XTC probability threshold", examples=("sampling",)),
    Arg(("--top-n-sigma",), "top_n_sigma", float, -1.0,
        "top-n-sigma (<=0 disables)", examples=("sampling",)),
    Arg(("--dry-multiplier",), "dry_multiplier", float, 0.0,
        "DRY repetition penalty multiplier", examples=("sampling",)),
    Arg(("--dry-base",), "dry_base", float, 1.75, "DRY base",
        examples=("sampling",)),
    Arg(("--dry-allowed-length",), "dry_allowed_length", int, 2,
        "DRY allowed repeat length", examples=("sampling",)),
    Arg(("--dry-penalty-last-n",), "dry_penalty_last_n", int, -1,
        "DRY window (-1 = ctx)", examples=("sampling",)),
    Arg(("--dynatemp-range",), "dynatemp_range", float, 0.0,
        "dynamic temperature range", examples=("sampling",)),
    Arg(("--dynatemp-exp",), "dynatemp_exponent", float, 1.0,
        "dynamic temperature exponent", examples=("sampling",)),
    Arg(("-l", "--logit-bias"), "logit_bias", str, None,
        "TOKEN_ID(+|-)BIAS, e.g. 1024+5 (repeatable)", action="append",
        examples=("sampling",)),
    Arg(("--ignore-eos",), "ignore_eos", "store_true", False,
        "ignore end-of-generation tokens", env="LLAMA_ARG_IGNORE_EOS",
        examples=("sampling",)),
    Arg(("--grammar",), "grammar", str, "", "GBNF grammar",
        examples=("sampling",)),
    Arg(("--grammar-file",), "grammar_file", str, None,
        "GBNF grammar file", examples=("sampling",)),
    Arg(("--json-schema",), "json_schema", str, None,
        "JSON schema to constrain output (converted to GBNF)",
        env="LLAMA_ARG_JSON_SCHEMA", examples=("sampling",)),
    # -- server --------------------------------------------------------------
    Arg(("--host",), "host", str, "127.0.0.1", "bind address",
        env="LLAMA_ARG_HOST", examples=("server",)),
    Arg(("--port",), "port", int, 8080, "bind port",
        env="LLAMA_ARG_PORT", examples=("server",)),
    Arg(("-np", "--parallel"), "parallel", int, 4,
        "concurrent server slots", env="LLAMA_ARG_N_PARALLEL",
        examples=("server",)),
    Arg(("--alias",), "alias", str, None, "model alias",
        env="LLAMA_ARG_ALIAS", examples=("server",)),
    Arg(("--api-key",), "api_key", str, None, "require this API key",
        env="LLAMA_API_KEY", examples=("server",)),
    Arg(("--slot-save-path",), "slot_save_path", str, None,
        "directory for slot save/restore", examples=("server",)),
    # -- speculative ---------------------------------------------------------
    Arg(("-md", "--model-draft"), "model_draft", str, None,
        "draft model GGUF for speculative decoding",
        env="LLAMA_ARG_MODEL_DRAFT", examples=("server", "speculative")),
    Arg(("--draft-max",), "draft_max", int, 8, "max drafted tokens",
        env="LLAMA_ARG_DRAFT_MAX", examples=("server", "speculative")),
    Arg(("--draft-p-min",), "draft_p_min", float, 0.75,
        "draft confidence floor", env="LLAMA_ARG_DRAFT_P_MIN",
        examples=("server", "speculative")),
    Arg(("--rope-freq-base",), "rope_freq_base", float, 0.0,
        "RoPE base frequency override (0 = from model)",
        env="LLAMA_ARG_ROPE_FREQ_BASE", examples=("common",)),
    Arg(("--rope-freq-scale",), "rope_freq_scale", float, 0.0,
        "RoPE frequency scaling factor override (0 = from model)",
        env="LLAMA_ARG_ROPE_FREQ_SCALE", examples=("common",)),
    Arg(("--yarn-orig-ctx",), "yarn_orig_ctx", int, 0,
        "YaRN original context size (0 = from model)",
        env="LLAMA_ARG_YARN_ORIG_CTX", examples=("common",)),
    Arg(("-b", "--batch-size"), "batch_size", int, 512,
        "prompt chunk size (scheduler prefill chunking)",
        env="LLAMA_ARG_BATCH", examples=("common",)),
    Arg(("--no-context-shift",), "no_context_shift", "store_true", False,
        "stop at n_ctx instead of shifting the cache",
        env="LLAMA_ARG_NO_CONTEXT_SHIFT", examples=("common",)),
    Arg(("-t", "--threads"), "threads", int, 0,
        "loader/repacker threads (0 = auto)", env="LLAMA_ARG_THREADS",
        examples=("common",)),
    Arg(("-ngl", "--n-gpu-layers"), "n_gpu_layers", int, -1,
        "accepted for llama.cpp CLI compatibility (every layer always "
        "runs on the device)", examples=("common",)),
    Arg(("-fa", "--flash-attn"), "flash_attn", "store_true", False,
        "accepted for compatibility (flash attention is always on)",
        examples=("common",)),
    Arg(("--chat-template",), "chat_template", str, None,
        "force a builtin chat template name",
        env="LLAMA_ARG_CHAT_TEMPLATE", examples=("server",)),
    Arg(("--override-kv",), "override_kv", str, None,
        "override model metadata: KEY=TYPE:VALUE (int/float/bool/str; "
        "repeatable)", action="append", env="LLAMA_ARG_OVERRIDE_KV",
        examples=("common",)),
    Arg(("--cache-reuse",), "cache_reuse", int, 0,
        "min chunk size to reuse from the prompt cache via KV shifting "
        "(0 = exact-prefix reuse only)", env="LLAMA_ARG_CACHE_REUSE",
        examples=("server",)),
    # -- multimodal ----------------------------------------------------------
    Arg(("--mmproj",), "mmproj", str, None, "CLIP mmproj GGUF",
        env="LLAMA_ARG_MMPROJ", examples=("llava",)),
    Arg(("--image",), "image", str, None, "image file (repeatable)",
        action="append", examples=("llava",)),
]


def build_parser(prog: str, examples: Sequence[str] = ("common",),
                 extra: Sequence[Arg] = (), registry: Sequence[Arg] = None,
                 require_model: bool = True) -> argparse.ArgumentParser:
    """argparse parser with every registry Arg whose examples intersect
    `examples` (plus 'common'), env-mirror defaults applied."""
    ap = argparse.ArgumentParser(prog)
    want = set(examples) | {"common"}
    for a in list(registry if registry is not None else REGISTRY) + \
            list(extra):
        if not (set(a.examples) & want):
            continue
        kw: dict = {"dest": a.dest, "help": a.help}
        default = _env_default(a)
        if a.type == "store_true":
            kw["action"] = "store_true"
            kw["default"] = default
        else:
            if a.action:
                kw["action"] = a.action
                kw["default"] = default if default is not None else []
            else:
                kw["default"] = default
            kw["type"] = a.type
            if a.nargs:
                kw["nargs"] = a.nargs
                kw.pop("type", None)
            if a.choices:
                kw["choices"] = a.choices
            if a.metavar is not None:
                kw["metavar"] = a.metavar
        if a.required and require_model and default is None:
            kw["required"] = True
        ap.add_argument(*a.flags, **kw)
    return ap


def parse_kv_overrides(specs) -> dict:
    """--override-kv KEY=TYPE:VALUE strings -> {key: typed value}
    (the llama_model_kv_override analogue, reference llama.h:260-278)."""
    out = {}
    for spec in specs or ():
        key, _, tv = spec.partition("=")
        typ, _, val = tv.partition(":")
        if not key or not typ or (typ != "str" and not val):
            raise ValueError(
                f"--override-kv {spec!r}: expected KEY=TYPE:VALUE")
        if typ == "int":
            out[key] = int(val)
        elif typ == "float":
            out[key] = float(val)
        elif typ == "bool":
            out[key] = val.lower() in ("1", "true", "yes", "on")
        elif typ == "str":
            out[key] = val
        else:
            raise ValueError(f"--override-kv {spec!r}: unknown type {typ!r} "
                             "(int/float/bool/str)")
    return out


def parse_logit_bias(specs) -> dict:
    """-l TOKEN_ID(+|-)BIAS strings -> {token_id: bias} (common/arg.cpp
    logit-bias parsing; 'ID-5' lowers, 'ID+5' raises; the FIRST sign after
    the id splits, so exponent signs in the value parse correctly)."""
    import re as _re

    out: dict[int, float] = {}
    for spec in specs or ():
        m = _re.match(r"^(\d+)([+-].*)$", spec)
        if not m:
            raise ValueError(f"--logit-bias {spec!r}: expected ID+V or ID-V")
        try:
            out[int(m.group(1))] = float(m.group(2))
        except ValueError:
            raise ValueError(
                f"--logit-bias {spec!r}: bad bias value {m.group(2)!r}")
    return out


def sampler_params_from_args(args) -> "SamplerParams":
    """SamplerParams from a parser that included the 'sampling' domain."""
    from ..runtime.sampling import SamplerParams

    grammar = getattr(args, "grammar", "") or ""
    gf = getattr(args, "grammar_file", None)
    if gf:
        with open(gf) as f:
            grammar = f.read()
    if not grammar and getattr(args, "json_schema", None):
        import json as _json

        from ..runtime.json_schema import schema_to_gbnf

        grammar = schema_to_gbnf(_json.loads(args.json_schema))
    g = lambda name, d: getattr(args, name, d)
    return SamplerParams(
        temp=args.temp, top_k=args.top_k, top_p=args.top_p,
        min_p=args.min_p, typ_p=args.typical,
        penalty_repeat=args.repeat_penalty,
        penalty_last_n=args.repeat_last_n,
        penalty_freq=args.frequency_penalty,
        penalty_present=args.presence_penalty,
        mirostat=args.mirostat, mirostat_tau=args.mirostat_tau,
        mirostat_eta=args.mirostat_eta, seed=args.seed,
        xtc_probability=g("xtc_probability", 0.0),
        xtc_threshold=g("xtc_threshold", 0.1),
        top_n_sigma=g("top_n_sigma", -1.0),
        dry_multiplier=g("dry_multiplier", 0.0),
        dry_base=g("dry_base", 1.75),
        dry_allowed_length=g("dry_allowed_length", 2),
        dry_penalty_last_n=g("dry_penalty_last_n", -1),
        dynatemp_range=g("dynatemp_range", 0.0),
        dynatemp_exponent=g("dynatemp_exponent", 1.0),
        logit_bias=parse_logit_bias(g("logit_bias", None)),
        grammar=grammar,
    )


def rope_kv_overrides(args) -> dict:
    """--rope-freq-base/--rope-freq-scale/--yarn-orig-ctx -> metadata
    overrides ('*.' resolves to the loaded arch in Model)."""
    ov: dict = {}
    if getattr(args, "rope_freq_base", 0.0):
        ov["*.rope.freq_base"] = float(args.rope_freq_base)
    if getattr(args, "rope_freq_scale", 0.0):
        # llama.cpp freq_scale s compresses positions by 1/s: factor = 1/s
        ov["*.rope.scaling.type"] = "linear"
        ov["*.rope.scaling.factor"] = 1.0 / float(args.rope_freq_scale)
    if getattr(args, "yarn_orig_ctx", 0):
        ov["*.rope.scaling.original_context_length"] = int(
            args.yarn_orig_ctx)
    return ov


def env_docs() -> str:
    """--help appendix: every env mirror (reference prints these too)."""
    lines = ["environment variable mirrors (cli overrides env):"]
    for a in REGISTRY:
        if a.env:
            lines.append(f"  {a.env:32s} {'/'.join(a.flags)}")
    return "\n".join(lines)
