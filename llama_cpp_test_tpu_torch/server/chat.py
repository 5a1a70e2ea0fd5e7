"""Chat templating (the common/chat + llama-chat analogue).

Copy of llama_cpp_test_tpu/server/chat.py (stdlib re and json; jinja2
imported when a template is rendered, the builtin format otherwise).

Applies the model's embedded Jinja chat template (GGUF key
`tokenizer.chat_template`, rendered with jinja2 — the minja.hpp analogue)
or a named built-in fallback mirroring llama_chat_apply_template's builtin
table (reference src/llama-chat.cpp: ~40 handwritten formats keyed by
LLM_CHAT_TEMPLATE_*), plus the template auto-detection that the reference
does by fingerprinting the Jinja source (llm_chat_detect_template).

Also provides OpenAI-style tool-call extraction from generated text
(the common/chat.cpp format parsers): ChatML <tool_call> blocks, Mistral
[TOOL_CALLS] arrays, and bare JSON function objects.
"""
from __future__ import annotations

import json
import re
from typing import Any, Callable, Sequence


def _render_jinja(template: str, messages: Sequence[dict],
                  add_generation_prompt: bool, special: dict,
                  tools: Sequence[dict] | None = None) -> str:
    import jinja2

    env = jinja2.Environment(trim_blocks=True, lstrip_blocks=True)

    def raise_exception(msg):
        raise jinja2.TemplateError(msg)

    def strftime_now(fmt):
        import datetime

        return datetime.datetime.now().strftime(fmt)

    kwargs = dict(
        messages=list(messages),
        add_generation_prompt=add_generation_prompt,
        raise_exception=raise_exception,
        strftime_now=strftime_now,
        **special,
    )
    if tools:
        kwargs["tools"] = list(tools)
    tmpl = env.from_string(template)
    return tmpl.render(**kwargs)


# -- builtin templates (llama-chat.cpp:llm_chat_apply_template) --------------

def _sys_fold(msgs: Sequence[dict]) -> list[dict]:
    """Fold a leading system message into the first user turn (templates
    without a system role)."""
    out: list[dict] = []
    system = ""
    for m in msgs:
        if m["role"] == "system":
            system = m["content"]
        elif m["role"] == "user" and system:
            out.append({"role": "user",
                        "content": f"{system}\n\n{m['content']}"})
            system = ""
        else:
            out.append(m)
    return out


def _chatml(msgs, gen):
    return "".join(
        f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n" for m in msgs
    ) + ("<|im_start|>assistant\n" if gen else "")


def _llama2(msgs, gen, sys_block=True):
    out = []
    system = ""
    for m in msgs:
        if m["role"] == "system":
            system = m["content"]
        elif m["role"] == "user":
            content = m["content"]
            if system:
                if sys_block:
                    content = f"<<SYS>>\n{system}\n<</SYS>>\n\n{content}"
                else:
                    content = f"{system}\n\n{content}"
                system = ""
            out.append(f"[INST] {content} [/INST]")
        else:
            # reference (src/llama-chat.cpp LLM_CHAT_TEMPLATE_LLAMA_2*)
            # terminates each assistant turn with </s> before reopening
            # [INST] for the next user turn
            out.append(f"{m['content']}</s>")
    return "".join(out)


def _llama3(msgs, gen):
    return "<|begin_of_text|>" + "".join(
        f"<|start_header_id|>{m['role']}<|end_header_id|>\n\n"
        f"{m['content']}<|eot_id|>" for m in msgs
    ) + ("<|start_header_id|>assistant<|end_header_id|>\n\n" if gen else "")


def _mistral_v3(msgs, gen):
    out = []
    for m in _sys_fold(msgs):
        if m["role"] == "user":
            out.append(f"[INST] {m['content']}[/INST]")
        else:
            out.append(f" {m['content']}</s>")
    return "".join(out)


def _mistral_v7(msgs, gen):
    out = []
    for m in msgs:
        if m["role"] == "system":
            out.append(f"[SYSTEM_PROMPT] {m['content']}[/SYSTEM_PROMPT]")
        elif m["role"] == "user":
            out.append(f"[INST] {m['content']}[/INST]")
        else:
            out.append(f" {m['content']}</s>")
    return "".join(out)


def _phi3(msgs, gen):
    return "".join(
        f"<|{m['role']}|>\n{m['content']}<|end|>\n" for m in msgs
    ) + ("<|assistant|>\n" if gen else "")


def _phi4(msgs, gen):
    return "".join(
        f"<|im_start|>{m['role']}<|im_sep|>{m['content']}<|im_end|>"
        for m in msgs
    ) + ("<|im_start|>assistant<|im_sep|>" if gen else "")


def _falcon3(msgs, gen):
    return "".join(
        f"<|{m['role']}|>\n{m['content']}\n" for m in msgs
    ) + ("<|assistant|>\n" if gen else "")


def _zephyr(msgs, gen):
    return "".join(
        f"<|{m['role']}|>\n{m['content']}<|endoftext|>\n" for m in msgs
    ) + ("<|assistant|>\n" if gen else "")


def _monarch(msgs, gen):
    out = []
    for i, m in enumerate(msgs):
        bos = "<s>" if i > 0 else ""
        out.append(f"{bos}{m['role']}\n{m['content']}</s>\n")
    if gen:
        out.append("<s>assistant\n")
    return "".join(out)


def _gemma(msgs, gen):
    out = []
    for m in _sys_fold(msgs):
        role = "model" if m["role"] == "assistant" else m["role"]
        out.append(f"<start_of_turn>{role}\n{m['content']}<end_of_turn>\n")
    if gen:
        out.append("<start_of_turn>model\n")
    return "".join(out)


def _orion(msgs, gen):
    out = []
    for m in _sys_fold(msgs):
        if m["role"] == "user":
            out.append(f"Human: {m['content']}\n\nAssistant: </s>")
        else:
            out.append(f"{m['content']}</s>")
    return "".join(out)


def _openchat(msgs, gen):
    out = []
    for m in msgs:
        if m["role"] == "system":
            out.append(f"{m['content']}<|end_of_turn|>")
        else:
            role = "GPT4 Correct " + m["role"].capitalize()
            out.append(f"{role}: {m['content']}<|end_of_turn|>")
    if gen:
        out.append("GPT4 Correct Assistant:")
    return "".join(out)


def _vicuna(msgs, gen, orca=False):
    out = []
    for m in msgs:
        if m["role"] == "system":
            out.append(f"SYSTEM: {m['content']}\n" if orca
                       else f"{m['content']}\n\n")
        elif m["role"] == "user":
            out.append(f"USER: {m['content']}\n")
        else:
            out.append(f"ASSISTANT: {m['content']}</s>\n")
    if gen:
        out.append("ASSISTANT:")
    return "".join(out)


def _deepseek(msgs, gen):
    out = []
    for m in msgs:
        if m["role"] == "system":
            out.append(f"{m['content']}\n\n")
        elif m["role"] == "user":
            out.append(f"### Instruction:\n{m['content']}\n")
        else:
            out.append(f"### Response:\n{m['content']}\n<|EOT|>\n")
    if gen:
        out.append("### Response:\n")
    return "".join(out)


def _deepseek3(msgs, gen):
    out = []
    for m in msgs:
        if m["role"] == "system":
            out.append(m["content"] + "\n\n")
        elif m["role"] == "user":
            out.append(f"<｜User｜>{m['content']}")
        else:
            out.append(f"<｜Assistant｜>{m['content']}<｜end▁of▁sentence｜>")
    if gen:
        out.append("<｜Assistant｜>")
    return "".join(out)


def _command_r(msgs, gen):
    role_map = {"system": "SYSTEM", "user": "USER", "assistant": "CHATBOT"}
    out = []
    for m in msgs:
        out.append(f"<|START_OF_TURN_TOKEN|><|{role_map[m['role']]}_TOKEN|>"
                   f"{m['content']}<|END_OF_TURN_TOKEN|>")
    if gen:
        out.append("<|START_OF_TURN_TOKEN|><|CHATBOT_TOKEN|>")
    return "".join(out)


def _chatglm4(msgs, gen):
    out = ["[gMASK]<sop>"]
    for m in msgs:
        out.append(f"<|{m['role']}|>\n{m['content']}")
    if gen:
        out.append("<|assistant|>")
    return "".join(out)


def _minicpm(msgs, gen):
    out = []
    for m in _sys_fold(msgs):
        if m["role"] == "user":
            out.append(f"<用户>{m['content']}<AI>")
        else:
            out.append(m["content"])
    return "".join(out)


def _exaone3(msgs, gen):
    out = []
    for m in msgs:
        if m["role"] == "system":
            out.append(f"[|system|]{m['content']}[|endofturn|]\n")
        elif m["role"] == "user":
            out.append(f"[|user|]{m['content']}\n")
        else:
            out.append(f"[|assistant|]{m['content']}[|endofturn|]\n")
    if gen:
        out.append("[|assistant|]")
    return "".join(out)


def _rwkv_world(msgs, gen):
    out = []
    for m in _sys_fold(msgs):
        role = "User" if m["role"] == "user" else "Assistant"
        out.append(f"{role}: {m['content']}\n\n")
    if gen:
        out.append("Assistant:")
    return "".join(out)


def _granite(msgs, gen):
    out = []
    for m in msgs:
        out.append(f"<|start_of_role|>{m['role']}<|end_of_role|>"
                   f"{m['content']}<|end_of_text|>\n")
    if gen:
        out.append("<|start_of_role|>assistant<|end_of_role|>\n")
    return "".join(out)


_BUILTINS: dict[str, Callable] = {
    "chatml": _chatml,
    "llama2": lambda m, g: _llama2(m, g, sys_block=True),
    "llama2-sys": lambda m, g: _llama2(m, g, sys_block=True),
    "mistral-v1": lambda m, g: _llama2(m, g, sys_block=False),
    "mistral-v3": _mistral_v3,
    "mistral-v7": _mistral_v7,
    "mistral": lambda m, g: _llama2(m, g, sys_block=True),
    "llama3": _llama3,
    "phi3": _phi3,
    "phi4": _phi4,
    "falcon3": _falcon3,
    "zephyr": _zephyr,
    "monarch": _monarch,
    "gemma": _gemma,
    "orion": _orion,
    "openchat": _openchat,
    "vicuna": lambda m, g: _vicuna(m, g, orca=False),
    "vicuna-orca": lambda m, g: _vicuna(m, g, orca=True),
    "deepseek": _deepseek,
    "deepseek3": _deepseek3,
    "command-r": _command_r,
    "chatglm4": _chatglm4,
    "minicpm": _minicpm,
    "exaone3": _exaone3,
    "rwkv-world": _rwkv_world,
    "granite": _granite,
}

# fingerprints of well-known Jinja sources -> builtin names
# (llm_chat_detect_template's substring checks, same order of specificity)
_DETECT: list[tuple[str, str]] = [
    ("<|im_sep|>", "phi4"),
    ("<|im_start|>", "chatml"),
    ("[SYSTEM_PROMPT]", "mistral-v7"),
    ("<<SYS>>", "llama2-sys"),
    ("[INST]", "mistral-v3"),
    ("<|start_header_id|>", "llama3"),
    ("<|assistant|>", "phi3"),
    ("<|user|>", "zephyr"),
    ("bos_token + message['role']", "monarch"),
    ("<start_of_turn>", "gemma"),
    ("'\\n\\nAssistant: ' + eos_token", "orion"),
    ("GPT4 Correct ", "openchat"),
    ("USER: ", "vicuna"),
    ("### Instruction:", "deepseek"),
    ("<｜User｜>", "deepseek3"),
    ("<|START_OF_TURN_TOKEN|>", "command-r"),
    ("[gMASK]<sop>", "chatglm4"),
    ("<用户>", "minicpm"),
    ("[|system|]", "exaone3"),
    ("start_of_role", "granite"),
]


def detect_template(jinja_src: str) -> str:
    for needle, name in _DETECT:
        if needle in jinja_src:
            return name
    return "chatml"


def apply_chat_template(metadata: dict, messages: Sequence[dict],
                        add_generation_prompt: bool = True,
                        template_override: str | None = None,
                        tools: Sequence[dict] | None = None) -> str:
    template = template_override or metadata.get("tokenizer.chat_template")
    if template and "{" in template:
        bos = ""
        eos = ""
        toks = metadata.get("tokenizer.ggml.tokens")
        if toks is not None:
            bos_id = metadata.get("tokenizer.ggml.bos_token_id")
            eos_id = metadata.get("tokenizer.ggml.eos_token_id")
            if bos_id is not None and int(bos_id) < len(toks):
                bos = toks[int(bos_id)]
            if eos_id is not None and int(eos_id) < len(toks):
                eos = toks[int(eos_id)]
        try:
            return _render_jinja(template, messages, add_generation_prompt,
                                 {"bos_token": bos, "eos_token": eos},
                                 tools=tools)
        except Exception:
            # fall back to the detected builtin (reference falls back to
            # llm_chat_apply_template when minja can't render)
            name = detect_template(template)
            return _BUILTINS[name](messages, add_generation_prompt)
    name = template if template in _BUILTINS else "chatml"
    return _BUILTINS[name](messages, add_generation_prompt)


# -- tool-call extraction (common/chat.cpp format parsers) -------------------

_TOOL_CALL_RE = re.compile(
    r"<tool_call>\s*(\{.*?\})\s*</tool_call>", re.DOTALL)
_MISTRAL_TC_RE = re.compile(r"\[TOOL_CALLS\]\s*(\[.*\])", re.DOTALL)


def parse_tool_calls(text: str) -> tuple[str, list[dict]]:
    """Extract tool calls from generated text. Returns (content, tool_calls)
    where tool_calls follow the OpenAI schema
    {"type": "function", "function": {"name", "arguments"}}."""
    calls: list[dict] = []

    def add(obj):
        name = obj.get("name")
        if not name:
            return False
        args = obj.get("arguments", obj.get("parameters", {}))
        if isinstance(args, str):
            arg_str = args
        else:
            arg_str = json.dumps(args)
        calls.append({"type": "function", "id": f"call_{len(calls)}",
                      "function": {"name": name, "arguments": arg_str}})
        return True

    # ChatML / Hermes style: <tool_call>{...}</tool_call>
    content = text
    found = _TOOL_CALL_RE.findall(text)
    if found:
        for blob in found:
            try:
                add(json.loads(blob))
            except json.JSONDecodeError:
                pass
        content = _TOOL_CALL_RE.sub("", text).strip()
        if calls:
            return content, calls

    # Mistral style: [TOOL_CALLS][{...}, ...]
    m = _MISTRAL_TC_RE.search(text)
    if m:
        try:
            for obj in json.loads(m.group(1)):
                add(obj)
        except json.JSONDecodeError:
            pass
        if calls:
            return text[: m.start()].strip(), calls

    # bare JSON object that looks like a function call
    stripped = text.strip()
    if stripped.startswith("{"):
        try:
            obj = json.loads(stripped)
            if isinstance(obj, dict) and add(obj):
                return "", calls
        except json.JSONDecodeError:
            pass
    return text, []


# -- model-specific tool-call formats (common/chat.h:45-58) ------------------

# format ids mirror COMMON_CHAT_FORMAT_* (reference common/chat.h:45-58)
TOOL_FORMATS = ("auto", "generic", "mistral_nemo", "llama_3_x",
                "llama_3_x_builtin", "deepseek_r1", "functionary_v3_2",
                "functionary_v3_1", "hermes_2_pro", "command_r7b",
                "firefunction_v2")


def detect_tool_format(jinja_src: str) -> str:
    """Pick the tool-call format from the chat template source, mirroring
    common_chat_templates_apply_jinja's sniffing (chat.cpp:1600-1665)."""
    src = jinja_src or ""
    if "<｜tool▁calls▁begin｜>" in src:
        return "deepseek_r1"
    if "<|END_THINKING|><|START_ACTION|>" in src:
        return "command_r7b"
    if "<tool_call>" in src:
        return "hermes_2_pro"
    if ">>>all" in src:
        return "functionary_v3_2"
    if "<|start_header_id|>" in src and "<function=" in src:
        return "functionary_v3_1"
    if "<|start_header_id|>ipython<|end_header_id|>" in src:
        return "llama_3_x_builtin" if "<|python_tag|>" in src \
            else "llama_3_x"
    if "[TOOL_CALLS]" in src:
        return "mistral_nemo"
    if " functools[" in src:
        return "firefunction_v2"
    return "generic"


def _mk_call(name: str, args, calls: list) -> None:
    arg_str = args if isinstance(args, str) else json.dumps(args)
    calls.append({"type": "function", "id": f"call_{len(calls)}",
                  "function": {"name": name, "arguments": arg_str}})


def _split_reasoning(text: str) -> tuple[str, str]:
    """Strip an optional <think>...</think> prelude (DeepSeek-R1 /
    Command-R7B reasoning extraction, chat.cpp handle_think_tag_prelude).
    Returns (reasoning, rest)."""
    m = re.match(r"(?:<think>)?([\s\S]*?)</think>([\s\S]*)", text)
    if m:
        return m.group(1).strip(), m.group(2)
    m = re.match(r"<\|START_THINKING\|>([\s\S]*?)<\|END_THINKING\|>"
                 r"([\s\S]*)", text)
    if m:
        return m.group(1).strip(), m.group(2)
    return "", text


_LLAMA3_FN_RE = re.compile(
    r"\{\s*(?:\"type\"\s*:\s*\"function\"\s*,\s*)?\"name\"\s*:\s*"
    r"\"([^\"]+)\"\s*,\s*\"(?:parameters|arguments)\"\s*:\s*")
_PYTHON_TAG_RE = re.compile(
    r"<\|python_tag\|>\s*([^.(]+)\s*\.\s*call\s*\(\s*(\w+)\s*=\s*"
    r"([\s\S]*?)\)\s*$")
_DSR1_BLOCK_RE = re.compile(
    r"(?:<｜tool▁calls▁begin｜>|<｜tool_calls_begin｜>|<｜tool calls begin｜>)"
    r"([\s\S]*?)<｜tool▁calls▁end｜>")
_DSR1_CALL_RE = re.compile(
    r"<｜tool▁call▁begin｜>function<｜tool▁sep｜>([^\n]+)\n```json\n"
    r"([\s\S]*?)```[\s\r\n]*<｜tool▁call▁end｜>")
_FUNCTIONARY31_RE = re.compile(r"<function=(\w+)>([\s\S]*?)</function>")
_CR7B_ACTION_RE = re.compile(
    r"<\|START_ACTION\|>([\s\S]*?)<\|END_ACTION\|>")
_CR7B_RESPONSE_RE = re.compile(
    r"<\|START_RESPONSE\|>([\s\S]*?)(?:<\|END_RESPONSE\|>|$)")


def _parse_json_prefix(s: str):
    """Parse a JSON value at the START of s; returns (obj, rest) or None."""
    try:
        obj, end = json.JSONDecoder().raw_decode(s)
        return obj, s[end:]
    except json.JSONDecodeError:
        return None


def _parse_named_json_calls(text: str, fn_re, calls: list) -> str:
    """parse_json_tool_calls analogue (chat.cpp:537): scan for the function
    header regex, json-parse the arguments that follow, repeat. Returns the
    non-call content."""
    content = []
    pos = 0
    while True:
        m = fn_re.search(text, pos)
        if not m:
            content.append(text[pos:])
            break
        content.append(text[pos:m.start()])
        parsed = _parse_json_prefix(text[m.end():].lstrip())
        if parsed is None:
            content.append(text[m.start():])
            break
        args, rest = parsed
        if fn_re is _LLAMA3_FN_RE:
            # the matched header is the JSON prefix {"name": .., "parameters":
            # — the args close one brace short of the full object
            rest = rest.lstrip()
            if rest.startswith("}"):
                rest = rest[1:]
        _mk_call(m.group(1).strip(), args, calls)
        text = rest
        pos = 0
    return "".join(content).strip()


def parse_assistant_message(text: str, fmt: str = "auto",
                            extract_reasoning: bool = False) -> dict:
    """Format-aware assistant-output parsing: tool calls + optional
    reasoning extraction. Returns {"content", "tool_calls",
    "reasoning_content"} (reasoning only when extract_reasoning).

    Mirrors the reference's per-model parsers (common/chat.cpp):
    Llama-3.x JSON calls + <|python_tag|> builtin tools, DeepSeek-R1
    <think> + tool-call blocks, Hermes-2-Pro <tool_call> (+<think>),
    Functionary v3.2 '>>>name' / v3.1 '<function=..>', Command-R7B
    THINKING/ACTION/RESPONSE blocks, Mistral-Nemo [TOOL_CALLS].
    """
    calls: list[dict] = []
    reasoning = ""
    if fmt in ("deepseek_r1", "hermes_2_pro", "command_r7b",
               "content_only") or \
            (fmt == "auto" and ("<think>" in text or "</think>" in text or
                                "<|START_THINKING|>" in text)):
        reasoning, text = _split_reasoning(text)
        if reasoning and not extract_reasoning:
            # leave unextracted reasoning in the content, like the
            # reference's non-extract variants
            text = f"<think>{reasoning}</think>{text}"
            reasoning = ""

    if fmt == "content_only":
        # no tool parsing: reasoning extraction only, text stays verbatim
        # (the no-tools request path — tool-call markup the model emits
        # unprompted is content, mirroring the reference's
        # common_chat_params_init_without_tools)
        return {"content": text, "tool_calls": [],
                "reasoning_content": reasoning}
    if fmt == "auto":
        content, calls = parse_tool_calls(text)
        return {"content": content, "tool_calls": calls,
                "reasoning_content": reasoning}

    if fmt in ("llama_3_x", "llama_3_x_builtin"):
        if fmt == "llama_3_x_builtin":
            m = _PYTHON_TAG_RE.match(text.strip())
            if m:
                parsed = _parse_json_prefix(m.group(3))
                val = parsed[0] if parsed else m.group(3)
                _mk_call(m.group(1).strip(), {m.group(2): val}, calls)
                return {"content": "", "tool_calls": calls,
                        "reasoning_content": reasoning}
        content = _parse_named_json_calls(text, _LLAMA3_FN_RE, calls)
    elif fmt == "deepseek_r1":
        content = text
        blk = _DSR1_BLOCK_RE.search(text)
        if blk:
            for name, blob in _DSR1_CALL_RE.findall(blk.group(1)):
                parsed = _parse_json_prefix(blob.strip())
                if parsed:
                    _mk_call(name.strip(), parsed[0], calls)
            content = (text[:blk.start()] + text[blk.end():]).strip()
    elif fmt == "hermes_2_pro":
        content, calls = parse_tool_calls(text)
    elif fmt == "functionary_v3_2":
        # ">>>name\n{args}" segments; leading "all\n" segment is content;
        # name "python" may carry raw code (allow_raw_python)
        content_parts = []
        segs = re.split(r">>>", text)
        for i, seg in enumerate(segs):
            if not seg:
                continue
            m = re.match(r"(\w+)\n", seg)
            if i == 0 and (not m or m.group(1) == "all"):
                content_parts.append(seg[4:] if seg.startswith("all\n")
                                     else seg)
                continue
            if not m:
                content_parts.append(seg)
                continue
            name, body = m.group(1), seg[m.end():]
            if name == "all":
                content_parts.append(body)
                continue
            parsed = _parse_json_prefix(body.strip())
            if parsed is not None:
                _mk_call(name, parsed[0], calls)
            elif name in ("python", "ipython"):
                _mk_call(name, {"code": body}, calls)
            else:
                content_parts.append(seg)
        content = "".join(content_parts).strip()
    elif fmt == "functionary_v3_1":
        content = text
        m = _PYTHON_TAG_RE.match(text.strip())
        if m:
            parsed = _parse_json_prefix(m.group(3))
            val = parsed[0] if parsed else m.group(3)
            _mk_call(m.group(1).strip(), {m.group(2): val}, calls)
            content = ""
        else:
            for name, blob in _FUNCTIONARY31_RE.findall(text):
                parsed = _parse_json_prefix(blob.strip())
                if parsed:
                    _mk_call(name, parsed[0], calls)
            if calls:
                content = _FUNCTIONARY31_RE.sub("", text).strip()
    elif fmt == "command_r7b":
        content = text
        act = _CR7B_ACTION_RE.search(text)
        if act:
            try:
                for obj in json.loads(act.group(1)):
                    _mk_call(obj.get("tool_name", ""),
                             obj.get("parameters", {}), calls)
            except json.JSONDecodeError:
                pass
            content = ""
        else:
            resp = _CR7B_RESPONSE_RE.search(text)
            if resp:
                content = resp.group(1).strip()
    elif fmt == "firefunction_v2":
        # " functools[{...}, ...]" prefixed JSON call array (reference
        # common_chat_parse_firefunction_v2, common/chat.cpp:1192)
        content = text
        idx = text.find("functools[")
        if idx >= 0:
            arr = _parse_json_prefix(text[idx + len("functools"):])
            if arr and isinstance(arr[0], list):
                for obj in arr[0]:
                    if isinstance(obj, dict) and obj.get("name"):
                        _mk_call(obj["name"], obj.get("arguments", {}),
                                 calls)
                if calls:
                    content = text[:idx].rstrip()
    else:  # generic / mistral_nemo ride the shared extractor
        content, calls = parse_tool_calls(text)
    return {"content": content, "tool_calls": calls,
            "reasoning_content": reasoning}


# -- SSE streaming ------------------------------------------------------------

# per-format markup that may START a tool-call section: while the pending
# text could still be a prefix of one of these, it is held back from the
# content stream (common_chat_msg_parser's partial-parse holdback,
# reference common/chat-parser.cpp); once one fully appears, everything
# from it on is buffered for the end-of-stream authoritative parse
_STREAM_TRIGGERS = {
    "generic": ("<tool_call>", "[TOOL_CALLS]", "{"),
    "auto": ("<tool_call>", "[TOOL_CALLS]", "{"),
    "mistral_nemo": ("[TOOL_CALLS]",),
    "llama_3_x": ("{",),
    "llama_3_x_builtin": ("{", "<|python_tag|>"),
    "deepseek_r1": ("<｜tool▁calls▁begin｜>", "<｜tool_calls_begin｜>",
                    "<｜tool calls begin｜>"),
    "hermes_2_pro": ("<tool_call>",),
    "functionary_v3_2": (">>>",),
    "functionary_v3_1": ("<function=", "<|python_tag|>"),
    "firefunction_v2": (" functools[", "functools["),
    "command_r7b": ("<|START_ACTION|>",),
    "content_only": (),
}
# markup that wraps plain content and is dropped from the stream in place
_STREAM_STRIP = {
    "command_r7b": ("<|START_RESPONSE|>", "<|END_RESPONSE|>"),
}
_THINK_OPEN = {"<think>": "</think>",
               "<|START_THINKING|>": "<|END_THINKING|>"}


def _holdback(s: str, markers) -> tuple[str, str]:
    """Split s into (emit, keep): keep is the longest suffix of s that is a
    PROPER prefix of any marker (may still grow into one)."""
    maxk = max((len(m) for m in markers), default=1) - 1
    for k in range(min(len(s), maxk), 0, -1):
        suf = s[-k:]
        if any(m.startswith(suf) and k < len(m) for m in markers):
            return s[:-k], suf
    return s, ""


class StreamParser:
    """Incremental assistant-output parsing for SSE chat streaming.

    feed(piece) returns delta dicts ({"content": ...} or
    {"reasoning_content": ...}) safe to emit NOW; tool-call markup never
    leaks into the stream. finish() runs parse_assistant_message over the
    full text — the single source of truth — and returns the trailing
    deltas (anything held back that turned out to be plain content) plus
    the parsed message, mirroring the reference's end-of-stream
    common_chat_msg_diff against the partially-streamed message."""

    # formats whose tool-call bodies carry a JSON arguments OBJECT whose
    # raw text can stream as OpenAI-style argument fragments (the
    # reference's incremental common_chat_msg_diff); functionary/command
    # formats wrap args in non-JSON markup and stay whole-call-at-finish
    _ARG_STREAM_FMTS = ("hermes_2_pro", "mistral_nemo", "firefunction_v2",
                        "generic", "auto", "llama_3_x")
    _TC_NAME_RE = re.compile(
        r'"name"\s*:\s*"((?:[^"\\]|\\.)*)"')
    _TC_ARGS_RE = re.compile(r'"(?:arguments|parameters)"\s*:\s*\{')

    def __init__(self, fmt: str, extract_reasoning: bool = False):
        self.fmt = fmt
        self.extract = extract_reasoning
        self._raw: list[str] = []
        self._pend = ""
        self._state = "start"
        self._close = ""
        self._sent_content: list[str] = []
        self._sent_reasoning: list[str] = []
        self._markers = (tuple(_STREAM_TRIGGERS.get(fmt,
                                                    _STREAM_TRIGGERS["generic"]))
                         + _STREAM_STRIP.get(fmt, ()))
        self._strip = set(_STREAM_STRIP.get(fmt, ()))
        # incremental tool-call state
        self._tool_buf = ""
        self._tc_scan = 0            # cursor for the next "name" search
        self._tc_args_sent: list[str] = []   # streamed raw args per call
        self._tc_open = False        # inside an args object
        self._tc_pos = 0             # next unstreamed char of the args
        self._tc_depth = 0
        self._tc_in_str = False
        self._tc_esc = False

    def _emit(self, out, key, text):
        if text:
            out.append({key: text})
            (self._sent_content if key == "content"
             else self._sent_reasoning).append(text)

    def _tool_deltas(self, out: list[dict]) -> None:
        """Incremental OpenAI-style tool_calls deltas from the buffered
        tool section: a header delta (index/id/name) as soon as the call's
        name and its args object open are visible, then RAW argument-text
        fragments as they arrive (everything inside the args object is
        arguments by construction). finish() reconciles with the
        authoritative parse."""
        if self.fmt not in self._ARG_STREAM_FMTS:
            return
        buf = self._tool_buf
        while True:
            if not self._tc_open:
                m = self._TC_NAME_RE.search(buf, self._tc_scan)
                if not m:
                    return
                ma = self._TC_ARGS_RE.search(buf, m.end())
                if not ma:
                    return
                idx = len(self._tc_args_sent)
                out.append({"tool_calls": [{
                    "index": idx, "id": f"call_{idx}", "type": "function",
                    "function": {"name": json.loads(f'"{m.group(1)}"'),
                                 "arguments": ""}}]})
                self._tc_args_sent.append("")
                self._tc_open = True
                self._tc_pos = ma.end() - 1   # at the opening '{'
                self._tc_depth = 0
                self._tc_in_str = self._tc_esc = False
            i = self._tc_pos
            end = None
            while i < len(buf):
                c = buf[i]
                if self._tc_esc:
                    self._tc_esc = False
                elif self._tc_in_str:
                    if c == "\\":
                        self._tc_esc = True
                    elif c == '"':
                        self._tc_in_str = False
                elif c == '"':
                    self._tc_in_str = True
                elif c == "{":
                    self._tc_depth += 1
                elif c == "}":
                    self._tc_depth -= 1
                    if self._tc_depth == 0:
                        end = i + 1
                        i = end
                        break
                i += 1
            frag = buf[self._tc_pos:i]
            if frag:
                self._tc_args_sent[-1] += frag
                out.append({"tool_calls": [{
                    "index": len(self._tc_args_sent) - 1,
                    "function": {"arguments": frag}}]})
            self._tc_pos = i
            if end is None:
                return
            self._tc_open = False
            self._tc_scan = end

    def feed(self, piece: str) -> list[dict]:
        piece = piece or ""
        self._raw.append(piece)
        if self._state == "tool":
            self._tool_buf += piece
            out: list[dict] = []
            self._tool_deltas(out)
            return out
        self._pend += piece
        out: list[dict] = []
        progress = True
        while progress:
            progress = False
            if self._state == "start":
                s = self._pend.lstrip()
                if not s:
                    break
                if self.fmt == "functionary_v3_2":
                    # leading ">>>all\n" / "all\n" section header is markup
                    if "all\n".startswith(s):
                        break
                    if s.startswith("all\n"):
                        self._pend = s[4:]
                        progress = True
                        continue
                opens = _THINK_OPEN if self.extract else {}
                if any(o.startswith(s) for o in opens):
                    break  # may still become a think tag
                hit = next((o for o in opens if s.startswith(o)), None)
                if hit:
                    self._state = "reasoning"
                    self._close = _THINK_OPEN[hit]
                    self._pend = s[len(hit):]
                else:
                    self._state = "content"
                progress = True
            elif self._state == "reasoning":
                i = self._pend.find(self._close)
                if i >= 0:
                    self._emit(out, "reasoning_content", self._pend[:i])
                    self._pend = self._pend[i + len(self._close):]
                    self._state = "content"
                    progress = True
                else:
                    emit, keep = _holdback(self._pend, (self._close,))
                    self._emit(out, "reasoning_content", emit)
                    self._pend = keep
            elif self._state == "content":
                first = None
                for mk in self._markers:
                    i = self._pend.find(mk)
                    if i >= 0 and (first is None or i < first[0]):
                        first = (i, mk)
                if first is not None:
                    i, mk = first
                    self._emit(out, "content", self._pend[:i])
                    if mk in self._strip:
                        self._pend = self._pend[i + len(mk):]
                        progress = True
                    else:
                        self._state = "tool"
                        # seed the tool buffer with the marker onward so
                        # argument fragments stream from this very piece
                        self._tool_buf = self._pend[i:]
                        self._pend = ""
                        self._tool_deltas(out)
                else:
                    emit, keep = _holdback(self._pend, self._markers)
                    self._emit(out, "content", emit)
                    self._pend = keep
        return out

    def finish(self) -> tuple[list[dict], dict]:
        parsed = parse_assistant_message("".join(self._raw), self.fmt,
                                         extract_reasoning=self.extract)
        out: list[dict] = []
        for key, sent in (("reasoning_content", self._sent_reasoning),
                          ("content", self._sent_content)):
            done = "".join(sent)
            full = parsed[key] or ""
            if full.startswith(done) and len(full) > len(done):
                out.append({key: full[len(done):]})
        # reconcile streamed argument fragments with the authoritative
        # parse (the reference's end-of-stream common_chat_msg_diff):
        # stream any unshipped remainder; calls never streamed (unsupported
        # formats / late markup) arrive whole here
        for i, call in enumerate(parsed.get("tool_calls") or []):
            full_args = call["function"]["arguments"]
            if i < len(self._tc_args_sent):
                done = self._tc_args_sent[i]
                if full_args.startswith(done):
                    if len(full_args) > len(done):
                        out.append({"tool_calls": [{
                            "index": i,
                            "function": {"arguments":
                                         full_args[len(done):]}}]})
                else:
                    # normalization-only mismatch (the parser re-dumps the
                    # JSON): keep the STREAMED raw text authoritative when
                    # it decodes to the same object, so stream and final
                    # message agree
                    try:
                        if json.loads(done) == json.loads(full_args):
                            call["function"]["arguments"] = done
                    except (json.JSONDecodeError, ValueError):
                        pass
            else:
                out.append({"tool_calls": [{
                    "index": i, "id": call.get("id", f"call_{i}"),
                    "type": "function",
                    "function": {"name": call["function"]["name"],
                                 "arguments": ""}}]})
                if full_args:
                    out.append({"tool_calls": [{
                        "index": i,
                        "function": {"arguments": full_args}}]})
        return out, parsed
