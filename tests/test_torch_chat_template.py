"""The port's chat templating (llama_cpp_test_tpu_torch/server/chat.py)
against the JAX package's server/chat.py: every case of
tests/test_chat_template.py runs once against each package's module
(the test file's source with its import path pointed at the package),
and the two modules give equal outputs from every builtin template, the
Jinja path and its fallback, parse_assistant_message and StreamParser."""
import pathlib
import sys
import types

import pytest

from llama_cpp_test_tpu.server import chat as jchat
from llama_cpp_test_tpu_torch.server import chat as pchat

_CASES = pathlib.Path(__file__).with_name("test_chat_template.py")


def _cases_for(package: str) -> types.ModuleType:
    """tests/test_chat_template.py compiled with every import of the chat
    module taken from `package`."""
    src = _CASES.read_text().replace("llama_cpp_test_tpu.server.chat",
                                     f"{package}.server.chat")
    mod = types.ModuleType(f"_chat_cases_{package}")
    mod.__file__ = str(_CASES)
    sys.modules[mod.__name__] = mod
    exec(compile(src, str(_CASES), "exec"), mod.__dict__)
    return mod


for _pkg, _tag in (("llama_cpp_test_tpu", "jax"),
                   ("llama_cpp_test_tpu_torch", "torch")):
    _mod = _cases_for(_pkg)
    for _name, _fn in list(vars(_mod).items()):
        if _name.startswith("test_") and callable(_fn):
            globals()[f"test_{_tag}_{_name[5:]}"] = _fn

MSGS = [
    {"role": "system", "content": "You are helpful."},
    {"role": "user", "content": "Hi"},
    {"role": "assistant", "content": "Hello"},
    {"role": "user", "content": "Bye"},
]
TOOLS = [{"type": "function", "function": {
    "name": "get_weather", "description": "weather",
    "parameters": {"type": "object",
                   "properties": {"city": {"type": "string"}}}}}]
JINJA = ("{% for m in messages %}<|{{ m['role'] }}|>{{ m['content'] }}"
         "{{ eos_token }}{% endfor %}{% if add_generation_prompt %}"
         "<|assistant|>{% endif %}{% if tools %}[{{ tools|length }} tools]"
         "{% endif %}")
META = {"tokenizer.ggml.tokens": ["<unk>", "<s>", "</s>"],
        "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2}


def test_module_is_a_copy():
    assert sorted(pchat._BUILTINS) == sorted(jchat._BUILTINS)


@pytest.mark.parametrize("name", sorted(jchat._BUILTINS))
def test_builtin_outputs_equal(name):
    for gen in (True, False):
        assert pchat._BUILTINS[name](MSGS, gen) == \
            jchat._BUILTINS[name](MSGS, gen)


@pytest.mark.parametrize("template,tools", [
    (JINJA, None), (JINJA, TOOLS),
    ("{% for m in messages %}{{ m.content }{% endfor %}", None),  # broken
    ("zephyr", None), ("no-such-template", None), (None, None)])
def test_apply_chat_template_outputs_equal(template, tools):
    kw = {"template_override": template, "tools": tools}
    assert pchat.apply_chat_template(META, MSGS, **kw) == \
        jchat.apply_chat_template(META, MSGS, **kw)


_OUTPUTS = [
    ("plain words, no call", "content_only"),
    ('<tool_call>{"name": "f", "arguments": {"a": 1}}</tool_call>',
     "hermes_2_pro"),
    ('[TOOL_CALLS][{"name": "g", "arguments": {"b": 2}}]', "mistral_nemo"),
    ('{"name": "get_weather", "parameters": {"city": "Oslo"}}', "llama_3_x"),
    ("<think>step one.</think>The answer is 4.", "deepseek_r1"),
    ("<|START_THINKING|>hm<|END_THINKING|><|START_RESPONSE|>hi there"
     "<|END_RESPONSE|>", "command_r7b"),
    ('>>>get_weather\n{"city": "Oslo"}', "functionary_v3_2"),
    ('<function=get_weather>{"city": "Oslo"}</function>',
     "functionary_v3_1_llama_3_1"),
]


@pytest.mark.parametrize("text,fmt", _OUTPUTS)
def test_parsers_equal(text, fmt):
    for extract in (True, False):
        assert pchat.parse_assistant_message(text, fmt, extract) == \
            jchat.parse_assistant_message(text, fmt, extract)
    assert pchat.parse_tool_calls(text) == jchat.parse_tool_calls(text)
    for chunk in (1, 4, 50):
        got, want = [], []
        for mod, out in ((pchat, got), (jchat, want)):
            p = mod.StreamParser(fmt, True)
            for i in range(0, len(text), chunk):
                out.extend(p.feed(text[i:i + chunk]))
            out.append(p.finish())
        assert got == want


def test_detection_equal():
    for src in ("<|im_start|>", "[INST]", "<|start_header_id|>", JINJA, ""):
        assert pchat.detect_template(src) == jchat.detect_template(src)
        assert pchat.detect_tool_format(src) == jchat.detect_tool_format(src)
