"""The port's OpenAI-compatible server (llama_cpp_test_tpu_torch/server/
app.py) over HTTP with the tiny model on the CPU: the scenarios of
tests/test_server.py against the port's LlamaServer, then parity with the
JAX LlamaServer on the same file (greedy /completion and
/v1/chat/completions text, /tokenize, /detokenize, /apply-template,
embeddings within the logits gate for each pooling, rerank order), and
the Scheduler's chained windows with an embed and a slot erase issued
between two of them. Every request waits with a bounded timeout and every
fixture stops its engine thread."""
import asyncio
import json

import numpy as np
import pytest
import torch

aiohttp = pytest.importorskip("aiohttp")
from aiohttp.test_utils import TestClient, TestServer  # noqa: E402

from test_engine import make_tiny_gguf, nmse  # noqa: E402

from llama_cpp_test_tpu.server import app as japp  # noqa: E402
from llama_cpp_test_tpu_torch.server import app as papp  # noqa: E402

LOGITS_GATE = 2e-3   # tests/test_engine.py:225
TIMEOUT = 60         # seconds a request may take


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist every
    worker's OpenMP pool takes all cores, and the small steps these
    scenarios run by the hundred spin against each other (a 13 s module
    took minutes beside five other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
# TinyLlama-1.1B-Chat's published (zephyr-style) tokenizer.chat_template
ZEPHYR = (
    "{% for message in messages %}\n{% if message['role'] == 'user' %}\n"
    "{{ '<|user|>\\n' + message['content'] + eos_token }}\n"
    "{% elif message['role'] == 'system' %}\n"
    "{{ '<|system|>\\n' + message['content'] + eos_token }}\n"
    "{% elif message['role'] == 'assistant' %}\n"
    "{{ '<|assistant|>\\n'  + message['content'] + eos_token }}\n"
    "{% endif %}\n{% if loop.last and add_generation_prompt %}\n"
    "{{ '<|assistant|>' }}\n{% endif %}\n{% endfor %}")


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("srv") / "tiny.gguf")
    make_tiny_gguf(p)
    return p


def stop(srv):
    srv.engine.stop()
    assert not srv.engine.thread.is_alive()


@pytest.fixture(scope="module")
def server(path):
    srv = papp.LlamaServer(path, n_ctx=64, n_slots=2, device="cpu")
    srv.engine.start()
    yield srv
    stop(srv)


@pytest.fixture(scope="module")
def jserver(path):
    srv = japp.LlamaServer(path, n_ctx=64, n_slots=2)
    srv.engine.start()
    yield srv
    stop(srv)


class Client:
    """A TestClient on its own event loop; call(coro_fn) runs
    coro_fn(client) with the request timeout."""

    def __init__(self, srv):
        self.loop = asyncio.new_event_loop()

        async def make():
            c = TestClient(TestServer(srv.make_app()))
            await c.start_server()
            return c

        self.c = self.loop.run_until_complete(make())

    def call(self, fn):
        return self.loop.run_until_complete(
            asyncio.wait_for(fn(self.c), TIMEOUT))

    def post(self, url, body=None, **kw):
        async def go(c):
            r = await c.post(url, json=body, **kw)
            return r.status, await r.text()
        status, text = self.call(go)
        return status, (json.loads(text) if text.startswith(("{", "["))
                        else text)

    def close(self):
        self.loop.run_until_complete(self.c.close())
        self.loop.close()


@pytest.fixture()
def client(server):
    c = Client(server)
    yield c
    c.close()


@pytest.fixture()
def jclient(jserver):
    c = Client(jserver)
    yield c
    c.close()


def sse(c, url, body) -> list:
    async def go(cl):
        r = await cl.post(url, json=body)
        assert r.status == 200
        out = []
        async for line in r.content:
            line = line.decode().strip()
            if line.startswith("data: ") and line != "data: [DONE]":
                out.append(json.loads(line[6:]))
        return out
    return c.call(go)


# ---------------------------------------------------------------------------
# the scenarios of tests/test_server.py


def test_health_props_models(client):
    async def go(c):
        r = await c.get("/health")
        assert r.status == 200 and (await r.json())["status"] == "ok"
        body = await (await c.get("/props")).json()
        assert body["n_ctx"] == 64 and body["total_slots"] == 2
        body = await (await c.get("/v1/models")).json()
        assert body["data"][0]["object"] == "model"
        for url in ("/", "/index.html"):
            r = await c.get(url)
            assert r.status == 200
            assert "text/html" in r.headers["Content-Type"]
            assert "/v1/chat/completions" in await r.text()
    client.call(go)


def test_completion_with_token_prompt(client):
    body = {"prompt": [3, 17, 42], "max_tokens": 6, "temperature": 0.0,
            "ignore_eos": True}
    s1, b1 = client.post("/v1/completions", body)
    s2, b2 = client.post("/v1/completions", body)
    assert s1 == s2 == 200
    assert b1["choices"][0]["finish_reason"] in ("stop", "length")
    assert b1["usage"]["prompt_tokens"] == 3
    assert 1 <= b1["usage"]["completion_tokens"] <= 6
    assert b1["usage"] == b2["usage"]
    assert b1["choices"][0]["text"] == b2["choices"][0]["text"]


def test_prompt_longer_than_n_ctx_answers_400_and_serving_goes_on(client):
    """Reference fault 27: an 80-token prompt on the n_ctx = 64 fixture is
    refused with a 400 that names n_ctx before it reaches the engine
    thread, which goes on serving (the JAX server's thread ends on it)."""
    status, body = client.post("/v1/completions", {
        "prompt": list(range(3, 83)), "max_tokens": 4, "temperature": 0.0})
    assert status == 400 and "n_ctx=64" in body["error"]
    status, body = client.post("/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hello world " * 40}],
        "max_tokens": 4, "stream": True})
    assert status == 400 and "n_ctx=64" in body["error"]
    status, body = client.post("/v1/completions", {
        "prompt": [3, 17, 42], "max_tokens": 4, "temperature": 0.0,
        "ignore_eos": True})
    assert status == 200 and body["usage"]["completion_tokens"] == 4


def test_streaming(client):
    """The streamed pieces, concatenated, equal the unstreamed text."""
    body = {"prompt": "hello world", "max_tokens": 8, "temperature": 0.0,
            "ignore_eos": True}
    chunks = sse(client, "/completion", {**body, "stream": True})
    assert chunks and chunks[-1]["choices"][0]["finish_reason"] is not None
    _, whole = client.post("/completion", body)
    assert "".join(ch["choices"][0]["text"] for ch in chunks) == \
        whole["choices"][0]["text"]


def test_metrics_and_slots(client):
    async def go(c):
        text = await (await c.get("/metrics")).text()
        assert "llamacpp_tpu:gen_tokens_processed" in text
        assert len(await (await c.get("/slots")).json()) == 2
    client.call(go)


def test_concurrent_completions(client):
    """Four requests over two slots at once: each equals the same request
    sent alone."""
    def body(i):
        return {"prompt": [3, 17, 40 + i], "max_tokens": 4,
                "temperature": 0.0, "ignore_eos": True}

    async def go(c):
        async def one(i):
            return await (await c.post("/v1/completions", json=body(i))).json()
        return await asyncio.gather(*(one(i) for i in range(4)))

    together = client.call(go)
    for i, b in enumerate(together):
        assert b["choices"][0]["finish_reason"] is not None
        assert b["choices"][0]["text"] == \
            client.post("/v1/completions", body(i))[1]["choices"][0]["text"]


def test_concurrent_completions_and_embeddings_stress(client):
    """Completions on the engine thread and embeddings on executor threads
    share one Context under ctx_lock: sixteen requests at once, with the
    interpreter switching threads every microsecond, each give what they
    give alone."""
    import sys

    comp = [{"prompt": [3, 17, 40 + i], "max_tokens": 5, "temperature": 0.0,
             "ignore_eos": True} for i in range(8)]
    emb = [{"input": [5, 9, 11 + i, 4]} for i in range(8)]
    alone = [client.post("/completion", b)[1]["choices"][0]["text"]
             for b in comp] + [client.post("/v1/embeddings", b)[1]["data"][0]
                               ["embedding"] for b in emb]

    async def go(c):
        async def one(url, b):
            return await (await c.post(url, json=b)).json()
        return await asyncio.gather(
            *[one("/completion", b) for b in comp],
            *[one("/v1/embeddings", b) for b in emb])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        together = client.call(go)
    finally:
        sys.setswitchinterval(old)
    got = [b["choices"][0]["text"] for b in together[:8]] + \
        [b["data"][0]["embedding"] for b in together[8:]]
    assert got == alone


def test_embeddings_and_rerank(client):
    _, b1 = client.post("/v1/embeddings", {"input": [3, 17, 42]})
    emb = np.asarray(b1["data"][0]["embedding"])
    assert abs(float(np.linalg.norm(emb)) - 1.0) < 1e-3
    _, b2 = client.post("/v1/embeddings", {"input": [3, 17, 42]})
    assert np.allclose(emb, b2["data"][0]["embedding"], atol=1e-5)
    _, body = client.post("/rerank", {"query": "hello",
                                      "documents": ["hello", "zzz qqq"]})
    res = body["results"]
    assert len(res) == 2 and res[0]["index"] == 0
    assert res[0]["relevance_score"] >= res[1]["relevance_score"]


def test_infill_endpoint(client, server):
    v = server.model.tokenizer.vocab
    old = (v.fim_pre_id, v.fim_suf_id, v.fim_mid_id)
    v.fim_pre_id, v.fim_suf_id, v.fim_mid_id = 1, 2, 0
    try:
        status, body = client.post("/infill", {
            "input_prefix": "def add(a, b):\n", "input_suffix": "\n",
            "n_predict": 4, "temperature": 0.0})
    finally:
        v.fim_pre_id, v.fim_suf_id, v.fim_mid_id = old
    assert status == 200 and "content" in body
    assert body["usage"]["completion_tokens"] > 0


def test_infill_missing_fim_tokens(client):
    assert client.post("/infill", {"input_prefix": "x",
                                   "input_suffix": "y"})[0] == 400


def test_slot_save_restore_erase(client, server, tmp_path):
    """/slots/{id}?action=save|restore|erase: the restored slot's next
    request reuses the restored prefix and continues as without save."""
    server.slot_save_path = str(tmp_path)
    body = {"prompt": [3, 5, 7, 9], "n_predict": 3, "temperature": 0.0}
    try:
        assert client.post("/completion", body)[0] == 200
        slot = next(i for i, s in enumerate(server.sched.slots)
                    if s.cache_tokens[:4] == [3, 5, 7, 9])
        status, b = client.post(f"/slots/{slot}?action=save",
                                {"filename": "s0.npz"})
        assert status == 200 and b["filename"] == "s0.npz"
        n_saved = b["n_saved"]
        assert n_saved >= 4 and b["n_written"] > 0
        status, b = client.post(f"/slots/{slot}?action=erase")
        assert status == 200 and b["n_erased"] == n_saved
        assert server.sched.slots[slot].seq is None
        status, b = client.post(f"/slots/{slot}?action=restore",
                                {"filename": "s0.npz"})
        assert status == 200 and b["n_restored"] == n_saved
        assert len(server.sched.slots[slot].cache_tokens) == n_saved
        assert client.post(f"/slots/{slot}?action=restore",
                           {"filename": "missing.npz"})[0] == 404
        assert client.post(f"/slots/{slot}?action=save",
                           {"filename": "../evil.npz"})[0] == 400
        assert client.post("/slots/99?action=erase")[0] == 404
        assert client.post(f"/slots/{slot}?action=bogus")[0] == 400
    finally:
        server.slot_save_path = None


def test_slot_save_requires_path(client, server):
    assert server.slot_save_path is None
    assert client.post("/slots/0?action=save",
                       {"filename": "x.npz"})[0] == 400


def test_lora_adapters_endpoint(path, client, tmp_path):
    """LlamaServer(lora=) lists its adapters; POST /lora-adapters changes a
    scale between two requests (at scale 0 the completion equals the
    server without an adapter, and no slot reuses KV cached under the
    old scale); a body with a bad id answers 400 and changes no scale."""
    from test_torch_lora import TINY_DIMS, write_adapter

    a1 = write_adapter(str(tmp_path / "a1.gguf"), TINY_DIMS, 2, seed=1)
    a2 = write_adapter(str(tmp_path / "a2.gguf"), TINY_DIMS, 2, seed=2,
                       targets=("attn_q", "ffn_down"))
    body = {"prompt": "hello world", "max_tokens": 8, "temperature": 0.0,
            "ignore_eos": True}
    base = client.post("/completion", body)[1]["choices"][0]["text"]
    srv = papp.LlamaServer(path, n_ctx=64, n_slots=1, device="cpu",
                           lora=[(a1, 1.0), (a2, 0.5)])
    srv.engine.start()
    c = Client(srv)
    try:
        listed = [{"id": 0, "path": a1, "scale": 1.0},
                  {"id": 1, "path": a2, "scale": 0.5}]
        assert c.call(lambda cl: _get_json(cl, "/lora-adapters")) == listed
        adapted = c.post("/completion", body)[1]["choices"][0]["text"]
        assert adapted != base
        status, out = c.post("/lora-adapters", [{"id": 0, "scale": 0.0},
                                                {"id": 1, "scale": 0.0}])
        assert status == 200 and [l["scale"] for l in out] == [0.0, 0.0]
        assert all(lw.lora == {} for lw in srv.model.weights.layers)
        assert c.post("/completion", body)[1]["choices"][0]["text"] == base
        # a bad id anywhere in the body: 400, every scale as it was
        for bad in ([{"id": 1, "scale": 2.0}, {"id": 7, "scale": 1.0}],
                    [{"id": "x"}], [3]):
            status, out = c.post("/lora-adapters", bad)
            assert status == 400 and "invalid adapter" in out["error"]
        assert [l["scale"] for l in
                c.call(lambda cl: _get_json(cl, "/lora-adapters"))] == [0, 0]
        assert c.post("/lora-adapters", {"id": 0})[0] == 400
        status, _ = c.post("/lora-adapters", [{"id": 0, "scale": 1.0},
                                              {"id": 1, "scale": 0.5}])
        assert status == 200
        assert c.post("/completion", body)[1]["choices"][0]["text"] == adapted
    finally:
        c.close()
        stop(srv)


async def _get_json(cl, url):
    return await (await cl.get(url)).json()


def test_api_key_auth(path):
    srv = papp.LlamaServer(path, n_ctx=64, n_slots=1, api_key="sk-test",
                           device="cpu")
    srv.engine.start()
    c = Client(srv)
    try:
        async def go(cl):
            assert (await cl.get("/health")).status == 200
            r = await cl.get("/")
            assert r.status == 200
            assert "text/html" in r.headers["Content-Type"]
            assert (await cl.get("/props")).status == 401
            r = await cl.post("/tokenize", json={"content": "hi"},
                              headers={"Authorization": "Bearer wrong"})
            assert r.status == 401
            r = await cl.get("/props",
                             headers={"Authorization": "Bearer sk-test"})
            assert r.status == 200
        c.call(go)
    finally:
        c.close()
        stop(srv)


@pytest.mark.parametrize("body", [
    {"grammar": 'root ::= "x"', "grammar_lazy": True, "grammar_triggers": [
        {"type": "word", "value": "<tool_call>"},
        {"type": "token", "value": 42},
        {"type": "pattern", "value": ".*?(\\{)"}]},
    {"grammar": 'root ::= "x"'},
    {"temperature": 0.7, "top_k": 5, "top_p": 0.9, "min_p": 0.1, "seed": 3,
     "repeat_penalty": 1.2, "logit_bias": {"5": -1.5}, "mirostat": 2},
    {"response_format": {"type": "json_object"}},
    {"response_format": {"type": "json_schema", "json_schema": {
        "schema": {"type": "object", "properties": {
            "a": {"type": "integer"}}, "required": ["a"]}}}},
])
def test_sampling_body_matches_reference(body):
    """_sampling_from_body gives the JAX server's SamplerParams, lazy
    grammar triggers and response formats included."""
    got, want = papp._sampling_from_body(body), japp._sampling_from_body(body)
    assert vars(got) == vars(want)
    if body.get("grammar_lazy"):
        assert got.grammar_lazy
        assert got.grammar_trigger_words == ("<tool_call>",)
        assert got.grammar_trigger_tokens == (42,)
        assert got.grammar_trigger_patterns == (".*?(\\{)",)


def test_chat_streaming_delta_shape(client):
    body = {"messages": [{"role": "user", "content": "hi"}],
            "max_tokens": 4, "temperature": 0.0, "ignore_eos": True}
    chunks = sse(client, "/v1/chat/completions", {**body, "stream": True})
    assert chunks
    assert all(ch["object"] == "chat.completion.chunk" for ch in chunks)
    assert chunks[-1]["choices"][0]["finish_reason"] is not None
    assert chunks[-1]["choices"][0]["delta"] == {}
    streamed = "".join(ch["choices"][0]["delta"].get("content", "")
                       for ch in chunks)
    _, whole = client.post("/v1/chat/completions", body)
    assert streamed == whole["choices"][0]["message"]["content"]


# ---------------------------------------------------------------------------
# parity with the JAX server


@pytest.mark.parametrize("url,body", [
    ("/completion", {"prompt": "hello world", "n_predict": 8}),
    ("/v1/completions", {"prompt": [3, 17, 42, 9, 150], "max_tokens": 8}),
    ("/v1/chat/completions", {"messages": [
        {"role": "user", "content": "hello"}], "max_tokens": 8}),
])
def test_greedy_text_matches_jax_server(client, jclient, url, body):
    body = {**body, "temperature": 0.0, "ignore_eos": True}
    (s, got), (sj, want) = client.post(url, body), jclient.post(url, body)
    assert s == sj == 200
    pick = (lambda b: b["choices"][0]["message"]["content"]) \
        if "chat" in url else (lambda b: b["choices"][0]["text"])
    assert pick(got) == pick(want)
    assert got["usage"] == want["usage"]


def test_tokenize_detokenize_apply_template_match_jax(client, jclient):
    msgs = [{"role": "user", "content": "hello world"}]
    for url, body in (("/tokenize", {"content": "hello world"}),
                      ("/detokenize", {"tokens": [3, 17, 42, 9, 150]}),
                      ("/apply-template", {"messages": msgs})):
        assert client.post(url, body) == jclient.post(url, body)


def test_chat_template_override_matches_jax(path):
    """--chat-template with TinyLlama's zephyr Jinja source: the same
    rendered prompt and the same greedy reply as the JAX server."""
    msgs = [{"role": "user", "content": "hello world"}]
    srvs = (papp.LlamaServer(path, n_ctx=64, n_slots=1, device="cpu",
                             chat_template=ZEPHYR),
            japp.LlamaServer(path, n_ctx=64, n_slots=1,
                             chat_template=ZEPHYR))
    out = []
    for srv in srvs:
        srv.engine.start()
        c = Client(srv)
        try:
            _, tpl = c.post("/apply-template", {"messages": msgs})
            _, reply = c.post("/v1/chat/completions", {
                "messages": msgs, "max_tokens": 6, "temperature": 0.0,
                "ignore_eos": True})
            out.append((tpl, reply["choices"][0]["message"]))
        finally:
            c.close()
            stop(srv)
    assert out[0] == out[1]
    assert out[0][0]["prompt"].startswith("<|user|>\nhello world")


@pytest.mark.parametrize("pooling", ["mean", "cls", "last"])
def test_embeddings_match_jax(client, jclient, pooling):
    """Each pooling within the logits gate of the JAX server's (jitted)
    embedding, at unit norm."""
    body = {"input": [[3, 17, 42, 9, 150, 7], "hello world"],
            "pooling": pooling}
    (_, got), (_, want) = client.post("/v1/embeddings", body), \
        jclient.post("/v1/embeddings", body)
    assert got["usage"] == want["usage"]
    for g, w in zip(got["data"], want["data"]):
        g, w = np.asarray(g["embedding"]), np.asarray(w["embedding"])
        assert abs(float(np.linalg.norm(g)) - 1.0) < 1e-5
        assert nmse(w, g) < LOGITS_GATE, nmse(w, g)


def test_rerank_order_matches_jax(client, jclient):
    body = {"query": "hello world",
            "documents": ["zzz qqq", "hello world", "world hello", "abc"]}
    (_, got), (_, want) = client.post("/rerank", body), \
        jclient.post("/rerank", body)
    assert [r["index"] for r in got["results"]] == \
        [r["index"] for r in want["results"]]
    assert got["results"][0]["index"] == 1


def test_unported_serving_raises(path, tmp_path):
    """An encoder-decoder file raises the reference's ValueError naming
    its model class (neither server hosts T5), and multi-device serving
    (ROADMAP item 13) raises instead of serving something else."""
    from llama_cpp_test_tpu_torch.gguf.writer import GGUFWriter

    t5 = str(tmp_path / "t5.gguf")
    GGUFWriter(t5, arch="t5").write()
    with pytest.raises(ValueError, match="models.t5.T5Model"):
        papp.LlamaServer(t5, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP item 13"):
        papp.LlamaServer(path, device="cpu", followers=[])
    for flags in (["--coordinator", "localhost:1234"], ["-tp", "2"]):
        with pytest.raises(NotImplementedError, match="ROADMAP item 13"):
            papp.main(["-m", path] + flags, device="cpu")


def test_default_device_is_cuda(path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        papp.LlamaServer(path, n_ctx=64, n_slots=1)


# ---------------------------------------------------------------------------
# engine work from other callers between two chained windows


def test_embed_and_erase_between_chained_windows(server):
    """An embed and a slot erase issued while a chained window is in
    flight (from the request's own token callback, as the server's
    executor threads would between scheduler steps) leave the request's
    tokens as they are without them, and the embed as it is alone."""
    from llama_cpp_test_tpu_torch.runtime.engine import Context
    from llama_cpp_test_tpu_torch.runtime.sampling import SamplerParams
    from llama_cpp_test_tpu_torch.runtime.scheduler import GenRequest, \
        Scheduler

    model = server.model
    alone = Context(model, n_ctx=128, n_seq_max=3, block_size=8).embed(
        [5, 6, 7, 8, 9])

    def run(interfere: bool):
        ctx = Context(model, n_ctx=128, n_seq_max=4, block_size=8)
        sched = Scheduler(ctx, n_slots=3, decode_window=4)
        greedy = SamplerParams(temp=0.0)
        for p in ([5, 6, 7], [8, 9, 10]):   # two idle slots holding a seq
            sched.submit(GenRequest(p, max_tokens=3, sampling=greedy,
                                    ignore_eos=True))
        sched.run()
        done = []

        def on_token(tok, piece, finished):
            if not interfere or finished is not None or \
                    sched.n_windows_chained <= len(done):
                return
            if not done:   # a chained window is in flight: embed
                done.append(ctx.embed([5, 6, 7, 8, 9]))
            elif len(done) == 1:   # the next chained window: erase
                idle = next(s for s in sched.slots
                            if s.req is None and s.seq is not None)
                ctx.free_seq(idle.seq)   # the erase action's work
                idle.seq, idle.cache_tokens = None, []
                done.append("erased")

        req = sched.submit(GenRequest([3, 17, 42, 9], max_tokens=24,
                                      sampling=greedy, ignore_eos=True,
                                      on_token=on_token))
        sched.run()
        return req.output_tokens, done, sched.metrics()["windows_chained"]

    want, _, _ = run(False)
    got, done, chained = run(True)
    assert chained >= 2 and len(done) == 2 and done[1] == "erased"
    assert got == want
    np.testing.assert_array_equal(done[0], alone)
