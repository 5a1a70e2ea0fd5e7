"""OpenAI-compatible HTTP server (the llama-server analogue,
reference examples/server/server.cpp).

Endpoints (mirroring server.cpp:4411-4438):
  GET  /  /index.html                 (built-in chat webui, server/webui.py)
  GET  /health /props /metrics /v1/models /slots
  POST /completion /completions /v1/completions /infill
  POST /v1/chat/completions          (chat template + SSE streaming)
  POST /embeddings /v1/embeddings /rerank /v1/rerank
  POST /tokenize /detokenize /apply-template

Architecture: aiohttp front end; a dedicated engine thread runs the
continuous-batching Scheduler loop (the reference's single inference thread,
server.cpp:4501). Requests cross the boundary through a thread-safe submit
queue; streamed tokens come back over per-request asyncio queues via
call_soon_threadsafe.

Counterpart of llama_cpp_test_tpu/server/app.py over the port's engine:
the model runs on the CUDA device unless the caller passes device="cpu".
Every thread that touches the Context (the engine thread's scheduler
steps; embeddings, rerank and slot actions on executor threads) takes
EngineThread.ctx_lock and issues its work on the device's default stream,
so a chained decode window still in flight when a step returns runs
before anything another thread queues. LoRA adapters (lora=, --lora)
have hot-swappable scales (POST /lora-adapters): the new scales attach
under ctx_lock, between two scheduler steps, and a window already queued
keeps the tensors it was queued with. A recurrent file (mamba, rwkv6,
rwkv6qwen2, rwkv7, arwkv7) is served by the same Scheduler over a
runtime/recurrent.RecurrentContext state pool: a draft model, LoRA
adapters or followers raise ValueError, and /embeddings and slot
save/restore answer 400. A t5, t5encoder or wavtokenizer-dec file raises
ValueError naming its loader (models/registry.NOT_PAGED), as the
reference's server raises through Model: neither server hosts an
encoder-decoder or a vocoder. Multi-device serving (ROADMAP item 13)
raises NotImplementedError. An encoder (bert, nomic-bert,
jina-bert-v2) serves /v1/embeddings and /rerank with its own pooling and
causality; its n_ctx is cut to a learned position table (fit_n_ctx), and
a generation request answers 400, as it has no LM head (the reference's
engine thread dies on it, ROADMAP §3 fault 22).

Usage:
  python -m llama_cpp_test_tpu_torch.server.app -m model.gguf --port 8080
"""
from __future__ import annotations

import asyncio
import json
import threading
import time
import uuid

from ..runtime.engine import Context, Model, fit_n_ctx
from ..runtime.sampling import SamplerParams
from ..runtime.scheduler import GenRequest, Scheduler
from .chat import apply_chat_template

try:  # the package imports without aiohttp; serving needs it
    from aiohttp import web
except ImportError:  # pragma: no cover
    web = None


class EngineThread:
    """Single inference thread driving the scheduler."""

    def __init__(self, scheduler: Scheduler):
        self.sched = scheduler
        self._wake = threading.Event()
        self._stop = False
        self._lock = threading.Lock()
        # serializes all Context access (scheduler steps vs. embed calls)
        self.ctx_lock = threading.Lock()
        self._pending: list[GenRequest] = []
        self.thread = threading.Thread(target=self._loop, daemon=True)

    def start(self):
        self.thread.start()

    def stop(self):
        self._stop = True
        self._wake.set()
        self.thread.join(timeout=30)

    def submit(self, req: GenRequest) -> None:
        with self._lock:
            self._pending.append(req)
        self._wake.set()

    def _loop(self):
        while not self._stop:
            with self._lock:
                for r in self._pending:
                    self.sched.submit(r)
                self._pending.clear()
            if self.sched.has_work():
                with self.ctx_lock:
                    self.sched.step()
            else:
                self._wake.wait(timeout=0.05)
                self._wake.clear()


def _sampling_from_body(body: dict) -> SamplerParams:
    p = SamplerParams()
    m = {
        "temperature": "temp", "top_k": "top_k", "top_p": "top_p",
        "min_p": "min_p", "typical_p": "typ_p", "seed": "seed",
        "repeat_penalty": "penalty_repeat", "repeat_last_n": "penalty_last_n",
        "frequency_penalty": "penalty_freq", "presence_penalty": "penalty_present",
        "mirostat": "mirostat", "mirostat_tau": "mirostat_tau",
        "mirostat_eta": "mirostat_eta", "xtc_probability": "xtc_probability",
        "xtc_threshold": "xtc_threshold", "dry_multiplier": "dry_multiplier",
        "dry_base": "dry_base", "top_n_sigma": "top_n_sigma",
    }
    for k, attr in m.items():
        if k in body and body[k] is not None:
            setattr(p, attr, type(getattr(p, attr))(body[k]))
    if "logit_bias" in body and body["logit_bias"]:
        p.logit_bias = {int(k): float(v) for k, v in body["logit_bias"].items()}
    if body.get("grammar"):
        p.grammar = str(body["grammar"])
        # lazy triggers (server.cpp grammar_lazy + grammar_triggers)
        p.grammar_lazy = bool(body.get("grammar_lazy", False))
        words, toks, pats = [], [], []
        for trig in body.get("grammar_triggers") or []:
            t = trig.get("type", "word")
            if t in ("word", 1):
                words.append(str(trig["value"]))
            elif t in ("token", 0):
                toks.append(int(trig["value"]))
            else:  # pattern / pattern_full
                pats.append(str(trig["value"]))
        p.grammar_trigger_words = tuple(words)
        p.grammar_trigger_tokens = tuple(toks)
        p.grammar_trigger_patterns = tuple(pats)
    elif (body.get("response_format") or {}).get("type") == "json_object":
        from ..runtime.json_schema import JSON_GBNF

        p.grammar = JSON_GBNF
    elif (body.get("response_format") or {}).get("type") == "json_schema":
        from ..runtime.json_schema import schema_to_gbnf

        schema = (body["response_format"].get("json_schema") or {}).get(
            "schema") or body["response_format"].get("schema") or {}
        p.grammar = schema_to_gbnf(schema)
    return p


class LlamaServer:
    def __init__(self, model_path: str, n_ctx: int = 2048, n_slots: int = 4,
                 model_alias: str | None = None,
                 kv_type: str = "bf16", slot_save_path: str | None = None,
                 api_key: str | None = None,
                 lora: list[tuple[str, float]] | None = None,
                 draft_model_path: str | None = None, n_draft: int = 8,
                 p_draft_min: float = 0.75, cache_reuse: int = 0,
                 kv_overrides: dict | None = None,
                 chat_template: str | None = None, followers=None,
                 device=None):
        from ..gguf.reader import open_gguf
        from ..models.registry import RECURRENT, check_arch

        arch = open_gguf(model_path).metadata.get("general.architecture",
                                                  "llama")
        # a recurrent model (state-space / rwkv) rides a state pool behind
        # the same Scheduler and endpoints (runtime/recurrent.py, the
        # reference's recurrent-cache mode)
        self.recurrent = arch in RECURRENT
        if self.recurrent and followers is not None:
            raise ValueError("recurrent models run single-device")
        if self.recurrent and (draft_model_path or lora):
            raise ValueError("draft models / LoRA are not supported for "
                             "recurrent models")
        if not self.recurrent:
            check_arch(arch)
        if followers is not None:
            raise NotImplementedError(
                "multi-host serving is not ported yet (ROADMAP item 13)")
        if self.recurrent:
            from ..runtime.recurrent import RecurrentContext, classes

            self.model = classes(arch)[0](model_path, device=device)
            ctx = RecurrentContext(self.model, n_ctx=n_ctx,
                                   n_seq_max=n_slots)
        else:
            self.model = Model(model_path, device=device,
                               kv_overrides=kv_overrides)
            n_ctx = fit_n_ctx(self.model, n_ctx)
            ctx = Context(self.model, n_ctx=n_ctx, n_seq_max=n_slots,
                          kv_type=kv_type)
        # --chat-template: force a builtin template name or jinja source
        self.chat_template = chat_template
        self.alias = model_alias or model_path.rsplit("/", 1)[-1]
        draft_ctx = None
        if draft_model_path:
            # server-side speculative decoding (-md analogue, reference
            # server.cpp:1861-1937): one draft context shared by all slots
            self.draft_model = Model(draft_model_path, device=device)
            draft_ctx = Context(self.draft_model, n_ctx=n_ctx,
                                n_seq_max=n_slots)
        self.sched = Scheduler(ctx, n_slots=n_slots, draft_ctx=draft_ctx,
                               n_draft=n_draft, p_draft_min=p_draft_min,
                               cache_reuse=cache_reuse)
        self.engine = EngineThread(self.sched)
        self.t_start = time.time()
        self.slot_save_path = slot_save_path
        self.api_key = api_key
        # LoRA adapters with hot-swappable scales (server /lora-adapters)
        self.loras: list[dict] = []
        if lora:
            from ..models.lora import load_lora

            for i, (path, scale) in enumerate(lora):
                self.loras.append({"id": i, "path": path, "scale": scale,
                                   "adapter": load_lora(path, self.model.hp)})
            with self.engine.ctx_lock:
                self._reattach_loras()

    def _reattach_loras(self) -> None:
        """Stack every adapter at its current scale onto the weights (the
        caller holds engine.ctx_lock). Each layer's .lora dict is replaced,
        not edited, so work already queued keeps the tensors it read. The
        idle slots' cached KV was computed under the old scales: it is
        dropped, so no later request reuses it as its prefix (the
        reference keeps it; ROADMAP §3, fault 10)."""
        from ..models.lora import attach_loras
        from ..runtime.scheduler import SlotState

        attach_loras(self.model.weights,
                     [(l["adapter"], l["scale"]) for l in self.loras])
        for slot in self.sched.slots:
            if slot.state == SlotState.IDLE and slot.seq is not None:
                self.sched.ctx.free_seq(slot.seq)
                slot.seq = None
                slot.cache_tokens = []

    # -- request plumbing ----------------------------------------------------

    async def _run_request(self, prompt_tokens, body, stream_cb=None):
        loop = asyncio.get_running_loop()
        done = loop.create_future()

        def on_token(tok, piece, finished):
            if stream_cb is not None:
                loop.call_soon_threadsafe(stream_cb, tok, piece, finished)
            if finished is not None:
                def _finish():
                    if not done.done():
                        done.set_result(None)
                loop.call_soon_threadsafe(_finish)

        stop = body.get("stop") or []
        if isinstance(stop, str):
            stop = [stop]
        req = GenRequest(
            prompt_tokens=prompt_tokens,
            max_tokens=int(body.get("max_tokens")
                           or body.get("n_predict") or 128),
            sampling=_sampling_from_body(body),
            stop_strings=list(stop),
            ignore_eos=bool(body.get("ignore_eos", False)),
            on_token=on_token,
        )
        self.engine.submit(req)
        await done
        return req

    def _tokenize_prompt(self, prompt) -> list[int]:
        tok = self.model.tokenizer
        if isinstance(prompt, list):
            return [int(t) for t in prompt]
        if tok is None:
            raise ValueError("model has no tokenizer; pass token ids")
        return tok.encode(prompt, add_special=True, parse_special=True)

    def _detok(self, ids) -> str:
        tok = self.model.tokenizer
        return tok.decode(ids) if tok is not None else ""

    # -- endpoints -----------------------------------------------------------

    async def index(self, request):
        """Built-in chat webui (reference examples/server/webui/, served
        by server.cpp's static handler at GET /)."""
        from .webui import INDEX_HTML

        return web.Response(text=INDEX_HTML, content_type="text/html")

    async def health(self, request):
        return web.json_response({"status": "ok"})

    async def props(self, request):
        hp = self.model.hp
        return web.json_response({
            "model_path": self.model.path,
            "n_ctx": self.sched.ctx.n_ctx,
            "total_slots": len(self.sched.slots),
            "model_alias": self.alias,
            "arch": hp.arch,
            "n_params_approx": None,
            "uptime_s": round(time.time() - self.t_start, 1),
        })

    async def models(self, request):
        return web.json_response({
            "object": "list",
            "data": [{"id": self.alias, "object": "model",
                      "created": int(self.t_start), "owned_by": "local"}],
        })

    async def metrics(self, request):
        m = self.sched.metrics()
        lines = []
        for k, v in m.items():
            lines.append(f"# TYPE llamacpp_tpu:{k} gauge")
            lines.append(f"llamacpp_tpu:{k} {v}")
        return web.Response(text="\n".join(lines) + "\n",
                            content_type="text/plain")

    async def slots(self, request):
        out = []
        for s in self.sched.slots:
            out.append({
                "id": s.id,
                "state": s.state.name,
                "n_cached": s.seq.n_cached if s.seq else 0,
            })
        return web.json_response(out)

    def slot_action(self, slot_id: int, action: str, body: dict) -> dict:
        """save | restore | erase a slot's KV cache and token prefix, under
        the Context lock (the work of POST /slots/{id}; callable without
        the HTTP front end). Raises ValueError for a bad request and
        FileNotFoundError for a missing file."""
        import os

        from ..runtime import scheduler as sched_mod
        from ..runtime import state as state_io

        slot = self.sched.slots[slot_id]
        with self.engine.ctx_lock:
            ctx = self.sched.ctx
            # a busy slot's SeqState is owned by the scheduler loop;
            # swapping it mid-generation desyncs n_prompt_done /
            # cache_tokens (the reference server defers slot actions and
            # errors on busy slots)
            if slot.state != sched_mod.SlotState.IDLE:
                raise ValueError(
                    f"slot {slot_id} is busy ({slot.state.name})")
            if action == "save":
                if slot.seq is None:
                    raise ValueError("slot holds no sequence")
                fn = str(body.get("filename") or f"slot{slot_id}.npz")
                if "/" in fn or fn.startswith("."):
                    raise ValueError("invalid filename")
                path = os.path.join(self.slot_save_path, fn)
                t0 = time.time()
                n_written = state_io.save_seq_state(ctx, slot.seq, path)
                return {"id_slot": slot_id, "filename": fn,
                        "n_saved": slot.seq.n_cached,
                        "n_written": n_written,
                        "timings": {"save_ms": round(
                            (time.time() - t0) * 1000, 2)}}
            if action == "restore":
                fn = str(body.get("filename") or f"slot{slot_id}.npz")
                if "/" in fn or fn.startswith("."):
                    raise ValueError("invalid filename")
                path = os.path.join(self.slot_save_path, fn)
                t0 = time.time()
                s = state_io.load_seq_state(ctx, path)
                if slot.seq is not None:
                    ctx.free_seq(slot.seq)
                slot.seq = s
                slot.cache_tokens = list(s.tokens)
                return {"id_slot": slot_id, "filename": fn,
                        "n_restored": s.n_cached,
                        "timings": {"restore_ms": round(
                            (time.time() - t0) * 1000, 2)}}
            if action == "erase":
                n = slot.seq.n_cached if slot.seq is not None else 0
                if slot.seq is not None:
                    ctx.free_seq(slot.seq)
                    slot.seq = None
                slot.cache_tokens = []
                return {"id_slot": slot_id, "n_erased": n}
            raise ValueError(f"unknown action {action!r}")

    async def slots_action(self, request):
        """POST /slots/{id}?action=save|restore|erase (server.cpp:4438):
        persist / reload / drop a slot's KV cache + token prefix."""
        slot_id = int(request.match_info["id"])
        action = request.query.get("action", "")
        if not (0 <= slot_id < len(self.sched.slots)):
            raise web.HTTPNotFound(text='{"error": "no such slot"}',
                                   content_type="application/json")
        if action in ("save", "restore") and self.recurrent:
            raise web.HTTPBadRequest(
                text='{"error": "slot save/restore is not supported for '
                     'recurrent models"}',
                content_type="application/json")
        if action in ("save", "restore") and not self.slot_save_path:
            raise web.HTTPBadRequest(
                text='{"error": "server started without --slot-save-path"}',
                content_type="application/json")
        body = {}
        if request.can_read_body:
            try:
                body = await request.json()
            except Exception:
                body = {}
        loop = asyncio.get_running_loop()
        try:
            out = await loop.run_in_executor(None, self.slot_action,
                                             slot_id, action, body)
        except FileNotFoundError as e:
            raise web.HTTPNotFound(
                text=json.dumps({"error": str(e)}),
                content_type="application/json")
        except ValueError as e:
            raise web.HTTPBadRequest(
                text=json.dumps({"error": str(e)}),
                content_type="application/json")
        return web.json_response(out)

    async def lora_adapters_get(self, request):
        return web.json_response([
            {"id": l["id"], "path": l["path"], "scale": l["scale"]}
            for l in self.loras])

    async def lora_adapters_post(self, request):
        """Set per-adapter scales: body [{"id": 0, "scale": 0.5}, ...]. The
        whole body is checked before any scale changes, so a bad id late in
        the list leaves every scale as it was (answered 400)."""
        body = await request.json()
        if not isinstance(body, list):
            raise web.HTTPBadRequest(
                text='{"error": "expected a JSON list"}',
                content_type="application/json")
        by_id = {l["id"]: l for l in self.loras}
        staged: dict[int, float] = {}
        for item in body:
            try:
                lid = int(item.get("id", -1))
                scale = float(item.get("scale", 1.0))
            except (AttributeError, TypeError, ValueError):
                lid, scale = -1, 0.0
            if lid not in by_id:
                raise web.HTTPBadRequest(
                    text=json.dumps(
                        {"error": f"invalid adapter entry {item}"}),
                    content_type="application/json")
            staged[lid] = scale
        if staged:
            def run():
                with self.engine.ctx_lock:
                    for lid, sc in staged.items():
                        by_id[lid]["scale"] = sc
                    self._reattach_loras()

            await asyncio.get_running_loop().run_in_executor(None, run)
        return await self.lora_adapters_get(request)

    async def tokenize(self, request):
        body = await request.json()
        ids = self._tokenize_prompt(body.get("content", ""))
        return web.json_response({"tokens": ids})

    async def detokenize(self, request):
        body = await request.json()
        return web.json_response(
            {"content": self._detok(body.get("tokens", []))})

    async def apply_template(self, request):
        body = await request.json()
        prompt = apply_chat_template(self.model.reader.metadata,
                                     body.get("messages", []),
                                     template_override=self.chat_template)
        return web.json_response({"prompt": prompt})

    async def embeddings(self, request):
        """OpenAI /v1/embeddings + llama.cpp /embeddings."""
        body = await request.json()
        inputs = body.get("input") or body.get("content") or ""
        if isinstance(inputs, (str, list)) and (
                not isinstance(inputs, list) or
                (inputs and isinstance(inputs[0], int))):
            inputs = [inputs]
        # None = the model's own default (bert: non-causal CLS; decoders:
        # causal mean) — Context.embed resolves from hparams
        pooling = body.get("pooling")
        if not hasattr(self.sched.ctx, "embed"):
            raise web.HTTPBadRequest(
                text='{"error": "embeddings are not supported for this '
                     'model architecture"}',
                content_type="application/json")
        loop = asyncio.get_running_loop()
        out = []
        for i, item in enumerate(inputs):
            toks = self._tokenize_prompt(item)
            def run(t=toks):
                with self.engine.ctx_lock:
                    return self.sched.ctx.embed(t, pooling)
            emb = await loop.run_in_executor(None, run)
            out.append({"object": "embedding", "index": i,
                        "embedding": [float(x) for x in emb]})
        return web.json_response({
            "object": "list", "data": out, "model": self.alias,
            "usage": {"prompt_tokens": sum(len(self._tokenize_prompt(x))
                                           for x in inputs)},
        })

    async def rerank(self, request):
        """Cosine-similarity rerank of documents against a query
        (the /rerank endpoint analogue, embedding-based)."""
        body = await request.json()
        query = body.get("query", "")
        docs = body.get("documents", [])
        if not hasattr(self.sched.ctx, "embed"):
            raise web.HTTPBadRequest(
                text='{"error": "rerank is not supported for this model '
                     'architecture"}',
                content_type="application/json")
        loop = asyncio.get_running_loop()

        def emb_of(text):
            toks = self._tokenize_prompt(text)
            with self.engine.ctx_lock:
                return self.sched.ctx.embed(toks)

        qv = await loop.run_in_executor(None, emb_of, query)
        results = []
        for i, doc in enumerate(docs):
            dv = await loop.run_in_executor(None, emb_of, doc)
            results.append({"index": i,
                            "relevance_score": float(qv @ dv)})
        results.sort(key=lambda r: -r["relevance_score"])
        top_n = body.get("top_n")
        if top_n:
            results = results[: int(top_n)]
        return web.json_response({"model": self.alias, "results": results})

    def _check_generates(self) -> None:
        """An encoder has no LM head: refuse a generation request before it
        reaches the engine thread."""
        if self.model.weights.output is None:
            raise web.HTTPBadRequest(
                text=json.dumps({"error": f"arch {self.model.hp.arch} is an "
                                 "encoder: it serves /v1/embeddings and "
                                 "/rerank, and has no LM head"}),
                content_type="application/json")

    def _check_prompt(self, prompt_tokens) -> None:
        """A prompt longer than n_ctx is refused before it is queued for
        the engine thread (Scheduler.submit would raise there, on the
        thread; the reference lets it through; ROADMAP §3, fault 27)."""
        n_ctx = self.sched.ctx.n_ctx
        if len(prompt_tokens) > n_ctx:
            raise web.HTTPBadRequest(
                text=json.dumps({"error": f"the prompt has "
                                 f"{len(prompt_tokens)} tokens, more than "
                                 f"the context's n_ctx={n_ctx}"}),
                content_type="application/json")

    async def completions(self, request):
        """llama.cpp-style /completion and OpenAI /v1/completions."""
        self._check_generates()
        body = await request.json()
        prompt_tokens = self._tokenize_prompt(body.get("prompt", ""))
        self._check_prompt(prompt_tokens)
        rid = f"cmpl-{uuid.uuid4().hex[:12]}"
        if body.get("stream"):
            return await self._stream_completion(
                request, body, prompt_tokens, rid, chat=False)
        req = await self._run_request(prompt_tokens, body)
        text = self._detok(req.output_tokens)
        return web.json_response({
            "id": rid, "object": "text_completion",
            "created": int(time.time()), "model": self.alias,
            "choices": [{"index": 0, "text": text,
                         "finish_reason": req.finish_reason}],
            "usage": {
                "prompt_tokens": req.n_prompt,
                "completion_tokens": len(req.output_tokens),
                "total_tokens": req.n_prompt + len(req.output_tokens),
            },
            "timings": self._timings(req),
        })

    def _fim_prompt(self, body: dict) -> list[int]:
        """Build the fill-in-the-middle prompt (reference server.cpp
        /infill handler + format_infill): PSM order
        fim_pre + prefix + fim_suf + suffix + fim_mid, with optional
        extra-context repo chunks when the vocab has repo/sep tokens."""
        tok = self.model.tokenizer
        v = tok.vocab
        if v.fim_pre_id < 0 or v.fim_suf_id < 0 or v.fim_mid_id < 0:
            raise web.HTTPBadRequest(
                text='{"error": "model lacks FIM (infill) tokens"}',
                content_type="application/json")
        ids: list[int] = []
        extra = body.get("input_extra") or []
        if extra and v.fim_rep_id >= 0:
            ids.append(v.fim_rep_id)
            for chunk in extra:
                if v.fim_sep_id >= 0:
                    ids.append(v.fim_sep_id)
                    ids.extend(tok.encode(str(chunk.get("filename", "")),
                                          add_special=False))
                ids.extend(tok.encode(str(chunk.get("text", "")),
                                      add_special=False))
        ids.append(v.fim_pre_id)
        ids.extend(tok.encode(body.get("input_prefix", ""),
                              add_special=False))
        ids.append(v.fim_suf_id)
        ids.extend(tok.encode(body.get("input_suffix", ""),
                              add_special=False))
        ids.append(v.fim_mid_id)
        if v.add_bos and (not ids or ids[0] != v.bos_id):
            ids.insert(0, v.bos_id)
        return ids

    async def infill(self, request):
        """Code-completion endpoint (reference server.cpp /infill)."""
        self._check_generates()
        body = await request.json()
        prompt_tokens = self._fim_prompt(body)
        self._check_prompt(prompt_tokens)
        rid = f"infill-{uuid.uuid4().hex[:12]}"
        if body.get("stream"):
            return await self._stream_completion(
                request, body, prompt_tokens, rid, chat=False)
        req = await self._run_request(prompt_tokens, body)
        text = self._detok(req.output_tokens)
        return web.json_response({
            "id": rid, "object": "text_completion",
            "created": int(time.time()), "model": self.alias,
            "content": text,
            "choices": [{"index": 0, "text": text,
                         "finish_reason": req.finish_reason}],
            "usage": {
                "prompt_tokens": req.n_prompt,
                "completion_tokens": len(req.output_tokens),
                "total_tokens": req.n_prompt + len(req.output_tokens),
            },
            "timings": self._timings(req),
        })

    async def chat_completions(self, request):
        self._check_generates()
        body = await request.json()
        tools = body.get("tools") or None
        prompt = apply_chat_template(
            self.model.reader.metadata, body.get("messages", []),
            template_override=self.chat_template, tools=tools)
        prompt_tokens = self._tokenize_prompt(prompt)
        self._check_prompt(prompt_tokens)
        rid = f"chatcmpl-{uuid.uuid4().hex[:12]}"
        if body.get("stream"):
            return await self._stream_completion(
                request, body, prompt_tokens, rid, chat=True)
        req = await self._run_request(prompt_tokens, body)
        text = self._detok(req.output_tokens)
        message: dict = {"role": "assistant", "content": text}
        finish = req.finish_reason
        # model-specific parsing: format sniffed from the chat template
        # (common_chat_templates_apply detection, chat.cpp:1600-1665);
        # reasoning_format='deepseek' (default, like the reference) moves
        # <think> preludes into message.reasoning_content
        from .chat import parse_assistant_message

        fmt = self._chat_fmt(body, tools)
        extract = body.get("reasoning_format", "deepseek") != "none"
        parsed = parse_assistant_message(text, fmt,
                                         extract_reasoning=extract)
        if parsed["tool_calls"] and tools:
            message = {"role": "assistant",
                       "content": parsed["content"] or None,
                       "tool_calls": parsed["tool_calls"]}
            finish = "tool_calls"
        else:
            message = {"role": "assistant", "content": parsed["content"]}
        if parsed["reasoning_content"]:
            message["reasoning_content"] = parsed["reasoning_content"]
        return web.json_response({
            "id": rid, "object": "chat.completion",
            "created": int(time.time()), "model": self.alias,
            "choices": [{"index": 0,
                         "message": message,
                         "finish_reason": finish}],
            "usage": {
                "prompt_tokens": req.n_prompt,
                "completion_tokens": len(req.output_tokens),
                "total_tokens": req.n_prompt + len(req.output_tokens),
            },
            "timings": self._timings(req),
        })

    def _chat_fmt(self, body, tools) -> str:
        """Tool-call format for this request: sniffed from the chat
        template (common_chat_templates_apply detection,
        chat.cpp:1600-1665); without tools, model-emitted tool markup is
        plain content (reference init_without_tools) but reasoning formats
        still extract."""
        from .chat import detect_tool_format

        fmt = body.get("chat_format") or detect_tool_format(
            self.model.reader.metadata.get("tokenizer.chat_template", ""))
        if not tools and fmt not in ("deepseek_r1", "command_r7b"):
            fmt = "content_only"
        return fmt

    @staticmethod
    def _timings(req: GenRequest) -> dict:
        pp = (req.t_first_token - req.t_submit) if req.t_first_token else 0
        gen = (req.t_done - req.t_first_token) if req.t_first_token else 0
        n = len(req.output_tokens)
        return {
            "prompt_ms": round(pp * 1000, 2),
            "predicted_ms": round(gen * 1000, 2),
            "predicted_per_second": round(n / gen, 2) if gen > 0 else None,
        }

    async def _stream_completion(self, request, body, prompt_tokens, rid,
                                 chat: bool):
        resp = web.StreamResponse(headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
        })
        await resp.prepare(request)
        q: asyncio.Queue = asyncio.Queue()

        def cb(tok, piece, finished):
            q.put_nowait((tok, piece, finished))

        task = asyncio.ensure_future(
            self._run_request(prompt_tokens, body, stream_cb=cb))
        obj = "chat.completion.chunk" if chat else "text_completion"
        parser = None
        tools = None
        if chat:
            # format-aware streaming: tool-call markup is held back from
            # content deltas, reasoning streams as reasoning_content, and
            # completed calls arrive as OpenAI tool_calls deltas with
            # finish_reason "tool_calls" (the reference server's
            # common_chat_msg_diff streaming)
            from .chat import StreamParser

            tools = body.get("tools") or None
            parser = StreamParser(
                self._chat_fmt(body, tools),
                body.get("reasoning_format", "deepseek") != "none")

        def mk_chunk(payload: dict, finish) -> bytes:
            chunk = {"id": rid, "object": obj,
                     "created": int(time.time()), "model": self.alias,
                     "choices": [{"index": 0, **payload,
                                  "finish_reason": finish}]}
            return f"data: {json.dumps(chunk)}\n\n".encode()

        while True:
            tok, piece, finished = await q.get()
            if not chat:
                await resp.write(mk_chunk({"text": piece or ""}, finished))
                if finished is not None:
                    break
                continue
            deltas = parser.feed(piece)
            if finished is not None:
                # finish() reconciles streamed argument fragments with the
                # authoritative parse: tail carries any unshipped argument
                # remainder plus whole deltas for never-streamed calls
                tail, parsed = parser.finish()
                deltas += tail
                if parsed["tool_calls"] and tools:
                    finished = "tool_calls"
            if not tools:
                # tools not requested: drop tool deltas, keep content
                deltas = [d for d in deltas if "tool_calls" not in d]
            for d in deltas:
                await resp.write(mk_chunk({"delta": d}, None))
            if finished is not None:
                await resp.write(mk_chunk({"delta": {}}, finished))
                break
        await resp.write(b"data: [DONE]\n\n")
        await task
        await resp.write_eof()
        return resp

    # -- app -----------------------------------------------------------------

    def _auth_middleware(self):
        """Bearer API-key check (reference server API-key security tests):
        every endpoint except /health requires Authorization: Bearer <key>."""
        @web.middleware
        async def mw(request, handler):
            # the webui itself loads without a key (the key is entered in
            # the page and sent with its API calls), matching the
            # reference server's public static assets
            if request.path in ("/health", "/", "/index.html"):
                return await handler(request)
            auth = request.headers.get("Authorization", "")
            if auth != f"Bearer {self.api_key}":
                return web.json_response(
                    {"error": {"message": "Invalid API Key",
                               "type": "authentication_error"}},
                    status=401)
            return await handler(request)

        return mw

    def make_app(self):
        middlewares = [self._auth_middleware()] if self.api_key else []
        app = web.Application(middlewares=middlewares)
        r = app.router
        r.add_get("/", self.index)
        r.add_get("/index.html", self.index)
        r.add_get("/health", self.health)
        r.add_get("/props", self.props)
        r.add_get("/metrics", self.metrics)
        r.add_get("/slots", self.slots)
        r.add_get("/v1/models", self.models)
        r.add_post("/tokenize", self.tokenize)
        r.add_post("/detokenize", self.detokenize)
        r.add_post("/apply-template", self.apply_template)
        r.add_post("/infill", self.infill)
        r.add_post("/completion", self.completions)
        r.add_post("/completions", self.completions)
        r.add_post("/v1/completions", self.completions)
        r.add_post("/v1/chat/completions", self.chat_completions)
        r.add_post("/embeddings", self.embeddings)
        r.add_post("/v1/embeddings", self.embeddings)
        r.add_post("/rerank", self.rerank)
        r.add_post("/v1/rerank", self.rerank)
        r.add_post("/slots/{id}", self.slots_action)
        r.add_get("/lora-adapters", self.lora_adapters_get)
        r.add_post("/lora-adapters", self.lora_adapters_post)
        return app

    def run(self, host: str = "127.0.0.1", port: int = 8080):
        self.engine.start()
        web.run_app(self.make_app(), host=host, port=port)


def main(argv=None, device=None):
    from ..common.args import build_parser, parse_kv_overrides

    ap = build_parser("llama-server (cuda)", examples=("server",))
    args = ap.parse_args(argv)
    loras = [(p, 1.0) for p in args.lora] + \
        [(p, float(s)) for p, s in args.lora_scaled]
    if args.coordinator or args.tensor_parallel > 1:
        raise NotImplementedError(
            "--coordinator / -tp > 1 are not ported yet (ROADMAP item 13)")
    srv = LlamaServer(args.model, n_ctx=args.ctx_size, n_slots=args.parallel,
                      model_alias=args.alias,
                      kv_type=args.cache_type_kv,
                      slot_save_path=args.slot_save_path,
                      api_key=args.api_key, lora=loras or None,
                      draft_model_path=args.model_draft,
                      n_draft=args.draft_max, p_draft_min=args.draft_p_min,
                      cache_reuse=args.cache_reuse,
                      chat_template=getattr(args, "chat_template", None),
                      kv_overrides=parse_kv_overrides(
                          getattr(args, "override_kv", None)),
                      device=device)
    srv.run(args.host, args.port)


if __name__ == "__main__":
    main()
