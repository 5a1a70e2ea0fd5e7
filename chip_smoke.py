#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (llama_cpp_test_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing one JSON line as it finishes; any failure exits
non-zero before the final line:

  device   nvidia-smi name/power limit, torch and CUDA versions
  build    nvcc builds every kernel under llama_cpp_test_tpu_torch/csrc;
           registers and spill bytes of every qmm_gemv, qmm_gemm,
           qmm_cache, flash_prefill (D = 64, 80, 96, 100, 128, 192, 256),
           gmm_gemv, gmm_gemm and paged_decode (D = 64, 80, 96, 100, 128,
           192, 256; bf16 and q8) instantiation (and of paged_decode's merge), and of the probe
           GEMV (kbench_gemv, pairs_gemv) and the byte stream, from ptxas -v
           (a spill fails the phase), and the atomic instructions in the
           SASS of the GEMV kernels (K1's, K4's, the probes') and the byte
           stream by cuobjdump (one fails the phase)
  kernels  each kernel against its plain PyTorch version at the main
           paths' shapes: TinyLlama-1.1B and Mixtral-8x7B, plus the widest
           Llama-3-8B ones, decode attention over ~4000 cached tokens and
           K2, K3 and K3-q8 at BitNet b1.58-3B's D = 100 (error, gate,
           kernel/plain/library times, SDPA's backend, roofline bound); one
           K1 and one K4 GEMV call, captured in a CUDA graph, must each hold
           one kernel and no memset, and give the same bits twice
  serve    a TinyLlama-1.1B-geometry Q4_K GGUF (full width, 2 of 22
           layers) synthesized from seeded random block bytes is loaded with Model(path) on cuda and serves
           three generate() requests plus one batched decode; the launch
           count of every kernel of that path must be > 0, and the logits
           at every row of a prefill and of the next decode steps are held
           against the plain path, its min rounded as the TPU kernels round
           it (the XLA path's joint rounding is recorded beside, on this
           file alone since PR 19)
  serve_moe the same for a Mixtral-8x7B-geometry MoE GGUF (full width, 1
           layer), served by two Contexts, bf16 and q8_0 KV, each with
           three generate() requests and one batched decode of 8 sequences;
           the logits gate holds the rows whose expert routing agrees with
           the plain path's, and the rows whose routing differs are counted
  serve_iq4xs  the same for a Llama-3-70B-geometry IQ4_XS GGUF (full width,
           1 layer; u4lut planes), one bf16 Context, then K1 rows on the
           loaded planes of layer 0 and the lm head at M = 1, 8, 128, 512
  serve_lowbit the same for two Llama-3-8B-geometry files (full width, 1
           layer): Q2_K (u2 planes with a min) and IQ1_S (u2lut, with
           Q4_K attn_v, IQ2_XXS ffn_down, Q5_K output, Q2_K token_embd),
           each served by a Context at the default qmm variant and one at
           "cache", whose prefills must launch K5 (qmm_cache); then K1 rows
           on each file's loaded planes (the int8 lm heads among them, at
           M = 1, 8, 128 and 512) and K5 rows at M = 130 and 512
  serve_moe_lowbit the same for three Mixtral-8x7B-geometry files (full
           width): Q2_K (1 layer; u2 expert stacks with a min), IQ1_S (1
           layers; IQ1_S gate/up stacks as u2lut, IQ2_XXS down as u4lut)
           and BF16 (1 layer; dense expert stacks), F32 router, one bf16
           Context each; K4 (gmm_gemv and gmm_gemm) must launch on u2,
           u2lut, u4lut and dense; then K4 rows on each file's layer-0
           gate and down stacks at M = 1, 8 and 512
  probes   the five kernels of the port's tools (kbench F, G, H and the
           byte stream E; pairprobe's pairs GEMV) against their plain
           versions at the probes' own shapes, with the timer's floor for
           one empty kernel beside them (one call of each, captured in a
           CUDA graph after the kernels phase, must hold one kernel and
           no memset and give the same bits twice); then both entry points
           (python -m llama_cpp_test_tpu_torch.tools.kbench / .pairprobe)
           run once in this process
  cli      llama_cpp_test_tpu_torch.cli.main -m <TinyLlama file> -p <text>
           -n 32 --temp 0, in this process on the serve phase's file (its
           synthesized SPM vocabulary): the printed
           text must equal the pieces of generate()'s greedy tokens, and K1,
           K2 and K3 must launch; then cli.perplexity -c 512 --chunks 2 on
           the same file, its perplexity within 1e-3 relative of the plain
           path's over the same chunks and K1's GEMM and K2 launched; K1's
           GEMM row of the lm head at M = 512 (prefill_nll's head)
  sched    the Scheduler on the TinyLlama file (bf16, then q8_0 KV) and on
           serve_lowbit's Llama-3-8B Q2_K file (its synthesized Llama-3 BPE
           vocabulary; the segmented candidate selector): eight requests of
           16-512 prompt tokens and 64 new ones, four greedy and four seeded
           (temp 0.8, top-k 40, top-p 0.95, min-p 0.05, repeat penalty 1.1),
           windows of 16; every greedy token must equal a per-token decode()
           replay at the same batches, a rerun must repeat every row, two
           chained windows must run with no host sync (torch.cuda sync
           debug mode "error") and no memset (torch.profiler); on TinyLlama
           bf16 a request past n_ctx must finish through shift_context, a
           shared prefix must be reused and a stop string must stop; prints
           Scheduler.metrics() and the decode wall per token of windows
           against per-token decode() at B = 1 and 8 beside the card
  server   the OpenAI-compatible server (llama_cpp_test_tpu_torch.server
           .app.LlamaServer) on the TinyLlama file and its zephyr chat
           template, over HTTP on 127.0.0.1 (aiohttp.test_utils.TestServer;
           the phase fails without aiohttp), the launch counts zeroed just
           before each request and read just after it: three greedy
           /completion requests (16, 130, 512 prompt tokens) equal
           generate() and their streamed pieces; the sched phase's eight
           requests streamed at once, a rerun repeating every row and the
           greedy rows equal to a per-token replay at the same batches; a
           chat reply equal to
           generate() on apply_chat_template's prompt; /v1/embeddings at
           16, 130 and 512 tokens (unit norm, within the logits gate of a
           plain Context, causal and not, K1's GEMM and K2 launched);
           /rerank; a request without the API key refused 401; an embed on
           another thread and a slot erase between two chained windows
           leaving a request's tokens unchanged; a 512-token slot saved,
           erased and restored at bf16 and q8_0 KV continuing with the same
           32 tokens; -md speculative serving with the file as its own
           draft and with a 4-layer draft of another seed, at one slot and
           at four, every emitted token the argmax of its verification row,
           every verification row within the logits gate of the plain
           server's logits replayed at its batch rows, greedy tokens equal
           to the plain server's (or a first difference within the two
           paths' logit difference) and the draft blocks freed. Prints the
           client's time to first token, tok/s, embed ms, save and restore
           ms and bytes, accept rates beside the card
  adapters on the TinyLlama file: a seeded rank-16 LoRA over all seven
           projections of every layer; generate() at 16, 130 and 512
           prompt tokens launches K1's GEMV and GEMM, K2 and K3 as often
           as without it, its prefill rows and 8 decode steps within the
           logits gate of the plain path carrying the same adapter and far
           from the base's, and at scale 0 the base's bits; the Scheduler
           with the adapter (greedy rows equal a per-token replay, two
           chained windows with no host sync and no memset, a scale change
           between two windows leaving the in-flight window at the old
           scale); the server's POST /lora-adapters between two requests
           (each equal to generate() at its scale; a bad id answers 400);
           cli.cvector_generator (one unit direction a layer; attached they
           move the logits, detached the logits are the base's bits);
           trace_eval within the gate of the plain path, a live
           sequence's next decode bit-equal with and without a trace;
           imatrix over 1024 tokens within the gate of the plain path;
           cli.lookahead and cli.lookup at -n 64, every token the argmax of
           its verification row and equal to plain greedy decode up to a
           first difference within the two paths' logit difference. Prints
           the decode wall with and without the adapter, imatrix tok/s and
           the drafters' tokens a pass and tok/s beside the card
  quirks   the gemma and qwen archs: Gemma-2-2B (Q4_K) and Gemma-3-1B
           (Q8_0) at published widths, depth cut to 2 and 6 of 26 layers
           (head dim 256, tied heads; Gemma-2's window 4096 on every second layer and
           softcaps 50/30, Gemma-3's window 512 on five layers of six with
           a local rope base and QK norms), Qwen2.5-0.5B (biases) and
           Qwen3-0.6B (QK norms) at published widths, 2 layers, each
           served as in serve (generate() at 16, 130 and 512 tokens; on
           the Gemma files at bf16 and q8_0 KV, 8 decode steps held to
           the plain path); on
           each Gemma file a prompt past its window (4608 and 1024
           tokens) in 512-token chunks: K2 launched once a layer a chunk,
           K3 once a global layer a decode step (1 of 2, 1 of 6; the
           windowed layers decode on the gather path), K1's GEMV 4 times
           a layer and once for the head, the logits within the plain
           path's gate; the same prompt through one Scheduler slot equal
           to its per-token replay; the sched phase's eight requests at
           bf16 KV (K3 at B = 8, D = 256) against their replay; K2, K3 and
           K3-q8 rows at D = 256
  quirks_ln the LayerNorm, parallel-residual and partial-rope archs:
           Phi-3-mini-128k (Q4_K; head dim 96, fused QKV and gate|up, long
           rope, window 262144) and Phi-2 (Q4_K; head dim 80, partial rope,
           parallel residual, biases) at published widths, 2 of 32
           layers each (cut for the smoke's clock), each
           served as in serve at bf16 and q8_0 KV (8 decode steps held to
           the plain path), a 600-token prompt at each n_ctx (Phi-3: 8192,
           the long rope table, and 2048, the short one) with K2 once a
           layer a chunk, K3 (K3-q8) once a layer a decode step (no window
           binds) and K1's GEMV four times a layer and once for the head,
           the logits within the gate; the sched phase's eight requests at
           bf16 KV against their replay; then eight 1-layer Q8_0 files at
           published widths (StableLM-2-1.6B, StarCoder2-3B, Pythia-1.4B,
           Falcon-7B, Granite-3.0-2B, OLMo-2-1124-7B, Minitron-4B,
           OLMo-1.7-7B; Command-R v01 left out for the clock), each with
           the same logits check at bf16 KV and its launch counts; K2, K3
           and K3-q8 rows at D = 80 and 96 and K3 at Falcon-7B's G = 71;
           the ptxas registers and spills of the D = 80 and 96 builds
  quirks_body the other llama-body archs: MiniCPM-2B (Q8_0: FFN 5760; the
           mup scales, tied head) at published widths and 2 of 40
           layers (cut for the smoke's clock), Command
           R7B (cohere2; Q4_K) at published widths and 4 layers (three
           sliding at window 4096, one global without rope) and BitNet
           b1.58-3B (Q8_0; D = 100, the sub-norms) at 2, each served as in
           serve at bf16 and q8_0 KV (generate() at 16, 130 and 512
           tokens, a batched decode of 8, 8 decode steps held to the plain
           path) and a path prediction at bf16 and q8_0 KV (K2 once a layer
           a chunk, K3 or K3-q8 once a global layer a step, K1's GEMV once
           a quantized plane a step); on Command R7B a 4672-token prompt
           past its window (K3 on the global layer alone) and one context
           shift at each KV type held to the plain path; then nine 1-layer
           Q8_0 files at published widths (InternLM2-7B, Baichuan2-7B,
           XVERSE-7B, Orion-14B, Qwen-7B, EXAONE-3.5-2.4B, CodeShell-7B,
           ChatGLM3-6B, PLaMo-13B), each with generate() and a batched
           decode of 8, its logits and its path prediction at bf16 KV; the
           ptxas registers and spills of the D = 100 builds
  positions the position axes: GPT-2 (1024 learned positions; 2 of 12
           layers) and BLOOM-560m (ALiBi, the embedding LayerNorm; 2 of 24
           layers), cut for the smoke's clock, at published widths as in
           quirks_body, K2 and K3 launched on GPT-2 and
           never on BLOOM (ALiBi takes the gather path, as the reference
           sends it to XLA); then five 1-layer Q8_0 files
           (StarCoderBase-1B, MPT-7B, Jais-13B, Refact-1.6B, Baichuan2-13B
           by its max_alibi_bias key) with the same checks
  encoders the bert-family encoders: BERT-base, nomic-embed-text-v1.5 and
           jina-embeddings-v2-base-en at published widths and depth (their
           WordPiece vocabularies synthesized), each at Q8_0 and Q4_K:
           pooled embeddings (CLS, mean, last) at 16, 130 and 512 tokens
           within the embedding gate of the plain path, K2 once a layer a
           512-token embed and bidirectional (none on jina: ALiBi takes
           the gather path), K1's GEMM once a projection plane, the embed
           wall; on each Q8_0 file cli.embedding's printout and the
           server's /v1/embeddings equal to Context.embed, /rerank in its
           order, a completion refused (no LM head), BERT's Context cut to
           its 512 positions; K2 bidirectional at BERT-base's T = 512
  geometry per-layer geometry and chameleon: OpenELM-270M (Q4_K; query
           heads 12-20 on KV heads 3-5, FFN widths 768-5120) at published
           widths and 4 of 16 layers as in quirks_body, with a session save and
           restore, one context shift held to the plain path and greedy
           tokens at equal batches (B = 4) against the plain path, at
           bf16 and q8_0 KV; then DeciLM-7B at 2 layers (KV heads 4 and
           2), a Llama-3.1-Nemotron-51B-width file of 3 layers
           (attention, attention-free, linear attention), Chameleon-7B at
           1 layer (QK LayerNorms with biases) and a Chameleon-34B-width
           swin-norm file at 1, each with the small files' checks at bf16
           KV (K2 and K3 once an attending layer) and greedy tokens at
           equal batches at bf16 and q8_0 KV; K3 and K3-q8 at DeciLM-7B's
           KV = 2 and OpenELM-270M's widest layer (20 on 5)
  moe_forms the other MoE forms and MLA attention: DeepSeek-V2-Lite
           (Q4_K; MLA at D = 192, a dense first layer, 64 experts top-6,
           2 shared) at published widths and 2 of 27 layers, served as in
           serve at bf16 and q8_0 KV with its path predictions (K4's GEMV
           three times a MoE layer a step), the Scheduler's greedy tokens
           and cli.main's printout equal to generate()'s; then, one at a
           time on the card: DeepSeek-V3 (Q2_K, 2 layers: sigmoid gating,
           the selection bias, 256 experts top-8), MiniCPM3-4B (MLA at D =
           96, 1 layer), Qwen1.5-MoE-A2.7B, Qwen3-30B-A3B, OLMoE-1B-7B,
           Phi-3.5-MoE and granite-3.0-3b-a800m at 1 layer and
           deepseek-moe-16b at 2 (its dense lead) (Q4_K) and DBRX at one
           (Q2_K), each with generate() and a batched decode of 8, its
           logits and its path prediction at bf16 KV (Grok-1 and Arctic
           left out for the clock); K2 at D = 192 (V2-Lite's 16 heads,
           V3's 128), K3 and K3-q8 at D = 192, K4 at top-6 of 64 and top-8
           of 128; the ptxas registers and spills
           of the D = 192 builds
  multimodal image input at published widths, driven as the llava CLI
           drives it after preprocessing (seeded arrays, no PIL):
           LLaVA-1.5-7B (CLIP ViT-L/14-336, 23 blocks, MLP projector, f16;
           the Llama-2-7B LLM at 2 of 32 layers, Q4_K) and Qwen2-VL-2B (the
           32-block tower and merger, f16, a 448 x 448 image of 256 merged
           tokens; the LLM at 4 of 28 layers, Q4_K, M-RoPE); each tower's
           encode_image within 1e-6 of itself in float64 on the card, its
           wall and busy ms against its f32 bound; each LLM's turn (text,
           prefill_embeds, text, 16 greedy decode steps) with K1's GEMV
           and GEMM, K2 and K3 launched, every step within the logits gate
           of the plain path, greedy tokens equal or first different
           within the logit difference; a profile of prefill_embeds + 8
           decode steps; K2 at Llama-2-7B's T = 576 + text and Qwen2-VL's
           256 and 512, K3 at both at B = 1 and 8, K1 at Qwen2-VL-2B's
           gate|up at M = 1 and 512
  recurrent the recurrent families, plain f32 torch (no kernel of the
           port launches: every count stays 0): Mamba-130M (24 layers),
           RWKV-6 World 1.6B (6 of 24) and RWKV-7 World 1.5B (2 of 24) at
           published widths from seeded F16 files, each loaded on the
           card and its weights copied to the CPU: a 32-token prompt and a
           16-token greedy continuation prefilled at once on both within
           NMSE 1e-6, the
           CPU's argmax the card's token at each step; a prefill of T and
           one decode against a prefill of T + 1; RecurrentContext at
           B = 4 on rows out of order after a free_seq against each
           sequence's solo Context; the Scheduler on 8 mixed requests, one
           past n_ctx (shift_context); the wall ms a decoded token at
           B = 1 and 4 and of the prefill, device busy and launches a
           token, the f32 byte bound; on Mamba-130M cli.main's printout
           and the server (/completion, a streamed chat, /embeddings and
           a slot save answering 400); then the rwkv6qwen2 and arwkv7
           branches at the CPU tests' widths
  t5       the encoder-decoder family, plain f32 torch (no kernel of the
           port launches: every count stays 0): flan-t5-base (gated-gelu,
           untied head) and t5-small (relu, the scaled tied head) at
           published widths and full depth from seeded F16 files with a
           synthesized T5 unigram vocab, and t5-small's encoder as a
           t5encoder file; each loaded on the card and its weights copied
           to the CPU: a 64-token encode on both within NMSE 1e-9; on the
           t5 files 16 greedy decoder steps on the card against the CPU fed
           the same tokens (every step within 1e-9, the CPU's argmax the
           card's token), cli.main's printout (-n 32) equal to generate()'s
           pieces; on the t5encoder file cli.main returning 1 with the
           reference's message; the encode wall and busy ms at T = 64 and
           512 against the f32 flop bound, a decoder step's wall, busy ms
           and launches at n_ctx 512 against the f32 byte bound
  tts      llama-tts: WavTokenizer-large-75 (F16, full depth) decoding 750
           seeded codes (10 s of audio) on the card, cuDNN's TF32 allowed
           as torch leaves it, and on the CPU: spectra and audio within
           NMSE 1e-9, the wall and busy ms, real-time factor and f32 flop
           bound; then OuteTTS-0.2-500M (Q8_0 at published widths, 2 of 24
           layers, vocab 157696 with OuteTTS's marks and codes) whose tied
           embedding makes greedy decoding walk 40 seeded codes, a timing
           token past the code range and <|audio_end|> (chain_rows):
           cli.tts's text-to-codes loop with K1's GEMM and GEMV, K2 and K3
           launched as the path predicts, every step within the logits
           gate of the plain path, the greedy tokens the chain; cli.tts
           end to end (the same launches; a 24 kHz WAV of 320 samples a
           kept code, within 1 LSB of decode_codes + embd_to_audio of those
           codes; the timing token dropped) and in --codes mode; K1's int8
           GEMV row at OuteTTS's 157696-row head
  quantize llama-quantize as a user runs it: TinyLlama-1.1B at published
           widths, 1 of 22 layers (cut for the smoke's clock), written
           as F16 with the synthesized SPM vocab; runtime.imatrix.main
           over a seeded text of 1100 words on the card (8 tensors, sums
           finite and positive); quant.quantize_model.main to Q4_K_M with
           that imatrix (Q4_K with Q6_K head, attn_v and ffn_down; the
           types by tensor and the seconds printed); models.llama
           .load_weights of the file timed with the native repack
           (native/ggufio.cpp) and with the numpy one, their Q4_K and
           Q6_K planes bit-equal; Model(path) on cuda: a 130-token
           prefill and 8 greedy decode steps with K1's GEMM once a layer
           plane and its GEMV once for the head in the prefill, K2 once,
           K1's GEMV once a plane and K3 once a step, the logits of every
           row within the gate of the plain path and the greedy tokens
           the plain path's (or first different within the two paths'
           logit difference); cli.gguf_split into shards of 4 tensors,
           the first loaded through Model giving the file's 16 greedy
           tokens, and the merged shards' cli.gguf_hash digests the
           file's; cli.quantize_stats -l blk.0 -t Q4_K over the F16 file
  timings  the seconds of each phase

Every file the serve phases write carries a synthesized tokenizer
(write_llama_gguf's vocab: SPM for 32000 tokens and for the gemma, qwen,
phi and other vocabularies, Llama-3's BPE layout for 128256, BERT's
WordPiece layout for the encoders, OuteTTS's for 157696; T5's unigram
vocab for the t5 files); nothing is downloaded.

Before the last line it prints the kernels summary and the card's
nvidia-smi name and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Times are medians of per-launch CUDA-event timings with the 50 MB L2
flushed before each launch (the main path finds weights and pages cold)
and a spin kernel queued ahead, so the events time the card, not the
host's launch work (llama_cpp_test_tpu_torch.tools.L2FlushedTimer).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor, as_completed

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES = 3.35e12     # H100 SXM HBM3 bytes/s (data sheet)
PEAK_BF16 = 989e12       # H100 SXM dense bf16 tensor-core flop/s
QMM_GATE = 5e-5          # NMSE gate of the qmm suite (tests/test_qmatmul.py)
ATTN_GATE = 2e-4         # NMSE gate of the attention suites
GMM_GATE = 2e-4          # NMSE gate of the gmm suite (tests/test_gmm.py:73)
LOGITS_GATE = 2e-3       # NMSE gate of the engine suite (tests/test_engine.py)
FOLD_GATE = 1e-8         # a GEMM with a min against the plain fold (the
                         # card tests' K4-vs-K1 and K5-vs-K1 gate)
PROBE_GATE = 1e-5        # NMSE gate of tests/test_torch_probes.py

# TinyLlama-1.1B (BASELINE.json config #1) published widths, depth cut
# from 22 to 2 layers (full depth until the quirks_ln phase needed the
# time, 11 until the encoders and geometry phases, 6 until the moe_forms
# phase, 4 until the multimodal phase; the cli, sched, server and
# adapters phases serve this file)
TINYLLAMA = dict(n_vocab=32000, n_embd=2048, n_head=32, n_head_kv=4,
                 head_dim=64, n_layer=2, n_ff=5632)
# Llama-3-8B (BASELINE.json config #2) published widths
LLAMA3_8B = dict(n_vocab=128256, n_embd=4096, n_head=32, n_head_kv=8,
                 head_dim=128, n_layer=32, n_ff=14336)
# Mixtral-8x7B (BASELINE.json config #4; mistralai/Mixtral-8x7B-v0.1
# config.json) published widths, depth cut from 32 to 1 layer (8 until
# the quirks phase, 4 until the quirks_ln phase, 2 until the multimodal
# phase needed the time); weights at the TinyLlama phase's std (~0.015)
MIXTRAL = dict(n_vocab=32000, n_embd=4096, n_head=32, n_head_kv=8,
               head_dim=128, n_layer=1, n_ff=14336, n_expert=8,
               n_expert_used=2, rope_base=1e6)

# Llama-3-70B (BASELINE.json config #5; meta-llama/Meta-Llama-3-70B
# config.json) published widths, depth cut from 80 to 1 layer (4 until
# the quirks_ln phase needed the time, 2 until the multimodal phase)
LLAMA3_70B = dict(n_vocab=128256, n_embd=8192, n_head=64, n_head_kv=8,
                  head_dim=128, n_layer=1, n_ff=28672, rope_base=500000.0)
# Llama-3-8B widths for the low-bit files, depth cut from 32 to 1 layer
# (8 until the quirks_ln phase needed the time, 4 until the encoders and
# geometry phases, 2 until the multimodal phase)
LLAMA3_8B_LOWBIT = dict(LLAMA3_8B, n_layer=1, rope_base=500000.0)
# Mixtral-8x7B widths for the low-bit MoE files, depth cut from 32 to 1
# layer (a layer's 1.4G expert weights are 0.56-0.7 GB of planes, but
# repacking 4 layers took 9 s (Q2_K) and 21 s (IQ1_S) on the 8 host cores
# of an H100 machine; 4 until the quirks_ln phase, 2 until the moe_forms
# phase needed the time), and to 1 for the BF16 file (3.1 GB a layer)
MIXTRAL_LOWBIT = dict(MIXTRAL, n_layer=1)
MIXTRAL_BF16 = dict(MIXTRAL, n_layer=1)
# Gemma-2-2B (google/gemma-2-2b config.json) published widths, depth cut
# from 26 to 2 layers (one sliding, one global, as layers 0 and 1 are;
# full depth until the quirks_ln phase needed the time, 4 until the
# multimodal phase): head dim 256,
# query_pre_attn_scalar 256, tied head, sliding window 4096 on every
# second layer, attention and final softcaps 50 and 30
GEMMA2_2B = dict(arch="gemma2", n_vocab=256000, n_embd=2304, n_head=8,
                 n_head_kv=4, head_dim=256, n_layer=2, n_ff=9216,
                 rope_base=10000.0, rms_eps=1e-6, sliding_window=4096,
                 attn_softcap=50.0, final_softcap=30.0, tied=True,
                 post_norms=True)
# Gemma-3-1B (google/gemma-3-1b-pt config.json) published widths, depth
# cut from 26 to 6 layers (layer 5 global; full depth until the quirks_ln
# phase needed the time): sliding window 512 on five layers of
# every six, rope base 1e6 with a local base of 10000, per-head QK norms,
# no softcaps, tied head
GEMMA3_1B = dict(arch="gemma3", n_vocab=262144, n_embd=1152, n_head=4,
                 n_head_kv=1, head_dim=256, n_layer=6, n_ff=6912,
                 rope_base=1e6, rope_base_swa=10000.0, rms_eps=1e-6,
                 sliding_window=512, swa_pattern=6, tied=True,
                 post_norms=True, qk_norm=True)
# Qwen2.5-0.5B (Qwen/Qwen2.5-0.5B config.json) published widths, depth cut
# from 24 to 2 layers (4 until the multimodal phase): Q/K/V biases, NEOX
# rope, tied head
QWEN25_05B = dict(arch="qwen2", n_vocab=151936, n_embd=896, n_head=14,
                  n_head_kv=2, head_dim=64, n_layer=2, n_ff=4864,
                  rope_base=1e6, rms_eps=1e-6, tied=True, qkv_bias=True)
# Qwen3-0.6B (Qwen/Qwen3-0.6B config.json) published widths, depth cut
# from 28 to 2 layers (4 until the multimodal phase): per-head QK norms,
# head dim 128, tied head
QWEN3_06B = dict(arch="qwen3", n_vocab=151936, n_embd=1024, n_head=16,
                 n_head_kv=8, head_dim=128, n_layer=2, n_ff=3072,
                 rope_base=1e6, rms_eps=1e-6, tied=True, qk_norm=True)

# Phi-3-mini-128k-instruct (microsoft/Phi-3-mini-128k-instruct
# config.json) published widths, depth cut from 32 to 2 layers for the
# smoke's clock (16 before the encoders and geometry phases, 4 before the
# multimodal phase): head dim 96, MHA, fused qkv_proj and gate_up_proj,
# NEOX rope, long rope (original context 4096 of 131072; 48-entry factor
# tables, seeded in the published range), sliding window 262144 on every
# layer, untied head
PHI3_MINI = dict(arch="phi3", n_vocab=32064, n_embd=3072, n_head=32,
                 n_head_kv=32, head_dim=96, n_layer=2, n_ff=8192,
                 rope_base=10000.0, sliding_window=262144,
                 longrope=(4096, 131072), fused_qkv=True, ffn="fused")
# Phi-2 (microsoft/phi-2 config.json) published widths, depth cut from 32
# to 2 layers for the smoke's clock (16 before the encoders and geometry
# phases, 4 before the multimodal phase): head dim 80, partial rope (32
# of 80), one LayerNorm (eps 1e-5) feeding the parallel attention and
# GELU FFN, biases on every projection and the head
PHI2 = dict(arch="phi2", n_vocab=51200, n_embd=2560, n_head=32,
            n_head_kv=32, head_dim=80, rope_dim=32, n_layer=2, n_ff=10240,
            ln_eps=1e-5, norm_bias=True, ffn_norm=False, fused_qkv=True,
            qkv_bias=True, bo=True, ffn="up", ffn_bias=True, head_bias=True)
# The other archs of the slice at published widths, depth cut to 1 layer
# (2 until PR 19):
# StableLM-2-1.6B (stabilityai/stablelm-2-1_6b config.json): partial rope
# (16 of 64), LayerNorms with biases, Q/K/V biases
STABLELM2_16B = dict(arch="stablelm", n_vocab=100352, n_embd=2048,
                     n_head=32, n_head_kv=32, head_dim=64, rope_dim=16,
                     n_layer=2, n_ff=5632, ln_eps=1e-5, norm_bias=True,
                     qkv_bias=True)
# StarCoder2-3B (bigcode/starcoder2-3b config.json): GQA on 2 KV heads,
# window 4096, biases everywhere, non-gated GELU FFN, tied head
STARCODER2_3B = dict(arch="starcoder2", n_vocab=49152, n_embd=3072,
                     n_head=24, n_head_kv=2, head_dim=128, n_layer=2,
                     n_ff=12288, rope_base=999999.4, ln_eps=1e-5,
                     norm_bias=True, qkv_bias=True, bo=True, ffn="up",
                     ffn_bias=True, sliding_window=4096, tied=True)
# Pythia-1.4B (EleutherAI/pythia-1.4b config.json; gptneox): partial rope
# (32 of 128), parallel residual with a dedicated ffn_norm, fused QKV
PYTHIA_14B = dict(arch="gptneox", n_vocab=50304, n_embd=2048, n_head=16,
                  n_head_kv=16, head_dim=128, rope_dim=32, n_layer=2,
                  n_ff=8192, ln_eps=1e-5, norm_bias=True, fused_qkv=True,
                  qkv_bias=True, bo=True, ffn="up", ffn_bias=True)
# Falcon-7B (tiiuae/falcon-7b config.json): 71 heads on one KV head, one
# shared LayerNorm, fused QKV, no biases; n_embd 4544 is no multiple of
# 256, so this file is Q8_0
FALCON_7B = dict(arch="falcon", n_vocab=65024, n_embd=4544, n_head=71,
                 n_head_kv=1, head_dim=64, n_layer=2, n_ff=18176,
                 ln_eps=1e-5, norm_bias=True, ffn_norm=False,
                 fused_qkv=True, ffn="up")
# Command-R v01 (CohereForAI/c4ai-command-r-v01 config.json): MHA, weight-
# only LayerNorms, parallel gated FFN, logit_scale 0.0625, rope base 8e6,
# tied head of 256000 rows, NORM rope
COMMAND_R = dict(arch="command-r", n_vocab=256000, n_embd=8192, n_head=64,
                 n_head_kv=64, head_dim=128, n_layer=2, n_ff=22528,
                 rope_base=8e6, ln_eps=1e-5, ffn_norm=False, tied=True,
                 meta={"logit_scale": 0.0625})
# Granite-3.0-2B (ibm-granite/granite-3.0-2b-base config.json): the mup
# scales (embedding 12, residual 0.22, attention 0.015625, logits 8)
GRANITE3_2B = dict(arch="granite", n_vocab=49155, n_embd=2048, n_head=32,
                   n_head_kv=8, head_dim=64, n_layer=2, n_ff=8192,
                   tied=True, meta={"embedding_scale": 12.0,
                                    "residual_scale": 0.22,
                                    "attention.scale": 0.015625,
                                    "logit_scale": 8.0})
# OLMo-2-1124-7B (allenai/OLMo-2-1124-7B config.json): post norms only,
# RMS norms over the flat q and k
OLMO2_7B = dict(arch="olmo2", n_vocab=100352, n_embd=4096, n_head=32,
                n_head_kv=32, head_dim=128, n_layer=2, n_ff=11008,
                rope_base=500000.0, rms_eps=1e-6, pre_norms=False,
                post_norms=True, qk_norm="flat")
# Minitron-4B-Base (nvidia/Minitron-4B-Base config.json; nemotron):
# partial rope (64 of 128), LayerNorms with biases, squared-ReLU FFN
MINITRON_4B = dict(arch="nemotron", n_vocab=256000, n_embd=3072, n_head=24,
                   n_head_kv=8, head_dim=128, rope_dim=64, n_layer=2,
                   n_ff=9216, ln_eps=1e-5, norm_bias=True, ffn="up")
# OLMo-1.7-7B (allenai/OLMo-1.7-7B-hf config.json; olmo): weightless
# LayerNorms (no norm tensors), clip_qkv 8, NORM rope
OLMO17_7B = dict(arch="olmo", n_vocab=50304, n_embd=4096, n_head=32,
                 n_head_kv=32, head_dim=128, n_layer=2, n_ff=11008,
                 ln_eps=1e-5, pre_norms=False, output_norm=False,
                 meta={"attention.clamp_kqv": 8.0})

TPU_KERNELS = {
    "qmm_gemv": ("llama_cpp_test_tpu_torch/csrc/qmm.cu",
                 "llama_cpp_test_tpu/ops/qmatmul.py:145"),
    "qmm_gemm": ("llama_cpp_test_tpu_torch/csrc/qmm.cu",
                 "llama_cpp_test_tpu/ops/qmatmul.py:145"),
    "qmm_cache": ("llama_cpp_test_tpu_torch/csrc/qmm_cache.cu",
                  "llama_cpp_test_tpu/ops/qmatmul.py:276"),
    "flash_prefill": ("llama_cpp_test_tpu_torch/csrc/flash_prefill.cu",
                      "llama_cpp_test_tpu/ops/flash_prefill.py:31"),
    "paged_decode": ("llama_cpp_test_tpu_torch/csrc/paged_attention.cu",
                     "llama_cpp_test_tpu/ops/paged_attention.py:50"),
    "paged_decode_q8": ("llama_cpp_test_tpu_torch/csrc/paged_attention.cu",
                        "llama_cpp_test_tpu/ops/paged_attention.py:50"),
    "gmm_gemv": ("llama_cpp_test_tpu_torch/csrc/gmm.cu",
                 "llama_cpp_test_tpu/ops/gmm.py:118"),
    "gmm_gemm": ("llama_cpp_test_tpu_torch/csrc/gmm.cu",
                 "llama_cpp_test_tpu/ops/gmm.py:118"),
    "kbench_f": ("llama_cpp_test_tpu_torch/csrc/kbench.cu",
                 "tools/kbench.py:98"),
    "kbench_g": ("llama_cpp_test_tpu_torch/csrc/kbench.cu",
                 "tools/kbench.py:155"),
    "kbench_h": ("llama_cpp_test_tpu_torch/csrc/kbench.cu",
                 "tools/kbench.py:203"),
    "kbench_e": ("llama_cpp_test_tpu_torch/csrc/kbench.cu",
                 "tools/kbench.py:265"),
    "pairs_qmm": ("llama_cpp_test_tpu_torch/csrc/pairprobe.cu",
                  "tools/pairprobe.py:42"),
}
# TinyLlama-1.1B-Chat-v1.0's published (zephyr-style) tokenizer.chat_template
ZEPHYR = (
    "{% for message in messages %}\n{% if message['role'] == 'user' %}\n"
    "{{ '<|user|>\\n' + message['content'] + eos_token }}\n"
    "{% elif message['role'] == 'system' %}\n"
    "{{ '<|system|>\\n' + message['content'] + eos_token }}\n"
    "{% elif message['role'] == 'assistant' %}\n"
    "{{ '<|assistant|>\\n'  + message['content'] + eos_token }}\n"
    "{% endif %}\n{% if loop.last and add_generation_prompt %}\n"
    "{{ '<|assistant|>' }}\n{% endif %}\n{% endfor %}")

# the kernels each serving path must launch
DENSE_PATH = ("qmm_gemv", "qmm_gemm", "flash_prefill", "paged_decode")
MOE_BF16_PATH = DENSE_PATH + ("gmm_gemv", "gmm_gemm")   # bf16 KV only
MOE_PATH = MOE_BF16_PATH + ("paged_decode_q8",)
# a BF16 file's dense projections are plain products (no K1), as the JAX
# package leaves them to XLA; its expert stacks still run K4
MOE_DENSE_FILE_PATH = ("flash_prefill", "paged_decode", "gmm_gemv", "gmm_gemm")
# the slice whose serve path each kernel's `launches` is read from
PROBES = ("kbench_f", "kbench_g", "kbench_h", "kbench_e", "pairs_qmm")
OWN_PATH = {"paged_decode_q8": "serve_moe", "gmm_gemv": "serve_moe",
            "gmm_gemm": "serve_moe", "qmm_cache": "serve_lowbit",
            **dict.fromkeys(PROBES, "probes")}
# the expert plane kinds serve_moe_lowbit's three files must bring to K4
MOE_LOWBIT_KINDS = ("u2", "u2lut", "u4lut", "dense")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nmse(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(((a - b) ** 2).mean() / ((a * a).mean() + 1e-30))


# ---------------------------------------------------------------------------
# bounds


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / PEAK_BYTES, flops / PEAK_BF16
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


# ---------------------------------------------------------------------------
# synthetic weights: seeded random block bytes with bounded fp16 scales


def _f16_field(raw, off: int, values) -> None:
    raw[:, off:off + 2] = np.asarray(values, np.float16).view(np.uint8) \
        .reshape(-1, 2)


def random_blocks(rng, ggml_type, n: int, k: int) -> np.ndarray:
    """Packed GGUF bytes for an (n, k) weight: random quant bytes with fp16
    scale fields drawn from a bounded range, so every weight is finite.
    Every type aims at a weight std of ~0.015; the scale ranges below come
    from the std of each type's decoded random blocks at d = 1 (measured
    with quant/codecs.dequantize on 20000 blocks), divided into 0.015."""
    from llama_cpp_test_tpu_torch.gguf.constants import GGML_BLOCK_SIZES, GGMLType

    blk, nbytes = GGML_BLOCK_SIZES[ggml_type]
    nb = n * k // blk
    # the random bytes drawn as 64-bit words: about twice the rate of a
    # uint8 draw, which set much of the smoke's host time
    words = rng.integers(0, 1 << 64, size=-(-nb * nbytes // 8),
                         dtype=np.uint64)
    raw = words.view(np.uint8)[:nb * nbytes].reshape(nb, nbytes)
    d = lambda lo, hi: rng.uniform(lo, hi, nb).astype(np.float16)
    if ggml_type == GGMLType.Q4_K:
        # weight std ~0.015. A random 22-layer stack at TinyLlama's trained
        # std (~0.03) amplifies the bf16 weight-rounding difference between
        # kernels and plain path (NMSE ~3e-6 per projection) to logits NMSE
        # up to 2e-3 (measured on an H100); at ~0.015 it stays below 6e-4
        dv = d(0.35e-4, 0.65e-4)
        _f16_field(raw, 0, dv)
        # dmin ~ 7.5 d centers the weights (E[q] = 7.5, scales/mins alike)
        _f16_field(raw, 2, dv.astype(np.float32) * 7.5)
    elif ggml_type == GGMLType.Q5_K:
        # std 528 d with dmin = 15.5 d (E[q] = 15.5 centers the weights)
        dv = d(2.3e-5, 3.4e-5)
        _f16_field(raw, 0, dv)
        _f16_field(raw, 2, dv.astype(np.float32) * 15.5)
    elif ggml_type == GGMLType.Q2_K:
        # std 13.9 d with dmin = 1.5 d (E[q] = 1.5 centers the weights)
        dv = d(0.8e-3, 1.4e-3)
        _f16_field(raw, 80, dv)
        _f16_field(raw, 82, dv.astype(np.float32) * 1.5)
    elif ggml_type == GGMLType.Q8_0:
        _f16_field(raw, 0, d(0.5e-4, 1.5e-4))
    elif ggml_type == GGMLType.Q6_K:
        # int8 sub-block scales in [4, 12] and d ~ 1e-4: q in [-32, 31]
        # gives weight std ~0.015, as the Q4_K blocks above
        raw[:, 192:208] = rng.integers(4, 13, size=(nb, 16), dtype=np.uint8)
        _f16_field(raw, 208, d(0.7e-4, 1.3e-4))
    elif ggml_type == GGMLType.IQ4_XS:
        # std 1246 d (6-bit signed block scales times the IQ4_NL LUT's
        # |values| up to 127); d ~ 1.2e-5 is an fp16 subnormal, still exact
        _f16_field(raw, 0, d(0.9e-5, 1.5e-5))
    elif ggml_type == GGMLType.IQ1_S:
        # std 7.2 d (ternary grid values +- 0.125, scales 2s + 1 <= 15)
        _f16_field(raw, 0, d(1.6e-3, 2.6e-3))
    elif ggml_type == GGMLType.IQ2_XXS:
        # std 53 d (grid magnitudes 8, 25, 43 times (0.5 + s) / 4)
        _f16_field(raw, 0, d(2.2e-4, 3.4e-4))
    elif ggml_type == GGMLType.BF16:
        # random sign and mantissa, exponent field 120 or 121: |w| in
        # [2^-7, 2^-5), std ~0.019 (drawing normals for 2.8G weights would
        # take half a minute)
        bits = raw.view(np.uint16)
        bits &= 0x80FF
        bits |= 60 << 8
    elif ggml_type == GGMLType.F16:
        # random sign and mantissa under the exponent field 8: |w| in
        # [2^-7, 2^-6), std ~0.012, the other types' scale
        bits = raw.view(np.uint16)
        bits &= 0x83FF
        bits |= 8 << 10
    else:
        raise ValueError(ggml_type)
    return raw.reshape(-1)


_ROLES = ("token_embd", "output", "attn_q", "attn_k", "attn_v",
          "attn_output", "ffn_gate", "ffn_up", "ffn_down")


def file_types(ftype: str) -> dict:
    """Tensor role -> GGML type of a file of type ftype, by the JAX
    package's per-tensor rules (quant/quantize_model.tensor_target_type):
    a Q4_K, Q8_0, IQ4_XS, BF16 or F16 file is that type throughout; a
    Q2_K file keeps a Q6_K head; an IQ1_S file bumps attn_v to Q4_K and
    ffn_down to IQ2_XXS, keeps a Q5_K head and a Q2_K token embedding."""
    from llama_cpp_test_tpu_torch.gguf.constants import GGMLType as T

    base = dict.fromkeys(_ROLES, T[ftype])
    return {"Q4_K": base,
            "Q8_0": base,
            "IQ4_XS": base,
            "BF16": base,
            "F16": base,
            "Q2_K": {**base, "output": T.Q6_K},
            "IQ1_S": {**base, "attn_v": T.Q4_K, "ffn_down": T.IQ2_XXS,
                      "output": T.Q5_K, "token_embd": T.Q2_K}}[ftype]


def expert_types(ftype: str, layer: int) -> tuple:
    """GGML types of a layer's gate, up and down expert stacks: in a Q4_K
    file Q4_K, with ffn_down_exps Q6_K on even layers and Q4_K on odd ones,
    as a Q4_K_M file mixes them; in the others file_types' ffn_gate,
    ffn_up and ffn_down (the JAX rules match ".ffn_down" in the stacks'
    names too)."""
    from llama_cpp_test_tpu_torch.gguf.constants import GGMLType as T

    if ftype == "Q4_K":
        return T.Q4_K, T.Q4_K, T.Q6_K if layer % 2 == 0 else T.Q4_K
    types = file_types(ftype)
    return types["ffn_gate"], types["ffn_up"], types["ffn_down"]


# common English words: the synthesized vocabularies hold them whole, so
# text prompts tokenize into word pieces as well as into characters
_WORDS = tuple("""the of and to in is that it for was on are with as his they
be at one have this from or had by word but what some we can out other were
all there when up use your how said an each she which do their time if will
way about many then them write would like so these her long make thing see
him two has look more day could go come did number sound no most people my
over know water than call first who may down side been now find any new
work part take get place made live where after back little only round man
year came show every good me give our under name very through just form
sentence great think say help low line differ turn cause much mean before
move right boy old too same tell does set three want air well also play
small end put home read hand port large spell add even land here must big
high such follow act why ask men change went light kind off need house
picture try us again animal point mother world near build self earth
father""".split())
# letter frequencies of English text (a..z), for the random pieces
_LETTERS = "abcdefghijklmnopqrstuvwxyz"
_LETTER_P = np.array([8.2, 1.5, 2.8, 4.3, 12.7, 2.2, 2.0, 6.1, 7.0, 0.15,
                      0.77, 4.0, 2.4, 6.7, 7.5, 1.9, 0.095, 6.0, 6.3, 9.1,
                      2.8, 0.98, 2.4, 0.15, 2.0, 0.074])


def spm_vocab(n_vocab: int, seed: int) -> dict:
    """Tokenizer metadata of an SPM vocab (tokenizer.ggml.model "llama",
    TinyLlama's and Mixtral's kind) of n_vocab tokens: <unk>, <s>, </s>,
    the 256 <0xNN> byte tokens, then pieces with descending scores: the
    words of _WORDS with and without the '\u2581' space mark, printable
    ASCII, then seeded letter strings of 2-8 letters by English letter
    frequency."""
    rng = np.random.default_rng(seed)
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    types = [2, 3, 3] + [6] * 256
    want = n_vocab - len(tokens)
    pieces = dict.fromkeys(["\u2581" + w for w in _WORDS] + list(_WORDS) +
                           ["\u2581"] + [chr(c) for c in range(33, 127)])
    letters = np.array(list(_LETTERS))
    while len(pieces) < want:
        lens = rng.integers(2, 9, size=4096)
        chars = rng.choice(letters, size=(4096, 8), p=_LETTER_P / _LETTER_P.sum())
        marks = rng.random(4096) < 0.5
        for n, row, mark in zip(lens, chars, marks):
            pieces.setdefault(("\u2581" if mark else "") + "".join(row[:n]))
    tokens += list(pieces)[:want]
    scores = [0.0] * len(types) + [-float(i + 1) for i in range(want)]
    types += [1] * want
    return {"tokenizer.ggml.model": "llama", "tokenizer.ggml.tokens": tokens,
            "tokenizer.ggml.scores": np.asarray(scores, np.float32),
            "tokenizer.ggml.token_type": np.asarray(types, np.int32),
            "tokenizer.ggml.bos_token_id": 1, "tokenizer.ggml.eos_token_id": 2,
            "tokenizer.ggml.unknown_token_id": 0,
            "tokenizer.ggml.add_bos_token": True}


def llama3_specials(n: int) -> list[str]:
    """The n control tokens that follow Llama-3's regular vocabulary, in
    its order."""
    named = {0: "<|begin_of_text|>", 1: "<|end_of_text|>",
             6: "<|start_header_id|>", 7: "<|end_header_id|>",
             9: "<|eot_id|>"}
    out, reserved = [], 0
    for i in range(n):
        if i in named:
            out.append(named[i])
        else:
            out.append(f"<|reserved_special_token_{reserved}|>")
            reserved += 1
    return out


def bpe_vocab(n_vocab: int, seed: int, n_special: int = 256) -> dict:
    """Tokenizer metadata of a byte-level BPE vocab laid out as Llama-3's
    (tokenizer.ggml.model "gpt2", pre "llama-bpe"): the 256 characters of
    the GPT-2 byte alphabet, tokens made by seeded merges up to
    n_vocab - n_special (first the merges that spell each word of _WORDS,
    with and without the 'G-dot' space mark, then random ones: a token of
    up to 11 characters and one byte character), then the n_special
    control tokens; BOS and EOS are the first two of them."""
    from llama_cpp_test_tpu_torch.tokenizer.bpe import bytes_to_unicode

    rng = np.random.default_rng(seed)
    b2u = bytes_to_unicode()
    tokens = [b2u[b] for b in range(256)]
    have = set(tokens)
    merges = []
    n_normal = n_vocab - n_special

    def add(a, b):
        if a + b not in have and len(tokens) < n_normal:
            have.add(a + b)
            tokens.append(a + b)
            merges.append(f"{a} {b}")

    for w in _WORDS:
        for word in (w, b2u[32] + w):
            for i in range(1, len(word)):
                add(word[:i], word[i])
    while len(tokens) < n_normal:
        left = rng.integers(0, len(tokens), size=4096)
        right = rng.integers(0, 256, size=4096)
        for i, j in zip(left, right):
            if len(tokens[i]) < 12:
                add(tokens[i], tokens[j])
    types = [1] * n_normal + [3] * n_special
    return {"tokenizer.ggml.model": "gpt2", "tokenizer.ggml.pre": "llama-bpe",
            "tokenizer.ggml.tokens": tokens + llama3_specials(n_special),
            "tokenizer.ggml.token_type": np.asarray(types, np.int32),
            "tokenizer.ggml.merges": merges,
            "tokenizer.ggml.bos_token_id": n_normal,
            "tokenizer.ggml.eos_token_id": n_normal + 1,
            "tokenizer.ggml.add_bos_token": True}


def wpm_vocab(n_vocab: int, seed: int) -> dict:
    """Tokenizer metadata of a WordPiece vocab (tokenizer.ggml.model
    "bert") laid out as BERT's uncased one as llama.cpp converts it: [PAD]
    0, [unused0..98], [UNK] 100, [CLS] 101, [SEP] 102, [MASK] 103, then
    word pieces, a word's first piece marked with the '\u2581' space mark
    and a continuation piece bare: the words of _WORDS and the printable
    ASCII characters both ways, then seeded letter strings of 2-8 letters.
    [CLS] and [SEP] wrap an encoded text."""
    rng = np.random.default_rng(seed)
    tokens = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + [
        "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    types = [3] * len(tokens)
    want = n_vocab - len(tokens)
    chars = [chr(c) for c in range(33, 127) if not chr(c).isupper()]
    pieces = dict.fromkeys(["\u2581" + w for w in _WORDS + tuple(chars)]
                           + list(_WORDS) + chars)
    letters = np.array(list(_LETTERS))
    while len(pieces) < want:
        lens = rng.integers(2, 9, size=4096)
        rows = rng.choice(letters, size=(4096, 8), p=_LETTER_P / _LETTER_P.sum())
        marks = rng.random(4096) < 0.5
        for n, row, mark in zip(lens, rows, marks):
            pieces.setdefault(("\u2581" if mark else "") + "".join(row[:n]))
    tokens += list(pieces)[:want]
    types += [1] * want
    return {"tokenizer.ggml.model": "bert", "tokenizer.ggml.tokens": tokens,
            "tokenizer.ggml.token_type": np.asarray(types, np.int32),
            "tokenizer.ggml.bos_token_id": 101,
            "tokenizer.ggml.eos_token_id": 102,
            "tokenizer.ggml.unknown_token_id": 100,
            "tokenizer.ggml.padding_token_id": 0,
            "tokenizer.ggml.add_bos_token": True,
            "tokenizer.ggml.add_eos_token": True}


def t5_vocab(n_vocab: int, seed: int, n_extra: int = 100) -> dict:
    """Tokenizer metadata of a T5 unigram vocab (tokenizer.ggml.model
    "t5", the UGM tokenizer) laid out as T5's sentencepiece model as
    llama.cpp converts it: <pad> 0, </s> 1, <unk> 2, then pieces with
    nearly equal scores (so the fewest pieces win): the '▁' space
    mark, printable ASCII, the words of _WORDS with and without the mark,
    then seeded letter strings of 2-8 letters; the last n_extra tokens are
    the <extra_id_N> sentinels (N from n_extra - 1 down). An encoded text
    ends with </s>."""
    rng = np.random.default_rng(seed)
    want = n_vocab - 3 - n_extra
    pieces = dict.fromkeys(["▁"] + [chr(c) for c in range(33, 127)] +
                           ["▁" + w for w in _WORDS] + list(_WORDS))
    letters = np.array(list(_LETTERS))
    while len(pieces) < want:
        lens = rng.integers(2, 9, size=4096)
        rows = rng.choice(letters, size=(4096, 8), p=_LETTER_P / _LETTER_P.sum())
        marks = rng.random(4096) < 0.5
        for n, row, mark in zip(lens, rows, marks):
            pieces.setdefault(("▁" if mark else "") + "".join(row[:n]))
    tokens = ["<pad>", "</s>", "<unk>"] + list(pieces)[:want] + [
        f"<extra_id_{i}>" for i in range(n_extra - 1, -1, -1)]
    scores = [0.0] * 3 + [-1.0 - 1e-3 * i for i in range(want)] + \
        [0.0] * n_extra
    types = [3, 3, 2] + [1] * want + [4] * n_extra
    return {"tokenizer.ggml.model": "t5", "tokenizer.ggml.tokens": tokens,
            "tokenizer.ggml.scores": np.asarray(scores, np.float32),
            "tokenizer.ggml.token_type": np.asarray(types, np.int32),
            "tokenizer.ggml.eos_token_id": 1,
            "tokenizer.ggml.unknown_token_id": 2,
            "tokenizer.ggml.padding_token_id": 0,
            "tokenizer.ggml.add_bos_token": False,
            "tokenizer.ggml.add_eos_token": True,
            "tokenizer.ggml.add_space_prefix": True}


CODE_TOKEN_OFFSET = 151672          # OuteTTS v0.2's "<|0|>" (tts.cpp:720)
QWEN2_REGULAR = 151643              # Qwen2.5's byte-level BPE tokens
OUTETTS_MARKS = ("<|endoftext|>", "<|im_start|>", "<|im_end|>",
                 "<|text_start|>", "<|text_end|>", "<|text_sep|>",
                 "<|audio_start|>", "<|audio_end|>")


def outetts_vocab(n_vocab: int, seed: int, n_bpe: int = QWEN2_REGULAR,
                  n_codes: int = 4100) -> dict:
    """Tokenizer metadata of OuteTTS-0.2's vocab laid out as llama.cpp's
    converter writes it (tokenizer.ggml.model "gpt2", pre "qwen2"): n_bpe
    byte-level BPE tokens (bpe_vocab's; [UNUSED_i] fill the rest of
    Qwen2.5's 151643), Qwen's control tokens <|endoftext|> (the EOS),
    <|im_start|>, <|im_end|>, then OuteTTS's user-defined marks
    (<|text_start|> ... <|audio_end|>) and reserved ones up to
    CODE_TOKEN_OFFSET, the audio codes <|0|> ... <|n_codes - 1|>, then
    timing tokens <|t_0.00|> ... to n_vocab. A prompt's marks match as
    written (user-defined tokens do); its '\\n' is the byte token 10."""
    md = bpe_vocab(n_bpe, seed, n_special=0)
    tokens = md["tokenizer.ggml.tokens"] + [
        f"[UNUSED_{i}]" for i in range(n_bpe, QWEN2_REGULAR)]
    types = [1] * n_bpe + [5] * (QWEN2_REGULAR - n_bpe)
    tokens += list(OUTETTS_MARKS) + [
        f"<|reserved_{i}|>" for i in range(CODE_TOKEN_OFFSET - QWEN2_REGULAR
                                          - len(OUTETTS_MARKS))]
    types += [3, 3, 3] + [4] * (CODE_TOKEN_OFFSET - QWEN2_REGULAR - 3)
    tokens += [f"<|{i}|>" for i in range(n_codes)]
    tokens += [f"<|t_{i / 100:.2f}|>" for i in range(n_vocab - len(tokens))]
    types += [4] * (n_vocab - len(types))
    return {"tokenizer.ggml.model": "gpt2", "tokenizer.ggml.pre": "qwen2",
            "tokenizer.ggml.tokens": tokens,
            "tokenizer.ggml.token_type": np.asarray(types, np.int32),
            "tokenizer.ggml.merges": md["tokenizer.ggml.merges"],
            "tokenizer.ggml.eos_token_id": QWEN2_REGULAR,
            "tokenizer.ggml.bos_token_id": QWEN2_REGULAR,
            "tokenizer.ggml.add_bos_token": False}


CHAIN_SCALE = 64.0      # the first chain row's norm (random rows: ~0.2)
CHAIN_PHI2 = 0.1        # the chain's step: the next row wins by e^0.05


def chain_rows(c: int, chain, seed: int) -> dict:
    """Token-embedding rows of width c that make greedy decoding of a
    tied-head model walk `chain` (token ids) one step at a time: row j is
    CHAIN_SCALE e^(CHAIN_PHI2 j) v_j, with unit v_j whose Gram is
    exp(-CHAIN_PHI2 (j - k)^2 / 2) (built exactly from its
    eigendecomposition, turned into width c by a seeded orthonormal
    basis). These rows dwarf the random rows and the layers' output, so
    the hidden state at token chain[k] is ~ row k, and the logit of
    chain[k + m] is proportional to e^(CHAIN_PHI2 (k + m - m^2 / 2)): the
    next token wins by e^(CHAIN_PHI2 / 2), 5% of its logit, and a token
    past it or before it loses."""
    n = len(chain)
    check(n <= c, f"a chain of {n} tokens needs a width of at least {n}")
    j = np.arange(n)
    w, u = np.linalg.eigh(np.exp(-0.5 * CHAIN_PHI2 * (j[:, None] - j) ** 2))
    v = u * np.sqrt(np.clip(w, 0.0, None))          # rows: that Gram
    basis, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal(
        (c, n)))
    v = v @ basis.T
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return {int(t): CHAIN_SCALE * np.exp(CHAIN_PHI2 * i) * v[i]
            for i, t in enumerate(chain)}


def write_llama_gguf(path: str, hp: dict, seed: int,
                     ftype: str = "Q4_K", vocab: str | None = "auto",
                     vocab_seed: int | None = None,
                     chat_template: str | None = None) -> None:
    """A GGUF of arch hp.get("arch", "llama") and geometry hp from seeded
    random block bytes: matmul tensors by file_types(ftype) and F32 norms;
    with hp["n_expert"], Mixtral's layout as llama.cpp writes it: an F32
    router and expert stacks of expert_types(ftype, layer). The quirk keys
    of hp (the gemma and qwen configurations) add: rms_eps,
    sliding_window, swa_pattern (written for gemma3), rope_base_swa (the
    local base), attn_softcap and final_softcap, tied (no output.weight),
    qk_norm (per-head Q/K norms: True or "shared" [D], "head" [H, D],
    "flat" [H * D]), post_norms (the sandwich norms) and qkv_bias (F32
    Q/K/V biases). Those of the LayerNorm and parallel archs: ln_eps (a
    layer_norm_epsilon instead of rms_eps), rope_dim, pre_norms (False:
    no attn_norm and ffn_norm), ffn_norm (False: no pre-FFN norm, as a
    parallel layer with one norm has), output_norm (False: none), norm_bias
    (LayerNorm biases), fused_qkv (one attn_qkv, with a fused bias under
    qkv_bias), bo, ffn ("gated", "up" non-gated, "fused" [gate|up] in one
    ffn_up), ffn_bias (up and down biases), head_bias, longrope ((original
    context, training context): the long-rope keys and seeded factor
    tables in the published range) and meta (more {arch}.* keys). Those of
    the position axes and the other llama-body archs: pos_rows (an F32
    learned position table of that many rows, the context length too),
    tok_norm (the embedding LayerNorm, weight and bias), sub_norms
    (bitnet's attn_sub_norm and ffn_sub_norm) and gate_bias (an F32
    ffn_gate bias). Those of the encoders: post_norm (no pre-norms, no
    final norm and no LM head; attn_output_norm and layer_output_norm,
    with biases under norm_bias), types (the token-type rows) and
    down_bias (an ffn_down bias alone). Those of per-layer geometry:
    n_head_layers, n_head_kv_layers, n_ff_layers (each written as the
    GGUF array of its key; n_head 0 an attention-free layer with its FFN
    alone, n_head_kv 0 a linear-attention layer with attn_norm and an
    n_embd x n_embd attn_output alone) and qk_norm "head_bias" (per-head
    QK LayerNorms [H, D] with biases, chameleon's). Those of the other MoE
    forms and MLA: n_ff_exp (the experts' width, default n_ff),
    n_dense_lead (leading layers with a gated FFN of n_ff), shexp_ff (the
    shared experts' width: ffn_{gate,up,down}_shexp in each MoE layer),
    shexp_gate (qwen2moe's F32 ffn_gate_inp_shexp), exp_probs_b (an F32
    selection bias), arctic (a gated FFN of n_ff beside the experts and
    ffn_norm_exps), branch_norms ("grok": attn_output_norm and
    layer_output_norm on the branch outputs; "dbrx": attn_output_norm in
    place of ffn_norm) and mla (dict of q_lora, kv_lora, rope_dim, v_dim:
    attn_q or attn_q_a, attn_q_a_norm and attn_q_b; attn_kv_a_mqa,
    attn_kv_a_norm, attn_kv_b; head_dim is the q and k head, nope +
    rope_dim). A tensor whose K the type's block does not divide is
    written Q8_0, or BF16 where 32 does not divide it either (_fit_type);
    the choices are returned, tensor role -> type name. vocab:
    the tokenizer written beside them (from vocab_seed, default seed),
    "spm" (spm_vocab), "bpe" (bpe_vocab) or "wpm" (wpm_vocab, BERT's);
    "auto" takes "wpm" for an encoder, "bpe" for Llama-3's 128256 tokens
    and "spm" for any other size, a dict is the tokenizer metadata itself;
    None writes none. chat_template: the tokenizer.chat_template written
    with it. hp["embd_rows"] ({token id: float vector}) writes those rows
    of a Q8_0 token_embd as the vectors quantized (q8_0_row), the rest of
    the plane random blocks."""
    from llama_cpp_test_tpu_torch.gguf.writer import GGUFWriter

    rng = np.random.default_rng(seed)
    types = file_types(ftype)
    c, hq, hkv, d = hp["n_embd"], hp["n_head"], hp["n_head_kv"], hp["head_dim"]
    v, ff, n_layer = hp["n_vocab"], hp["n_ff"], hp["n_layer"]
    n_exp = hp.get("n_expert", 0)
    arch = hp.get("arch", "llama")
    w = GGUFWriter(path, arch=arch)
    per_layer = {key: hp.get(f"{key}_layers") or [dflt] * n_layer
                 for key, dflt in (("n_head", hq), ("n_head_kv", hkv),
                                   ("n_ff", ff))}
    arr = lambda key, dflt: hp.get(f"{key}_layers") or dflt
    meta = {"context_length": hp.get("pos_rows") or 2048,
            "embedding_length": c,
            "block_count": n_layer, "attention.head_count": arr("n_head", hq),
            "attention.head_count_kv": arr("n_head_kv", hkv),
            "attention.key_length": d, "attention.value_length": d,
            "feed_forward_length": arr("n_ff", ff),
            "rope.dimension_count": hp.get("rope_dim", d),
            "rope.freq_base": hp.get("rope_base", 10000.0),
            ("attention.layer_norm_epsilon" if "ln_eps" in hp else
             "attention.layer_norm_rms_epsilon"):
                hp.get("ln_eps", hp.get("rms_eps", 1e-5)),
            "vocab_size": v}
    if n_exp:
        meta.update({"expert_count": n_exp,
                     "expert_used_count": hp["n_expert_used"]})
    for key, name in (("sliding_window", "attention.sliding_window"),
                      ("swa_pattern", "attention.sliding_window_pattern"),
                      ("rope_base_swa", "rope.local_freq_base"),
                      ("attn_softcap", "attn_logit_softcapping"),
                      ("final_softcap", "final_logit_softcapping")):
        if key in hp:
            meta[name] = hp[key]
    if "longrope" in hp:
        orig, train = hp["longrope"]
        meta.update({"context_length": train,
                     "rope.scaling.type": "longrope",
                     "rope.scaling.original_context_length": orig,
                     "rope.scaling.attn_factor": float(np.sqrt(
                         1.0 + np.log(train / orig) / np.log(orig)))})
    meta.update(hp.get("meta", {}))
    meta = {f"{arch}.{k}": val for k, val in meta.items()}
    post = hp.get("post_norm", False)
    if vocab == "auto":
        vocab = "wpm" if post else "bpe" if v == 128256 else "spm"
    if isinstance(vocab, dict):
        meta.update(vocab)
    elif vocab is not None:
        meta.update({"spm": spm_vocab, "bpe": bpe_vocab,
                     "wpm": wpm_vocab}[vocab](
            v, seed if vocab_seed is None else vocab_seed))
    if chat_template is not None:
        meta["tokenizer.chat_template"] = chat_template
    for key, val in meta.items():
        w.add_kv(key, val)

    fitted = {}

    def fit(role, gt, k):
        ft = _fit_type(gt, k)
        if ft != gt:
            fitted[role] = ft.name
        return ft

    def quant(name, n, k, e=1, gt=None, rows=None):
        role = name.split(".")[-2]
        # a shared expert takes its FFN role's type, an MLA plane attn_q's
        base = role.replace("_shexp", "")
        gt = fit(role, gt or types.get(base, types["attn_q"]), k)
        shape = (k, n) if e == 1 else (k, n, e)
        raw = random_blocks(rng, gt, n * e, k)
        if rows:
            from llama_cpp_test_tpu_torch.gguf.constants import GGMLType

            check(gt == GGMLType.Q8_0, f"{name}: designed rows need Q8_0")
            per_row = raw.size // n
            for r, vec in rows.items():
                raw[r * per_row:(r + 1) * per_row] = q8_0_row(vec)
        w.add_tensor(name, raw, ggml_type=gt, raw_ggml_shape=shape)

    def vec(name, *shape, mean=1.0, std=0.05):
        w.add_tensor(name, mean + std * rng.standard_normal(shape).astype(
            np.float32))

    def norm(name, n=c):
        vec(name, n)
        if hp.get("norm_bias"):
            vec(name[:-len("weight")] + "bias", n, mean=0.0)

    bias = lambda name, n: vec(name, n, mean=0.0, std=0.1)
    quant("token_embd.weight", v, c, rows=hp.get("embd_rows"))
    if hp.get("pos_rows"):
        vec("position_embd.weight", hp["pos_rows"], c, mean=0.0, std=0.02)
    if hp.get("types"):
        vec("token_types.weight", 2, c, mean=0.0, std=0.02)
    if hp.get("tok_norm"):
        vec("token_embd_norm.weight", c)
        vec("token_embd_norm.bias", c, mean=0.0)
    if hp.get("output_norm", True) and not post:
        norm("output_norm.weight")
    if not (hp.get("tied") or post):
        quant("output.weight", v, c)
    if hp.get("head_bias"):
        bias("output.bias", v)
    for i in range(n_layer):
        p = f"blk.{i}."
        hq, hkv, ff = (per_layer[k][i] for k in ("n_head", "n_head_kv",
                                                 "n_ff"))
        pre = hp.get("pre_norms", True) and not post
        branch = hp.get("branch_norms")
        if post or branch:
            norm(p + "attn_output_norm.weight")
        if post or branch == "grok":
            norm(p + "layer_output_norm.weight")
        if pre and hq:
            norm(p + "attn_norm.weight")
        mla = hp.get("mla")
        if not (hq and hkv):
            # deci: an attention-free layer has its FFN alone, a linear-
            # attention one an n_embd x n_embd wo on its normed input
            if hq:
                quant(p + "attn_output.weight", c, c)
        elif mla:
            rd, dv, ql, kl = (mla[k] for k in ("rope_dim", "v_dim", "q_lora",
                                                "kv_lora"))
            if ql:
                quant(p + "attn_q_a.weight", ql, c)
                vec(p + "attn_q_a_norm.weight", ql)
                quant(p + "attn_q_b.weight", hq * d, ql)
            else:
                quant(p + "attn_q.weight", hq * d, c)
            quant(p + "attn_kv_a_mqa.weight", kl + rd, c)
            vec(p + "attn_kv_a_norm.weight", kl)
            quant(p + "attn_kv_b.weight", hq * (d - rd + dv), kl)
        elif hp.get("fused_qkv"):
            # the attn_qkv rows as one tensor of the attn_q type
            gt = fit("attn_qkv", types["attn_q"], c)
            w.add_tensor(p + "attn_qkv.weight", random_blocks(
                rng, gt, (hq + 2 * hkv) * d, c), ggml_type=gt,
                raw_ggml_shape=(c, (hq + 2 * hkv) * d))
        else:
            quant(p + "attn_q.weight", hq * d, c)
            quant(p + "attn_k.weight", hkv * d, c)
            quant(p + "attn_v.weight", hkv * d, c)
        if hq and hkv:
            quant(p + "attn_output.weight", c,
                  hq * (mla["v_dim"] if mla else d))
        if hp.get("qkv_bias") and hp.get("fused_qkv"):
            bias(p + "attn_qkv.bias", (hq + 2 * hkv) * d)
        elif hp.get("qkv_bias"):
            for name, n in (("attn_q", hq * d), ("attn_k", hkv * d),
                            ("attn_v", hkv * d)):
                bias(p + name + ".bias", n)
        if hp.get("bo"):
            bias(p + "attn_output.bias", c)
        qk = hp.get("qk_norm") if hq and hkv else None
        if qk in (True, "shared"):
            vec(p + "attn_q_norm.weight", d)
            vec(p + "attn_k_norm.weight", d)
        elif qk in ("head", "head_bias"):
            vec(p + "attn_q_norm.weight", hq, d)
            vec(p + "attn_k_norm.weight", hkv, d)
            if qk == "head_bias":
                vec(p + "attn_q_norm.bias", hq, d, mean=0.0)
                vec(p + "attn_k_norm.bias", hkv, d, mean=0.0)
        elif qk == "flat":
            vec(p + "attn_q_norm.weight", hq * d)
            vec(p + "attn_k_norm.weight", hkv * d)
        if hp.get("post_norms"):
            vec(p + "post_attention_norm.weight", c)
            vec(p + "post_ffw_norm.weight", c)
        if pre and hp.get("ffn_norm", True):
            norm(p + "ffn_norm.weight")
        if n_exp and i >= hp.get("n_dense_lead", 0):
            # router logits of std ~3 over the experts
            w.add_tensor(p + "ffn_gate_inp.weight", 0.05 * rng.standard_normal(
                (n_exp, c)).astype(np.float32))
            gt_gate, gt_up, gt_down = expert_types(ftype, i)
            fe = hp.get("n_ff_exp", ff)
            quant(p + "ffn_gate_exps.weight", fe, c, n_exp, gt_gate)
            quant(p + "ffn_up_exps.weight", fe, c, n_exp, gt_up)
            quant(p + "ffn_down_exps.weight", c, fe, n_exp, gt_down)
            fs = hp.get("shexp_ff", 0)
            if fs:
                quant(p + "ffn_gate_shexp.weight", fs, c)
                quant(p + "ffn_up_shexp.weight", fs, c)
                quant(p + "ffn_down_shexp.weight", c, fs)
            if hp.get("shexp_gate"):
                vec(p + "ffn_gate_inp_shexp.weight", c, mean=0.0, std=0.05)
            if hp.get("exp_probs_b"):
                vec(p + "exp_probs_b.bias", n_exp, mean=0.0, std=0.3)
            if not hp.get("arctic"):
                continue
            vec(p + "ffn_norm_exps.weight", c)
        ffn = hp.get("ffn", "gated")
        if ffn == "gated":
            quant(p + "ffn_gate.weight", ff, c)
        quant(p + "ffn_up.weight", 2 * ff if ffn == "fused" else ff, c)
        quant(p + "ffn_down.weight", c, ff)
        if hp.get("ffn_bias"):
            bias(p + "ffn_up.bias", ff)
        if hp.get("ffn_bias") or hp.get("down_bias"):
            bias(p + "ffn_down.bias", c)
        if hp.get("gate_bias"):
            bias(p + "ffn_gate.bias", ff)
        if hp.get("sub_norms"):
            vec(p + "attn_sub_norm.weight", hq * d)
            vec(p + "ffn_sub_norm.weight", ff)
    if "longrope" in hp:
        half = hp.get("rope_dim", d) // 2
        for name, hi in (("rope_factors_short.weight", 3.0),
                         ("rope_factors_long.weight", 64.0)):
            w.add_tensor(name, np.sort(rng.uniform(1.0, hi, half)).astype(
                np.float32))
    w.write()
    return fitted


def q8_0_row(x) -> np.ndarray:
    """A float vector (length a multiple of 32) as Q8_0 block bytes: per
    32 values an f16 scale d = max|x| / 127 and int8 round(x / d)."""
    x = np.asarray(x, np.float32).reshape(-1, 32)
    d = (np.abs(x).max(axis=1) / 127.0).astype(np.float16)
    inv = np.divide(1.0, d.astype(np.float32), where=d > 0,
                    out=np.zeros(d.shape, np.float32))
    q = np.clip(np.rint(x * inv[:, None]), -127, 127).astype(np.int8)
    raw = np.empty((x.shape[0], 34), np.uint8)
    raw[:, :2] = d.view(np.uint8).reshape(-1, 2)
    raw[:, 2:] = q.view(np.uint8)
    return raw.reshape(-1)


def _fit_type(ggml_type, k: int):
    """ggml_type if its block divides K, else Q8_0 if 32 does, else BF16
    (MiniCPM's FFN of 5760 and ChatGLM3's 13696 are no multiple of 256,
    Jais-13B's 13653 not even of 32)."""
    from llama_cpp_test_tpu_torch.gguf.constants import GGML_BLOCK_SIZES, GGMLType

    if k % GGML_BLOCK_SIZES[ggml_type][0] == 0:
        return ggml_type
    return GGMLType.Q8_0 if k % 32 == 0 else GGMLType.BF16


# ---------------------------------------------------------------------------
# phases


def phase_device(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    info = {"phase": "device", "nvidia_smi": line,
            "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "capability": list(torch.cuda.get_device_capability(0)),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0]}
    emit(info)
    return info


_KIND_NAMES = ("int8", "u4", "u2", "u4lut", "u2lut", "dense")


def _kind_label(m) -> str:
    return _KIND_NAMES[int(m.group(1))] + ("+min" if m.group(2) == "1" else "")


# checked kernel -> (its source, its mangled template arguments, how many
# instantiations the build must report, the label of one)
_INSTANTIATIONS = {
    "qmm_gemm": ("qmm", re.compile(r"qmm_gemm_kernelILi(\d)ELb([01])ELi(\d)E"),
                 16, lambda m: f"{_kind_label(m)} wg{m.group(3)}"),
    "qmm_gemv": ("qmm", re.compile(r"qmm_gemv_kernelILi(\d)ELi(\d)ELb([01])E"),
                 32, lambda m: _KIND_NAMES[int(m.group(1))]
                 + ("+min" if m.group(3) == "1" else "") + f" MT={m.group(2)}"),
    "gmm_gemv": ("gmm", re.compile(r"gmm_gemv_kernelILi(\d)ELb([01])ELi(\d)E"),
                 18, lambda m: f"{_kind_label(m)} MT<={m.group(3)}"),
    "qmm_cache": ("qmm_cache", re.compile(r"qmm_cache_kernelILi(\d)ELb([01])E"),
                  8, _kind_label),
    "flash_prefill": ("flash_prefill",
                      re.compile(r"flash_prefill_kernelILi(\d+)E"), 7,
                      lambda m: f"D={m.group(1)}"),
    "gmm_gemm": ("gmm", re.compile(r"gmm_gemm_kernelILi(\d)ELb([01])E"), 9,
                 _kind_label),
    "paged_decode": ("paged_attention",
                     re.compile(r"paged_decode_kernelILi(\d+)E(13__nv_bfloat16|a)E"),
                     14, lambda m: f"D={m.group(1)} "
                                  f"{'q8' if m.group(2) == 'a' else 'bf16'}"),
    "paged_decode_merge": ("paged_attention",
                           re.compile(r"paged_decode_merge_kernel"), 1,
                           lambda m: "f32"),
    "kbench_gemv": ("kbench", re.compile(r"probe_gemv_kernelILi(\d)ELi(\d+)E"),
                    3, lambda m: f"{'FGH'[int(m.group(1))]} LB={m.group(2)}"),
    "pairs_gemv": ("pairprobe",
                   re.compile(r"probe_gemv_kernelILi(\d)ELi(\d+)E"), 2,
                   lambda m: f"LB={m.group(2)}"),
    "kbench_stream": ("kbench", re.compile(r"stream_colsum_kernel"), 1,
                      lambda m: "u8"),
}


def ptxas_functions(text: str) -> dict:
    """Per compiled kernel of an `nvcc -Xptxas -v` report: registers and
    spill bytes (stores + loads), keyed by mangled name."""
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([\w$]+)'?", line)
        if m:
            fn = m.group(1)
            out.setdefault(fn, {"registers": 0, "spill_bytes": 0})
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[fn]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn]["registers"] = int(m.group(1))
    return out


def instantiations(reports: dict) -> dict:
    """The checked kernels' instantiations in the build reports (K1's
    qmm_gemm_kernel<KIND, HAS_MIN, WG>, K5's qmm_cache_kernel<KIND,
    HAS_MIN>, K2's flash_prefill_kernel<D>, K4's gmm_gemm_kernel<KIND,
    HAS_MIN>, K3's paged_decode_kernel<D, T> and its merge): "qmm_gemm
    u2+min wg2" -> {"registers", "spill_bytes"}."""
    out = {}
    for kernel, (src, pattern, _, label) in _INSTANTIATIONS.items():
        for fn, info in ptxas_functions(reports.get(src, "")).items():
            m = pattern.search(fn)
            if m:
                out[f"{kernel} {label(m)}"] = info
    return out


def gemv_atomics(lib_path: str) -> dict | None:
    """Atomic instructions (ATOM, ATOMG, ATOMS, RED) in the SASS of every
    GEMV kernel (qmm_gemv_kernel, gmm_gemv_kernel, probe_gemv_kernel) and
    of the byte stream (stream_colsum_kernel) of a built library, by
    cuobjdump; None where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300).stdout
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if ("gemv_kernel" in m.group(1)
                                or "stream_colsum_kernel" in m.group(1)) \
                else None
            if fn:
                out[fn] = 0
        elif fn and re.search(r"\b(ATOMG?|ATOMS|RED)\.", line):
            out[fn] += 1
    return out


def phase_build() -> dict:
    from llama_cpp_test_tpu_torch.ops import _cuda

    shutil.rmtree(_cuda.BUILD_DIR, ignore_errors=True)
    t0 = time.time()
    reports = _cuda.build_all()
    secs = time.time() - t0
    summary = {}
    for name, text in reports.items():
        fns = ptxas_functions(text)
        summary[name] = {
            "functions": len(fns),
            "max_registers": max((f["registers"] for f in fns.values()),
                                 default=0),
            "spill_functions": sum(f["spill_bytes"] > 0 for f in fns.values())}
    inst = instantiations(reports)
    for name in _cuda.SOURCES:
        _cuda.lib(name)
    # one cuobjdump a library, all started together
    names = ("qmm", "gmm", "kbench", "pairprobe")
    with ThreadPoolExecutor(len(names)) as pool:
        atomics = dict(zip(names, pool.map(
            lambda n: gemv_atomics(_cuda._lib_path(n)), names)))
    emit({"phase": "build", "seconds": round(secs, 3), "kernels": summary,
          "instantiations": inst, "gemv_atomics": atomics})
    for name, found in atomics.items():
        check(found is None or (found and not any(found.values())),
              f"build: atomics in the {name} GEMV or stream kernels: {found}")
    for kernel, (_, _, count, _) in _INSTANTIATIONS.items():
        found = sorted(k for k in inst if k.split()[0] == kernel)
        check(len(found) == count, f"build: expected {count} {kernel} "
                                   f"instantiations in the ptxas report, "
                                   f"found {found}")
    spilled = {k: v for k, v in inst.items() if v["spill_bytes"]}
    check(not spilled, f"build: spills: {spilled}")
    return inst


def _qmm_planes(rng, hp: dict, ggml_type, labels) -> dict:
    """Repacked planes (host) of the listed projections of geometry hp."""
    from llama_cpp_test_tpu_torch.quant.repack import fuse_qtensors, repack

    c, ff, v = hp["n_embd"], hp["n_ff"], hp["n_vocab"]
    nq, nkv = hp["n_head"] * hp["head_dim"], hp["n_head_kv"] * hp["head_dim"]
    mk = lambda n, k, tile_n=256: repack(random_blocks(rng, ggml_type, n, k),
                                         ggml_type, n, k, tile_n=tile_n)
    build = {
        "wqkv": lambda: fuse_qtensors([mk(nq, c), mk(nkv, c), mk(nkv, c)]),
        "wo": lambda: mk(c, nq),
        "gate|up": lambda: fuse_qtensors([mk(ff, c), mk(ff, c)]),
        "down": lambda: mk(c, ff),
        "lm_head": lambda: mk(v, c, tile_n=1024),
    }
    return {label: build[label]() for label in labels}


class KernelChecks:
    """Each kernel against its plain version on the same inputs, timed
    beside a library call computing the same function and its bound."""

    def __init__(self, torch, timer, rng):
        self.torch, self.timer, self.rng = torch, timer, rng
        self.failures = []

    def _row(self, kernel, shape, out_k, out_p, gate, fn_k, fn_p, fn_lib,
             nbytes, flops, library=None, out_fold=None, extra=None):
        """out_fold: for a GEMM (K1's, K5, K4's) on planes with a min, the
        plain version rounded as the GEMM and the TPU kernels round it
        (bf16(s*q), then x-sums . min in f32), held at FOLD_GATE beside the
        plain version's gate. The GEMVs apply each group's scale in f32
        and round no weight, so they have no such twin."""
        torch = self.torch
        a = out_k.float().reshape(out_p.shape)
        b = out_p.float()
        torch.cuda.synchronize()
        err = nmse(b.cpu(), a.cpu())
        b_ms, b_by = bound(nbytes, flops)
        row = {"kernel": kernel, "shape": shape, "nmse": err, "gate": gate,
               "max_abs_err": float((a - b).abs().max()),
               "ms": self.timer(fn_k), "plain_ms": self.timer(fn_p, iters=5),
               "library_ms": self.timer(fn_lib), "bound_ms": b_ms,
               "bound_by": b_by}
        if out_fold is not None:
            row["nmse_fold"] = nmse(out_fold.float().reshape(out_p.shape)
                                    .cpu(), a.cpu())
            row["fold_gate"] = FOLD_GATE
        if library:
            row["library"] = library
        row.update(extra or {})
        emit({"phase": "kernels", **row})
        if not err < gate or not row.get("nmse_fold", 0.0) < FOLD_GATE:
            self.failures.append(shape)
        return row

    def qmm(self, label, kind, qt, m, cache=False):
        """K1 (GEMV for m <= 8, GEMM above), or K5 with cache=True."""
        from llama_cpp_test_tpu_torch.ops import qmatmul

        torch = self.torch
        k, n_full = qt.shape[1], qt.shape[0]
        x = torch.from_numpy(self.rng.standard_normal((m, k)).astype(np.float32)) \
            .to("cuda").to(torch.bfloat16)
        w_lib = qmatmul.dequantize(qt)                     # [K, N] bf16
        if cache:
            name, fn_k = "qmm_cache", lambda: qmatmul._qmm_cache_cuda(x, qt)
        else:
            name = "qmm_gemv" if m <= 8 else "qmm_gemm"
            fn_k = lambda: qmatmul._qmm_planes_cuda(x, qt)
        fn_p = lambda: qmatmul._matmul_f32(x, qmatmul.dequantize(qt))
        plane_bytes = sum(t.numel() * t.element_size()
                          for t in (qt.qs, qt.scale, qt.min_, qt.lut)
                          if t is not None)
        fold = (None if qt.min_ is None or name == "qmm_gemv"
                else qmatmul.plain_planes(x, qt, rounding="fold"))
        row = self._row(name, f"{label} {kind} M={m} K={k} N={n_full}",
                        fn_k(), fn_p(), QMM_GATE, fn_k, fn_p,
                        lambda: torch.matmul(x, w_lib),
                        x.numel() * 2 + plane_bytes + m * n_full * 4,
                        2.0 * m * k * n_full, out_fold=fold)
        del w_lib
        return row

    def gmm(self, label, kind, qt, m, top_k=2):
        """K4 on a stacked expert plane at m tokens routed top_k of E by
        softmax over random router logits, as moe_ffn routes them."""
        from llama_cpp_test_tpu_torch.ops import gmm, qmatmul

        torch = self.torch
        e, k, npk = qt.qs.shape
        logits = torch.from_numpy(self.rng.standard_normal((m, e)).astype(
            np.float32)).to("cuda")
        topv, topi = torch.topk(torch.softmax(logits, -1), top_k, dim=-1)
        tile_m = gmm.TILE_GEMV if m * top_k <= 256 else gmm.TILE_GEMM
        rt = gmm.route_tokens(topi, topv / topv.sum(-1, keepdim=True),
                              n_expert_local=e, tile_m=tile_m)
        x = torch.from_numpy(self.rng.standard_normal((m, k)).astype(
            np.float32)).to("cuda").to(torch.bfloat16)
        xs = x[rt.tok_idx.long()].contiguous()
        fn_k = lambda: gmm._planes_cuda(xs, qt, rt, tile_m)
        fn_p = lambda: gmm._planes_plain(xs, qt, rt, tile_m)
        # the bound counts the experts this routing reads, once each
        routed = torch.unique(topi).numel()
        plane_bytes = sum(t.numel() * t.element_size() for t in
                          (qt.qs, qt.scale, qt.min_) if t is not None)
        w_all = qt.qs if qt.kind == "dense" else torch.stack([
            qmatmul._dequant_t(qt.qs[i], qt.scale[i],
                               None if qt.min_ is None else qt.min_[i],
                               qt.lut, kind=qt.kind, group=qt.group)
            for i in range(e)])
        fn_lib, lib_name = _grouped_yardstick(torch, x, topi, w_all)
        fold = (None if qt.min_ is None or tile_m == gmm.TILE_GEMV else
                gmm._planes_plain(xs, qt, rt, tile_m, rounding="fold"))
        row = self._row(
            "gmm_gemv" if tile_m == gmm.TILE_GEMV else "gmm_gemm",
            f"{label} {kind} M={m} top{top_k}/{e} K={k} N={qt.shape[0]} "
            f"tile_m={tile_m} routed={routed}",
            fn_k(), fn_p(), GMM_GATE, fn_k, fn_p, fn_lib,
            m * k * 2 + plane_bytes * routed // e + m * top_k * qt.shape[0] * 4,
            2.0 * m * top_k * k * qt.shape[0], library=lib_name,
            out_fold=fold)
        del w_all
        return row

    def _pool(self, kvh, nb, bs, d):
        return torch_bf16(self.torch, self.rng.standard_normal((kvh, nb, bs, d)) * 0.5)

    def paged_decode(self, hp, b, bs=16, nbmax=64, q8=False, lens=None,
                     soft_cap=None):
        """K3 over bf16 pages, or over q8_0 pages (int8 + f32 slot
        scales) with q8=True; lengths drawn from 200-500, or `lens`; the
        logits soft-capped at soft_cap (Gemma-2's global layers). The
        block tables are nbmax pages wide: 64 is the engine's width in
        every serve phase (n_ctx 1024 over pages of 16), and K3's split
        count follows it. Beside the kernel's time, `one_split_ms` times
        the same call with the split plan forced to one range (one kernel,
        no merge). SDPA, the library yardstick, takes no softcap: with
        one, it times the uncapped function on the same inputs."""
        from llama_cpp_test_tpu_torch.ops import flash_prefill as fp
        from llama_cpp_test_tpu_torch.ops import paged_attention as pa
        from llama_cpp_test_tpu_torch.runtime import kv_cache

        torch, rng = self.torch, self.rng
        h, kvh, d = hp["n_head"], hp["n_head_kv"], hp["head_dim"]
        if lens is not None:
            nbmax = max(nbmax, -(-max(lens) // bs))
        nb = b * nbmax + 4
        kpool, vpool = self._pool(kvh, nb, bs, d), self._pool(kvh, nb, bs, d)
        scales = {}
        if q8:
            (kq, ks), (vq, vs) = (kv_cache.quantize_q8(kpool),
                                  kv_cache.quantize_q8(vpool))
            scales = {"k_scale": ks, "v_scale": vs}
            kpool, vpool = kq, vq
        table = torch.from_numpy(rng.permutation(nb)[: b * nbmax]
                                 .reshape(b, nbmax).astype(np.int32)).to("cuda")
        lens_np = (np.asarray(lens, np.int32) if lens is not None else
                   rng.integers(200, 500, size=b).astype(np.int32))
        lens = torch.from_numpy(lens_np).to("cuda")
        q = torch_bf16(torch, rng.standard_normal((b, h, d)) / 8)
        fn_k = lambda: pa.paged_attention_decode(q, kpool, vpool, lens, table,
                                                 soft_cap=soft_cap, **scales)
        fn_p = lambda: pa.paged_attention_decode_plain(
            q, kpool, vpool, lens, table, soft_cap=soft_cap, **scales)
        s = nbmax * bs
        mask = (torch.arange(s, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
        if q8:
            lk, lv = (kv_cache.gather_kv_q8(p, sc, table).permute(0, 2, 1, 3)
                      .repeat_interleave(h // kvh, dim=1).contiguous()
                      for p, sc in ((kpool, scales["k_scale"]),
                                    (vpool, scales["v_scale"])))
        else:
            lk, lv = _sdpa_kv(fp, kpool, vpool, table, h // kvh)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lq = q[:, :, None, :]
        n_keys = int(lens_np.sum())
        # bytes per key or value row: D elements, plus its f32 scale (q8)
        row_bytes = d + 4 if q8 else 2 * d
        plan = pa.split_plan
        try:
            pa.split_plan = lambda *a: (1, nbmax)
            one = {"one_split_ms": self.timer(fn_k)}
        finally:
            pa.split_plan = plan
        one["splits"] = plan(b, kvh, nbmax, bs, torch.cuda.get_device_properties(
            0).multi_processor_count)
        cap = f" cap={soft_cap}" if soft_cap else ""
        one["sdpa_backend"] = _sdpa_backend(torch, lq, lk, lv, mask)
        return self._row(
            "paged_decode_q8" if q8 else "paged_decode",
            f"B={b} H={h} KV={kvh} D={d} BS={bs} nbmax={nbmax}{cap} "
            f"lens={lens_np.tolist()}",
            fn_k(), fn_p(), ATTN_GATE, fn_k, fn_p,
            lambda: sdpa(lq, lk, lv, attn_mask=mask, scale=1.0),
            2 * q.numel() * 2 + n_keys * kvh * row_bytes * 2,
            4.0 * d * h * n_keys, extra=one,
            library="sdpa without the softcap" if soft_cap else None)

    def flash_prefill(self, hp, t=512, start=0, bs=16, window=0,
                      soft_cap=0.0, causal=True):
        """A chunk of t tokens at positions start.. over a cache that holds
        start + t tokens (start > 0: a cached prefix), with a sliding
        window and a softcap if given; causal=False gives every row the
        mask position start + t - 1, as an encoder's embed does (every
        query attends every key). The operations count the (query, key)
        pairs the mask leaves; SDPA takes the window in its mask but no
        softcap (with one, it times the uncapped function)."""
        from llama_cpp_test_tpu_torch.ops import flash_prefill as fp

        torch, rng = self.torch, self.rng
        h, kvh, d = hp["n_head"], hp["n_head_kv"], hp["head_dim"]
        n = start + t
        nbmax = -(-n // bs)
        nb = nbmax + 4
        kpool, vpool = self._pool(kvh, nb, bs, d), self._pool(kvh, nb, bs, d)
        table = torch.from_numpy(rng.permutation(nb)[:nbmax].reshape(1, nbmax)
                                 .astype(np.int32)).to("cuda")
        pos = torch.arange(start, n, dtype=torch.int32, device="cuda")[None]
        if not causal:
            pos = torch.full_like(pos, n - 1)
        kvl = torch.tensor([n], dtype=torch.int32, device="cuda")
        q = torch_bf16(torch, rng.standard_normal((1, t, h, d)) / 8)
        kw = dict(window=window, soft_cap=soft_cap)
        fn_k = lambda: fp.flash_prefill(q, kpool, vpool, pos, kvl, table, **kw)
        fn_p = lambda: fp.flash_prefill_plain(q, kpool, vpool, pos, kvl,
                                              table, **kw)
        mask = fp.prefill_mask(pos, kvl, nbmax * bs, window)[:, None]
        lk, lv = _sdpa_kv(fp, kpool, vpool, table, h // kvh)
        lq = q.permute(0, 2, 1, 3).contiguous()
        sdpa = torch.nn.functional.scaled_dot_product_attention
        p = pos[0].cpu().numpy()
        pairs = int((np.minimum(p + 1, window) if window else p + 1).sum())
        quirks = (f" window={window}" if window else "") + (
            f" cap={soft_cap}" if soft_cap else "") + (
            "" if causal else " non-causal")
        return self._row(
            "flash_prefill",
            f"B=1 T={t} start={start} H={h} KV={kvh} D={d} BS={bs}{quirks}",
            fn_k(), fn_p(), ATTN_GATE, fn_k, fn_p,
            lambda: sdpa(lq, lk, lv, attn_mask=mask, scale=1.0),
            2 * q.numel() * 2 + n * kvh * d * 2 * 2, 4.0 * d * h * pairs,
            library="sdpa without the softcap" if soft_cap else None,
            extra={"sdpa_backend": _sdpa_backend(torch, lq, lk, lv, mask)})


def _sdpa_backend(torch, q, k, v, mask) -> str:
    """The backend torch's scaled_dot_product_attention dispatches these
    inputs to (flash, efficient, cuDNN, math): its flash backend takes no
    mask and no head dim that is not a multiple of 8."""
    try:
        from torch.nn.attention import SDPBackend

        i = int(torch._fused_sdp_choice(q, k, v, mask, 0.0, False,
                                        scale=1.0))
        names = {int(m): n for n, m in SDPBackend.__members__.items()}
        return names.get(i, str(i))
    except Exception as e:   # a torch without the private query
        return f"not read ({type(e).__name__})"


def _grouped_yardstick(torch, x, topi, w_all):
    """One library call computing the grouped product on pre-dequantized
    bf16 experts w_all [E, K, N]: torch._grouped_mm over the routed rows
    sorted by expert where the installed torch has it, else the per-expert
    torch.matmul calls (timed together). Returns (callable, label)."""
    e = w_all.shape[0]
    m, top_k = topi.shape
    flat = topi.reshape(-1)
    order = torch.argsort(flat, stable=True)
    a = x[torch.arange(m, device=x.device).repeat_interleave(top_k)[order]]
    counts = torch.bincount(flat, minlength=e)
    offs = torch.cumsum(counts, 0).to(torch.int32)
    gmm_fn = getattr(torch, "_grouped_mm", None)
    if gmm_fn is not None:
        for b in (w_all, w_all.transpose(1, 2).contiguous().transpose(1, 2)):
            fn = lambda b=b: gmm_fn(a, b, offs=offs)
            try:
                fn()
                torch.cuda.synchronize()
                return fn, "torch._grouped_mm"
            except (RuntimeError, TypeError, ValueError):
                continue
    bounds = [0] + torch.cumsum(counts, 0).tolist()
    segs = [(a[bounds[i]:bounds[i + 1]], w_all[i]) for i in range(e)
            if bounds[i + 1] > bounds[i]]
    return (lambda: [torch.matmul(xa, w) for xa, w in segs],
            "sum of per-expert torch.matmul")


def _expert_planes(torch, rng, kind: str, e: int, n: int, k: int):
    """Stacked expert planes [E, ...] on the card with the layout of the
    loader's _repack_3d: 'u4+min' as Q4_K repacks (u4 nibbles, group 32,
    bf16 scale and min), 'int8' as Q6_K (int8 in [-32, 31], group 16).
    Drawn on the device: the kernel checks need the shapes and value
    ranges, and host repacking of 16 Mixtral experts costs minutes."""
    from llama_cpp_test_tpu_torch.quant.repack import QTensor

    g = torch.Generator(device="cuda")
    g.manual_seed(int(rng.integers(1 << 30)))
    pack, group = (2, 32) if kind == "u4+min" else (1, 16)
    npk = n // pack
    if pack == 2:
        qs = torch.randint(0, 256, (e, k, npk), generator=g, device="cuda",
                           dtype=torch.uint8)
    else:
        qs = torch.randint(-32, 32, (e, k, npk), generator=g, device="cuda",
                           dtype=torch.int8)
    planes = (e, pack, k // group, npk)
    scale = (torch.rand(planes, generator=g, device="cuda") * 1e-3 + 5e-4) \
        .to(torch.bfloat16)
    min_ = (scale.float() * 7.5).to(torch.bfloat16) if pack == 2 else None
    return QTensor("u4" if pack == 2 else "int8", (n, k), n, group, qs,
                   scale, min_)


def torch_bf16(torch, a: np.ndarray):
    return torch.from_numpy(a.astype(np.float32)).to("cuda").to(torch.bfloat16)


def _sdpa_kv(fp, kpool, vpool, table, g):
    """Gathered, GQA-expanded K/V [B, H, S, D] for the library yardstick."""
    kk = fp.gather_pages(kpool, table).permute(0, 2, 1, 3)
    vv = fp.gather_pages(vpool, table).permute(0, 2, 1, 3)
    return (kk.repeat_interleave(g, dim=1).contiguous(),
            vv.repeat_interleave(g, dim=1).contiguous())


# profiled decode windows before their check gives up: a session with no
# device record at all proves nothing, and torch.profiler on an H100 has
# returned none for whole sessions now and then (PERF.md §7)
PROFILER_TRIES = 20


def gemv_launches(torch, qt, stack) -> dict:
    """One K1 GEMV call (x [1, K] against planes qt) and one K4 GEMV call
    (one token routed top-2 of the stacked experts), each captured in a
    CUDA graph: one kernel a call and no memset;
    and a second call on the same inputs must give the same bits (the K
    split meets in distributed shared memory, with no atomics)."""
    from llama_cpp_test_tpu_torch.ops import gmm, qmatmul

    rng = np.random.default_rng(99)
    x = torch_bf16(torch, rng.standard_normal((1, qt.shape[1])))
    e = stack.qs.shape[0]
    topv, topi = torch.topk(torch.softmax(torch.from_numpy(
        rng.standard_normal((1, e)).astype(np.float32)).to("cuda"), -1), 2)
    rt = gmm.route_tokens(topi, topv, n_expert_local=e, tile_m=gmm.TILE_GEMV)
    xs = torch_bf16(torch, rng.standard_normal((rt.tok_idx.shape[0],
                                                 stack.qs.shape[1])))
    calls = {"qmm_gemv": lambda: qmatmul._qmm_planes_cuda(x, qt),
             "gmm_gemv": lambda: gmm._planes_cuda(xs, stack, rt,
                                                  gmm.TILE_GEMV)}
    return one_launch_each(torch, calls, "kernels", "gemv launches")


# CUgraphNodeType (cuda.h): the node kinds a captured call can hold
GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
                    4: "graph", 5: "empty", 6: "wait_event",
                    7: "event_record", 8: "ext_semas_signal",
                    9: "ext_semas_wait", 10: "mem_alloc", 11: "mem_free",
                    12: "batch_mem_op", 13: "conditional"}


def captured_nodes(torch, fn):
    """One call of `fn` captured in a CUDA graph (any host sync inside it
    fails the capture): (its output, the node kinds of the graph in
    order). The graph is then replayed once, so the output holds what the
    captured work computed on the device."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, capture_error_mode="thread_local"):
        out = fn()
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)) == 0,
          "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    check(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) == 0,
          "cuGraphGetNodes failed")
    kinds = []
    for node in nodes[:n.value]:
        t = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                    ctypes.byref(t)) == 0,
              "cuGraphNodeGetType failed")
        kinds.append(GRAPH_NODE_TYPES.get(t.value, str(t.value)))
    g.replay()
    torch.cuda.synchronize()
    out = out.clone()
    g.reset()
    return out, kinds


def one_launch_each(torch, calls: dict, phase: str, label: str) -> dict:
    """Each call of `calls` (name -> fn) run once, then captured in a CUDA
    graph and replayed: the graph must hold one kernel and no memset, and
    its replay give the same bits as the first run. The graph records
    every launch the call makes on its stream, with no sampling (the
    torch.profiler sessions this check used before returned no device
    record at all for one short call, now and then, PERF.md §7)."""
    out = {"phase": phase, "kernel": label}
    for name, fn in calls.items():
        first = fn()
        torch.cuda.synchronize()
        second, kinds = captured_nodes(torch, fn)
        out[name] = {"graph_nodes": kinds,
                     "kernels": kinds.count("kernel"),
                     "memsets": kinds.count("memset"),
                     "bit_equal": bool(torch.equal(first, second))}
    emit(out)
    for name in calls:
        r = out[name]
        check(r["kernels"] == 1 and r["memsets"] == 0,
              f"{name}: one call put {r['graph_nodes']} on the device "
              "(one kernel and no memset expected)")
        check(r["bit_equal"], f"{name}: two calls on the same inputs differ")
    return out


def phase_kernels(torch, timer) -> dict:
    """TinyLlama-1.1B: the five projections as Q4_K (u4 planes with a min)
    and Q8_0 (int8) at M in {1, 512} (gate|up also at 128), decode
    attention at B in {1, 8}, prefill attention at T = 512 and for a chunk
    after a cached prefix.
    Llama-3-8B (config #2): the widest projections and both attentions at
    D = 128, G = 4. Mixtral-8x7B (config #4): K4 on both expert
    projections, u4+min and int8, and K3 over q8_0 pages."""
    from llama_cpp_test_tpu_torch.gguf.constants import GGMLType
    from llama_cpp_test_tpu_torch.weights import qtensor_to_torch

    rng = np.random.default_rng(1234)
    kc = KernelChecks(torch, timer, rng)
    rep = {}
    rows = {"paged_decode": [], "paged_decode_q8": [], "gmm_gemm": [],
            "qmm_gemv": [], "gmm_gemv": [], "flash_prefill": []}
    labels = ("wqkv", "wo", "gate|up", "down", "lm_head")
    for gt, kind in ((GGMLType.Q4_K, "u4+min"), (GGMLType.Q8_0, "int8")):
        for label, qt in _qmm_planes(rng, TINYLLAMA, gt, labels).items():
            qt = qtensor_to_torch(qt, "cuda")
            # M = 3 and 8: the GEMV's 4- and 8-row variants (batched
            # decode); M = 40: a partial GEMM row tile (short prompts);
            # M = 128: the GEMM at a middle bucket
            for m in (1, 512) + ((3, 8, 40) if label == "wo" else ()) + (
                    (8, 128) if label == "gate|up" else ()):
                row = kc.qmm(label, kind, qt, m)
                if label == "gate|up" and kind == "u4+min" and m in (1, 512):
                    rep[row["kernel"]] = row
                if m <= 8:
                    rows["qmm_gemv"].append(row)
            if label == "gate|up" and kind == "u4+min":
                gemv_qt = qt
    # the floor this timer reads for one and for two dependent kernels
    # that do nothing (K3 with more than one range is two: the split
    # kernel and its merge)
    empty = lambda n: lambda: [torch.cuda._sleep(0) for _ in range(n)]
    emit({"phase": "kernels", "kernel": "timer floor",
          "one_empty_kernel_ms": timer(empty(1)),
          "two_empty_kernels_ms": timer(empty(2))})
    for b in (1, 8):
        rep["paged_decode"] = kc.paged_decode(TINYLLAMA, b)
        rows["paged_decode"].append(rep["paged_decode"])
    # tables of 32 pages, as the kernel rows before the engine's width
    rows["paged_decode"].append(kc.paged_decode(TINYLLAMA, 8, nbmax=32))
    # one sequence over ~4000 cached tokens: the split across blocks
    rows["paged_decode"].append(kc.paged_decode(TINYLLAMA, 1, lens=[4000]))
    rows["flash_prefill"].append(kc.flash_prefill(TINYLLAMA, t=100,
                                                  start=300))
    rep["flash_prefill"] = kc.flash_prefill(TINYLLAMA)
    rows["flash_prefill"].append(rep["flash_prefill"])
    for label, qt in _qmm_planes(rng, LLAMA3_8B, GGMLType.Q4_K,
                                 ("gate|up", "down")).items():
        qt = qtensor_to_torch(qt, "cuda")
        for m in (1, 512):
            kc.qmm("8B " + label, "u4+min", qt, m)
    rows["paged_decode"] += [kc.paged_decode(LLAMA3_8B, 8),
                             kc.paged_decode(LLAMA3_8B, 1, lens=[4000])]
    rows["flash_prefill"].append(kc.flash_prefill(LLAMA3_8B))
    # Mixtral-8x7B: K4 on the expert stacks of gate/up (K=4096, N=14336)
    # and down (K=14336, N=4096) at M = 1 and 8 (decode, tile_m 8) and 512
    # (prefill, tile_m 64); K3 over q8_0 pages at Mixtral's geometry
    c, ff, e = MIXTRAL["n_embd"], MIXTRAL["n_ff"], MIXTRAL["n_expert"]
    for kind in ("u4+min", "int8"):
        for label, n, k in (("gate/up", ff, c), ("down", c, ff)):
            qt = _expert_planes(torch, rng, kind, e, n, k)
            for m in (1, 8, 512):
                row = kc.gmm("Mixtral " + label, kind, qt, m)
                if label == "gate/up" and kind == "u4+min" and m != 8:
                    rep[row["kernel"]] = row
                rows["gmm_gemm" if m == 512 else "gmm_gemv"].append(row)
            if label == "gate/up" and kind == "u4+min":
                gemv_launches(torch, gemv_qt, qt)
            del qt
    # BitNet b1.58-3B's geometry (MHA, D = 100, padded to 112 inside the
    # kernels): K2 at T = 512, K3 and K3-q8 at B = 1 and 8
    rows["flash_prefill"].append(kc.flash_prefill(BITNET_3B))
    for b in (1, 8):
        rows["paged_decode"].append(kc.paged_decode(BITNET_3B, b))
        rows["paged_decode_q8"].append(kc.paged_decode(BITNET_3B, b,
                                                       q8=True))
    rep["paged_decode_q8"] = kc.paged_decode(MIXTRAL, 8, q8=True)
    rows["paged_decode_q8"] += [rep["paged_decode_q8"],
                                kc.paged_decode(MIXTRAL, 8, nbmax=32, q8=True),
                                kc.paged_decode(MIXTRAL, 1, q8=True),
                                kc.paged_decode(MIXTRAL, 1, q8=True,
                                                lens=[4000])]
    check(not kc.failures, f"kernels outside their gate: {kc.failures}")
    return rep, rows


def _decode_plane_bytes(w, hp) -> int:
    """Bytes one decode token (B = 1) must read: every dense matmul plane
    (the lm head and the layer projections) once, and per MoE layer the
    planes of the n_expert_used routed experts only (top-2 of 8 for
    Mixtral), not the whole stacks. The embedding row gather is ~0."""
    size = lambda qt: sum(t.numel() * t.element_size()
                          for t in (qt.qs, qt.scale, qt.min_) if t is not None)
    total = size(w.output)
    for lw in w.layers:
        for f in ("wqkv", "wq", "wk", "wv", "wo", "w_gateup", "w_gate",
                  "w_up", "w_down", "gate_inp"):
            if getattr(lw, f) is not None:
                total += size(getattr(lw, f))
        for f in ("gate_exps", "up_exps", "down_exps"):
            if getattr(lw, f) is not None:
                qt = getattr(lw, f)
                total += size(qt) * hp.n_expert_used // qt.qs.shape[0]
    return int(total)


def _serve_requests(torch, ctx, prompts, n_vocab, batch: int) -> list:
    """Three generate() requests one after another, then one batched decode
    step of `batch` sequences (short prompts). Returns per-request rates."""
    from llama_cpp_test_tpu_torch.runtime.engine import generate

    requests = []
    for p in prompts:
        t0 = time.time()
        gen = generate(ctx, p, 32)
        toks = [next(gen)]
        t_first = time.time()
        toks.extend(gen)
        t_end = time.time()
        check(len(toks) == 32, f"generate gave {len(toks)} tokens")
        requests.append({"prompt": len(p), "new": len(toks),
                         "prefill_tok_s": len(p) / (t_first - t0),
                         "decode_tok_s": (len(toks) - 1) / (t_end - t_first)})
    seqs = [ctx.new_seq() for _ in range(batch)]
    last = [ctx.prefill(s, prompts[i % 2][: 16 + 8 * i])
            for i, s in enumerate(seqs)]
    t0 = time.time()
    out = ctx.decode(seqs, [int(np.argmax(l)) for l in last])
    torch.cuda.synchronize()
    requests.append({"batched_decode_rows": batch,
                     "step_ms": (time.time() - t0) * 1e3})
    check(out.shape == (batch, n_vocab) and np.isfinite(out).all(),
          "batched decode logits not finite / wrong shape")
    for s in seqs:
        ctx.free_seq(s)
    return requests


@contextlib.contextmanager
def _record_routing():
    """Collect the expert ids (sorted per row) that moe_ffn routes each MoE
    layer's rows to, with their weights where the gating is phimoe's
    sparsemixer (zeros otherwise), one [rows, 2 * top_k] array (ids, then
    weights) per layer call, by wrapping models.llama._moe_grouped while
    the block runs."""
    from llama_cpp_test_tpu_torch.models import llama

    orig, calls = llama._moe_grouped, []

    def record(xf, lw, hp, topi, topv, plain=False):
        ids, order = topi.sort(dim=-1)
        w = (topv.gather(-1, order) if hp.expert_gating == "sparsemixer"
             else topv.new_zeros(topv.shape))
        calls.append(_routing_array(ids, w))
        return orig(xf, lw, hp, topi, topv, plain)

    llama._moe_grouped = record
    try:
        yield calls
    finally:
        llama._moe_grouped = orig


def _routing_array(ids, weights) -> np.ndarray:
    """[rows, k] expert ids and [rows, k] weights as one float64 numpy
    array [rows, 2k]."""
    return np.concatenate([ids.cpu().double().numpy(),
                           weights.cpu().double().numpy()], -1)


# a sparsemixer pick whose weight moves by more than this share of its
# row's largest weight took another routing: phimoe's sparsemixer masks an
# expert within 2 * router_jitter of the best out of the pick's softmax, a
# decision a rounding can flip with the same picks, and the weight jumps
# (the softmax and sigmoid gates' weights move with the logits, smoothly,
# and only their picks are compared)
ROUTE_WEIGHT_TOL = 0.1


def _routing_differs(ra, rb) -> np.ndarray:
    """[..., rows] True where two recorded routings (ids, then weights)
    differ: another expert, or a weight moved past ROUTE_WEIGHT_TOL."""
    k = ra.shape[-1] // 2
    wa, wb = ra[..., k:], rb[..., k:]
    tol = ROUTE_WEIGHT_TOL * np.abs(wa).max(-1, keepdims=True)
    return (ra[..., :k] != rb[..., :k]).any(-1) | (
        np.abs(wa - wb) > tol).any(-1)


def _trace(ctx, prompt, tokens=None, n_decode: int = 4):
    """One prefill (logits at every position) and n_decode decode steps, on
    the given decode tokens or else greedy ones. Returns the logits of each
    step [rows, V], its routing [layers, rows, 2 * top_k] (None on a dense
    model) and the decode tokens."""
    s = ctx.new_seq()
    steps, toks = [], []
    with _record_routing() as calls:
        logits = ctx.prefill(s, prompt, all_logits=True)
        for i in range(n_decode + 1):
            if i:
                toks.append(tokens[i - 1] if tokens else
                            int(np.argmax(logits[-1])))
                logits = ctx.decode([s], toks[-1:])
            rows = logits.shape[0]
            steps.append((logits, np.stack(calls)[:, :rows] if calls else None))
            calls.clear()
    ctx.free_seq(s)
    return steps, toks


def _compare(steps_a, steps_b) -> dict:
    """Logits NMSE of b against a per step, over all rows and over the rows
    whose experts agree in every layer, with the count of rows (and of
    layer rows) whose routing differs."""
    out = {}
    for i, ((la, ra), (lb, rb)) in enumerate(zip(steps_a, steps_b)):
        diff = (np.zeros((1, la.shape[0]), bool) if ra is None
                else _routing_differs(ra, rb))            # [layers, rows]
        same = ~diff.any(0)
        out["prefill" if i == 0 else f"decode{i - 1}"] = {
            "rows": int(la.shape[0]), "nmse": nmse(la, lb),
            "nmse_last_row": nmse(la[-1], lb[-1]),
            "routing_changed_rows": int((~same).sum()),
            "routing_changed_layer_rows": int(diff.sum()),
            "first_changed_row": (int(np.argmin(same)) if not same.all()
                                  else None),
            "nmse_same_routing": (nmse(la[same], lb[same]) if same.any()
                                  else None)}
    return out


@contextlib.contextmanager
def _qmm_variant(variant):
    """ops.qmatmul.QMM_VARIANT set to variant (None: left as it is) while
    the block runs, as a user sets LLAMA_TPU_QMM_VARIANT."""
    from llama_cpp_test_tpu_torch.ops import qmatmul

    orig = qmatmul.QMM_VARIANT
    qmatmul.QMM_VARIANT = variant or orig
    try:
        yield
    finally:
        qmatmul.QMM_VARIANT = orig


@contextlib.contextmanager
def _plain_min(rounding):
    """ops.qmatmul.PLAIN_MIN set to rounding while the block runs."""
    from llama_cpp_test_tpu_torch.ops import qmatmul

    orig = qmatmul.PLAIN_MIN
    qmatmul.PLAIN_MIN = rounding
    try:
        yield
    finally:
        qmatmul.PLAIN_MIN = orig


@contextlib.contextmanager
def _record_kinds():
    """Count the K1, K5 and K4 launches per plane kind ("K1 u2": n, ...,
    "K4 gemv dense": n) while the block runs, by wrapping the launch
    wrappers of ops.qmatmul and ops.gmm."""
    from llama_cpp_test_tpu_torch.ops import gmm, qmatmul

    tally = {}
    count = lambda key: tally.__setitem__(key, tally.get(key, 0) + 1)
    wrapped = {(qmatmul, "_qmm_planes_cuda"): "K1",
               (qmatmul, "_qmm_cache_cuda"): "K5",
               (gmm, "_planes_cuda"): "K4"}
    orig = {key: getattr(*key) for key in wrapped}

    def wrap(key):
        f, label = orig[key], wrapped[key]
        if label == "K4":
            def launch(xs, qt, routing, tile_m):
                count(f"K4 {'gemv' if tile_m == gmm.TILE_GEMV else 'gemm'} "
                      f"{qt.kind}")
                return f(xs, qt, routing, tile_m)
        else:
            def launch(x2, qt):
                count(f"{label} {qt.kind}")
                return f(x2, qt)
        return launch

    for key in wrapped:
        setattr(*key, wrap(key))
    try:
        yield tally
    finally:
        for (mod, name), f in orig.items():
            setattr(mod, name, f)


def _label(kv, variant) -> str:
    return kv if variant is None else f"{kv}/{variant}"


def _kernels_vs_plain(model, prompt, contexts, n_decode: int = 4,
                      joint: bool = True) -> tuple[dict, list]:
    """Logits at every position of one prefill and of n_decode decode
    steps on the same tokens, through the kernels and through the plain path, per
    Context (KV type, qmm variant). The gated plain path rounds a weight
    with a min as the TPU kernels and K1, K4 and K5 do (PLAIN_MIN "fold");
    the plain path at the XLA path's joint rounding is recorded beside
    ("<context> joint min"), as the witness of what that rounding alone
    moves, on a file with a min (on one without, both roundings are one
    computation, and that trace is not run). Where a MoE router's top-2 probabilities are near-tied, the
    kernels' rounding can send a row to another expert pair than the
    plain path does: that row is then another computation, not a kernel
    error. So the routing of every row is compared, and the gate holds the
    rows whose experts agree in every layer (and fails if fewer than half
    of a prefill's rows do). The plain path's q8_0 prefill against its
    bf16 one is recorded too, as the witness of what int8 K/V alone moves.
    Returns the readings and the steps outside the gate."""
    from llama_cpp_test_tpu_torch.runtime.engine import Context

    out, plain, bad = {}, {}, []
    w = model.weights
    has_min = any(qt is not None and qt.min_ is not None for qt in [
        w.output] + [getattr(lw, f) for lw in w.layers for f in (
            "wqkv", "wq", "wk", "wv", "wo", "w_gateup", "w_gate", "w_up",
            "w_down", "gate_exps", "up_exps", "down_exps")])
    for kv, variant in contexts:
        label = _label(kv, variant)
        ctx = lambda **kw: Context(model, n_ctx=1024, n_seq_max=2,
                                   block_size=16, kv_type=kv, **kw)
        with _qmm_variant(variant):
            steps_k, toks = _trace(ctx(), prompt, n_decode=n_decode)
        with _plain_min("fold"):
            steps_p, _ = _trace(ctx(plain=True), prompt, toks, n_decode)
        check(all(np.isfinite(lg).all() for lg, _ in steps_k),
              f"{label}: kernel logits not finite")
        plain[label] = steps_p
        out[label] = _compare(steps_p, steps_k)
        if has_min and joint:
            with _plain_min("joint"):
                steps_j, _ = _trace(ctx(plain=True), prompt, toks, n_decode)
            out[f"{label} joint min"] = _compare(steps_j, steps_k)
        for step, r in out[label].items():
            v = r["nmse_same_routing"]
            if (v is not None and not v < LOGITS_GATE) or (
                    step == "prefill" and 2 * r["routing_changed_rows"]
                    > r["rows"]):
                bad.append((label, step, v, r["routing_changed_rows"]))
    if "q8_0" in plain and "bf16" in plain:
        out["plain_q8_0_vs_bf16"] = _compare(plain["bf16"][:1],
                                             plain["q8_0"][:1])["prefill"]
    return out, bad


class Kept:
    """Files the serve phases keep for the cli and sched phases: name ->
    path, in a directory main makes and removes."""

    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_kept_")
        self.files: dict[str, str] = {}

    def remove(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)


def _serve(torch, name, hp, seed, contexts, batch, path_kernels, profile,
           ftype="Q4_K", kinds=(), rows=None, keep=None, chat_template=None,
           n_ctx=1024, n_decode=4, joint=True):
    """Synthesize the GGUF, load it with Model(path) on cuda, serve every
    Context (KV type, qmm variant; n_ctx tokens) with the launch counts
    zeroed just before and read just after: generate() at 16, 130 and
    512 prompt tokens, then a batched decode of `batch` rows. Then hold
    the kernels against the plain path over the 130-token prompt's
    prefill and n_decode decode steps. path_kernels must launch over the
    phase; a "cache" Context must launch K5; every plane kind in `kinds`
    must reach K1. rows(model), if given, runs after the checks (kernel
    rows on the loaded planes, further checks). keep: (Kept, name) to keep
    the file under (else it is removed once loaded). joint False: no
    joint-min witness (_kernels_vs_plain; every file after TinyLlama's,
    for the smoke's clock)."""
    from llama_cpp_test_tpu_torch.ops import _cuda
    from llama_cpp_test_tpu_torch.runtime.engine import Context, Model

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        path = os.path.join(keep[0].dir if keep else tmp,
                            name.replace("/", "_") + ".gguf")
        t0 = time.time()
        write_llama_gguf(path, hp, seed=seed, ftype=ftype,
                         chat_template=chat_template)
        write_s = time.time() - t0
        model = Model(path, device="cuda")
        if keep:
            keep[0].files[keep[1]] = path
        else:
            os.remove(path)
        rng = np.random.default_rng(11)
        prompts = [rng.integers(3, hp["n_vocab"], size=n).tolist()
                   for n in (16, 130, 512)]
        requests, by_ctx, kind_launches = {}, {}, {}
        for kv, variant in contexts:
            label = _label(kv, variant)
            torch.cuda.synchronize()
            _cuda.reset_launches()
            with _qmm_variant(variant), _record_kinds() as tally:
                ctx = Context(model, n_ctx=n_ctx, n_seq_max=batch,
                              block_size=16, kv_type=kv)
                requests[label] = _serve_requests(torch, ctx, prompts,
                                                  hp["n_vocab"], batch)
                del ctx
                torch.cuda.synchronize()
            by_ctx[label] = dict(_cuda.LAUNCHES)
            kind_launches[label] = tally
            cache = by_ctx[label]["qmm_cache"]
            check(cache > 0 if variant == "cache" else cache == 0,
                  f"{name}/{label}: qmm_cache launched {cache} times")
        launches = {k: sum(c[k] for c in by_ctx.values())
                    for k in _cuda.LAUNCHES}
        missing = [k for k in path_kernels if launches[k] <= 0]
        check(not missing, f"{name}: kernels not launched on the path: "
                           f"{missing} ({launches})")
        reached = {key.split()[1] for t in kind_launches.values()
                   for key in t if key.startswith("K1")}
        check(set(kinds) <= reached, f"{name}: plane kinds {sorted(kinds)} "
                                     f"should reach K1; reached {reached}")
        checks, bad = _kernels_vs_plain(model, prompts[1], contexts,
                                        n_decode, joint)
        plane_bytes = _decode_plane_bytes(model.weights, model.hp)
        out = {"phase": name, "arch": model.hp.arch,
               "n_layer": hp["n_layer"], "ftype": ftype,
               "write_gguf_s": write_s, "load_s": model.load_seconds,
               "decode_weight_bytes": plane_bytes,
               "decode_bound_tok_s": PEAK_BYTES / plane_bytes,
               "requests": requests, "launches": launches,
               "launches_by_context": by_ctx,
               "kind_launches": kind_launches,
               "plain_vs_kernel_nmse": checks, "gate": LOGITS_GATE}
        emit(out)
        check(not bad, f"logits outside the gate: {bad}")
        if profile:
            for kv, variant in contexts:
                phase_profile(torch, model, hp["n_vocab"],
                              f"{name}/{_label(kv, variant)}", kv, variant)
        if rows is not None:
            out["rows"] = rows(model)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_serve(torch, kept: Kept, profile: bool = False) -> dict:
    return _serve(torch, "serve", TINYLLAMA, 7, [("bf16", None)], 2,
                  DENSE_PATH, profile, keep=(kept, "tinyllama"),
                  chat_template=ZEPHYR)


def phase_serve_moe(torch, profile: bool = False) -> dict:
    return _serve(torch, "serve_moe", MIXTRAL, 8,
                  [("bf16", None), ("q8_0", None)], 8, MOE_PATH, profile,
                  joint=False)


def _projections(model):
    """(label, planes) of layer 0's projections and of the lm head."""
    lw, w = model.weights.layers[0], model.weights
    cand = (("wqkv", lw.wqkv), ("wq", lw.wq), ("wv", lw.wv), ("wo", lw.wo),
            ("gate|up", lw.w_gateup), ("down", lw.w_down),
            ("lm_head", w.output))
    return [(label, qt) for label, qt in cand if qt is not None]


def _model_rows(kc, model, prefix, k5=()):
    """K1 rows at M = 1, 8, 128 and 512 on each projection of the served
    planes of a low-bit kind (u2, u4lut, u2lut) and on an int8 lm head
    (Q6_K; Q5_K with a min), and on the projections labelled
    in k5 K5 rows at M = 130 (the 130-token prompt's prefill routes there
    under "cache") and 512 beside K1's GEMM."""
    rows = {}
    for label, qt in _projections(model):
        kind = f"{qt.ggml_type.name}/{qt.kind}" + ("+min" if qt.min_ is not
                                                    None else "")
        if qt.kind in ("u2", "u4lut", "u2lut"):
            ms = (1, 8, 128, 512)
        elif qt.kind == "int8" and label == "lm_head":
            ms = (1, 8, 128, 512)
        else:
            ms = (512,) if label in k5 else ()
        for m in ms:
            rows[f"{label} M={m}"] = kc.qmm(f"{prefix} {label}", kind, qt, m)
        if label in k5:
            for m in (130, 512):
                rows[f"{label} K5 M={m}"] = kc.qmm(f"{prefix} {label}", kind,
                                                   qt, m, cache=True)
    check(not kc.failures, f"kernels outside their gate: {kc.failures}")
    return rows


def phase_serve_iq4xs(torch, kc, profile: bool = False) -> dict:
    return _serve(torch, "serve_iq4xs", LLAMA3_70B, 9, [("bf16", None)], 8,
                  DENSE_PATH, profile, ftype="IQ4_XS", kinds=("u4lut",),
                  rows=lambda model: _model_rows(kc, model, "70B"),
                  joint=False)


def phase_serve_lowbit(torch, kc, kept: Kept, profile: bool = False) -> dict:
    """The Q2_K and IQ1_S files, each served at the default variant and at
    "cache"; launches are summed over both files."""
    contexts = [("bf16", None), ("bf16", "cache")]
    k5 = ("wqkv", "wq", "gate|up", "lm_head")
    files = {
        ftype: _serve(torch, f"serve_lowbit/{ftype}", LLAMA3_8B_LOWBIT, seed,
                      contexts, 8, DENSE_PATH + ("qmm_cache",), profile,
                      ftype=ftype, kinds=kinds,
                      rows=lambda model, f=ftype: _model_rows(
                          kc, model, f"8B {f}", k5=k5),
                      keep=(kept, "8b_q2k") if ftype == "Q2_K" else None,
                      joint=False)
        for ftype, seed, kinds in (("Q2_K", 10, ("u2",)),
                                   ("IQ1_S", 12, ("u2lut", "u4lut")))}
    launches = {k: sum(f["launches"][k] for f in files.values())
                for k in files["Q2_K"]["launches"]}
    return {"launches": launches, "files": files}


def _moe_rows(kc, model, prefix, stacks=("gate", "down")):
    """K4 rows at M = 1, 8 and 512 on the first MoE layer's expert stacks
    (gate and down by default: up has gate's shape and kind) as the file
    loaded them, routed top-k of E as the file routes them."""
    lw = next(lw for lw in model.weights.layers if lw.gate_inp is not None)
    rows = {}
    for label in stacks:
        qt = getattr(lw, f"{label}_exps")
        kind = f"{qt.ggml_type.name}/{qt.kind}" + ("+min" if qt.min_ is not
                                                    None else "")
        for m in (1, 8, 512):
            rows[f"{prefix} {label} M={m}"] = kc.gmm(
                f"{prefix} {label}", kind, qt, m,
                top_k=model.hp.n_expert_used)
    check(not kc.failures, f"kernels outside their gate: {kc.failures}")
    return rows


def phase_serve_moe_lowbit(torch, kc, profile: bool = False) -> dict:
    """The Mixtral Q2_K, IQ1_S and BF16 files, one bf16 Context each;
    launches are summed over the files, and K4's GEMV and GEMM must each
    have run on every kind of MOE_LOWBIT_KINDS."""
    files = {
        ftype: _serve(torch, f"serve_moe_lowbit/{ftype}", hp, seed,
                      [("bf16", None)], 8, path, profile, ftype=ftype,
                      rows=lambda model, f=ftype: _moe_rows(
                          kc, model, f"Mixtral {f}"), joint=False)
        for ftype, hp, seed, path in (
            ("Q2_K", MIXTRAL_LOWBIT, 13, MOE_BF16_PATH),
            ("IQ1_S", MIXTRAL_LOWBIT, 14, MOE_BF16_PATH),
            ("BF16", MIXTRAL_BF16, 15, MOE_DENSE_FILE_PATH))}
    reached = {key for f in files.values()
               for t in f["kind_launches"].values() for key in t
               if key.startswith("K4")}
    missing = [f"K4 {v} {k}" for v in ("gemv", "gemm")
               for k in MOE_LOWBIT_KINDS if f"K4 {v} {k}" not in reached]
    check(not missing, f"serve_moe_lowbit: {missing} never launched "
                       f"(reached {sorted(reached)})")
    launches = {k: sum(f["launches"][k] for f in files.values())
                for k in files["Q2_K"]["launches"]}
    return {"launches": launches, "files": files}


def _probe_rows(torch, kc) -> dict:
    """Each probe kernel against its plain version at its entry point's
    shapes (kbench: M=8 K=2048 N=11264 and the 12672 x 1024 byte stream;
    pairprobe: M=8 K=4096 N=16384, 128-column blocks)."""
    from llama_cpp_test_tpu_torch.tools import kbench, pairprobe

    rows = {}
    x, q, s = kbench.make_data()
    for fmt in "FGH":
        xb, qs, sc = kbench.device_tensors(fmt, x, q, s, "cuda")
        fn_k = lambda: kbench.probe_gemv(fmt, xb, qs, sc)
        fn_p = lambda: kbench.probe_gemv_plain(fmt, xb, qs, sc)
        w = torch.from_numpy(((q.astype(np.float32) - (8 if fmt == "G" else 0))
                              * np.repeat(s, kbench.GROUP, 0))).to("cuda") \
            .to(torch.bfloat16)
        m, k, n = kbench.M, kbench.K, kbench.N
        rows[f"kbench_{fmt.lower()}"] = kc._row(
            f"kbench_{fmt.lower()}", f"{fmt} M={m} K={k} N={n} group 32",
            fn_k(), fn_p(), PROBE_GATE, fn_k, fn_p,
            lambda: torch.matmul(xb, w),
            xb.numel() * 2 + qs.numel() + sc.numel() * 2 + m * n * 4,
            2.0 * m * k * n, library="torch.matmul (pre-dequantized bf16)")
        del w
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    a = torch.randint(0, 256, kbench.STREAM_SHAPE, generator=g,
                      dtype=torch.uint8, device="cuda")
    x0 = torch.from_numpy(kc.rng.standard_normal((1, 128)).astype(
        np.float32)).to("cuda")
    used = kbench.stream_rows(a.shape[0])
    fn_k = lambda: kbench.stream_colsum(x0, a)
    fn_p = lambda: kbench.stream_colsum_plain(x0, a)
    rows["kbench_e"] = kc._row(
        "kbench_e", f"E u8 [{a.shape[0]}, {a.shape[1]}], {used} rows read",
        fn_k(), fn_p(), PROBE_GATE, fn_k, fn_p,
        lambda: torch.sum(a[:used], dim=0, dtype=torch.float32),
        used * a.shape[1] + 128 * 4 * 2, float(used * a.shape[1]),
        library="torch.sum over rows")
    rng = np.random.default_rng(3)
    c, n = pairprobe.C, pairprobe.N
    xp = torch_bf16(torch, rng.standard_normal((pairprobe.M, c)))
    qp, sp, fp_ = pairprobe.make_data(rng, "cuda")
    q32 = qp.to(torch.int32)
    qk = torch.stack([q32 & 0xF, q32 >> 4], dim=1).reshape(c, n)
    w_eff = ((128 + qk).float() * torch.repeat_interleave(sp.float(), 32, 0)
             - torch.repeat_interleave(fp_, 32, 0)).to(torch.bfloat16)
    del q32, qk
    fn_k = lambda: pairprobe.pairs_qmm(xp, qp, sp, fp_)
    fn_p = lambda: pairprobe.pairs_qmm_plain(xp, qp, sp, fp_)
    rows["pairs_qmm"] = kc._row(
        "pairs_qmm", f"pairs M=8 K={c} N={n} block 128 columns",
        fn_k(), fn_p(), PROBE_GATE, fn_k, fn_p,
        lambda: torch.matmul(xp, w_eff),
        xp.numel() * 2 + qp.numel() + sp.numel() * 2 + fp_.numel() * 4
        + pairprobe.M * n * 4, 2.0 * pairprobe.M * c * n,
        library="torch.matmul (pre-dequantized bf16)")
    del w_eff
    check(not kc.failures, f"kernels outside their gate: {kc.failures}")
    return rows


def _probe_calls() -> dict:
    """One call of each probe kernel at its entry point's shapes (fresh
    seeded inputs), for the one-launch check."""
    from llama_cpp_test_tpu_torch import tools

    names = {"kbench_f": "F", "kbench_g": "G", "kbench_h": "H",
             "kbench_e": "E", "pairs_qmm": "pairs4"}
    return {k: tools.probe_case(v, *tools.probe_shape(v), "cuda", seed=5)[0]
            for k, v in names.items()}


def phase_probes(torch, kc, one_launch: dict) -> dict:
    """The probe kernels' rows with the timer's floor beside them, then
    both probe entry points, each run as `python -m` runs it, with the
    launch counts zeroed just before and read just after. `one_launch`:
    one_launch_each's check of the probe calls, made after the kernels
    phase."""
    import io
    import runpy
    import warnings

    from llama_cpp_test_tpu_torch.ops import _cuda

    rows = _probe_rows(torch, kc)
    floor = kc.timer(lambda: torch.cuda._sleep(0))
    emit({"phase": "probes", "kernel": "timer floor",
          "one_empty_kernel_ms": floor})
    torch.cuda.synchronize()
    _cuda.reset_launches()
    printed = {}
    for mod in ("kbench", "pairprobe"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), warnings.catch_warnings():
            # _probe_rows imported the module already; run_module reruns it
            # as __main__, as `python -m` would
            warnings.filterwarnings("ignore", ".*found in sys.modules",
                                    RuntimeWarning)
            try:
                runpy.run_module(f"llama_cpp_test_tpu_torch.tools.{mod}",
                                 run_name="__main__")
                code = 0
            except SystemExit as e:
                code = e.code
        printed[mod] = buf.getvalue().splitlines()
        check(code == 0, f"probes: {mod} exited {code}: {printed[mod][-3:]}")
    torch.cuda.synchronize()
    launches = {k: _cuda.LAUNCHES[k] for k in PROBES}
    check(all(v > 0 for v in launches.values()),
          f"probes: kernels not launched by the entry points: {launches}")
    out = {"phase": "probes", "launches": launches, "printed": printed}
    emit(out)
    return {**out, "rows": rows, "one_empty_kernel_ms": floor,
            "one_launch": {k: v for k, v in one_launch.items()
                           if k in PROBES}}


# ---------------------------------------------------------------------------
# serving through the CLI and the scheduler


CLI_TEXT = ("The people of the world could find water in the little house, "
            "and they said that the first man came back.")


def phase_cli(torch, kept: Kept, kc) -> dict:
    """llama_cpp_test_tpu_torch.cli.main, run in this process on the kept
    TinyLlama file as a user runs it, greedy: its
    standard output must be the prompt and then the pieces of the greedy
    tokens of generate() on the same file (stopping where the CLI stops,
    at an end-of-generation token, and without the last token's piece
    when it stops by length, as the JAX CLI prints), and K1, K2 and K3
    must launch. Then cli.perplexity on the same file (_perplexity) and
    K1's GEMM row of its lm head at M = 512."""
    from llama_cpp_test_tpu_torch.runtime.engine import Model

    path = kept.files["tinyllama"]
    model = Model(path, device="cuda")
    out = _cli_vs_generate(torch, "cli", path, model, DENSE_PATH)
    out["perplexity"] = _perplexity(torch, path, model, kept.dir)
    out["rows"] = {"lm_head M=512": kc.qmm(
        "TinyLlama lm_head (prefill_nll)", model.weights.output.ggml_type.name,
        model.weights.output, 512)}
    check(not kc.failures, f"kernels outside their gate: {kc.failures}")
    return out


PPL_CTX = 512           # the perplexity CLI's chunk (its default -c)
PPL_CHUNKS = 2


def _perplexity(torch, path, model, tmp_dir) -> dict:
    """cli.perplexity -c 512 --chunks 2 on the file at path, in this
    process on the card, the launch counts zeroed before and read after
    (K1's GEMM and K2 must launch: every position's logits through the lm
    head); its perplexity against the plain path's over the same chunks
    (Context(plain=True).prefill_nll, the CLI's chunking and warm-up
    halves): relative difference < 1e-3, and the saved per-token NLL
    within the logits gate. Its tok/s is the CLI's own line."""
    import io

    from llama_cpp_test_tpu_torch.cli import perplexity as ppl
    from llama_cpp_test_tpu_torch.ops import _cuda
    from llama_cpp_test_tpu_torch.runtime.engine import Context

    body = " ".join([CLI_TEXT] * 100)
    text = os.path.join(tmp_dir, "ppl.txt")
    with open(text, "w") as f:
        f.write(body)
    npz = os.path.join(tmp_dir, "ppl_nll.npz")
    torch.cuda.synchronize()
    _cuda.reset_launches()
    buf, err = io.StringIO(), io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        rc = ppl.main(["-m", path, "-f", text, "-c", str(PPL_CTX),
                       "--chunks", str(PPL_CHUNKS), "--save-nll", npz])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(_cuda.LAUNCHES)
    check(rc == 0, f"cli.perplexity returned {rc}: {err.getvalue()[-400:]}")
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    rate = re.search(r"\(([0-9.]+) tok/s\)", err.getvalue())
    got = np.load(npz)["nll"]
    # the plain path over the same chunks, as the CLI scores them
    ids = model.tokenizer.encode(body, add_special=True)
    ctx = Context(model, n_ctx=PPL_CTX, n_seq_max=1, plain=True)
    stride, want = PPL_CTX // 2, []
    for i, (start, chunk) in enumerate(ppl.chunks(ids, PPL_CTX, stride)):
        if i == PPL_CHUNKS:
            break
        s = ctx.new_seq()
        want.append(ctx.prefill_nll(s, chunk)[
            0 if start == 0 else PPL_CTX - stride - 1:])
        ctx.free_seq(s)
    want = np.concatenate(want)
    ppl_plain = float(np.exp(want.mean()))
    out = {"phase": "cli/perplexity", "rc": rc, "result": res,
           "plain_ppl": ppl_plain,
           "rel_diff": abs(res["ppl"] / ppl_plain - 1),
           "nll_nmse": nmse(want, got) if got.shape == want.shape else None,
           "tok_s": float(rate.group(1)) if rate else None,
           "wall_s": wall, "launches": launches}
    emit(out)
    check(got.shape == want.shape and out["nll_nmse"] < LOGITS_GATE and
          out["rel_diff"] < 1e-3, f"perplexity off the plain path: {out}")
    missing = [k for k in ("qmm_gemm", "flash_prefill") if launches[k] <= 0]
    check(not missing, f"cli/perplexity: kernels not launched: {missing}")
    return out


def _cli_vs_generate(torch, phase, path, model, path_kernels) -> dict:
    """cli.main on the file at path, greedy at -n 32, against generate()
    on `model` (the same file, loaded): the printout of phase_cli, and
    path_kernels launched by the CLI's run."""
    import io

    from llama_cpp_test_tpu_torch.cli import main as cli
    from llama_cpp_test_tpu_torch.ops import _cuda
    from llama_cpp_test_tpu_torch.runtime.engine import Context, generate

    torch.cuda.synchronize()
    _cuda.reset_launches()
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["-m", path, "-p", CLI_TEXT, "-n", "32", "--temp", "0"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(_cuda.LAUNCHES)
    tok = model.tokenizer
    ids = tok.encode(CLI_TEXT, add_special=True, parse_special=True)
    eog = {t for t in range(model.hp.n_vocab) if tok.vocab.is_eog(t)}
    ctx = Context(model, n_ctx=2048, n_seq_max=1)
    toks = list(generate(ctx, ids, 32, eos_ids=eog))
    # as the JAX CLI: a request that ends by length does not print the
    # piece of its last token (on_token prints while finished is None)
    shown = toks[:-1] if len(toks) == 32 else toks
    want = CLI_TEXT + "".join(tok.token_to_piece(t) for t in shown)
    got = buf.getvalue()
    out = {"phase": phase, "rc": rc, "wall_s": wall, "prompt_tokens": len(ids),
           "generated": len(toks), "stdout": got, "same_as_generate": got == want,
           "launches": launches}
    emit(out)
    check(rc == 0, f"cli.main returned {rc}")
    check(got == want, f"the CLI printed {got!r}, generate() gives {want!r}")
    missing = [k for k in path_kernels if launches[k] <= 0]
    check(not missing, f"{phase}: kernels not launched: {missing} "
                       f"({launches})")
    return out


SCHED_LENS = (16, 40, 64, 100, 128, 200, 300, 512)   # prompt tokens
SCHED_NEW = 64                                      # tokens a request


def _sched_prompts(tok, seed: int) -> list:
    """Eight prompts of SCHED_LENS tokens: seeded word salad over _WORDS,
    encoded by the model's tokenizer and cut."""
    rng = np.random.default_rng(seed)
    text = " ".join(rng.choice(_WORDS, 1200))
    ids = tok.encode(text, add_special=True, parse_special=True)
    check(len(ids) >= max(SCHED_LENS), f"word salad gave {len(ids)} tokens")
    return [ids[:n] for n in SCHED_LENS]


def _sched_params():
    """Four greedy rows, then four seeded stochastic rows of the common
    chain (device sampling takes every one of them)."""
    from llama_cpp_test_tpu_torch.runtime.sampling import SamplerParams

    return [SamplerParams(temp=0.0)] * 4 + [
        SamplerParams(temp=0.8, top_k=40, top_p=0.95, min_p=0.05,
                      penalty_repeat=1.1, seed=100 + i) for i in range(4)]


class _Recorder:
    """Logs the engine calls a Scheduler makes on a Context (new_seq,
    prefill, decode, the windows, truncate_seq, free_seq), to replay them
    per token at the same batches (_replay)."""

    NAMES = ("new_seq", "prefill", "decode", "decode_window_async",
             "truncate_seq", "free_seq")

    def __init__(self, ctx):
        self.log, self.ctx = [], ctx
        orig = {n: getattr(ctx, n) for n in self.NAMES}

        def new_seq():
            seq = orig["new_seq"]()
            self.log.append(("new", seq.seq_id))
            return seq

        def prefill(seq, tokens, all_logits=False, top_k=0):
            res = orig["prefill"](seq, tokens, all_logits, top_k)
            first = int(res[1][0]) if top_k else None
            self.log.append(("prefill", seq.seq_id, list(tokens), first))
            return res

        def decode(seqs, tokens, top_k=0):
            res = orig["decode"](seqs, tokens, top_k)
            nxt = res[1][:, 0] if top_k else res.argmax(-1)
            self.log.append(("decode", [q.seq_id for q in seqs],
                             [int(t) for t in tokens], nxt.tolist()))
            return res

        def window(seqs, tokens=None, samplers=None, n_steps=16, seed=0,
                   histories=None, carry=None):
            h = orig["decode_window_async"](seqs, tokens, samplers, n_steps,
                                            seed, histories, carry)
            fed = None if tokens is None else [int(t) for t in tokens]
            self.log.append(("window", [q.seq_id for q in seqs], fed, carry,
                             h))
            return h

        def truncate_seq(seq, n):
            self.log.append(("truncate", seq.seq_id, n))
            return orig["truncate_seq"](seq, n)

        def free_seq(seq):
            self.log.append(("free", seq.seq_id))
            return orig["free_seq"](seq)

        for n, f in zip(self.NAMES, (new_seq, prefill, decode, window,
                                     truncate_seq, free_seq)):
            setattr(ctx, n, f)

    def detach(self):
        """Back to the Context's own methods."""
        for n in self.NAMES:
            delattr(self.ctx, n)


def _replay(ctx, log, greedy: set, logits: dict | None = None,
            hooks: dict | None = None) -> dict:
    """Replay a _Recorder log on a fresh Context with per-token decode()
    steps over the same sequences in the same order (so the same padded
    batches), feeding the tokens the scheduler fed; at every step a
    greedy row's argmax must equal the token the scheduler took there.
    A chained window the scheduler abandoned (never fetched) is skipped.
    With `logits`, each greedy row's decode logits are appended to
    logits[seq id] in order: entry i produced the row's token i + 1.
    hooks: event kind -> callable(event), for events a caller added to
    the log (an adapter swap)."""
    seqs, out = {}, {"window_tokens": 0, "step_tokens": 0, "mismatches": []}

    def compare(kind, sid, got, want, row=None):
        if sid in greedy:
            out["window_tokens" if kind == "window" else "step_tokens"] += 1
            if got != want:
                out["mismatches"].append((kind, sid, got, want))
            if logits is not None and row is not None:
                logits.setdefault(sid, []).append(row)

    for ev in log:
        if ev[0] == "new":
            seqs[ev[1]] = ctx.new_seq()
        elif ev[0] == "prefill":
            lg = ctx.prefill(seqs[ev[1]], ev[2])
            if ev[3] is not None:
                compare("prefill", ev[1], int(np.argmax(lg)), ev[3])
        elif ev[0] == "decode":
            lg = ctx.decode([seqs[i] for i in ev[1]], ev[2])
            for i, sid in enumerate(ev[1]):
                compare("decode", sid, int(np.argmax(lg[i])), ev[3][i],
                        lg[i])
        elif ev[0] == "window":
            _, sids, fed, carry, h = ev
            if h._result is None:
                continue
            toks = h._result[:, h.rowmap]
            cur = fed if fed is not None else \
                carry._result[-1, carry.rowmap].tolist()
            for j in range(toks.shape[0]):
                lg = ctx.decode([seqs[i] for i in sids], cur)
                for i, sid in enumerate(sids):
                    compare("window", sid, int(np.argmax(lg[i])),
                            int(toks[j, i]), lg[i])
                cur = toks[j].tolist()
        elif ev[0] == "free":
            ctx.free_seq(seqs[ev[1]])
        elif ev[0] == "truncate":
            ctx.truncate_seq(seqs[ev[1]], ev[2])
        else:
            hooks[ev[0]](ev)
    return out


def _drain(sched, max_steps: int = 5000) -> None:
    """Scheduler.run with a bound: a request that can never be admitted
    fails the phase instead of looping."""
    for _ in range(max_steps):
        if not sched.has_work():
            return
        sched.step()
    raise SmokeFailure(f"the scheduler still had work after {max_steps} "
                       f"steps: {sched.metrics()}")


def _run_sched(model, kv, prompts, params, record=False,
               max_tokens: int = SCHED_NEW, n_ctx: int = 1024,
               n_slots: int = 8):
    """The requests through a fresh Context of n_ctx tokens and a
    Scheduler (n_slots slots, windows of 16). Returns (scheduler,
    requests, recorder)."""
    from llama_cpp_test_tpu_torch.runtime.engine import Context
    from llama_cpp_test_tpu_torch.runtime.scheduler import GenRequest, Scheduler

    ctx = Context(model, n_ctx=n_ctx, n_seq_max=n_slots, block_size=16,
                  kv_type=kv)
    rec = _Recorder(ctx) if record else None
    sched = Scheduler(ctx, n_slots=n_slots, decode_window=16)
    reqs = [sched.submit(GenRequest(prompt_tokens=p, max_tokens=max_tokens,
                                    sampling=sp, ignore_eos=True))
            for p, sp in zip(prompts, params)]
    _drain(sched)
    return sched, reqs, rec


def _window_clean(torch, model, kv, prompts, params) -> dict:
    """Two chained decode_window_async calls of 16 steps over eight
    prefilled sequences, dispatched with torch.cuda's sync debug mode set
    to "error" (any synchronizing call raises) and under torch.profiler:
    no host sync and no memset may occur, and the profiler must have seen
    K1 and K3 run (a session that saw no device activity is run again)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from llama_cpp_test_tpu_torch.runtime.engine import Context

    ctx = Context(model, n_ctx=1024, n_seq_max=8, block_size=16, kv_type=kv)
    for tries in range(1, PROFILER_TRIES + 1):
        seqs = [ctx.new_seq() for _ in prompts]
        first = [int(np.argmax(ctx.prefill(q, p)))
                 for q, p in zip(seqs, prompts)]
        torch.cuda.synchronize()
        err = None
        torch.cuda.set_sync_debug_mode("error")
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                h = ctx.decode_window_async(seqs, first, params, 16)
                h2 = ctx.decode_window_async(seqs, n_steps=16, carry=h)
                torch.cuda.synchronize()
        except RuntimeError as e:
            err = str(e)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        check(err is None, f"{kv}: a window synchronized with the host: {err}")
        h.fetch()
        h2.fetch()
        for q in seqs:
            ctx.free_seq(q)
        dev = [(ev.key, int(ev.count)) for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA]
        if dev:
            break
    count = lambda key: sum(c for k, c in dev if key in k.lower())
    out = {"host_syncs": 0, "memsets": count("memset"),
           "qmm_gemv_kernels": count("qmm_gemv_kernel"),
           "paged_decode_kernels": count("paged_decode_kernel"),
           "device_kernels": sum(c for k, c in dev if "mem" not in k.lower()),
           "profiler_sessions": tries}
    check(out["memsets"] == 0, f"{kv}: memsets inside a window: {dev}")
    check(out["qmm_gemv_kernels"] > 0 and out["paged_decode_kernels"] > 0,
          f"{kv}: the profiler saw no K1/K3 in the windows: {dev}")
    return out


def _window_vs_per_token(torch, model, kv, prompts) -> dict:
    """Decode wall per token at B = 1 and 8: 32 per-token decode() steps
    (greedy on the host) against two chained decode_window(16) windows
    (greedy on the device), each after the same prefills."""
    from llama_cpp_test_tpu_torch.runtime.engine import Context
    from llama_cpp_test_tpu_torch.runtime.sampling import SamplerParams

    out = {}
    for b in (1, 8):
        ctx = Context(model, n_ctx=1024, n_seq_max=8, block_size=16,
                      kv_type=kv)
        row = {}
        for mode in ("per_token", "window"):
            seqs = [ctx.new_seq() for _ in range(b)]
            cur = [int(np.argmax(ctx.prefill(q, p)))
                   for q, p in zip(seqs, prompts)]
            torch.cuda.synchronize()
            t0 = time.time()
            if mode == "per_token":
                for _ in range(32):
                    cur = [int(t) for t in ctx.decode(seqs, cur).argmax(-1)]
            else:
                h = ctx.decode_window_async(
                    seqs, cur, [SamplerParams(temp=0.0)] * b, 16)
                h2 = ctx.decode_window_async(seqs, n_steps=16, carry=h)
                h.fetch()
                h2.fetch()
            torch.cuda.synchronize()
            row[f"{mode}_ms_per_token"] = (time.time() - t0) * 1e3 / 32
            for q in seqs:
                ctx.free_seq(q)
        out[f"B={b}"] = row
    return out


def _sched_edges(model, prompts) -> dict:
    """One slot: a request that passes n_ctx (256) finishes through
    shift_context; a second request sharing a 250-token prefix with the
    first prefills fewer tokens; a stop string taken from a greedy run's
    text ends the rerun early."""
    from llama_cpp_test_tpu_torch.runtime.engine import Context
    from llama_cpp_test_tpu_torch.runtime.sampling import SamplerParams
    from llama_cpp_test_tpu_torch.runtime.scheduler import GenRequest, Scheduler

    greedy = SamplerParams(temp=0.0)
    ctx = Context(model, n_ctx=256, n_seq_max=2, block_size=16)
    shifts = []
    orig = ctx.shift_context
    ctx.shift_context = lambda *a: (shifts.append(a), orig(*a))
    sched = Scheduler(ctx, n_slots=1, decode_window=16)
    long = sched.submit(GenRequest(prompt_tokens=prompts[6][:200],
                                   max_tokens=96, sampling=_sched_params()[4],
                                   ignore_eos=True))
    _drain(sched)
    out = {"shift": {"calls": [list(a[1:]) for a in shifts],
                     "finish": long.finish_reason,
                     "tokens": len(long.output_tokens)}}
    check(shifts and long.finish_reason == "length" and
          len(long.output_tokens) == 96,
          f"a request past n_ctx: {out['shift']}")
    ctx = Context(model, n_ctx=1024, n_seq_max=1, block_size=16)
    sched = Scheduler(ctx, n_slots=1, decode_window=16)
    base = prompts[6]
    first = sched.submit(GenRequest(prompt_tokens=base, max_tokens=8,
                                    sampling=greedy, ignore_eos=True))
    _drain(sched)
    n0 = sched.n_prompt_tokens
    second = sched.submit(GenRequest(prompt_tokens=base[:250] + prompts[2],
                                     max_tokens=8, sampling=greedy,
                                     ignore_eos=True))
    _drain(sched)
    out["prefix"] = {"first_prefilled": n0,
                     "second_prompt": len(second.prompt_tokens),
                     "second_prefilled": sched.n_prompt_tokens - n0}
    check(out["prefix"]["second_prefilled"] ==
          len(second.prompt_tokens) - 250, f"prefix reuse: {out['prefix']}")
    pieces = []
    run = lambda stops: sched.submit(GenRequest(
        prompt_tokens=prompts[3], max_tokens=24, sampling=greedy,
        ignore_eos=True, stop_strings=stops,
        on_token=lambda t, piece, fin: pieces.append(piece or "")))
    free = run([])
    _drain(sched)
    stop = next((p for p in pieces[8:20] if p.strip()
                 and "\ufffd" not in p), None)
    check(stop is not None, f"no piece to stop on in {pieces}")
    stopped = run([stop])
    _drain(sched)
    out["stop"] = {"string": stop, "free_tokens": len(free.output_tokens),
                   "stopped_tokens": len(stopped.output_tokens),
                   "finish": stopped.finish_reason}
    check(stopped.finish_reason == "stop" and
          len(stopped.output_tokens) < len(free.output_tokens),
          f"stop string: {out['stop']}")
    return out


SCHED_RUNS = (("tinyllama", "bf16"), ("tinyllama", "q8_0"), ("8b_q2k", "bf16"))


def phase_sched(torch, kept: Kept, nvidia_smi: str) -> dict:
    """The Scheduler over the kept files: TinyLlama (bf16, then q8_0 KV)
    and Llama-3-8B Q2_K (4 layers: its 128256-token vocab takes the
    segmented candidate selector and the BPE tokenizer). Eight requests
    of 16-512 prompt tokens and 64 new ones, four greedy and four seeded
    stochastic, 8 slots, windows of 16. Checks: every greedy token equals
    the per-token decode() replay at the same batches; a rerun gives every
    row the same tokens; windows make no host sync and no memset; the
    path's kernels launch. On TinyLlama bf16 also the shift, prefix-reuse
    and stop-string requests (_sched_edges). Prints Scheduler.metrics()
    and the window-versus-per-token decode reading with the card."""
    from llama_cpp_test_tpu_torch.ops import _cuda
    from llama_cpp_test_tpu_torch.runtime.engine import Context, Model

    models, runs, launches = {}, {}, dict.fromkeys(_cuda.LAUNCHES, 0)
    for name, kv in SCHED_RUNS:
        if name not in models:
            models = {name: Model(kept.files[name], device="cuda")}
        model = models[name]
        prompts = _sched_prompts(model.tokenizer, 21)
        params = _sched_params()
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t0 = time.time()
        sched, reqs, rec = _run_sched(model, kv, prompts, params, record=True)
        torch.cuda.synchronize()
        wall = time.time() - t0
        run_launches = dict(_cuda.LAUNCHES)
        for k, v in run_launches.items():
            launches[k] += v
        first = [list(r.output_tokens) for r in reqs]
        _, again, _ = _run_sched(model, kv, prompts, params)
        rerun_same = [list(r.output_tokens) for r in again] == first
        greedy = {ev[1] for ev in rec.log if ev[0] == "new"}
        greedy = set(sorted(greedy)[:4])
        rctx = Context(model, n_ctx=1024, n_seq_max=8, block_size=16,
                       kv_type=kv)
        replay = _replay(rctx, rec.log, greedy)
        label = f"{name}/{kv}"
        r = {"wall_s": wall, "metrics": sched.metrics(),
             "finish": [q.finish_reason for q in reqs],
             "tokens": [len(q.output_tokens) for q in reqs],
             "rerun_same": rerun_same, "replay": replay,
             "launches": run_launches,
             "window": _window_clean(torch, model, kv, prompts, params),
             "window_vs_per_token": _window_vs_per_token(
                 torch, model, kv, prompts),
             "card": nvidia_smi}
        if label == "tinyllama/bf16":
            r["edges"] = _sched_edges(model, prompts)
        runs[label] = r
        emit({"phase": "sched", "run": label, **r})
        check(all(n == SCHED_NEW for n in r["tokens"]),
              f"{label}: request lengths {r['tokens']}")
        check(rerun_same, f"{label}: a rerun gave other tokens")
        check(not replay["mismatches"] and replay["window_tokens"] > 0,
              f"{label}: greedy tokens differ from the per-token replay: "
              f"{replay}")
        check(r["metrics"]["gen_tokens_fast_path"] > 0,
              f"{label}: no token went through a window: {r['metrics']}")
        # a prefill over q8_0 pools is the dequantizing gather (no K2),
        # as in the reference
        path = (("qmm_gemv", "qmm_gemm", "paged_decode_q8") if kv == "q8_0"
                else DENSE_PATH)
        missing = [k for k in path if run_launches[k] <= 0]
        check(not missing, f"{label}: kernels not launched: {missing}")
    return {"launches": launches, "runs": runs}


# ---------------------------------------------------------------------------
# serving through the OpenAI-compatible server


SERVER_KEY = "smoke-key"
SERVER_TIMEOUT = 300       # seconds any one request or batch may take
SERVER_LENS = (16, 130, 512)
SERVER_NEW = 32


class _Http:
    """The server's aiohttp app on 127.0.0.1 (aiohttp.test_utils
    TestServer), driven from this thread through its own event loop. The
    launch counts are zeroed just before each request (or batch of
    concurrent requests) and read just after it: `last` holds that
    request's, and `launches` (the caller's dict) sums them, so work the
    checks do beside the server is not counted as the server's."""

    def __init__(self, srv, launches: dict):
        import asyncio

        from aiohttp.test_utils import TestClient, TestServer

        self.loop = asyncio.new_event_loop()
        self.launches, self.last = launches, {}

        async def make():
            c = TestClient(TestServer(srv.make_app(), host="127.0.0.1"))
            await c.start_server()
            return c

        self.c = self.loop.run_until_complete(make())
        self.auth = {"Authorization": f"Bearer {srv.api_key}"} \
            if srv.api_key else {}

    def _run(self, coro):
        import asyncio

        import torch

        from llama_cpp_test_tpu_torch.ops import _cuda

        torch.cuda.synchronize()
        _cuda.reset_launches()
        try:
            return self.loop.run_until_complete(
                asyncio.wait_for(coro, SERVER_TIMEOUT))
        finally:
            torch.cuda.synchronize()
            self.last = dict(_cuda.LAUNCHES)
            for k, v in self.last.items():
                self.launches[k] += v

    async def _post(self, url, body, auth=True):
        r = await self.c.post(url, json=body,
                              headers=self.auth if auth else {})
        return r.status, await r.json(content_type=None)

    async def _stream(self, url, body):
        """SSE chunks of one streamed request, and the perf_counter time
        its first chunk arrived."""
        r = await self.c.post(url, json={**body, "stream": True},
                              headers=self.auth)
        check(r.status == 200, f"{url} stream: status {r.status}")
        out, first = [], None
        async for line in r.content:
            line = line.decode().strip()
            if line.startswith("data: ") and line != "data: [DONE]":
                if first is None:
                    first = time.perf_counter()
                out.append(json.loads(line[6:]))
        return out, first

    def post(self, url, body=None, auth=True):
        return self._run(self._post(url, body or {}, auth))

    def post_many(self, url, bodies):
        import asyncio

        async def all_():
            return await asyncio.gather(*(self._post(url, b) for b in bodies))
        return self._run(all_())

    def stream(self, url, body) -> list:
        return self._run(self._stream(url, body))[0]

    def stream_many(self, url, bodies) -> list:
        """Every body streamed at once. Per request: its chunks and the
        seconds from just before the POSTs to its first chunk."""
        import asyncio

        async def all_():
            t0 = time.perf_counter()
            res = await asyncio.gather(*(self._stream(url, b)
                                         for b in bodies))
            return [(chunks, first - t0) for chunks, first in res]
        return self._run(all_())

    def close(self):
        self.loop.run_until_complete(self.c.close())
        self.loop.close()


@contextlib.contextmanager
def _server(path, launches: dict, **kw):
    """A LlamaServer on the card with its engine thread running and an
    HTTP client adding the server's launches to `launches`; stops both on
    exit."""
    from llama_cpp_test_tpu_torch.server.app import LlamaServer

    srv = LlamaServer(path, device="cuda", **kw)
    srv.engine.start()
    client = None
    try:
        client = _Http(srv, launches)
        yield srv, client
    finally:
        if client is not None:
            client.close()
        srv.engine.stop()
        check(not srv.engine.thread.is_alive(),
              "the server's engine thread did not stop")


@contextlib.contextmanager
def _gate(srv, n: int):
    """Hold the engine thread until n requests have reached the scheduler,
    then queue them in order of prompt length: concurrent requests start
    from the same queue whatever order they arrived in, so a rerun meets
    the same batches."""
    lock = srv.engine.ctx_lock
    lock.acquire()
    released = False

    def release():
        nonlocal released
        t_end = time.time() + SERVER_TIMEOUT
        while True:
            with srv.engine._lock:
                pending = list(srv.engine._pending)
                if len(pending) + len(srv.sched.queue) >= n:
                    srv.engine._pending.clear()
                    break
            check(time.time() < t_end, "requests did not reach the engine")
            time.sleep(0.01)
        for r in pending:
            srv.sched.submit(r)
        srv.sched.queue = type(srv.sched.queue)(sorted(
            srv.sched.queue, key=lambda r: len(r.prompt_tokens)))
        lock.release()
        released = True

    import threading

    t = threading.Thread(target=release, daemon=True)
    t.start()
    try:
        yield
    finally:
        t.join(timeout=SERVER_TIMEOUT)
        if not released:
            lock.release()


def _body(sp, n_new: int, prompt) -> dict:
    """A request body carrying SamplerParams sp, as a client sends it."""
    b = {"prompt": prompt, "n_predict": n_new, "ignore_eos": True,
         "temperature": sp.temp}
    if sp.temp > 0:
        b.update(top_k=sp.top_k, top_p=sp.top_p, min_p=sp.min_p,
                 repeat_penalty=sp.penalty_repeat, seed=sp.seed)
    return b


def _text(body) -> str:
    return body["choices"][0]["text"]


def _pct(xs, q) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q))


def _srv_metrics(srv, before=None) -> dict:
    """Scheduler token counts and seconds since `before` (a _srv_metrics
    result), with the rates."""
    s = srv.sched
    m = {"gen_tokens": s.n_gen_tokens, "gen_s": s.t_gen,
         "prompt_tokens": s.n_prompt_tokens, "prompt_s": s.t_prompt}
    if before:
        m = {k: m[k] - before[k] for k in m}
    m["gen_tok_s"] = m["gen_tokens"] / m["gen_s"] if m["gen_s"] else 0.0
    m["prompt_tok_s"] = (m["prompt_tokens"] / m["prompt_s"]
                         if m["prompt_s"] else 0.0)
    return m


def _erase_all(srv, c) -> None:
    """Empty every slot (POST /slots/{id}?action=erase), so the next
    request prefills its whole prompt as generate() does."""
    for k in range(len(srv.sched.slots)):
        status, body = c.post(f"/slots/{k}?action=erase")
        check(status == 200, f"erase slot {k}: {status} {body}")


def _server_completions(srv, c, model, ids) -> dict:
    """Three greedy /completion requests of 16, 130 and 512 prompt tokens,
    one at a time: each text equals generate()'s on the same file, and the
    streamed pieces joined equal the text."""
    from llama_cpp_test_tpu_torch.runtime.engine import Context, generate

    tok = model.tokenizer
    ctx = Context(model, n_ctx=1024, n_seq_max=1)
    out = []
    for n in SERVER_LENS:
        prompt = ids[:n]
        body = {"prompt": prompt, "n_predict": SERVER_NEW,
                "temperature": 0.0, "ignore_eos": True}
        _erase_all(srv, c)
        status, got = c.post("/completion", body)
        check(status == 200, f"/completion {n}: status {status} {got}")
        _erase_all(srv, c)
        chunks = c.stream("/completion", body)
        want = tok.decode(list(generate(ctx, prompt, SERVER_NEW)))
        streamed = "".join(ch["choices"][0]["text"] for ch in chunks)
        out.append({"prompt": n, "same_as_generate": _text(got) == want,
                    "stream_same": streamed == _text(got),
                    "timings": got.get("timings")})
        check(_text(got) == want, f"/completion {n}: {_text(got)!r} but "
                                  f"generate() gives {want!r}")
        check(streamed == _text(got), f"/completion {n}: streamed "
                                      f"{streamed!r}, unstreamed "
                                      f"{_text(got)!r}")
    return {"requests": out}


def _server_concurrency(torch, srv, c, model) -> dict:
    """The sched phase's eight requests (4 greedy, 4 seeded) streamed at
    once, then again after erasing every slot: the rerun repeats every
    row, and the greedy rows equal a per-token replay at the same batches.
    Time to first token is the client's: from just before the POSTs to
    each request's first SSE chunk (_gate queues the eight by length)."""
    from llama_cpp_test_tpu_torch.runtime.engine import Context

    prompts, params = _sched_prompts(model.tokenizer, 21), _sched_params()
    bodies = [_body(sp, SCHED_NEW, p) for p, sp in zip(prompts, params)]
    runs = []
    for i in range(2):
        _erase_all(srv, c)
        rec = _Recorder(srv.sched.ctx) if i == 0 else None
        before = _srv_metrics(srv)
        torch.cuda.synchronize()
        t0 = time.time()
        with _gate(srv, len(bodies)):
            res = c.stream_many("/completion", bodies)
        torch.cuda.synchronize()
        wall = time.time() - t0
        if rec is not None:
            rec.detach()
        runs.append({"wall_s": wall,
                     "texts": ["".join(ch["choices"][0]["text"]
                                       for ch in chunks)
                               for chunks, _ in res],
                     "finish": [chunks[-1]["choices"][0]["finish_reason"]
                                for chunks, _ in res],
                     "ttft_ms": [ttft * 1e3 for _, ttft in res],
                     "tokens": [len(chunks) for chunks, _ in res],
                     "metrics": _srv_metrics(srv, before), "rec": rec})
    first = runs[0]
    # a greedy row is the sequence whose prefilled tokens are its prompt
    filled = {}
    for ev in first["rec"].log:
        if ev[0] == "prefill":
            filled.setdefault(ev[1], []).extend(ev[2])
    greedy = {sid for sid, t in filled.items()
              if any(t == p for p, sp in zip(prompts, params)
                     if sp.temp == 0)}
    rctx = Context(model, n_ctx=srv.sched.ctx.n_ctx,
                   n_seq_max=len(srv.sched.slots), block_size=16)
    replay = _replay(rctx, first["rec"].log, greedy)
    n_gen = sum(first["tokens"])
    out = {"requests": len(bodies), "greedy_rows": len(greedy),
           "rerun_same": runs[1]["texts"] == first["texts"],
           "replay": replay, "wall_s": first["wall_s"],
           "client_ttft_ms": first["ttft_ms"],
           "client_ttft_ms_p50": _pct(first["ttft_ms"], 50),
           "client_ttft_ms_p95": _pct(first["ttft_ms"], 95),
           "client_gen_tok_s": n_gen / first["wall_s"],
           "client_prompt_tok_s": sum(map(len, prompts)) / first["wall_s"],
           "scheduler": first["metrics"], "rerun_scheduler": runs[1]["metrics"]}
    check(all(n == SCHED_NEW for n in first["tokens"]) and
          set(first["finish"]) == {"length"},
          f"concurrent request lengths {first['tokens']} {first['finish']}")
    check(len(greedy) == 4, f"found {len(greedy)} greedy rows in the log")
    check(out["rerun_same"], "a rerun of the eight requests gave other text")
    check(not replay["mismatches"] and replay["window_tokens"] > 0,
          f"greedy server tokens differ from the per-token replay: {replay}")
    return out


def _server_chat(srv, c, model) -> dict:
    """/v1/chat/completions on the file's zephyr template: the rendered
    prompt equals apply_chat_template's (the Jinja path: '</s>' closes each
    turn) and the reply equals generate() on that prompt."""
    from llama_cpp_test_tpu_torch.runtime.engine import Context, generate
    from llama_cpp_test_tpu_torch.server.chat import (apply_chat_template,
                                                      parse_assistant_message)

    msgs = [{"role": "system", "content": "You answer in one sentence."},
            {"role": "user", "content": CLI_TEXT}]
    want_prompt = apply_chat_template(model.reader.metadata, msgs)
    status, tpl = c.post("/apply-template", {"messages": msgs})
    check(status == 200 and tpl["prompt"] == want_prompt,
          f"/apply-template gave {tpl}, apply_chat_template {want_prompt!r}")
    check(want_prompt.startswith("<|system|>\n") and "</s>" in want_prompt,
          f"the zephyr template did not render: {want_prompt!r}")
    _erase_all(srv, c)
    status, body = c.post("/v1/chat/completions", {
        "messages": msgs, "max_tokens": SERVER_NEW, "temperature": 0.0,
        "ignore_eos": True})
    check(status == 200, f"/v1/chat/completions: status {status} {body}")
    tok = model.tokenizer
    ids = tok.encode(want_prompt, add_special=True, parse_special=True)
    gen = list(generate(Context(model, n_ctx=1024, n_seq_max=1), ids,
                        SERVER_NEW))
    want = parse_assistant_message(tok.decode(gen), "content_only",
                                   True)["content"]
    got = body["choices"][0]["message"]["content"]
    check(got == want, f"chat reply {got!r}, generate() gives {want!r}")
    return {"prompt_tokens": len(ids), "reply_same_as_generate": True}


def _server_embeddings(torch, srv, c, model, ids) -> dict:
    """/v1/embeddings on 16, 130 and 512 tokens: unit norm, within the
    logits gate of a plain Context's embed, K1's GEMM and K2 launched;
    embed(causal=False) held against the plain version too; embed ms."""
    from llama_cpp_test_tpu_torch.runtime.engine import Context

    plain = Context(model, n_ctx=1024, n_seq_max=1, plain=True)
    inputs = [ids[:n] for n in SERVER_LENS]
    status, body = c.post("/v1/embeddings", {"input": inputs})
    launches = c.last
    check(status == 200, f"/v1/embeddings: status {status}")
    rows = []
    for x, d in zip(inputs, body["data"]):
        got = np.asarray(d["embedding"], np.float32)
        ref = plain.embed(x)
        with srv.engine.ctx_lock:
            bi = srv.sched.ctx.embed(x, causal=False)
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.time()
                srv.sched.ctx.embed(x)
                times.append((time.time() - t0) * 1e3)
        rows.append({"tokens": len(x), "norm": float(np.linalg.norm(got)),
                     "nmse": nmse(got, ref),
                     "nmse_bidirectional": nmse(
                         bi, plain.embed(x, causal=False)),
                     "embed_ms": float(np.median(times))})
    out = {"rows": rows, "launches": launches, "gate": LOGITS_GATE}
    for r in rows:
        check(abs(r["norm"] - 1.0) < 1e-3, f"embedding norm {r}")
        check(r["nmse"] < LOGITS_GATE and r["nmse_bidirectional"] <
              LOGITS_GATE, f"embedding against the plain path: {r}")
    check(launches["qmm_gemm"] > 0 and launches["flash_prefill"] > 0,
          f"/v1/embeddings launched no K1 GEMM or K2: {launches}")
    return out


def _server_rerank(c, model) -> dict:
    rng = np.random.default_rng(3)
    docs = [" ".join(rng.choice(_WORDS, 24)) for _ in range(4)]
    query = docs[2]
    status, body = c.post("/rerank", {"query": query, "documents": docs})
    check(status == 200, f"/rerank: status {status}")
    order = [r["index"] for r in body["results"]]
    check(order[0] == 2, f"the query's own text ranks {order}")
    return {"order": order}


def _server_slots(path, launches, kv, ids, tmp) -> dict:
    """A 512-token slot saved, erased and restored through
    /slots/0?action=: the 32 greedy tokens after the restore equal those
    after the same prompt without save and restore. Save and restore ms
    (the server's timings) and bytes."""
    prompt = ids[:512]
    body = {"prompt": prompt, "n_predict": SERVER_NEW, "temperature": 0.0,
            "ignore_eos": True}
    with _server(path, launches, n_ctx=1024, n_slots=1, kv_type=kv,
                 slot_save_path=tmp) as (srv, c):
        status, _ = c.post("/completion", {**body, "n_predict": 1})
        check(status == 200, f"{kv}: first /completion: {status}")
        status, saved = c.post("/slots/0?action=save",
                               {"filename": f"slot_{kv}.npz"})
        check(status == 200 and saved["n_saved"] == len(prompt),
              f"{kv}: save: {status} {saved}")
        status, direct = c.post("/completion", body)
        fed_direct = list(srv.sched.slots[0].cache_tokens)
        status_e, erased = c.post("/slots/0?action=erase")
        status_r, restored = c.post("/slots/0?action=restore",
                                    {"filename": f"slot_{kv}.npz"})
        check(status_e == 200 and status_r == 200 and
              restored["n_restored"] == len(prompt),
              f"{kv}: erase/restore: {erased} {restored}")
        status, after = c.post("/completion", body)
        after_launches = c.last
        # the slot's fed tokens (prompt and every generated token but the
        # last) and the text, which holds the last
        same = (list(srv.sched.slots[0].cache_tokens) == fed_direct and
                len(fed_direct) == len(prompt) + SERVER_NEW - 1 and
                _text(after) == _text(direct))
    out = {"kv": kv, "n_saved": saved["n_saved"],
           "bytes": saved["n_written"], "save_ms": saved["timings"]["save_ms"],
           "restore_ms": restored["timings"]["restore_ms"],
           "same_after_restore": same,
           "launches_after_restore": after_launches}
    check(out["same_after_restore"], f"{kv}: after restore {_text(after)!r},"
                                     f" without {_text(direct)!r}")
    k3 = "paged_decode_q8" if kv == "q8_0" else "paged_decode"
    check(after_launches[k3] > 0,
          f"{kv}: no {k3} after the restore: {after_launches}")
    return out


def _interleaved(model) -> dict:
    """An embed (on another thread) and a slot erase issued while a chained
    window is in flight leave a request's tokens as they are without
    them, and the embed as it is alone."""
    import threading

    from llama_cpp_test_tpu_torch.runtime.engine import Context
    from llama_cpp_test_tpu_torch.runtime.sampling import SamplerParams
    from llama_cpp_test_tpu_torch.runtime.scheduler import GenRequest, \
        Scheduler

    greedy = SamplerParams(temp=0.0)
    probe = list(range(100, 230))
    alone = Context(model, n_ctx=1024, n_seq_max=1).embed(probe)

    def run(interfere):
        ctx = Context(model, n_ctx=1024, n_seq_max=4)
        sched = Scheduler(ctx, n_slots=3, decode_window=16)
        for p in ([5, 6, 7], [8, 9, 10]):
            sched.submit(GenRequest(p, max_tokens=3, sampling=greedy,
                                    ignore_eos=True))
        _drain(sched)
        done = []

        def on_token(tok, piece, finished):
            if not interfere or finished is not None or \
                    sched.n_windows_chained <= len(done):
                return
            if not done:   # a chained window is in flight on the card
                t = threading.Thread(
                    target=lambda: done.append(ctx.embed(probe)))
                t.start()
                t.join(SERVER_TIMEOUT)
            elif len(done) == 1:
                idle = next(s for s in sched.slots
                            if s.req is None and s.seq is not None)
                ctx.free_seq(idle.seq)
                idle.seq, idle.cache_tokens = None, []
                done.append("erased")

        req = sched.submit(GenRequest(list(range(40, 170)), max_tokens=64,
                                      sampling=greedy, ignore_eos=True,
                                      on_token=on_token))
        _drain(sched)
        return req.output_tokens, done, sched.n_windows_chained

    want, _, _ = run(False)
    got, done, chained = run(True)
    out = {"windows_chained": chained, "interleaved": len(done),
           "tokens_same": got == want,
           "embed_same": len(done) > 0 and bool(np.array_equal(done[0],
                                                               alone))}
    check(len(done) == 2 and out["tokens_same"] and out["embed_same"],
          f"work between chained windows changed the result: {out}")
    return out


def _spec_rounds(ctx) -> list:
    """Log every verification call (Context.prefill_batch) of ctx: target
    sequence ids, fed rows and the logits of each row."""
    log, orig = [], ctx.prefill_batch

    def prefill_batch(seqs, rows):
        res = orig(seqs, rows)
        log.append(([s.seq_id for s in seqs], [list(r) for r in rows], res))
        return res

    ctx.prefill_batch = prefill_batch
    return log


def _spec_expected(log, sid) -> list:
    """The tokens greedy verification emits for target sequence sid: per
    round the argmax of each row's logits up to the first that differs
    from the draft (sample-and-accept-n with a greedy chain)."""
    out = []
    for sids, rows, res in log:
        if sid not in sids:
            continue
        i = sids.index(sid)
        draft, logits = rows[i][1:], res[i]
        for j in range(len(draft) + 1):
            t = int(np.argmax(logits[j]))
            out.append((t, logits[j]))
            if j >= len(draft) or t != draft[j]:
                break
    return out


def _top2(x) -> list:
    i = np.argsort(-x)[:2]
    return [[int(k), float(x[k])] for k in i]


def _emissions(sched) -> tuple:
    """Log the tokens the scheduler emits and the prompt they answer, by
    target sequence id (the first token comes from the prefill)."""
    emitted, prompt_of, orig = {}, {}, sched._process_token

    def process_token(slot, tok):
        sid = slot.seq.seq_id
        prompt_of.setdefault(sid, tuple(slot.req.prompt_tokens))
        emitted.setdefault(sid, []).append(int(tok))
        return orig(slot, tok)

    sched._process_token = process_token
    return emitted, prompt_of


def _spec_run(torch, path, launches, n_slots, draft, bodies) -> dict:
    """One server (draft: a file or None) serving `bodies`: one at a time
    with the slot erased between them at one slot, all at once at more.
    Returns its row of numbers, the tokens each target sequence emitted
    and their prompts, and the verification log (with a draft) or, for
    the plain server, each sequence's logits replayed per token at the
    same batch rows (_replay)."""
    from llama_cpp_test_tpu_torch.runtime.engine import Context

    kw = {} if draft is None else dict(draft_model_path=draft, n_draft=8,
                                       p_draft_min=0.0)
    with _server(path, launches, n_ctx=1024, n_slots=n_slots,
                 **kw) as (srv, c):
        log = _spec_rounds(srv.sched.ctx)
        rec = _Recorder(srv.sched.ctx) if draft is None else None
        emitted, prompt_of = _emissions(srv.sched)
        torch.cuda.synchronize()
        t0 = time.time()
        if n_slots == 1:
            res = []
            for b in bodies:
                res.append(c.post("/completion", b))
                check(c.post("/slots/0?action=erase")[0] == 200,
                      "erasing the speculative server's slot failed")
        else:
            with _gate(srv, len(bodies)):
                res = c.post_many("/completion", bodies)
        torch.cuda.synchronize()
        wall = time.time() - t0
        for status, b in res:
            check(status == 200, f"speculative /completion: {status} {b}")
        m = _srv_metrics(srv)
        row = {"requests": len(bodies), "wall_s": wall,
               "gen_tok_s": m["gen_tok_s"],
               "client_gen_tok_s": sum(b["usage"]["completion_tokens"]
                                       for _, b in res) / wall}
        run = {"row": row, "emitted": emitted, "prompt_of": prompt_of,
               "log": log}
        if draft is not None:
            drafted = sum(s.n_drafted for s in srv.sched.slots)
            accepted = sum(s.n_draft_accepted for s in srv.sched.slots)
            row.update(drafted=drafted, accepted=accepted,
                       accept_rate=accepted / max(drafted, 1),
                       target_calls=len(log),
                       tokens_per_target_call=m["gen_tokens"] /
                       max(len(log), 1),
                       draft_blocks_free=srv.sched.draft_ctx.mgr.num_free()
                       == srv.sched.draft_ctx.num_blocks)
            # every token after a request's first is the argmax of its
            # verification row
            row["argmax_mismatch_seqs"] = [
                sid for sid, toks in emitted.items()
                if [t for t, _ in _spec_expected(log, sid)][:len(toks) - 1]
                != toks[1:]]
    if rec is not None:
        rec.detach()
        run["logits"] = {}
        rctx = Context(srv.model, n_ctx=1024, n_seq_max=n_slots,
                       block_size=16)
        row["replay"] = _replay(rctx, rec.log, set(emitted), run["logits"])
        check(not row["replay"]["mismatches"],
              f"plain server at {n_slots} slots: tokens differ from the "
              f"per-token replay: {row['replay']}")
    return run


def _spec_parity(spec: dict, plain: dict) -> list:
    """Per request, the speculative server's run against the plain one's
    (_spec_run results, matched by prompt). Every verification row is held
    against the plain path's logits for the same tokens, replayed per
    token at the plain server's batch rows, by NMSE; the rows compared are
    those up to the first emitted token where the two paths differ, whose
    contexts are still the same. Where they differ, both paths' top-2
    logits there, and the plain path's top-2 gap against the largest
    logit difference between the paths there."""
    by_prompt = {p: sid for sid, p in plain["prompt_of"].items()}
    out = []
    for sid, stoks in spec["emitted"].items():
        psid = by_prompt[spec["prompt_of"][sid]]
        ptoks, lp = plain["emitted"][psid], plain["logits"][psid]
        ls = [x for _, x in _spec_expected(spec["log"], sid)]
        k = next((i for i, (a, b) in enumerate(zip(stoks, ptoks))
                  if a != b), None)
        # verification row j - 1 and replayed row j - 1 both give token j
        last = len(stoks) - 1 if k is None else k
        errs = [nmse(ls[j - 1], lp[j - 1]) for j in range(1, last + 1)]
        r = {"same": k is None, "tokens": len(stoks), "rows_compared":
             len(errs), "max_nmse": max(errs, default=None)}
        if k is not None:
            r["first_diff"] = k
            if k > 0:   # token 0 comes from the prefill, alike in both
                top = _top2(lp[k - 1])
                gap = top[0][1] - top[1][1]
                diff = float(np.abs(ls[k - 1] - lp[k - 1]).max())
                r.update(plain_top2=top, spec_top2=_top2(ls[k - 1]),
                         plain_gap=gap, logit_diff=diff)
            r["within"] = k > 0 and gap <= diff
        out.append(r)
    return out


def _server_speculative(torch, path, draft4, launches, model) -> dict:
    """-md with the same file as its own draft and with a 4-layer file of
    another seed, at one slot (three requests one at a time) and at four
    (four at once), beside the server without a draft. Every token a
    draft server emits after a request's first is the argmax of its
    verification row; each verification row is within the logits gate of
    the plain server's row for the same tokens (replayed at its batch
    rows); greedy tokens equal the plain server's or, where they first
    differ, the plain path's top-2 gap is within the two paths' logit
    difference; the draft Context's blocks are all free after the
    requests."""
    prompts = [_sched_prompts(model.tokenizer, 31 + i)[i] for i in range(4)]
    bodies = [{"prompt": p, "n_predict": SCHED_NEW, "temperature": 0.0,
               "ignore_eos": True} for p in prompts]
    out = {}
    for n_slots, n_req in ((1, 3), (4, 4)):
        plain = None
        for name, draft in (("none", None), ("self", path),
                            ("4-layer", draft4)):
            label = f"slots={n_slots} draft={name}"
            run = _spec_run(torch, path, launches, n_slots, draft,
                            bodies[:n_req])
            row = out[label] = run["row"]
            if draft is None:
                plain = run
                continue
            check(row["draft_blocks_free"],
                  f"{label}: draft blocks still held")
            check(row["drafted"] > 0, f"{label}: nothing was drafted")
            check(not row["argmax_mismatch_seqs"],
                  f"{label}: emitted tokens are not the argmax of their "
                  f"verification rows: {row['argmax_mismatch_seqs']}")
            row["parity"] = _spec_parity(run, plain)
            bad = [p for p in row["parity"]
                   if not p["rows_compared"] or
                   p["max_nmse"] >= LOGITS_GATE or
                   not (p["same"] or p["within"])]
            check(not bad, f"{label}: verification rows off the plain "
                           f"path's logits, or speculative tokens that "
                           f"differ from the plain server's past the "
                           f"logit difference: {bad}")
    return out


def phase_server(torch, kept: Kept, nvidia_smi: str) -> dict:
    """The OpenAI-compatible server (server/app.py) over HTTP on
    127.0.0.1 (aiohttp.test_utils) on the kept TinyLlama file (full width
    and depth, its zephyr chat template). Completions, concurrency, chat,
    embeddings, rerank, the API key and work between chained windows on a
    bf16 server, then slots at bf16 and q8_0 KV and speculative decoding
    on servers of their own. The launch counts are zeroed just before
    each request and read just after it (_Http), so `launches` is the
    servers' own work."""
    from llama_cpp_test_tpu_torch.ops import _cuda

    try:
        import aiohttp
    except ImportError as e:
        raise SmokeFailure(f"the server phase needs aiohttp: {e}") from e
    emit({"phase": "server", "aiohttp": aiohttp.__version__})
    path = kept.files["tinyllama"]
    launches = dict.fromkeys(_cuda.LAUNCHES, 0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_server_")
    try:
        draft4 = os.path.join(tmp, "tinyllama_4layer.gguf")
        write_llama_gguf(draft4, dict(TINYLLAMA, n_layer=4), seed=17,
                         vocab_seed=7)
        out = {"aiohttp": aiohttp.__version__, "card": nvidia_smi}
        with _server(path, launches, n_ctx=1024, n_slots=8,
                     api_key=SERVER_KEY) as (srv, c):
            model = srv.model
            ids = _sched_prompts(model.tokenizer, 21)[-1]
            out["completion"] = _server_completions(srv, c, model, ids)
            out["concurrency"] = _server_concurrency(torch, srv, c, model)
            out["chat"] = _server_chat(srv, c, model)
            out["embeddings"] = _server_embeddings(torch, srv, c, model, ids)
            out["rerank"] = _server_rerank(c, model)
            status, _ = c.post("/props", auth=False)
            out["api_key"] = {"status_without_key": status}
            check(status == 401, f"a request without the key: {status}")
            out["interleaved"] = _interleaved(model)
        out["launches_bf16_server"] = dict(launches)
        missing = [k for k in DENSE_PATH if launches[k] <= 0]
        check(not missing, f"server: kernels not launched: {missing} "
                           f"({launches})")
        emit({"phase": "server", "part": "bf16", **out})
        out["slots"] = [_server_slots(path, launches, kv, ids, tmp)
                        for kv in ("bf16", "q8_0")]
        emit({"phase": "server", "part": "slots", "slots": out["slots"]})
        out["speculative"] = _server_speculative(torch, path, draft4,
                                                 launches, model)
        out["launches"] = launches
        emit({"phase": "server", "part": "speculative",
              "speculative": out["speculative"], "launches": launches,
              "card": nvidia_smi})
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# adapters, tracing and the draft-free drafters


ADAPTER_RANK = 16
ADAPTER_LENS = (16, 130, 512)       # prompt tokens of the LoRA checks
ADAPTER_DECODE = 8                  # decode steps held to the plain path
DRAFT_NEW = 64                      # tokens the lookahead/lookup CLIs make
IMATRIX_TOKENS, IMATRIX_CHUNK = 1024, 512
DRAFT_TEXT = CLI_TEXT + " " + CLI_TEXT


def write_lora_gguf(path: str, hp: dict, rank: int, seed: int,
                    std: float = 0.03) -> None:
    """A LoRA GGUF over all seven projections of every layer of geometry
    hp: lora_a [rank, K] and lora_b [N, rank], F32 from seeded normals of
    std `std`, alpha = rank (scale 1). At std 0.03 a rank-16 update B A
    has entries of std ~0.0036, about a quarter of the synthesized
    weights' (~0.015)."""
    from llama_cpp_test_tpu_torch.gguf.writer import GGUFWriter

    rng = np.random.default_rng(seed)
    c, ff = hp["n_embd"], hp["n_ff"]
    q, kv = hp["n_head"] * hp["head_dim"], hp["n_head_kv"] * hp["head_dim"]
    dims = {"attn_q": (q, c), "attn_k": (kv, c), "attn_v": (kv, c),
            "attn_output": (c, q), "ffn_gate": (ff, c), "ffn_up": (ff, c),
            "ffn_down": (c, ff)}
    w = GGUFWriter(path, arch="llama")
    w.add_kv("adapter.type", "lora")
    w.add_kv("adapter.lora.alpha", float(rank))
    for i in range(hp["n_layer"]):
        for t, (n, k) in dims.items():
            base = f"blk.{i}.{t}.weight"
            w.add_tensor(base + ".lora_a", (std * rng.standard_normal(
                (rank, k))).astype(np.float32))
            w.add_tensor(base + ".lora_b", (std * rng.standard_normal(
                (n, rank))).astype(np.float32))
    w.write()


def _salad_ids(tok, seed: int, n: int) -> list:
    """n token ids of seeded word salad over _WORDS."""
    rng = np.random.default_rng(seed)
    ids = tok.encode(" ".join(rng.choice(_WORDS, 4 * n)), add_special=True,
                     parse_special=True)
    check(len(ids) >= n, f"word salad gave {len(ids)} tokens, not {n}")
    return ids[:n]


def _rows(ctx, prompt):
    """Logits at every position of one prefill of a fresh sequence."""
    s = ctx.new_seq()
    try:
        return ctx.prefill(s, prompt, all_logits=True)
    finally:
        ctx.free_seq(s)


def _counted(torch, fn):
    """fn() with the launch counts zeroed just before and read just after:
    (result, launches)."""
    from llama_cpp_test_tpu_torch.ops import _cuda

    torch.cuda.synchronize()
    _cuda.reset_launches()
    res = fn()
    torch.cuda.synchronize()
    return res, dict(_cuda.LAUNCHES)


def _decode_ms(torch, ctx, prompt, n: int = 32) -> float:
    """Wall ms a token of n greedy per-token decode() steps after a
    prefill (the host argmax included, as generate() takes it)."""
    s = ctx.new_seq()
    tok = int(np.argmax(ctx.prefill(s, prompt)))
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(n):
        tok = int(np.argmax(ctx.decode([s], [tok])[0]))
    torch.cuda.synchronize()
    ctx.free_seq(s)
    return (time.time() - t0) * 1e3 / n


def _adapter_lora(torch, model, adapter, prompts) -> dict:
    """The adapter attached (scale 1): generate() at each prompt launches
    K1's GEMV and GEMM, K2 and K3, as many times as without it (no
    projection leaves its kernel); its prefill rows and ADAPTER_DECODE
    decode steps are within the logits gate of the plain path carrying the
    same adapter (min rounded as the kernels round it), and far from the
    base model's; at scale 0 (attach_loras, and attach_lora's user scale)
    the logits are the base model's bits. Decode wall a token with the
    adapter against without."""
    from llama_cpp_test_tpu_torch.models.lora import attach_lora, attach_loras
    from llama_cpp_test_tpu_torch.runtime.engine import Context, generate

    w = model.weights
    ctx = lambda **kw: Context(model, n_ctx=1024, n_seq_max=2,
                               block_size=16, **kw)
    gen = lambda: [list(generate(ctx(), p, ADAPTER_DECODE + 1))
                   for p in prompts]
    attach_loras(w, [])
    base_rows = [_rows(ctx(), p) for p in prompts]
    base_toks, base_launches = _counted(torch, gen)
    attach_lora(w, adapter)
    toks, launches = _counted(torch, gen)
    out = {"launches": launches, "launches_without": base_launches,
           "tokens_same_as_base": toks == base_toks, "prompts": {}}
    check(launches == base_launches,
          f"lora: launches {launches}, without the adapter {base_launches}")
    missing = [k for k in DENSE_PATH if launches[k] <= 0]
    check(not missing, f"lora: kernels not launched: {missing}")
    bad = []
    for p, base in zip(prompts, base_rows):
        steps_k, dtoks = _trace(ctx(), p, n_decode=ADAPTER_DECODE)
        with _plain_min("fold"):
            steps_p, _ = _trace(ctx(plain=True), p, dtoks,
                                n_decode=ADAPTER_DECODE)
        cmp = _compare(steps_p, steps_k)
        r = {"nmse": {k: v["nmse"] for k, v in cmp.items()},
             "nmse_vs_base": nmse(base, steps_k[0][0])}
        out["prompts"][len(p)] = r
        bad += [(len(p), k, v) for k, v in r["nmse"].items()
                if not v < LOGITS_GATE]
        if not r["nmse_vs_base"] > 10 * LOGITS_GATE:
            bad.append((len(p), "vs base", r["nmse_vs_base"]))
    check(not bad, f"lora: logits off the plain path or on the base's: {bad}")
    ref = prompts[1]
    attach_loras(w, [(adapter, 0.0)])
    zero = _rows(ctx(), ref)
    attach_lora(w, adapter, 0.0)
    zero_scaled = _rows(ctx(), ref)
    out["scale0_bit_equal"] = bool(np.array_equal(zero, base_rows[1]))
    out["user_scale0_bit_equal"] = bool(np.array_equal(zero_scaled,
                                                       base_rows[1]))
    check(out["scale0_bit_equal"] and out["user_scale0_bit_equal"],
          "lora: at scale 0 the logits are not the base model's bits")
    ms = {"with": [], "without": []}
    for _ in range(2):
        for label, pairs in (("without", []), ("with", [(adapter, 1.0)])):
            attach_loras(w, pairs)
            ms[label].append(_decode_ms(torch, ctx(), ref))
    out["decode_ms_per_token"] = {k: min(v) for k, v in ms.items()}
    return out


def _adapter_sched(torch, model, adapter) -> dict:
    """The Scheduler with the adapter attached: four requests (two greedy,
    two seeded) of 32 tokens through windows of 16, the greedy rows equal
    to a per-token replay at the same batches; two chained windows with no
    host sync and no memset (_window_clean). Then one greedy request of 64
    tokens whose scale drops to 0 between two windows (inside a token
    callback, while the next chained window is in flight): a per-token
    replay that keeps scale 1 until that point and 0 after it gives every
    token, so the in-flight window kept the tensors it was queued with."""
    from llama_cpp_test_tpu_torch.models.lora import attach_loras
    from llama_cpp_test_tpu_torch.runtime.engine import Context
    from llama_cpp_test_tpu_torch.runtime.sampling import SamplerParams
    from llama_cpp_test_tpu_torch.runtime.scheduler import GenRequest, \
        Scheduler

    w = model.weights
    attach_loras(w, [(adapter, 1.0)])
    prompts = _sched_prompts(model.tokenizer, 21)[:4]
    params = _sched_params()[2:6]
    sched, reqs, rec = _run_sched(model, "bf16", prompts, params,
                                  record=True, max_tokens=32)
    greedy = set(sorted(ev[1] for ev in rec.log if ev[0] == "new")[:2])
    rctx = Context(model, n_ctx=1024, n_seq_max=8, block_size=16)
    out = {"metrics": sched.metrics(),
           "replay": _replay(rctx, rec.log, greedy),
           "window": _window_clean(torch, model, "bf16", prompts, params)}
    check(not out["replay"]["mismatches"] and
          out["replay"]["window_tokens"] > 0,
          f"lora sched: greedy tokens off the per-token replay: "
          f"{out['replay']}")

    def run(swap: bool):
        attach_loras(w, [(adapter, 1.0)])
        ctx = Context(model, n_ctx=1024, n_seq_max=2, block_size=16)
        rec = _Recorder(ctx)
        sched = Scheduler(ctx, n_slots=1, decode_window=16)
        at = []

        def on_token(tok, piece, finished):
            if swap and not at and finished is None and \
                    sched.n_windows_chained >= 1:
                attach_loras(w, [(adapter, 0.0)])
                rec.log.append(("swap", 0.0))
                at.append(len(req.output_tokens))

        req = sched.submit(GenRequest(prompts[3], max_tokens=64,
                                      sampling=SamplerParams(temp=0.0),
                                      ignore_eos=True, on_token=on_token))
        _drain(sched)
        rec.detach()
        return req.output_tokens, rec.log, at

    unswapped, _, _ = run(False)
    toks, log, at = run(True)
    attach_loras(w, [(adapter, 1.0)])
    rctx = Context(model, n_ctx=1024, n_seq_max=2, block_size=16)
    replay = _replay(rctx, log, {ev[1] for ev in log if ev[0] == "new"},
                     hooks={"swap": lambda ev: attach_loras(
                         w, [(adapter, ev[1])])})
    out["swap"] = {"at_token": at[0] if at else None,
                   "same_as_unswapped": toks == unswapped,
                   "first_diff": next((i for i, (a, b) in enumerate(
                       zip(toks, unswapped)) if a != b), None),
                   "replay": replay}
    check(at and not replay["mismatches"] and replay["window_tokens"] > 0,
          f"lora swap between windows: {out['swap']}")
    check(toks != unswapped, "lora swap: the scale change changed no token")
    attach_loras(w, [])
    return out


def _adapter_server(torch, path, adapter_path, launches) -> dict:
    """LlamaServer(lora=[(adapter, 1.0)]) over HTTP: a greedy /completion
    equals generate() on the server's own weights with the adapter; after
    POST /lora-adapters sets the scale to 0, the same request equals the
    base model's generate(); a body with a bad id answers 400 and leaves
    the scale at 0."""
    from llama_cpp_test_tpu_torch.runtime.engine import Context, generate

    out = {}
    with _server(path, launches, n_ctx=1024, n_slots=2,
                 lora=[(adapter_path, 1.0)]) as (srv, c):
        tok = srv.model.tokenizer
        prompt = _sched_prompts(tok, 23)[4]
        body = {"prompt": prompt, "n_predict": SERVER_NEW,
                "temperature": 0.0, "ignore_eos": True}

        def want():
            with srv.engine.ctx_lock:
                ctx = Context(srv.model, n_ctx=1024, n_seq_max=1)
                return tok.decode(list(generate(ctx, prompt, SERVER_NEW)))

        for scale in (1.0, 0.0):
            if scale == 0.0:
                status, listed = c.post("/lora-adapters",
                                        [{"id": 0, "scale": 0.0}])
                check(status == 200 and listed[0]["scale"] == 0.0,
                      f"POST /lora-adapters: {status} {listed}")
            status, got = c.post("/completion", body)
            check(status == 200, f"/completion at scale {scale}: {status}")
            out[f"scale={scale}"] = {"same_as_generate": _text(got) == want(),
                                     "launches": c.last}
            check(_text(got) == want(), f"server at lora scale {scale}: "
                                        f"{_text(got)!r} but generate() "
                                        f"gives {want()!r}")
        status, _ = c.post("/lora-adapters", [{"id": 0, "scale": 1.0},
                                              {"id": 5, "scale": 1.0}])
        out["bad_id"] = {"status": status,
                         "scale_after": srv.loras[0]["scale"]}
        check(status == 400 and srv.loras[0]["scale"] == 0.0,
              f"a bad adapter id: {out['bad_id']}")
    return out


def _adapter_cvec_trace(torch, model, path, prompts, tmp) -> dict:
    """cli.cvector_generator on two prompt pairs: one unit-norm direction a
    layer. Attached at a strength of half the mid layer's hidden-state
    norm, they move the logits past the gate; detached, the logits are the
    base's bits. trace_eval through the kernels against the plain path:
    every tensor within the logits gate; a live sequence's next decode is
    bit-equal with and without a trace before it."""
    import io

    from llama_cpp_test_tpu_torch.cli import cvector_generator
    from llama_cpp_test_tpu_torch.models.cvec import (attach_control_vector,
                                                      detach_control_vector,
                                                      load_control_vector)
    from llama_cpp_test_tpu_torch.runtime.engine import Context
    from llama_cpp_test_tpu_torch.runtime.tracing import trace_eval

    words = np.random.default_rng(5).choice(_WORDS, (4, 12))
    files = []
    for name, rows in (("pos", words[:2]), ("neg", words[2:])):
        files.append(os.path.join(tmp, f"{name}.txt"))
        with open(files[-1], "w") as f:
            f.write("\n".join(" ".join(r) for r in rows) + "\n")
    cv = os.path.join(tmp, "cvec.gguf")
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        rc = cvector_generator.main(["-m", path, "--positive-file", files[0],
                                     "--negative-file", files[1], "-o", cv],
                                    device="cuda")
    out = {"cli_rc": rc, "cli_stdout": buf.getvalue().strip(),
           "cli_s": time.time() - t0}
    dirs = load_control_vector(cv)
    norms = [float(np.linalg.norm(dirs[il])) for il in sorted(dirs)]
    out["directions"] = len(dirs)
    check(rc == 0 and sorted(dirs) == list(range(1, model.hp.n_layer + 1))
          and all(abs(n - 1.0) < 1e-4 for n in norms),
          f"cvector_generator: rc {rc}, layers {sorted(dirs)}, norms {norms}")
    ctx = lambda **kw: Context(model, n_ctx=1024, n_seq_max=2,
                               block_size=16, **kw)
    ref = prompts[1]
    (traces, launches) = _counted(
        torch, lambda: trace_eval(ctx(), ref, keep_values=True))
    with _plain_min("fold"):
        plain = trace_eval(ctx(plain=True), ref, keep_values=True)
    out["trace"] = {"tensors": len(traces), "launches": launches,
                    "max_nmse": max(nmse(p.values, t.values)
                                    for p, t in zip(plain, traces))}
    check([t.name for t in traces] == ["inp_embd"] + [
        f"l_out-{i}" for i in range(model.hp.n_layer)] + ["result_output"],
        f"trace names {[t.name for t in traces]}")
    check(out["trace"]["max_nmse"] < LOGITS_GATE and
          launches["qmm_gemm"] > 0 and launches["flash_prefill"] > 0,
          f"trace_eval off the plain path or off the kernels: {out['trace']}")
    mid = traces[1 + model.hp.n_layer // 2]
    strength = 0.5 * mid.std * np.sqrt(model.hp.n_embd)
    base = _rows(ctx(), ref)
    attach_control_vector(model.weights, dirs, strength=strength)
    steered = _rows(ctx(), ref)
    detach_control_vector(model.weights)
    back = _rows(ctx(), ref)
    out["cvec"] = {"strength": float(strength),
                   "nmse_steered_vs_base": nmse(base, steered),
                   "detached_bit_equal": bool(np.array_equal(back, base))}
    check(out["cvec"]["nmse_steered_vs_base"] > LOGITS_GATE and
          out["cvec"]["detached_bit_equal"], f"control vector: {out['cvec']}")

    def next_decode(trace: bool):
        c = ctx()
        s = c.new_seq()
        tok = int(np.argmax(c.prefill(s, ref)))
        if trace:
            trace_eval(c, prompts[0])
        return c.decode([s], [tok])
    out["decode_bit_equal_after_trace"] = bool(np.array_equal(
        next_decode(False), next_decode(True)))
    check(out["decode_bit_equal_after_trace"],
          "a trace between a prefill and a decode changed the decode")
    return out


def _adapter_imatrix(torch, model) -> dict:
    """IMatrixCollector over IMATRIX_TOKENS tokens in IMATRIX_CHUNK-token
    chunks: K1's GEMM launches; every tensor's sums within the logits gate
    (NMSE) of the plain path's (min rounded as the kernels round it). The
    second of two runs is timed."""
    from llama_cpp_test_tpu_torch.runtime.imatrix import IMatrixCollector

    ids = _salad_ids(model.tokenizer, 41, IMATRIX_TOKENS)

    def collect(plain=False):
        coll = IMatrixCollector(model, plain=plain)
        coll.collect(ids, chunk=IMATRIX_CHUNK)
        return coll

    _, launches = _counted(torch, collect)
    t0 = time.time()
    coll = collect()
    torch.cuda.synchronize()
    secs = time.time() - t0
    with _plain_min("fold"):
        plain = collect(plain=True)
    errs = {n: nmse(plain.sums[n], v) for n, v in coll.sums.items()}
    out = {"tensors": len(coll.sums), "tok_s": IMATRIX_TOKENS / secs,
           "seconds": secs, "launches": launches,
           "max_nmse": max(errs.values()),
           "counts": sorted(set(coll.counts.values()))}
    check(set(plain.sums) == set(coll.sums) and out["max_nmse"] < LOGITS_GATE
          and launches["qmm_gemm"] > 0 and out["counts"] == [IMATRIX_TOKENS],
          f"imatrix: {out}")
    return out


def _draft_cli(torch, model, cli, decoder, argv) -> dict:
    """Run a drafter CLI (cli.lookahead or cli.lookup) in this process on
    the card, logging its prompt prefill and every verification prefill
    (Context.prefill) and its decoder's tokens. Every emitted token must be
    the argmax of its own verification row; against plain greedy decode on
    the same prompt (per-token decode(), K1's GEMV and K3), the rows up to
    the first token where the two differ are within the logits gate, and
    at that token the plain path's top-2 gap is within the largest logit
    difference between the two paths (_spec_parity)."""
    import io

    from llama_cpp_test_tpu_torch.runtime.engine import Context

    calls, ran = [], []
    orig_prefill, orig_gen = Context.prefill, decoder.generate

    def prefill(self, s, tokens, all_logits=False, top_k=0):
        res = orig_prefill(self, s, tokens, all_logits, top_k)
        calls.append((list(tokens), res))
        return res

    def generate(self, prompt, n, eos_ids=None):
        torch.cuda.synchronize()
        t0 = time.time()
        toks = orig_gen(self, prompt, n, eos_ids)
        torch.cuda.synchronize()
        ran.append((self, list(prompt), toks, time.time() - t0, eos_ids))
        return toks

    buf, err = io.StringIO(), io.StringIO()
    Context.prefill, decoder.generate = prefill, generate
    try:
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            rc = cli.main(argv, device="cuda")
    finally:
        Context.prefill, decoder.generate = orig_prefill, orig_gen
    check(rc == 0 and len(ran) == 1, f"{cli.__name__}: rc {rc}")
    dec, prompt, toks, secs, eos = ran[0]
    check(calls[0][0] == prompt, "the first prefill is not the prompt's")
    log = [([0], [t], [lg]) for t, lg in calls[1:]]
    verified = [t for t, _ in _spec_expected(log, 0)]
    argmax_ok = toks[0] == int(np.argmax(calls[0][1])) and \
        verified[:len(toks) - 1] == toks[1:]
    # plain greedy decode of the same prompt, its logits kept
    ctx = Context(model, n_ctx=2048, n_seq_max=1)
    s = ctx.new_seq()
    cur = [int(np.argmax(ctx.prefill(s, prompt)))]
    rows = []
    while len(cur) < len(toks) and not (eos and cur[-1] in eos):
        rows.append(ctx.decode([s], cur[-1:])[0])
        cur.append(int(np.argmax(rows[-1])))
    parity = _spec_parity(
        {"emitted": {0: toks}, "prompt_of": {0: 0}, "log": log},
        {"emitted": {0: cur}, "prompt_of": {0: 0}, "logits": {0: rows}})[0]
    stats = (vars(dec.stats) if hasattr(dec, "stats") else
             {"n_drafted": dec.n_drafted, "n_accepted": dec.n_accepted})
    out = {"rc": rc, "tokens": len(toks), "passes": len(calls),
           "tokens_per_pass": len(toks) / len(calls),
           "tok_s": len(toks) / secs,
           "stats": stats, "stderr_stats": err.getvalue().strip()
           .splitlines()[-5:], "argmax_of_own_rows": argmax_ok,
           "parity": parity, "stdout_chars": len(buf.getvalue())}
    check(argmax_ok, f"{cli.__name__}: a token is not the argmax of its "
                     f"verification row")
    check(parity["rows_compared"] and parity["max_nmse"] < LOGITS_GATE and
          (parity["same"] or parity["within"]),
          f"{cli.__name__}: verification rows off plain decode, or tokens "
          f"that differ past the logit difference: {parity}")
    return out


def phase_adapters(torch, kept: Kept, nvidia_smi: str) -> dict:
    """LoRA, control vectors, eval tracing, imatrix and the draft-free
    drafters on the kept TinyLlama file (full width and depth): a seeded
    rank-16 adapter over all seven projections of every layer through
    generate() (_adapter_lora), the Scheduler (_adapter_sched) and the
    server (_adapter_server); cvector_generator, control vectors and
    trace_eval (_adapter_cvec_trace); imatrix (_adapter_imatrix); the
    lookahead and lookup CLIs at -n 64 (_draft_cli). Prints the decode
    wall with the adapter against without, imatrix tok/s and the
    drafters' tokens a pass and tok/s beside the card."""
    from llama_cpp_test_tpu_torch.cli import lookahead as la_cli
    from llama_cpp_test_tpu_torch.cli import lookup as lu_cli
    from llama_cpp_test_tpu_torch.models.lora import attach_loras, load_lora
    from llama_cpp_test_tpu_torch.ops import _cuda
    from llama_cpp_test_tpu_torch.runtime.engine import Model
    from llama_cpp_test_tpu_torch.runtime.lookahead import LookaheadDecoder
    from llama_cpp_test_tpu_torch.runtime.ngram_cache import LookupDecoder

    path = kept.files["tinyllama"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_adapters_")
    t_phase = time.time()
    try:
        adapter_path = os.path.join(tmp, "lora.gguf")
        write_lora_gguf(adapter_path, TINYLLAMA, ADAPTER_RANK, seed=29)
        model = Model(path, device="cuda")
        adapter = load_lora(adapter_path, model.hp)
        prompts = [_salad_ids(model.tokenizer, 37, n) for n in ADAPTER_LENS]
        out = {"card": nvidia_smi, "rank": ADAPTER_RANK}
        out["lora"] = _adapter_lora(torch, model, adapter, prompts)
        emit({"phase": "adapters", "part": "lora", **out["lora"]})
        out["sched"] = _adapter_sched(torch, model, adapter)
        emit({"phase": "adapters", "part": "sched", **out["sched"]})
        server_launches = dict.fromkeys(_cuda.LAUNCHES, 0)
        out["server"] = _adapter_server(torch, path, adapter_path,
                                        server_launches)
        emit({"phase": "adapters", "part": "server", **out["server"]})
        attach_loras(model.weights, [])
        out["cvec_trace"] = _adapter_cvec_trace(torch, model, path, prompts,
                                                tmp)
        emit({"phase": "adapters", "part": "cvec_trace",
              **out["cvec_trace"]})
        out["imatrix"] = _adapter_imatrix(torch, model)
        emit({"phase": "adapters", "part": "imatrix", **out["imatrix"]})
        for name, cli, dec in (("lookahead", la_cli, LookaheadDecoder),
                               ("lookup", lu_cli, LookupDecoder)):
            out[name] = _draft_cli(torch, model, cli, dec, [
                "-m", path, "-p", DRAFT_TEXT, "-n", str(DRAFT_NEW)])
            emit({"phase": "adapters", "part": name, **out[name]})
        out["launches"] = out["lora"]["launches"]
        out["seconds"] = time.time() - t_phase
        emit({"phase": "adapters", "part": "summary", "card": nvidia_smi,
              "seconds": out["seconds"],
              "decode_ms_per_token": out["lora"]["decode_ms_per_token"],
              "imatrix_tok_s": out["imatrix"]["tok_s"],
              "lookahead": {k: out["lookahead"][k] for k in
                            ("tokens_per_pass", "tok_s")},
              "lookup": {k: out["lookup"][k] for k in
                         ("tokens_per_pass", "tok_s")}})
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# the gemma and qwen quirk axes


# (label, geometry, GGUF type, seed, long prompt past the window or None)
QUIRK_FILES = (("gemma2_2b", GEMMA2_2B, "Q4_K", 31, 4608),
               ("gemma3_1b", GEMMA3_1B, "Q8_0", 32, 1024),
               ("qwen25_05b", QWEN25_05B, "Q8_0", 33, None),
               ("qwen3_06b", QWEN3_06B, "Q8_0", 34, None))
QUIRK_DECODE = 8            # decode steps held to the plain path
LONG_CHUNK = 512            # the Scheduler's prefill chunk


def _global_layers(hp, n_ctx: int) -> list:
    """The layers whose decode takes K3 in a Context of n_ctx tokens: the
    layers that attend (not deci's attention-free and linear-attention
    ones) with no window, or one that cannot bind (>= n_ctx)."""
    from llama_cpp_test_tpu_torch.models.hparams import layer_window
    from llama_cpp_test_tpu_torch.models.llama import attends

    return [i for i in range(hp.n_layer) if attends(hp, i)
            and not 0 < layer_window(hp, i) < n_ctx]


def _launch_counts(torch, ctx, prompt, n_decode: int, tokens=None) -> dict:
    """Launches of one prefill of `prompt` (LONG_CHUNK-token chunks) on a
    fresh sequence, then of n_decode decode steps (on `tokens`, else
    greedy), counted apart; with the logits of the last prefill position
    and of each decode step, the tokens fed and, on a MoE model, the
    experts each of those rows took in every layer (else None)."""
    from llama_cpp_test_tpu_torch.ops import _cuda

    s = ctx.new_seq()
    route = lambda calls, row: (np.stack([c[row] for c in calls])
                                if calls else None)
    with _record_routing() as calls:
        torch.cuda.synchronize()
        _cuda.reset_launches()
        for i in range(0, len(prompt), LONG_CHUNK):
            calls.clear()
            chunk = prompt[i:i + LONG_CHUNK]
            logits = ctx.prefill(s, chunk)
        torch.cuda.synchronize()
        pre = dict(_cuda.LAUNCHES)
        _cuda.reset_launches()
        rows, toks = [logits], []
        routes = [route(calls, len(chunk) - 1)]
        for i in range(n_decode):
            toks.append(tokens[i] if tokens else int(np.argmax(rows[-1])))
            calls.clear()
            rows.append(ctx.decode([s], toks[-1:])[0])
            routes.append(route(calls, 0))
        torch.cuda.synchronize()
    dec = dict(_cuda.LAUNCHES)
    ctx.free_seq(s)
    return {"prefill": pre, "decode": dec, "rows": rows, "tokens": toks,
            "routes": routes}


def _k1_per_step(model) -> int:
    """K1 launches one decode step makes: each quantized projection plane
    of every layer once (the fused q|k|v and gate|up planes once each, the
    MLA planes, the shared experts') and the head; a BF16 tensor's dense
    plane (an F32 router's too) is a plain product, no K1."""
    w = model.weights
    planes = [w.output] + [getattr(lw, f) for lw in w.layers for f in (
        "wqkv", "wq", "wk", "wv", "wo", "w_gateup", "w_gate", "w_up",
        "w_down", "wq_a", "wq_b", "wkv_a", "wkv_b", "gate_shexp",
        "up_shexp", "down_shexp")]
    return sum(qt is not None and qt.kind != "dense" for qt in planes)


def _path_prediction(torch, model, prompt, n_ctx: int,
                     kv: str = "bf16", plain_too: bool = True) -> dict:
    """The launches a prefill and QUIRK_DECODE decode steps of one
    sequence must make: K2 once a layer that attends a chunk (every such
    layer, windowed or not, at its own head counts; none over q8_0 pages,
    which prefill on the dequantizing gather),
    K3 (K3-q8 at q8_0 KV) once a global layer a step (a sliding-window
    layer whose window binds at n_ctx decodes on the gather path, as the
    reference sends any window to XLA), K1's GEMV once a quantized
    projection plane a step (_k1_per_step: four a layer where q|k|v and
    gate|up fuse, and the head), K4's GEMV three times a MoE layer a step
    (gate, up, down; its GEMM never in decode). An ALiBi file launches
    neither K2 nor K3:
    its attention takes the gather path, as the reference sends it to XLA.
    Then the same tokens through the plain path: the last prompt
    position's logits and every decode step's within the logits gate; on
    a MoE model, the steps whose expert routing agrees with the plain
    path's in every layer (a near tie may send one to other experts,
    another computation: counted, and at most half the steps). With
    plain_too False, the launches alone (a caller that holds the same
    file's logits to the plain path elsewhere)."""
    from llama_cpp_test_tpu_torch.models.llama import attends
    from llama_cpp_test_tpu_torch.runtime.engine import Context

    hp = model.hp
    glob = [] if hp.alibi else _global_layers(hp, n_ctx)
    attending = sum(attends(hp, i) for i in range(hp.n_layer))
    ctx = lambda **kw: Context(model, n_ctx=n_ctx, n_seq_max=1,
                               block_size=16, kv_type=kv, **kw)
    got = _launch_counts(torch, ctx(), prompt, QUIRK_DECODE)
    chunks = -(-len(prompt) // LONG_CHUNK)
    k3 = "paged_decode_q8" if kv == "q8_0" else "paged_decode"
    want = {"prefill": {"flash_prefill": 0 if kv == "q8_0" or hp.alibi else
                        attending * chunks, k3: 0},
            "decode": {"flash_prefill": 0,
                       k3: len(glob) * QUIRK_DECODE,
                       "qmm_gemv": _k1_per_step(model) * QUIRK_DECODE}}
    moe_layers = sum(lw.gate_inp is not None for lw in model.weights.layers)
    if moe_layers:
        want["decode"].update(gmm_gemv=3 * moe_layers * QUIRK_DECODE,
                              gmm_gemm=0)
    out = {"prompt": len(prompt), "kv": kv, "n_ctx": n_ctx,
           "global_layers": glob,
           "launches": {k: got[k] for k in ("prefill", "decode")},
           "predicted": want}
    for step, counts in want.items():
        for k, n in counts.items():
            check(got[step][k] == n, f"{hp.arch} {len(prompt)} tokens: {k} "
                                     f"launched {got[step][k]} times in "
                                     f"{step}, the path predicts {n}")
    if not plain_too:
        return out
    with _plain_min("fold"):
        plain = _launch_counts(torch, ctx(plain=True), prompt, QUIRK_DECODE,
                               got["tokens"])
    same = [a is None or not _routing_differs(a, b).any()
            for a, b in zip(plain["routes"], got["routes"])]
    out.update(nmse=[nmse(a, b) for a, b in zip(plain["rows"], got["rows"])],
               routing_changed_steps=[i for i, ok in enumerate(same)
                                      if not ok],
               gate=LOGITS_GATE)
    held = [v for v, ok in zip(out["nmse"], same) if ok]
    check(2 * len(held) > len(same) and max(held) < LOGITS_GATE,
          f"{hp.arch} {len(prompt)} tokens: logits outside the gate: "
          f"{out['nmse']} (routing changed at steps "
          f"{out['routing_changed_steps']})")
    return out


def _long_sched(torch, model, prompt, n_ctx: int) -> dict:
    """One Scheduler slot on a prompt past the window: LONG_CHUNK-token
    prefill chunks (K2, the window biting), then 32 greedy tokens through
    decode windows; every token equals the per-token decode() replay."""
    from llama_cpp_test_tpu_torch.runtime.engine import Context
    from llama_cpp_test_tpu_torch.runtime.sampling import SamplerParams

    t0 = time.time()
    sched, reqs, rec = _run_sched(model, "bf16", [prompt],
                                  [SamplerParams(temp=0.0)], record=True,
                                  max_tokens=32, n_ctx=n_ctx, n_slots=1)
    wall = time.time() - t0
    sid = next(ev[1] for ev in rec.log if ev[0] == "new")
    replay = _replay(Context(model, n_ctx=n_ctx, n_seq_max=1, block_size=16),
                     rec.log, {sid})
    out = {"prompt": len(prompt), "tokens": len(reqs[0].output_tokens),
           "wall_s": wall, "metrics": sched.metrics(), "replay": replay}
    check(out["tokens"] == 32 and not replay["mismatches"]
          and replay["window_tokens"] > 0,
          f"{model.hp.arch}: the long request against its replay: {out}")
    return out


def _quirk_sched(torch, model) -> dict:
    """The sched phase's eight requests (four greedy, four seeded; 8
    slots, windows of 16) at bf16 KV: K3 at B = 8 on the global layers;
    every greedy token equals the per-token replay (q8_0 KV, run by the
    sched phase and by each file's _serve, was cut for the smoke's clock
    in PR 19)."""
    from llama_cpp_test_tpu_torch.ops import _cuda
    from llama_cpp_test_tpu_torch.runtime.engine import Context

    prompts = _sched_prompts(model.tokenizer, 21)
    params = _sched_params()
    out = {}
    for kv in ("bf16",):
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t0 = time.time()
        sched, reqs, rec = _run_sched(model, kv, prompts, params,
                                      record=True)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(_cuda.LAUNCHES)
        greedy = set(sorted(ev[1] for ev in rec.log if ev[0] == "new")[:4])
        replay = _replay(Context(model, n_ctx=1024, n_seq_max=8,
                                 block_size=16, kv_type=kv), rec.log, greedy)
        k3 = "paged_decode_q8" if kv == "q8_0" else "paged_decode"
        out[kv] = {"wall_s": wall, "metrics": sched.metrics(),
                   "tokens": [len(q.output_tokens) for q in reqs],
                   "replay": replay, "launches": launches}
        check(all(n == SCHED_NEW for n in out[kv]["tokens"]),
              f"{model.hp.arch}/{kv}: request lengths {out[kv]['tokens']}")
        check(not replay["mismatches"] and replay["window_tokens"] > 0,
              f"{model.hp.arch}/{kv}: greedy tokens differ from the "
              f"per-token replay: {replay}")
        check(launches[k3] > 0 and launches["qmm_gemv"] > 0,
              f"{model.hp.arch}/{kv}: K1/{k3} not launched: {launches}")
    return out


def _quirk_rows(kc, hp: dict, long: int) -> dict:
    """K2 on a 512-token chunk, on the long prompt's last chunk (the one
    the path runs past the window, over its cached prefix) and on the
    long prompt at once (the local layers' window and the softcap); K3 and
    K3-q8 at B = 1 (the long context) and 8 (the global layers' softcap),
    at the file's geometry."""
    cap = hp.get("attn_softcap", 0.0)
    win = hp["sliding_window"]
    last = long - LONG_CHUNK
    rows = {"K2 T=512": kc.flash_prefill(hp, t=512, window=win, soft_cap=cap),
            f"K2 T={LONG_CHUNK} start={last}": kc.flash_prefill(
                hp, t=LONG_CHUNK, start=last, window=win, soft_cap=cap),
            f"K2 T={long}": kc.flash_prefill(hp, t=long, window=win,
                                             soft_cap=cap)}
    for q8 in (False, True):
        name = "K3-q8" if q8 else "K3"
        rows[f"{name} B=1"] = kc.paged_decode(hp, 1, q8=q8, lens=[long],
                                              soft_cap=cap or None)
        rows[f"{name} B=8"] = kc.paged_decode(hp, 8, q8=q8,
                                              soft_cap=cap or None)
    check(not kc.failures, f"kernels outside their gate: {kc.failures}")
    return rows


def phase_quirks(torch, kc, nvidia_smi: str, profile: bool = False) -> dict:
    """The gemma and qwen quirk axes. Gemma-2-2B (Q4_K) and Gemma-3-1B
    (Q8_0) at published widths, 2 and 6 layers, Qwen2.5-0.5B and Qwen3-0.6B
    (Q8_0) at published widths, 4 layers, each file from seeded random
    blocks with an SPM vocabulary at the published size, through _serve
    (bf16 KV, and q8_0 KV on the Gemma files; generate() at 16, 130 and
    512 tokens; the logits of a 130-token prefill and of QUIRK_DECODE
    decode steps within the gate of the plain path). On each Gemma file also: a prompt past its window (4608 tokens
    for the 4096 window of Gemma-2, 1024 for Gemma-3's 512) with the
    launches the path predicts and its logits within the gate
    (_path_prediction); the same prompt through one Scheduler slot
    against its replay (_long_sched); eight Scheduler requests at bf16
    KV (_quirk_sched); K2, K3 and K3-q8 rows at D = 256."""
    files, launches = {}, {}
    for label, hp, ftype, seed, long in QUIRK_FILES:
        n_ctx = 1024 if long is None else -(-(long + 64) // 1024) * 1024

        def more(model, hp=hp, long=long, n_ctx=n_ctx):
            prompt = np.random.default_rng(12).integers(
                3, hp["n_vocab"], size=long).tolist()
            out = {"path": _path_prediction(torch, model, prompt, n_ctx),
                   "long_sched": _long_sched(torch, model, prompt, n_ctx),
                   "sched": _quirk_sched(torch, model),
                   "rows": _quirk_rows(kc, hp, long), "card": nvidia_smi}
            emit({"phase": f"quirks/{label}", "checks": {
                k: v for k, v in out.items() if k != "rows"}})
            return out

        t0 = time.time()
        contexts = [("bf16", None)] + ([] if long is None else
                                       [("q8_0", None)])
        r = _serve(torch, f"quirks/{label}", hp, seed, contexts, 2,
                   DENSE_PATH, profile, ftype=ftype, n_ctx=n_ctx,
                   n_decode=QUIRK_DECODE if long else 4,
                   rows=None if long is None else more, joint=False)
        r["seconds"] = time.time() - t0
        files[label] = r
        runs = [r["launches"]]
        if long is not None:
            runs += [r["rows"]["sched"]["bf16"]["launches"]]
        for counts in runs:
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
    return {"launches": launches, "files": files,
            "rows": {f"{label} {k}": row for label, f in files.items()
                     for k, row in f.get("rows", {}).get("rows", {}).items()}}


# ---------------------------------------------------------------------------
# the LayerNorm, parallel-residual and partial-rope archs


# (label, geometry, GGUF type, seed, the n_ctx of each path prediction
# (bf16 KV, then q8_0 at the first))
QUIRK_LN_FILES = (("phi3_mini", PHI3_MINI, "Q4_K", 51, (8192, 2048)),
                  ("phi2", PHI2, "Q4_K", 52, (2048,)))
# (label, geometry, GGUF type, seed): 1 layer each, Q8_0 (cut from 2
# layers and Q4_K for the smoke's clock, PR 19: a Q8_0 tensor repacks in
# about half a Q4_K one's host time a weight). Command-R v01 (COMMAND_R,
# seed 57: 25.7 s of writing and repacking its tied 256000 x 8192 head,
# PR 19 run 9) is left out for the clock since PR 19 (ROADMAP §2 C (t))
QUIRK_LN_SMALL = (("stablelm2_16b", STABLELM2_16B, "Q8_0", 53),
                  ("starcoder2_3b", STARCODER2_3B, "Q8_0", 54),
                  ("pythia_14b", PYTHIA_14B, "Q8_0", 55),
                  ("falcon_7b", FALCON_7B, "Q8_0", 56),
                  ("granite3_2b", GRANITE3_2B, "Q8_0", 58),
                  ("olmo2_7b", OLMO2_7B, "Q8_0", 59),
                  ("minitron_4b", MINITRON_4B, "Q8_0", 60),
                  ("olmo17_7b", OLMO17_7B, "Q8_0", 61))
LN_PROMPT = 600             # two K2 chunks (512 + 88) for the path check


def _add_launches(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def _rope_tables(model, n_ctxs) -> dict:
    """Which rope table a Context of each n_ctx serves (phi3's long one iff
    n_ctx > rope_orig_ctx, as the reference Context picks it)."""
    from llama_cpp_test_tpu_torch.runtime.engine import Context

    w, out = model.weights, {}
    for n_ctx in n_ctxs:
        ctx = Context(model, n_ctx=n_ctx, n_seq_max=1, block_size=16)
        out[n_ctx] = ("long" if ctx.w.rope_inv_freq is w.rope_inv_freq_long
                      else "short" if ctx.w.rope_inv_freq
                      is w.rope_inv_freq else "other")
        del ctx
        want = "long" if n_ctx > model.hp.rope_orig_ctx else "short"
        check(out[n_ctx] == want, f"{model.hp.arch} n_ctx {n_ctx}: the "
                                  f"{out[n_ctx]} rope table, not the {want}")
    return out


def _ln_rows(kc) -> dict:
    """K2 at D = 80 (Phi-2) and 96 (Phi-3) on a 512-token chunk, and on a
    4096-token prompt under the 4k Phi-3's window of 2047 (which binds);
    K3 and K3-q8 at B = 1 and 8 for both dims; K3 at Falcon-7B's G = 71."""
    rows = {}
    for label, hp in (("Phi-2", PHI2), ("Phi-3", PHI3_MINI)):
        rows[f"{label} K2 T=512"] = kc.flash_prefill(hp, t=512)
    rows["Phi-3 K2 T=4096 window=2047"] = kc.flash_prefill(
        PHI3_MINI, t=4096, window=2047)
    for label, hp in (("Phi-2", PHI2), ("Phi-3", PHI3_MINI)):
        for q8 in (False, True):
            name = "K3-q8" if q8 else "K3"
            for b in (1, 8):
                rows[f"{label} {name} B={b}"] = kc.paged_decode(hp, b, q8=q8)
    for b in (1, 8):
        rows[f"Falcon-7B K3 B={b}"] = kc.paged_decode(FALCON_7B, b)
    check(not kc.failures, f"kernels outside their gate: {kc.failures}")
    return rows


def _ln_small(torch, label, hp, ftype, model, write_s, fitted) -> dict:
    """A 1-layer file at published widths, loaded: its logits over a
    130-token prefill (every row) and QUIRK_DECODE decode steps within the
    gate of the plain path at bf16 KV, and the launches its path predicts
    over a LN_PROMPT-token prompt."""
    rng = np.random.default_rng(13)
    prompt = rng.integers(3, hp["n_vocab"], size=LN_PROMPT).tolist()
    checks, bad = _kernels_vs_plain(model, prompt[:130], [("bf16", None)],
                                    QUIRK_DECODE)
    out = {"phase": f"quirks_ln/{label}", "arch": model.hp.arch,
           "n_layer": model.hp.n_layer, "ftype": ftype, "fitted_types": fitted,
           "write_gguf_s": write_s, "load_s": model.load_seconds,
           "plain_vs_kernel_nmse": checks, "gate": LOGITS_GATE,
           "path": _path_prediction(torch, model, prompt, 1024)}
    emit(out)
    check(not bad, f"{label}: logits outside the gate: {bad}")
    out["launches"] = {}
    for step in ("prefill", "decode"):
        _add_launches(out["launches"], out["path"]["launches"][step])
    return out


def phase_quirks_ln(torch, kc, nvidia_smi: str, build: dict,
                    profile: bool = False) -> dict:
    """The LayerNorm, parallel-residual and partial-rope archs.
    Phi-3-mini-128k (Q4_K, head dim 96, long rope, window 262144) and
    Phi-2 (Q4_K, head dim 80, parallel residual) at published widths and
    2 of 32 layers, each through _serve at bf16 and q8_0 KV (generate() at 16, 130
    and 512 tokens; the logits of a 130-token prefill and QUIRK_DECODE
    decode steps within the gate of the plain path), then a LN_PROMPT-token
    prompt at each n_ctx of QUIRK_LN_FILES with the launches the path
    predicts (K2 once a layer a chunk; K3, or K3-q8 on the q8_0 Context,
    once a layer a decode step: no window binds; K1's GEMV four times a
    layer and once for the head) and its logits within the gate; Phi-3's
    rope table at n_ctx 8192 (long) and 2048 (short); the sched phase's
    eight requests at bf16 KV against their replay. Then the eight
    1-layer files of QUIRK_LN_SMALL (_small_files: _small_load on three
    host threads, _ln_small as each load completes), the K2, K3 and K3-q8 rows
    at D = 80 and 96 and K3 at G = 71 (_ln_rows), and the registers and
    spills of the D = 80 and 96 builds (a spill fails the build phase)."""
    files, launches = {}, {}
    for label, hp, ftype, seed, n_ctxs in QUIRK_LN_FILES:

        def more(model, hp=hp, n_ctxs=n_ctxs):
            prompt = np.random.default_rng(12).integers(
                3, hp["n_vocab"], size=LN_PROMPT).tolist()
            paths = [_path_prediction(torch, model, prompt, n, "bf16")
                     for n in n_ctxs]
            paths.append(_path_prediction(torch, model, prompt, n_ctxs[0],
                                          "q8_0"))
            out = {"path": paths, "sched": _quirk_sched(torch, model),
                   "card": nvidia_smi}
            if model.hp.rope_scaling == "longrope":
                out["rope_tables"] = _rope_tables(model, n_ctxs)
            emit({"phase": f"quirks_ln/{label}", "checks": out})
            return out

        t0 = time.time()
        r = _serve(torch, f"quirks_ln/{label}", hp, seed,
                   [("bf16", None), ("q8_0", None)], 2, DENSE_PATH, profile,
                   ftype=ftype, n_ctx=n_ctxs[0], n_decode=QUIRK_DECODE,
                   rows=more, joint=False)
        r["seconds"] = time.time() - t0
        files[label] = r
        _add_launches(launches, r["launches"])
        for p in r["rows"]["path"]:
            for step in ("prefill", "decode"):
                _add_launches(launches, p["launches"][step])
        _add_launches(launches, r["rows"]["sched"]["bf16"]["launches"])
    _small_files(QUIRK_LN_SMALL, files, launches,
                 lambda label, hp, ftype, *loaded: _ln_small(
                     torch, label, hp, ftype, *loaded))
    emit({"phase": "quirks_ln", "seconds": {
        label: round(f["seconds"], 1) for label, f in files.items()}})
    rows = _ln_rows(kc)
    new_builds = {k: v for k, v in build.items()
                  if re.search(r"^(flash_prefill|paged_decode) D=(80|96)\b", k)}
    emit({"phase": "quirks_ln", "builds": new_builds, "card": nvidia_smi})
    check(len(new_builds) == 6 and not any(
        v["spill_bytes"] for v in new_builds.values()),
          f"quirks_ln: the D = 80 and 96 builds: {new_builds}")
    missing = [k for k in DENSE_PATH + ("paged_decode_q8",)
               if launches.get(k, 0) <= 0]
    check(not missing, f"quirks_ln: kernels not launched: {missing}")
    return {"launches": launches, "files": files, "rows": rows,
            "builds": new_builds}


# ---------------------------------------------------------------------------
# the rest of the llama-body archs, and the position axes

# MiniCPM-2B (openbmb/MiniCPM-2B-sft-bf16 config.json) published widths,
# depth cut from 40 to 2 layers for the smoke's clock (4 until the
# multimodal phase): MHA at D =
# 64, FFN 5760 (no multiple of 256: a Q8_0 file), tied head, the mup
# scales (scale_emb 12, residual scale_depth 1.4 / sqrt(40) of the
# published depth, logits divided by hidden / dim_model_base = 2304 / 256)
MINICPM_2B = dict(arch="minicpm", n_vocab=122753, n_embd=2304, n_head=36,
                  n_head_kv=36, head_dim=64, n_layer=2, n_ff=5760,
                  tied=True, meta={"embedding_scale": 12.0,
                                   "residual_scale": 1.4 / np.sqrt(40.0),
                                   "logit_scale": 9.0})
# Command R7B (CohereForAI/c4ai-command-r7b-12-2024 config.json) published
# widths, depth cut from 32 to 4 layers (three sliding, one global, as
# layers 0-3 are): GQA 32/8 at D = 128, sliding window 4096 on three
# layers of four, no rope on the fourth, one weight-only LayerNorm feeding
# a parallel gated FFN, logit_scale 0.25, rope base 50000, tied head
COMMAND_R7B = dict(arch="cohere2", n_vocab=256000, n_embd=4096, n_head=32,
                   n_head_kv=8, head_dim=128, n_layer=4, n_ff=14336,
                   rope_base=50000.0, ln_eps=1e-5, ffn_norm=False, tied=True,
                   sliding_window=4096, meta={"logit_scale": 0.25})
# BitNet b1.58-3B (1bitLLM/bitnet_b1_58-3B config.json) published widths,
# depth cut from 26 to 2 layers: D = 3200 / 32 = 100, the RMS sub-norms;
# 3200 and 8640 are no multiple of 256 (nor TQ1_0's or TQ2_0's block), so
# the file is Q8_0
BITNET_3B = dict(arch="bitnet", n_vocab=32002, n_embd=3200, n_head=32,
                 n_head_kv=32, head_dim=100, n_layer=2, n_ff=8640,
                 tied=True, sub_norms=True)
# the other llama-body archs at published widths (each model's
# config.json), depth cut to 1 layer (2 until PR 19), Q8_0
BODY_SMALL_HP = {
    # internlm/internlm2-7b: GQA 32/8, rope base 1e6
    "internlm2_7b": dict(arch="internlm2", n_vocab=92544, n_embd=4096,
                         n_head=32, n_head_kv=8, head_dim=128, n_ff=14336,
                         rope_base=1e6),
    # baichuan-inc/Baichuan2-7B-Base: MHA, rope (no max_alibi_bias key)
    "baichuan2_7b": dict(arch="baichuan", n_vocab=125696, n_embd=4096,
                         n_head=32, n_head_kv=32, head_dim=128, n_ff=11008,
                         rms_eps=1e-6),
    # xverse/XVERSE-7B: MHA
    "xverse_7b": dict(arch="xverse", n_vocab=100534, n_embd=4096,
                      n_head=32, n_head_kv=32, head_dim=128, n_ff=11008,
                      rms_eps=1e-6),
    # OrionStarAI/Orion-14B-Base: LayerNorms with biases, NEOX rope
    "orion_14b": dict(arch="orion", n_vocab=84608, n_embd=5120, n_head=40,
                      n_head_kv=40, head_dim=128, n_ff=15360, ln_eps=1e-5,
                      norm_bias=True),
    # Qwen/Qwen-7B: fused c_attn with its bias, FFN 22016 / 2
    "qwen_7b": dict(arch="qwen", n_vocab=151936, n_embd=4096, n_head=32,
                    n_head_kv=32, head_dim=128, n_ff=11008, rms_eps=1e-6,
                    fused_qkv=True, qkv_bias=True),
    # LGAI-EXAONE/EXAONE-3.5-2.4B-Instruct: GQA 32/8 at D = 80, tied head
    "exaone35_24b": dict(arch="exaone", n_vocab=102400, n_embd=2560,
                         n_head=32, n_head_kv=8, head_dim=80, n_ff=7168,
                         rope_base=1e6, tied=True),
    # WisdomShell/CodeShell-7B: GQA 32/8, LayerNorms with biases, fused
    # QKV with bias, wo bias, a non-gated GELU FFN with biases
    "codeshell_7b": dict(arch="codeshell", n_vocab=70144, n_embd=4096,
                         n_head=32, n_head_kv=8, head_dim=128, n_ff=16384,
                         ln_eps=1e-5, norm_bias=True, fused_qkv=True,
                         qkv_bias=True, bo=True, ffn="up", ffn_bias=True),
    # THUDM/chatglm3-6b: 2 KV groups, partial NORM rope (64 of 128), Q/K/V
    # biases, [gate|up] in one ffn_up of 2 x 13696 rows (13696: Q8_0 down)
    "chatglm3_6b": dict(arch="chatglm", n_vocab=65024, n_embd=4096,
                        n_head=32, n_head_kv=2, head_dim=128, rope_dim=64,
                        n_ff=13696, qkv_bias=True, ffn="fused"),
    # pfnet/plamo-13b: one RMS norm feeding the parallel attention and
    # gated FFN
    "plamo_13b": dict(arch="plamo", n_vocab=50432, n_embd=5120, n_head=40,
                      n_head_kv=40, head_dim=128, n_ff=13312, rms_eps=1e-6,
                      ffn_norm=False),
}
# GPT-2 (openai-community/gpt2 config.json) published widths, depth cut
# from 12 to 2 layers (full depth until the multimodal phase, 6 until the
# recurrent one): 1024
# learned positions, LayerNorms with biases, fused QKV with bias, wo
# bias, a non-gated GELU FFN with biases, tied head
GPT2_124M = dict(arch="gpt2", n_vocab=50257, n_embd=768, n_head=12,
                 n_head_kv=12, head_dim=64, n_layer=2, n_ff=3072,
                 ln_eps=1e-5, norm_bias=True, fused_qkv=True, qkv_bias=True,
                 bo=True, ffn="up", ffn_bias=True, tied=True, pos_rows=1024)
# BLOOM-560m (bigscience/bloom-560m config.json) published widths, depth
# cut from 24 to 2 layers for the smoke's clock (8 until the moe_forms
# phase, 4 until the multimodal phase): ALiBi over 16
# heads, the embedding LayerNorm, the gpt2 layout otherwise, tied head of
# 250880 rows
BLOOM_560M = dict(GPT2_124M, arch="bloom", n_vocab=250880, n_embd=1024,
                  n_head=16, n_head_kv=16, n_layer=2, n_ff=4096,
                  pos_rows=0, tok_norm=True)
POSITION_SMALL_HP = {
    # bigcode/starcoderbase-1b: MQA at D = 128, 8192 learned positions
    "starcoderbase_1b": dict(GPT2_124M, arch="starcoder", n_vocab=49152,
                             n_embd=2048, n_head=16, n_head_kv=1,
                             head_dim=128, n_ff=8192, pos_rows=8192),
    # mosaicml/mpt-7b: ALiBi, no biases, weight-only LayerNorms, the exact
    # GELU, tied head
    "mpt_7b": dict(arch="mpt", n_vocab=50432, n_embd=4096, n_head=32,
                   n_head_kv=32, head_dim=128, n_ff=16384, ln_eps=1e-5,
                   fused_qkv=True, ffn="up", tied=True),
    # inceptionai/jais-13b: ALiBi over 40 heads (no power of two: bloom's
    # slope order), a gated FFN of 13653 with gate, up and down biases
    # (13653: a BF16 down), 1/d_head attention, tied head
    "jais_13b": dict(arch="jais", n_vocab=84992, n_embd=5120, n_head=40,
                     n_head_kv=40, head_dim=128, n_ff=13653, ln_eps=1e-5,
                     norm_bias=True, fused_qkv=True, qkv_bias=True, bo=True,
                     ffn_bias=True, gate_bias=True, tied=True),
    # smallcloudai/Refact-1_6B-fim: ALiBi, MQA at D = 64, RMS norms
    "refact_16b": dict(arch="refact", n_vocab=49216, n_embd=2048, n_head=32,
                       n_head_kv=1, head_dim=64, n_ff=5632),
    # baichuan-inc/Baichuan2-13B-Base: ALiBi (the 40-layer class; at 2
    # layers by its max_alibi_bias key), MHA, 13696 (Q8_0 down)
    "baichuan2_13b": dict(arch="baichuan", n_vocab=125696, n_embd=5120,
                          n_head=40, n_head_kv=40, head_dim=128, n_ff=13696,
                          rms_eps=1e-6,
                          meta={"attention.max_alibi_bias": 8.0}),
}
R7B_PROMPT = 4608 + 64      # past Command R7B's 4096 window: 10 K2 chunks
R7B_SHIFT = (64, 512)       # n_keep, n_discard of its context shift


def _small_load(label, hp, ftype, seed, n_layer=1) -> tuple:
    """A file of n_layer layers at published widths, written (no
    tokenizer: its checks feed token ids) and loaded on the card: (Model,
    seconds the write took, the types _fit_type chose)."""
    from llama_cpp_test_tpu_torch.runtime.engine import Model

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        path = os.path.join(tmp, f"{label}.gguf")
        t0 = time.time()
        fitted = write_llama_gguf(path, dict(hp, n_layer=n_layer), seed=seed,
                                  ftype=ftype, vocab=None)
        write_s = time.time() - t0
        return Model(path, device="cuda"), write_s, fitted
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _small_check(torch, phase, label, model, write_s, fitted,
                 recheck: bool = True) -> dict:
    """A loaded small file: generate() on a 16-token prompt and one
    batched decode of 8 rows, its logits over a 130-token prefill (every
    row) and QUIRK_DECODE decode steps within the gate of the plain path,
    and the launches its path predicts over a LN_PROMPT-token prompt, all
    at bf16 KV (q8_0 KV, the same kernels' K3-q8 path, was cut for the
    smoke's clock in PR 19: each phase's headline files serve at both).
    recheck False (the clock) holds the logits to the plain path that
    once: the path prediction counts launches alone and the joint-min
    witness is not traced."""
    from llama_cpp_test_tpu_torch.runtime.engine import Context

    hp = model.hp
    rng = np.random.default_rng(13)
    prompt = rng.integers(3, hp.n_vocab, size=LN_PROMPT).tolist()
    ctx = Context(model, n_ctx=1024, n_seq_max=8, block_size=16,
                  kv_type="bf16")
    served = {"bf16": _serve_requests(torch, ctx, [prompt[:16], prompt[:24]],
                                      hp.n_vocab, 8)}
    del ctx
    checks, bad = _kernels_vs_plain(model, prompt[:130], [("bf16", None)],
                                    QUIRK_DECODE, recheck)
    out = {"phase": f"{phase}/{label}", "arch": hp.arch,
           "n_layer": hp.n_layer,
           "fitted_types": fitted, "write_gguf_s": write_s,
           "load_s": model.load_seconds, "requests": served,
           "plain_vs_kernel_nmse": checks, "gate": LOGITS_GATE,
           "path": [_path_prediction(torch, model, prompt, 1024, "bf16",
                                     recheck)]}
    emit(out)
    check(not bad, f"{label}: logits outside the gate: {bad}")
    out["launches"] = {}
    for p in out["path"]:
        for step in ("prefill", "decode"):
            _add_launches(out["launches"], p["launches"][step])
    return out


def _small_files(specs, files, launches, check) -> None:
    """The small files of specs ((label, geometry, type, seed[, layers]),
    1 layer by default), written and loaded three at a time on host
    threads (their vocabularies repack for seconds each) while the card
    checks the ones already loaded, in the order they load, by
    check(label, geometry, type, model, write seconds, fitted types); a
    file's seconds are its checks."""
    ex = ThreadPoolExecutor(max_workers=3)
    try:
        loads = {ex.submit(_small_load, *spec): spec for spec in specs}
        for load in as_completed(loads):
            label, hp, ftype = loads[load][:3]
            t0 = time.time()
            files[label] = check(label, hp, ftype, *load.result())
            files[label]["seconds"] = time.time() - t0
            _add_launches(launches, files[label]["launches"])
    finally:
        ex.shutdown(wait=True, cancel_futures=True)


def _shift_vs_plain(torch, model, prompt, n_ctx: int, kv: str) -> dict:
    """One context shift (R7B_SHIFT) of a sequence that holds `prompt`,
    then QUIRK_DECODE greedy decode steps, through the kernels and through
    the plain path on the same tokens: the logits within the gate. The
    sliding layers' K is re-rotated, the global layer's (no rope) moved.
    A fresh prefill of the kept tokens is printed beside, ungated: the
    kept tokens' deeper K and V still carry the dropped ones, in the
    reference and in llama.cpp alike."""
    from llama_cpp_test_tpu_torch.runtime.engine import Context

    n_keep, n_discard = R7B_SHIFT

    def run(plain, tokens=None):
        ctx = Context(model, n_ctx=n_ctx, n_seq_max=1, block_size=16,
                      kv_type=kv, plain=plain)
        s = ctx.new_seq()
        for i in range(0, len(prompt), LONG_CHUNK):
            ctx.prefill(s, prompt[i:i + LONG_CHUNK])
        ctx.shift_context(s, n_keep, n_discard)
        rows, toks = [], []
        nxt = 11
        for i in range(QUIRK_DECODE):
            toks.append(tokens[i] if tokens else nxt)
            rows.append(ctx.decode([s], toks[-1:])[0])
            nxt = int(np.argmax(rows[-1]))
        ctx.free_seq(s)
        return rows, toks

    got, toks = run(False)
    with _plain_min("fold"):
        want, _ = run(True, toks)
    kept = prompt[:n_keep] + prompt[n_keep + n_discard:]
    ctx = Context(model, n_ctx=n_ctx, n_seq_max=1, block_size=16, kv_type=kv)
    s = ctx.new_seq()
    for i in range(0, len(kept), LONG_CHUNK):
        ctx.prefill(s, kept[i:i + LONG_CHUNK])
    fresh = ctx.decode([s], toks[:1])[0]
    out = {"kv": kv, "n_keep": n_keep, "n_discard": n_discard,
           "nmse": [nmse(a, b) for a, b in zip(want, got)],
           "gate": LOGITS_GATE, "fresh_prefill_nmse_ungated": nmse(fresh,
                                                                   got[0])}
    check(all(np.isfinite(r).all() for r in got)
          and max(out["nmse"]) < LOGITS_GATE,
          f"{model.hp.arch}/{kv}: shifted logits outside the gate: {out}")
    return out


# (label, geometry, GGUF type, seed, the n_ctx of the path predictions)
BODY_FILES = (("minicpm_2b", MINICPM_2B, "Q8_0", 71, 1024),
              ("command_r7b", COMMAND_R7B, "Q4_K", 72, 5120),
              ("bitnet_3b", BITNET_3B, "Q8_0", 73, 1024))
BODY_SMALL = tuple((label, hp, "Q8_0", 74 + i)
                   for i, (label, hp) in enumerate(BODY_SMALL_HP.items()))
POSITION_FILES = (("gpt2", GPT2_124M, "Q4_K", 91),
                  ("bloom_560m", BLOOM_560M, "Q4_K", 92))
POSITION_SMALL = tuple((label, hp, "Q8_0", 93 + i) for i, (label, hp)
                       in enumerate(POSITION_SMALL_HP.items()))


def _headline(torch, phase, label, hp, ftype, seed, n_ctx, nvidia_smi,
              profile, extra=None) -> dict:
    """A headline file through _serve at bf16 and q8_0 KV (generate() at
    16, 130 and 512 tokens, a batched decode of 8, the logits of a
    130-token prefill and QUIRK_DECODE decode steps within the gate of the
    plain path), then the launches its path predicts at each KV type over
    a prompt of LN_PROMPT tokens, or R7B_PROMPT past a window; extra(model)
    adds checks."""
    long = hp.get("sliding_window", 0) > 0

    def more(model):
        prompt = np.random.default_rng(12).integers(
            3, hp["n_vocab"], size=R7B_PROMPT if long else LN_PROMPT).tolist()
        out = {"path": [_path_prediction(torch, model, prompt, n_ctx, kv)
                        for kv in ("bf16", "q8_0")], "card": nvidia_smi}
        if extra is not None:
            out.update(extra(model, prompt))
        emit({"phase": f"{phase}/{label}", "checks": out})
        return out

    t0 = time.time()
    r = _serve(torch, f"{phase}/{label}", hp, seed,
               [("bf16", None), ("q8_0", None)], 8, (), profile,
               ftype=ftype, n_ctx=min(n_ctx, hp.get("pos_rows") or n_ctx),
               n_decode=QUIRK_DECODE, rows=more, joint=False)
    r["seconds"] = time.time() - t0
    return r


def _collect(files, launches) -> None:
    """Add a headline file's launches (its serve and its paths) to the
    phase's."""
    for r in files.values():
        _add_launches(launches, r["launches"])
        for p in r["rows"]["path"]:
            for step in ("prefill", "decode"):
                _add_launches(launches, p["launches"][step])


def phase_quirks_body(torch, kc, nvidia_smi: str, build: dict,
                      profile: bool = False) -> dict:
    """The llama-body archs that need only small switches. MiniCPM-2B
    (Q8_0, 2 of 40 layers, the mup scales), Command R7B (cohere2, Q4_K, 4
    layers) and BitNet b1.58-3B (Q8_0, 2 layers, D = 100) through
    _headline at bf16 and q8_0 KV; Command R7B over a R7B_PROMPT-token
    prompt past its window (K3 on its global layer alone) and one context
    shift at each KV type held to the plain path (_shift_vs_plain). Then
    the nine 1-layer files of BODY_SMALL (_small_files) and the registers
    and spills of the D = 100 builds (a spill fails the build phase; the
    kernels phase holds K2, K3 and K3-q8 at D = 100 to their plain
    versions)."""
    files, launches = {}, {}
    for label, hp, ftype, seed, n_ctx in BODY_FILES:
        extra = None
        if hp["arch"] == "cohere2":
            extra = lambda model, prompt, n=n_ctx: {"shift": [
                _shift_vs_plain(torch, model, prompt, n, kv)
                for kv in ("bf16", "q8_0")]}
        files[label] = _headline(torch, "quirks_body", label, hp, ftype,
                                 seed, n_ctx, nvidia_smi, profile, extra)
    _collect(files, launches)
    _small_files(BODY_SMALL, files, launches,
                 lambda label, hp, ftype, *loaded: _small_check(
                     torch, "quirks_body", label, *loaded))
    emit({"phase": "quirks_body", "seconds": {
        label: round(f["seconds"], 1) for label, f in files.items()}})
    new_builds = {k: v for k, v in build.items()
                  if re.search(r"^(flash_prefill|paged_decode) D=100\b", k)}
    emit({"phase": "quirks_body", "builds": new_builds, "card": nvidia_smi})
    check(len(new_builds) == 3 and not any(
        v["spill_bytes"] for v in new_builds.values()),
          f"quirks_body: the D = 100 builds: {new_builds}")
    missing = [k for k in DENSE_PATH + ("paged_decode_q8",)
               if launches.get(k, 0) <= 0]
    check(not missing, f"quirks_body: kernels not launched: {missing}")
    return {"launches": launches, "files": files, "rows": {},
            "builds": new_builds}


def phase_positions(torch, kc, nvidia_smi: str,
                    profile: bool = False) -> dict:
    """The position axes. GPT-2 (Q4_K, 1024 learned positions; 2 of 12
    layers) and BLOOM-560m (Q4_K, ALiBi, the embedding LayerNorm; 2 of 24
    layers) at published widths through _headline at bf16 and q8_0 KV: K2
    once a layer a
    chunk and K3 (K3-q8) once a layer a step on GPT-2, neither on BLOOM,
    whose attention takes the gather path as the reference sends ALiBi to
    XLA; then the five 1-layer files of POSITION_SMALL (StarCoderBase-1B,
    MPT-7B, Jais-13B, Refact-1.6B, Baichuan2-13B) with the same launch
    checks."""
    files, launches = {}, {}
    for label, hp, ftype, seed in POSITION_FILES:
        files[label] = _headline(torch, "positions", label, hp, ftype, seed,
                                 1024, nvidia_smi, profile)
    _collect(files, launches)
    _small_files(POSITION_SMALL, files, launches,
                 lambda label, hp, ftype, *loaded: _small_check(
                     torch, "positions", label, *loaded))
    emit({"phase": "positions", "seconds": {
        label: round(f["seconds"], 1) for label, f in files.items()}})
    missing = [k for k in DENSE_PATH + ("paged_decode_q8",)
               if launches.get(k, 0) <= 0]
    check(not missing, f"positions: kernels not launched: {missing}")
    return {"launches": launches, "files": files, "rows": {}}


# ---------------------------------------------------------------------------
# the bert-family encoders and per-layer geometry

# BERT-base (google-bert/bert-base-uncased config.json) published widths
# and depth: 12 layers of 768, 12 heads at D = 64, a non-gated erf-GELU
# FFN of 3072 with biases, 512 learned positions, 2 token types, Q/K/V and
# wo biases, LayerNorms with biases over the residual sums (eps 1e-12),
# the WordPiece vocab of 30522, CLS pooling, no LM head
BERT_BASE = dict(arch="bert", n_vocab=30522, n_embd=768, n_head=12,
                 n_head_kv=12, head_dim=64, n_layer=12, n_ff=3072,
                 ln_eps=1e-12, norm_bias=True, post_norm=True, types=True,
                 pos_rows=512, tok_norm=True, qkv_bias=True, bo=True,
                 ffn="up", ffn_bias=True, meta={"pooling_type": 2})
# nomic-embed-text-v1.5 (nomic-ai/nomic-embed-text-v1.5 config.json): the
# same widths and depth with NEOX rope (base 1000), a bias-free fused
# Wqkv and wo, a SwiGLU FFN of 3072 without biases, mean pooling
NOMIC_EMBED = dict(BERT_BASE, arch="nomic-bert", pos_rows=0,
                   qkv_bias=False, bo=False, fused_qkv=True, ffn="gated",
                   ffn_bias=False, rope_base=1000.0,
                   meta={"pooling_type": 1})
# jina-embeddings-v2-base-en (jinaai/jina-embeddings-v2-base-en
# config.json): the same widths and depth with symmetric ALiBi (no
# position rows), Q/K/V and wo biases, an erf-GELU GeGLU of 3072 with a
# down bias, vocab 30528, mean pooling
JINA_V2_BASE = dict(BERT_BASE, arch="jina-bert-v2", n_vocab=30528,
                    pos_rows=0, ffn="gated", ffn_bias=False, down_bias=True,
                    meta={"pooling_type": 1})
ENCODER_FILES = (("bert_base", BERT_BASE, 101),
                 ("nomic_embed_v15", NOMIC_EMBED, 102),
                 ("jina_v2_base", JINA_V2_BASE, 103))
ENCODER_TYPES = ("Q8_0", "Q4_K")
ENCODER_LENS = (16, 130, 512)
POOLINGS = ("cls", "mean", "last")
ENCODER_TEXTS = ("the people of the world could find water",
                 "the little house by the water", "give me three good words")


def _openelm_270m() -> dict:
    """OpenELM-270M (apple/OpenELM-270M config.json) published widths,
    depth cut from 16 to 4 layers (0, 5, 10 and 15, the first and the last
    kept; full depth until the multimodal phase, 8 until the recurrent
    one): 1280 wide,
    D = 64, query heads from 12 to 20 on KV heads from 3 to 5 (G = 4), FFN
    multipliers from 0.5 to 4.0 (divisor 256), shared per-head QK RMS
    norms, a fused qkv, NEOX rope, tied head of 32000. The per-layer
    arrays are written here, not copied (PERF.md §4, synthetic): layer i
    of 16 has KV heads 3 + round(2 i / 15) and FFN 1280 x linspace(0.5, 4,
    16)[i] rounded up to 256."""
    kept = [0, 5, 10, 15]
    kv = [3 + round(2 * i / 15) for i in kept]
    ff = [int(-(-m * 1280 // 256) * 256)
          for m in np.linspace(0.5, 4.0, 16)[kept]]
    return dict(arch="openelm", n_vocab=32000, n_embd=1280, n_head=20,
                n_head_kv=5, head_dim=64, n_layer=4, n_ff=max(ff),
                rms_eps=1e-6, fused_qkv=True, qk_norm="shared", tied=True,
                n_head_layers=[4 * k for k in kv], n_head_kv_layers=kv,
                n_ff_layers=ff)


OPENELM_270M = _openelm_270m()
# DeciLM-7B (Deci/DeciLM-7B config.json) published widths, depth cut from
# 32 to 2 layers (4 until the recurrent phase): 4096 wide, 32 heads at
# D = 128, FFN 14336, per-layer KV heads (its
# num_key_value_heads_per_layer; the two written here, 4 and 2, are
# synthetic, PERF.md §4), NORM rope
DECILM_7B = dict(arch="deci", n_vocab=32000, n_embd=4096, n_head=32,
                 n_head_kv=4, head_dim=128, n_layer=2, n_ff=14336,
                 n_head_kv_layers=[4, 2])
# Llama-3.1-Nemotron-51B (nvidia/Llama-3_1-Nemotron-51B-Instruct
# config.json block_configs) widths, 3 layers, one of each kind: attention
# (64 heads on 8, D = 128, FFN 28672: ffn_mult 5.25), attention-free (FFN
# 14336) and linear attention (an 8192 x 8192 wo; FFN 7168); vocab 128256
NEMOTRON_51B = dict(arch="deci", n_vocab=128256, n_embd=8192, n_head=64,
                    n_head_kv=8, head_dim=128, n_layer=3, n_ff=28672,
                    n_head_layers=[64, 0, 64], n_head_kv_layers=[8, 0, 0],
                    n_ff_layers=[28672, 14336, 7168])
# Chameleon-7B (facebook/chameleon-7b config.json) published widths, depth
# cut from 32 to 1 layer (4 until the recurrent phase, 2 until PR 19's
# second cut): MHA at D = 128,
# FFN 11008, per-head QK LayerNorms with biases, NORM rope, vocab 65536
CHAMELEON_7B = dict(arch="chameleon", n_vocab=65536, n_embd=4096,
                    n_head=32, n_head_kv=32, head_dim=128, n_layer=2,
                    n_ff=11008, qk_norm="head_bias")
# Chameleon-34B (facebook/chameleon-30b config.json) widths, 1 layer (2
# until PR 19):
# 8192 wide, 64 heads on 8 at D = 128, FFN 22016, swin_norm (the norms on
# the branch outputs, no pre-norms)
CHAMELEON_34B = dict(CHAMELEON_7B, n_embd=8192, n_head=64, n_head_kv=8,
                     n_layer=2, n_ff=22016, meta={"swin_norm": True})
GEOMETRY_SMALL = (("decilm_7b", DECILM_7B, "Q4_K", 111, 2),
                  ("nemotron_51b_width", NEMOTRON_51B, "Q4_K", 112, 3),
                  ("chameleon_7b", CHAMELEON_7B, "Q4_K", 113, 1),
                  ("chameleon_34b_swin", CHAMELEON_34B, "Q4_K", 114, 1))


def _embed_ids(tok, rng, n: int) -> list:
    """[CLS], n - 2 random word pieces, [SEP]: an encoder's input."""
    v = tok.vocab
    return [v.bos_id] + rng.integers(104, len(v.tokens), size=n - 2).tolist() \
        + [v.eos_id]


def _embed_path(torch, model, profile: bool = False) -> dict:
    """Pooled embeddings at ENCODER_LENS tokens and every pooling through
    the kernels and the plain path (its min rounded as the kernels round
    it), within the embedding gate; the launches of one 512-token embed
    (K2 once a layer, bidirectional, none under ALiBi; K1's GEMM once a
    projection plane, no GEMV, no K3); the wall of a 512-token embed, and
    with profile its device busy time (torch.profiler)."""
    from llama_cpp_test_tpu_torch.ops import _cuda
    from llama_cpp_test_tpu_torch.runtime.engine import Context, fit_n_ctx

    hp = model.hp
    rng = np.random.default_rng(21)
    n_ctx = fit_n_ctx(model, 2048)
    ctx = Context(model, n_ctx=n_ctx, n_seq_max=2, block_size=16)
    plain = Context(model, n_ctx=n_ctx, n_seq_max=2, block_size=16,
                    plain=True)
    out = {"nmse": {}, "gate": LOGITS_GATE}
    for n in ENCODER_LENS:
        ids = _embed_ids(model.tokenizer, rng, n)
        for pooling in POOLINGS:
            a = ctx.embed(ids, pooling)
            with _plain_min("fold"):
                b = plain.embed(ids, pooling)
            check(np.isfinite(a).all() and abs(np.linalg.norm(a) - 1) < 1e-3,
                  f"{hp.arch}: embedding not finite or not unit norm")
            out["nmse"][f"T={n} {pooling}"] = nmse(b, a)
    ids = _embed_ids(model.tokenizer, rng, 512)
    ctx.embed(ids)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    ctx.embed(ids)
    torch.cuda.synchronize()
    out["launches"] = dict(_cuda.LAUNCHES)
    want = {"flash_prefill": 0 if hp.alibi else hp.n_layer,
            "qmm_gemm": _k1_per_step(model), "qmm_gemv": 0,
            "paged_decode": 0}
    out["predicted"] = want
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctx.embed(ids)
        walls.append((time.perf_counter() - t0) * 1e3)
    out["embed_ms_T512"] = float(np.median(walls))
    if profile:
        out["profile_T512"] = _profiled(torch, lambda: ctx.embed(ids))
    bad = {k: v for k, v in out["nmse"].items() if not v < LOGITS_GATE}
    check(not bad, f"{hp.arch}: embeddings outside the gate: {bad}")
    for k, n in want.items():
        check(out["launches"][k] == n, f"{hp.arch}: {k} launched "
              f"{out['launches'][k]} times in a 512-token embed, the path "
              f"predicts {n}")
    return out


def _encoder_entry_points(model, path, launches: dict) -> dict:
    """cli.embedding and the server's /v1/embeddings against Context.embed
    on ENCODER_TEXTS (the CLI's printed entries to the digit, the server's
    vectors within 1e-10), /rerank in the order of Context.embed's
    cosines, and a completion refused with 400 (no LM head); the server's
    Context cut to a learned table."""
    import io

    from llama_cpp_test_tpu_torch.cli import embedding as cli_embedding
    from llama_cpp_test_tpu_torch.runtime.engine import Context, fit_n_ctx

    tok = model.tokenizer
    ctx = Context(model, n_ctx=fit_n_ctx(model, 2048), n_seq_max=1)
    want = [ctx.embed(tok.encode(t, add_special=True)) for t in ENCODER_TEXTS]
    del ctx
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_embedding.main(["-m", path] + [
            a for t in ENCODER_TEXTS for a in ("-p", t)], device="cuda")
    expect = "".join(f"embedding {i}: "
                     + " ".join(f"{float(x):.6f}" for x in e[:8]) + " ...\n"
                     for i, e in enumerate(want))
    out = {"cli_rc": rc, "cli_equal": buf.getvalue() == expect}
    check(rc == 0 and out["cli_equal"],
          f"{model.hp.arch}: cli.embedding printed {buf.getvalue()!r}, "
          f"Context.embed gives {expect!r}")
    with _server(path, launches, n_ctx=2048, n_slots=1) as (srv, c):
        out["server_n_ctx"] = srv.sched.ctx.n_ctx
        st, body = c.post("/v1/embeddings", {"input": list(ENCODER_TEXTS)})
        got = [np.asarray(d["embedding"]) for d in body["data"]]
        out["server_nmse"] = [nmse(w, g) for w, g in zip(want, got)]
        out["server_embed_launches"] = c.last
        k2 = 0 if model.hp.alibi else model.hp.n_layer * len(ENCODER_TEXTS)
        check(c.last["flash_prefill"] == k2 and c.last["qmm_gemm"] > 0,
              f"{model.hp.arch}: /v1/embeddings launched {c.last}, K2 "
              f"{k2} times predicted")
        check(st == 200 and max(out["server_nmse"]) < 1e-10,
              f"{model.hp.arch}: /v1/embeddings against Context.embed: "
              f"{st} {out['server_nmse']}")
        st, body = c.post("/rerank", {"query": ENCODER_TEXTS[0],
                                      "documents": list(ENCODER_TEXTS)})
        order = [r["index"] for r in body["results"]]
        expect_order = np.argsort([-float(want[0] @ w) for w in want])
        out["rerank_order"] = order
        check(st == 200 and order == expect_order.tolist(),
              f"{model.hp.arch}: /rerank order {order}, Context.embed's "
              f"cosines give {expect_order.tolist()}")
        st, body = c.post("/completion", {"prompt": "hello", "n_predict": 4})
        out["completion_status"] = st
        check(st == 400, f"{model.hp.arch}: a completion answered {st}")
    return out


def phase_encoders(torch, kc, nvidia_smi: str,
                   profile: bool = False) -> dict:
    """The bert-family encoders: BERT-base, nomic-embed-text-v1.5 and
    jina-embeddings-v2-base-en at published widths and depth, each at Q8_0
    and Q4_K (ENCODER_FILES; their WordPiece vocabularies synthesized),
    loaded on the card: pooled embeddings (CLS, mean, last) at 16, 130
    and 512 tokens against the plain path, K2 once a layer a 512-token
    embed and bidirectional on BERT and nomic (none on jina, whose ALiBi
    takes the gather path), K1's GEMM once a projection plane, the embed
    wall (_embed_path); on each Q8_0 file cli.embedding, /v1/embeddings,
    /rerank and a refused completion (_encoder_entry_points). Then K2 at
    BERT-base's T = 512, H = KV = 12, D = 64, bidirectional, beside
    SDPA."""
    from llama_cpp_test_tpu_torch.runtime.engine import Model

    files, launches = {}, {}
    for label, hp, seed in ENCODER_FILES:
        for ftype in ENCODER_TYPES:
            t0 = time.time()
            tmp = tempfile.mkdtemp(prefix="chip_smoke_")
            try:
                path = os.path.join(tmp, f"{label}_{ftype}.gguf")
                write_llama_gguf(path, hp, seed=seed, ftype=ftype)
                write_s = time.time() - t0
                model = Model(path, device="cuda")
                r = {"arch": hp["arch"], "ftype": ftype, "write_gguf_s": write_s,
                     "load_s": model.load_seconds,
                     "embed": _embed_path(torch, model, profile)}
                _add_launches(launches, r["embed"]["launches"])
                if ftype == "Q8_0":
                    r["entry_points"] = _encoder_entry_points(
                        model, path, launches)
                del model
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            r["seconds"] = time.time() - t0
            files[f"{label}/{ftype}"] = r
            emit({"phase": f"encoders/{label}/{ftype}", "checks": r,
                  "card": nvidia_smi})
    rows = {"BERT-base K2 T=512 non-causal": kc.flash_prefill(
        BERT_BASE, t=512, causal=False)}
    check(not kc.failures, f"kernels outside their gate: {kc.failures}")
    missing = [k for k in ("qmm_gemm", "flash_prefill")
               if launches.get(k, 0) <= 0]
    check(not missing, f"encoders: kernels not launched: {missing}")
    return {"launches": launches, "files": files, "rows": rows}


def _greedy_batches(torch, model, kv: str, batch: int = 4) -> dict:
    """Greedy decode of `batch` sequences (prompts of 16 to 40 tokens) for
    QUIRK_DECODE steps at equal batches through the kernels and the plain
    path, the plain path fed the kernels' tokens: each token is the plain
    path's argmax too, or a near tie within the two paths' logit
    difference on its row (the kernels' rounding differs)."""
    from llama_cpp_test_tpu_torch.runtime.engine import Context

    rng = np.random.default_rng(17)
    prompts = [rng.integers(3, model.hp.n_vocab, size=16 + 8 * i).tolist()
               for i in range(batch)]

    def run(plain, tokens=None):
        ctx = Context(model, n_ctx=1024, n_seq_max=batch, block_size=16,
                      kv_type=kv, plain=plain)
        seqs = [ctx.new_seq() for _ in prompts]
        rows = [np.stack([ctx.prefill(s, p) for s, p in zip(seqs, prompts)])]
        toks = []
        for j in range(QUIRK_DECODE):
            t = tokens[j] if tokens else np.argmax(rows[-1], -1).tolist()
            toks.append([int(x) for x in t])
            rows.append(ctx.decode(seqs, toks[-1]))
        return rows, toks

    got, toks = run(False)
    with _plain_min("fold"):
        want, _ = run(True, toks)
    ties, bad = 0, []
    for j, step in enumerate(toks):
        for b, t in enumerate(step):
            w, g = want[j][b], got[j][b]
            if int(np.argmax(w)) != t:
                gap = float(w.max() - w[t])
                if gap <= float(np.abs(w - g).max()):
                    ties += 1
                else:
                    bad.append((j, b, gap))
    out = {"kv": kv, "batch": batch, "steps": QUIRK_DECODE,
           "near_ties": ties, "mismatches": bad,
           "nmse": [nmse(w, g) for w, g in zip(want, got)]}
    check(not bad and max(out["nmse"]) < LOGITS_GATE,
          f"{model.hp.arch}/{kv}: greedy tokens at equal batches: {out}")
    return out


def _session(torch, model, prompt, kv: str) -> dict:
    """A sequence holding `prompt` saved (runtime.state), restored into a
    fresh Context and decoded one step: the logits equal the unsaved
    sequence's (to the bit at bf16 KV, within 1e-5 at q8_0); the file
    holds k{li}/v{li} at each layer's own KV head count."""
    from llama_cpp_test_tpu_torch.runtime import state
    from llama_cpp_test_tpu_torch.runtime.engine import Context

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        ctx = lambda: Context(model, n_ctx=1024, n_seq_max=2, block_size=16,
                              kv_type=kv)
        a = ctx()
        s = a.new_seq()
        for i in range(0, len(prompt), LONG_CHUNK):
            a.prefill(s, prompt[i:i + LONG_CHUNK])
        path = os.path.join(tmp, "seq.npz")
        t0 = time.perf_counter()
        nbytes = state.save_seq_state(a, s, path)
        save_ms = (time.perf_counter() - t0) * 1e3
        want = a.decode([s], [11])[0]
        shapes = [list(np.load(path)[f"k{i}"].shape)
                  for i in range(model.hp.n_layer)]
        b = ctx()
        b.prefill(b.new_seq(), prompt[:7])
        t0 = time.perf_counter()
        s2 = state.load_seq_state(b, path)
        load_ms = (time.perf_counter() - t0) * 1e3
        got = b.decode([s2], [11])[0]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"kv": kv, "tokens": len(prompt), "bytes": nbytes,
           "save_ms": save_ms, "restore_ms": load_ms,
           "k_shapes": sorted({tuple(x) for x in shapes}),
           "nmse": nmse(want, got)}
    check([x[0] for x in shapes] == [max(model.hp.n_head_kv_of(i), 1)
                                     for i in range(model.hp.n_layer)]
          and out["nmse"] < (1e-10 if kv == "bf16" else 1e-5),
          f"{model.hp.arch}/{kv}: session round trip: {out}")
    return out


def _geometry_small(torch, label, model, write_s, fitted,
                    profile: bool = False) -> dict:
    """A small geometry file through _small_check (bf16 KV), then greedy
    tokens at equal batches at bf16 and q8_0 KV; with profile, the
    decode and prefill breakdown of phase_profile at each."""
    out = _small_check(torch, "geometry", label, model, write_s, fitted)
    out["greedy"] = [_greedy_batches(torch, model, kv)
                     for kv in ("bf16", "q8_0")]
    emit({"phase": f"geometry/{label}", "greedy": out["greedy"]})
    if profile:
        for kv in ("bf16", "q8_0"):
            phase_profile(torch, model, model.hp.n_vocab,
                          f"geometry/{label}/{kv}", kv)
    return out


def _geometry_rows(kc) -> dict:
    """K3 and K3-q8 at DeciLM-7B's smallest KV count (32 heads on 2) and at
    OpenELM-270M's widest layer (20 on 5), B = 1 and 8."""
    rows = {}
    for label, hp in (("DeciLM-7B KV=2", dict(DECILM_7B, n_head_kv=2)),
                      ("OpenELM-270M H=20", OPENELM_270M)):
        for q8 in (False, True):
            for b in (1, 8):
                rows[f"{label} {'K3-q8' if q8 else 'K3'} B={b}"] = \
                    kc.paged_decode(hp, b, q8=q8)
    check(not kc.failures, f"kernels outside their gate: {kc.failures}")
    return rows


def phase_geometry(torch, kc, nvidia_smi: str,
                   profile: bool = False) -> dict:
    """Per-layer geometry and chameleon. OpenELM-270M (Q4_K) at published
    widths and 4 of 16 layers through _headline at bf16 and q8_0 KV (K2
    and K3 at each layer's own G), with a session save/restore, one
    context shift held to the plain path and greedy tokens at equal
    batches, at each KV type; then GEOMETRY_SMALL (_small_files):
    DeciLM-7B at 2 layers of two KV counts, a Nemotron-51B-width file of 3
    layers (attention,
    attention-free, linear attention; K2 and K3 on its attention layer
    alone), Chameleon-7B at 1 layer (QK LayerNorms with biases) and a
    Chameleon-34B-width swin-norm file at 1, each at bf16 KV and its
    greedy tokens at bf16 and q8_0 KV (_geometry_small); then K3 rows at
    DeciLM-7B's and OpenELM's widest G (_geometry_rows)."""
    files, launches = {}, {}

    def extra(model, prompt):
        from llama_cpp_test_tpu_torch.runtime.kv_cache import (
            kv_bytes_per_token)

        return {"kv_bytes_per_token": {kv: kv_bytes_per_token(model.hp, kv)
                                       for kv in ("bf16", "q8_0")},
                "session": [_session(torch, model, prompt, kv)
                            for kv in ("bf16", "q8_0")],
                "shift": [_shift_vs_plain(torch, model, prompt, 1024, kv)
                          for kv in ("bf16", "q8_0")],
                "greedy": [_greedy_batches(torch, model, kv)
                           for kv in ("bf16", "q8_0")]}

    files["openelm_270m"] = _headline(torch, "geometry", "openelm_270m",
                                      OPENELM_270M, "Q4_K", 110, 1024,
                                      nvidia_smi, profile, extra)
    _collect(files, launches)
    _small_files(GEOMETRY_SMALL, files, launches,
                 lambda label, hp, ftype, *loaded: _geometry_small(
                     torch, label, *loaded, profile=profile))
    emit({"phase": "geometry", "seconds": {
        label: round(f["seconds"], 1) for label, f in files.items()}})
    rows = _geometry_rows(kc)
    missing = [k for k in DENSE_PATH + ("paged_decode_q8",)
               if launches.get(k, 0) <= 0]
    check(not missing, f"geometry: kernels not launched: {missing}")
    return {"launches": launches, "files": files, "rows": rows}


# ---------------------------------------------------------------------------
# the other MoE forms and MLA attention

# DeepSeek-V2-Lite (deepseek-ai/DeepSeek-V2-Lite config.json) published
# widths: 2048 wide, 16 heads, kv_lora_rank 512 with a plain q, qk 128 +
# 64 (D = 192), v 128, the first layer dense at 10944, 64 routed experts
# top-6 of 1408 (softmax, not renormalized), 2 shared, vocab 102400, YaRN
# x40 over 4096 (mscale_all_dim 0.707); depth cut from 27 to 2 layers,
# the dense one and a MoE one (4 until the multimodal phase)
DEEPSEEK_V2_LITE = dict(
    arch="deepseek2", n_vocab=102400, n_embd=2048, n_head=16, n_head_kv=16,
    head_dim=192, rope_dim=64, n_ff=10944, n_layer=2, rms_eps=1e-6,
    n_expert=64, n_expert_used=6, n_ff_exp=1408, n_dense_lead=1,
    shexp_ff=2 * 1408,
    mla=dict(q_lora=0, kv_lora=512, rope_dim=64, v_dim=128),
    meta={"attention.kv_lora_rank": 512, "attention.value_length": 128,
          "expert_feed_forward_length": 1408,
          "leading_dense_block_count": 1, "expert_shared_count": 2,
          "expert_weights_scale": 1.0, "expert_weights_norm": False,
          "expert_gating_func": 1, "rope.scaling.type": "yarn",
          "rope.scaling.factor": 40.0,
          "rope.scaling.original_context_length": 4096,
          "rope.scaling.yarn_log_multiplier": 0.0707,
          "context_length": 163840})
# DeepSeek-V3 (deepseek-ai/DeepSeek-V3 config.json) published widths: 7168
# wide, 128 heads, q_lora_rank 1536, kv_lora_rank 512, D = 192, dense FFN
# 18432, 256 routed experts top-8 of 2048 with sigmoid scores, the
# e_score_correction_bias, renormalized weights scaled by 2.5, 1 shared,
# vocab 129280, YaRN x40 over 4096; depth cut from 61 layers (3 dense) to
# 2: one dense, one MoE
DEEPSEEK_V3 = dict(
    DEEPSEEK_V2_LITE, n_vocab=129280, n_embd=7168, n_head=128,
    n_head_kv=128, n_ff=18432, n_layer=2, n_expert=256, n_expert_used=8,
    n_ff_exp=2048, shexp_ff=2048, exp_probs_b=True,
    mla=dict(q_lora=1536, kv_lora=512, rope_dim=64, v_dim=128),
    meta={"attention.q_lora_rank": 1536, "attention.kv_lora_rank": 512,
          "attention.value_length": 128, "expert_feed_forward_length": 2048,
          "leading_dense_block_count": 1, "expert_shared_count": 1,
          "expert_weights_scale": 2.5, "expert_weights_norm": True,
          "expert_gating_func": 2, "rope.scaling.type": "yarn",
          "rope.scaling.factor": 40.0,
          "rope.scaling.original_context_length": 4096,
          "rope.scaling.yarn_log_multiplier": 0.1,
          "context_length": 163840})
# MiniCPM3-4B (openbmb/MiniCPM3-4B config.json): 2560 wide, 40 heads,
# q_lora_rank 768, kv_lora_rank 256, qk 64 + 32 (D = 96), v 64, FFN 6400,
# vocab 73448, the mup scales (scale_emb 12, scale_depth 1.4 over 62
# layers, dim_model_base 256); its long-rope tables are not written;
# depth cut from 62 to 2
MINICPM3_4B = dict(
    arch="minicpm3", n_vocab=73448, n_embd=2560, n_head=40, n_head_kv=40,
    head_dim=96, rope_dim=32, n_ff=6400,
    mla=dict(q_lora=768, kv_lora=256, rope_dim=32, v_dim=64),
    meta={"attention.q_lora_rank": 768, "attention.kv_lora_rank": 256,
          "attention.value_length": 64, "embedding_scale": 12.0,
          "residual_scale": 1.4 / 62 ** 0.5, "logit_scale": 2560 / 256})
# the published widths of the other MoE files (each model's config.json),
# depth cut to 1 layer (2 for deepseek-moe-16b's dense lead and a MoE
# layer; the others at 2 until PR 19)
MOE_SMALL_HP = {
    # Qwen/Qwen1.5-MoE-A2.7B: 60 experts top-4 of 1408 (not renormalized),
    # a sigmoid-gated shared expert of 5632, Q/K/V biases; 24 layers
    "qwen15_moe_a27b": dict(
        arch="qwen2moe", n_vocab=151936, n_embd=2048, n_head=16,
        n_head_kv=16, head_dim=128, n_ff=5632, rms_eps=1e-6,
        rope_base=1e6, qkv_bias=True, n_expert=60, n_expert_used=4,
        n_ff_exp=1408, shexp_ff=5632, shexp_gate=True,
        meta={"expert_feed_forward_length": 1408}),
    # Qwen/Qwen3-30B-A3B: 32 heads on 4, QK norms, 128 experts top-8 of
    # 768 (renormalized); 48 layers
    "qwen3_30b_a3b": dict(
        arch="qwen3moe", n_vocab=151936, n_embd=2048, n_head=32,
        n_head_kv=4, head_dim=128, n_ff=6144, rms_eps=1e-6, rope_base=1e6,
        qk_norm=True, n_expert=128, n_expert_used=8, n_ff_exp=768,
        meta={"expert_feed_forward_length": 768}),
    # allenai/OLMoE-1B-7B-0924: RMS norms over the flat q and k, 64
    # experts top-8 of 1024 (not renormalized); 16 layers
    "olmoe_1b_7b": dict(
        arch="olmoe", n_vocab=50304, n_embd=2048, n_head=16, n_head_kv=16,
        head_dim=128, n_ff=1024, qk_norm="flat", n_expert=64,
        n_expert_used=8, meta={"expert_feed_forward_length": 1024}),
    # microsoft/Phi-3.5-MoE-instruct: LayerNorms with biases, Q/K/V, wo
    # and lm head biases, 16 experts top-2 of 6400 by the sparsemixer;
    # its long-rope tables are not written; 32 layers
    "phi35_moe": dict(
        arch="phimoe", n_vocab=32064, n_embd=4096, n_head=32, n_head_kv=8,
        head_dim=128, n_ff=6400, ln_eps=1e-5, norm_bias=True,
        qkv_bias=True, bo=True, head_bias=True, n_expert=16,
        n_expert_used=2),
    # ibm-granite/granite-3.0-3b-a800m-base: 24 heads on 8 at D = 64, 40
    # experts top-8 of 512, the mup scales, a tied head; 32 layers
    "granite3_3b_a800m": dict(
        arch="granitemoe", n_vocab=49155, n_embd=1536, n_head=24,
        n_head_kv=8, head_dim=64, n_ff=512, tied=True, n_expert=40,
        n_expert_used=8,
        meta={"embedding_scale": 12.0, "residual_scale": 0.22,
              "attention.scale": 0.015625, "logit_scale": 6.0}),
    # deepseek-ai/deepseek-moe-16b-base: the first layer dense at 10944,
    # 64 experts top-6 of 1408 (not renormalized), 2 shared; 28 layers
    "deepseek_moe_16b": dict(
        arch="deepseek", n_vocab=102400, n_embd=2048, n_head=16,
        n_head_kv=16, head_dim=128, n_ff=10944, rms_eps=1e-6, n_expert=64,
        n_expert_used=6, n_ff_exp=1408, n_dense_lead=1, shexp_ff=2 * 1408,
        meta={"expert_feed_forward_length": 1408,
              "leading_dense_block_count": 1, "expert_shared_count": 2}),
    # databricks/dbrx-base: 48 heads on 8, a fused Wqkv clamped at 8,
    # bias-free LayerNorms (the pre-MoE one under attn_output_norm), 16
    # experts top-4 of 10752, rope base 5e5; 40 layers
    "dbrx": dict(
        arch="dbrx", n_vocab=100352, n_embd=6144, n_head=48, n_head_kv=8,
        head_dim=128, n_ff=10752, ln_eps=1e-5, fused_qkv=True,
        rope_base=500000.0, ffn_norm=False, branch_norms="dbrx",
        n_expert=16, n_expert_used=4, meta={"attention.clamp_kqv": 8.0}),
    # xai-org/grok-1: 48 heads on 8, 8 GELU experts top-2 of 32768, the
    # norms of the branch outputs, the attention softcap 30, the embedding
    # multiplier 78.38 and the output multiplier 1/sqrt(3); 64 layers
    "grok1": dict(
        arch="grok", n_vocab=131072, n_embd=6144, n_head=48, n_head_kv=8,
        head_dim=128, n_ff=32768, branch_norms="grok", n_expert=8,
        n_expert_used=2,
        meta={"embedding_scale": 78.38367176906169,
              "logit_scale": 3.0 ** 0.5}),
    # Snowflake/snowflake-arctic-base: 56 heads on 8, a dense MLP of 4864
    # beside 128 experts top-2 of 4864 on the layer input; 35 layers
    "arctic": dict(
        arch="arctic", n_vocab=32000, n_embd=7168, n_head=56, n_head_kv=8,
        head_dim=128, n_ff=4864, arctic=True, n_expert=128,
        n_expert_used=2),
}
# (label, geometry, GGUF type, seed, layers): the big-expert files take
# Q2_K, whose random blocks the host synthesizes fastest
_MOE_SMALL = {spec[0]: spec for spec in (
    ("deepseek_v3", DEEPSEEK_V3, "Q2_K", 131, 2),
    ("minicpm3_4b", dict(MINICPM3_4B, n_layer=1), "Q4_K", 132, 1),
    # one MoE layer each (2 until PR 19), deepseek-moe-16b's dense lead
    # layer and its first MoE layer
    *((label, hp, "Q4_K", 133 + i, 2 if label == "deepseek_moe_16b" else 1)
      for i, (label, hp) in enumerate(list(MOE_SMALL_HP.items())[:6])),
    *((label, hp, "Q2_K", 139 + i, 1) for i, (label, hp) in
      enumerate(list(MOE_SMALL_HP.items())[6:])))}
# the host writes and loads each file while the card checks the one
# before (the first while V2-Lite serves), and the host's share sets the
# clock (129 s of writes and loads against 58 s of checks, PR 19 run 9,
# PERF.md §6), so the largest file goes first and each large one follows
# a long check. Grok-1 and Arctic (55 s of that host time) are left out
# for the smoke's clock since PR 19 (ROADMAP §2 C (t)); their geometry
# stays above for a run that adds them back
MOE_SMALL = tuple(_MOE_SMALL[label] for label in (
    "deepseek_v3", "qwen3_30b_a3b", "dbrx", "qwen15_moe_a27b", "phi35_moe",
    "deepseek_moe_16b", "olmoe_1b_7b", "granite3_3b_a800m", "minicpm3_4b"))
MOE_ROW_FILES = {"qwen3_30b_a3b": ("gate",)}


def _host_load(label, hp, ftype, seed, n_layer) -> tuple:
    """A file of n_layer layers at published widths written (no
    tokenizer) and loaded into host planes: (HParams, weights, write
    seconds, load seconds, the types _fit_type chose)."""
    from llama_cpp_test_tpu_torch.gguf.reader import GGUFReader
    from llama_cpp_test_tpu_torch.models.llama import load_weights

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        path = os.path.join(tmp, f"{label}.gguf")
        t0 = time.time()
        fitted = write_llama_gguf(path, dict(hp, n_layer=n_layer), seed=seed,
                                  ftype=ftype, vocab=None)
        t1 = time.time()
        php, w = load_weights(GGUFReader(path))
        return php, w, t1 - t0, time.time() - t1, fitted
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _sched_vs_generate(torch, model, kv: str) -> dict:
    """Three greedy requests queued on one Scheduler slot (windows of 8:
    a batch of one, as generate() decodes) give generate()'s tokens,
    request by request. (At equal batches of several rows the sched
    phase holds the windows to a per-token replay.)"""
    from llama_cpp_test_tpu_torch.runtime.engine import Context, generate
    from llama_cpp_test_tpu_torch.runtime.sampling import SamplerParams
    from llama_cpp_test_tpu_torch.runtime.scheduler import GenRequest, Scheduler

    rng = np.random.default_rng(17)
    prompts = [rng.integers(3, model.hp.n_vocab, size=n).tolist()
               for n in (16, 130, 300)]
    want = [list(generate(Context(model, n_ctx=1024, n_seq_max=1,
                                  block_size=16, kv_type=kv), p, 24))
            for p in prompts]
    t0 = time.time()
    sched = Scheduler(Context(model, n_ctx=1024, n_seq_max=1, block_size=16,
                              kv_type=kv), n_slots=1, decode_window=8)
    reqs = [sched.submit(GenRequest(p, max_tokens=24, ignore_eos=True,
                                    sampling=SamplerParams(temp=0.0)))
            for p in prompts]
    sched.run()
    got = [r.output_tokens for r in reqs]
    out = {"kv": kv, "wall_s": time.time() - t0, "metrics": sched.metrics(),
           "same_as_generate": got == want}
    check(got == want, f"{model.hp.arch}/{kv}: the Scheduler's tokens "
                       f"{got} differ from generate()'s {want}")
    return out


def phase_moe_forms(torch, kc, nvidia_smi: str, kept: Kept, build: dict,
                    profile: bool = False) -> dict:
    """The other MoE forms and MLA attention. DeepSeek-V2-Lite (Q4_K, 2 of
    27 layers) through _serve at bf16 and q8_0 KV (generate() at 16, 130
    and 512 tokens, a batched decode of 8, the logits of a 130-token
    prefill and QUIRK_DECODE decode steps within the gate of the plain
    path on the rows whose routing agrees), the launches its path predicts
    at each KV type (K2 once a layer a chunk, K3 or K3-q8 once a layer a
    step, K1's GEMV once a quantized plane a step, K4's GEMV three times
    a MoE layer a step), the Scheduler's greedy tokens and cli.main's
    printout equal to generate()'s, K4 rows on its stacks (top-6 of 64)
    and K2, K3 and K3-q8 rows at D = 192. Then MOE_SMALL one at a time on
    the card, the next written and loaded into host planes meanwhile (the
    first while V2-Lite serves), each freed before the next, each held to
    the plain path once (_small_check with recheck False): DeepSeek-V3 (2
    layers; sigmoid gating, the selection bias), MiniCPM3-4B (1 layer; MLA
    at D = 96), five MoE files at 1 layer, deepseek-moe-16b at 2 (its
    dense lead and a MoE layer) and DBRX at one layer, each through
    _small_check; K4 rows on Qwen3-30B-A3B's gate stack (top-8 of 128), K2
    at V3's 128 heads; the ptxas registers and spills of the D = 192
    builds."""
    from llama_cpp_test_tpu_torch.runtime.engine import Model

    files, launches, rows = {}, {}, {}
    lite = DEEPSEEK_V2_LITE

    def more(model):
        prompt = np.random.default_rng(12).integers(
            3, lite["n_vocab"], size=LN_PROMPT).tolist()
        out = {"path": [_path_prediction(torch, model, prompt, 1024, kv)
                        for kv in ("bf16", "q8_0")], "card": nvidia_smi,
               "sched": [_sched_vs_generate(torch, model, kv)
                         for kv in ("bf16", "q8_0")]}
        out["cli"] = _cli_vs_generate(torch, "moe_forms/cli",
                                      kept.files["deepseek_v2_lite"], model,
                                      MOE_BF16_PATH)
        rows.update(_moe_rows(kc, model, "DeepSeek-V2-Lite"))
        emit({"phase": "moe_forms/deepseek_v2_lite", "checks": out})
        return out

    # the small files write and load into host planes on one thread, one
    # ahead of the card, the first beside V2-Lite's serve (two at once
    # slowed the card's host-bound steps more than they hid; PERF.md §6)
    ex = ThreadPoolExecutor(max_workers=1)
    try:
        nxt = ex.submit(_host_load, *MOE_SMALL[0])
        t0 = time.time()
        files["deepseek_v2_lite"] = _serve(
            torch, "moe_forms/deepseek_v2_lite", lite, 121,
            [("bf16", None), ("q8_0", None)], 8, MOE_PATH, profile,
            ftype="Q4_K", keep=(kept, "deepseek_v2_lite"),
            n_decode=QUIRK_DECODE, rows=more, joint=False)
        files["deepseek_v2_lite"]["seconds"] = time.time() - t0
        emit({"phase": "moe_forms/deepseek_v2_lite",
              "seconds": files["deepseek_v2_lite"]["seconds"]})
        _collect(files, launches)
        for q8 in (False, True):
            name = "K3-q8" if q8 else "K3"
            for b in (1, 8):
                rows[f"DeepSeek-V2-Lite {name} B={b}"] = kc.paged_decode(
                    lite, b, q8=q8)
        rows["DeepSeek-V2-Lite K2 T=512"] = kc.flash_prefill(lite, t=512)
        rows["DeepSeek-V3 K2 T=512"] = kc.flash_prefill(DEEPSEEK_V3, t=512)
        check(not kc.failures, f"kernels outside their gate: {kc.failures}")
        for i, spec in enumerate(MOE_SMALL):
            label = spec[0]
            php, w, write_s, load_s, fitted = nxt.result()
            if i + 1 < len(MOE_SMALL):
                nxt = ex.submit(_host_load, *MOE_SMALL[i + 1])
            t0 = time.time()
            model = Model.from_weights(php, w, device="cuda")
            del w
            # held to the plain path once (the clock; V2-Lite is held at
            # every step of its paths)
            out = _small_check(torch, "moe_forms", label, model, write_s,
                               fitted, recheck=False)
            out["host_load_s"] = load_s
            if label in MOE_ROW_FILES:
                rows.update(_moe_rows(kc, model, label,
                                      MOE_ROW_FILES[label]))
            out["seconds"] = time.time() - t0
            emit({"phase": f"moe_forms/{label}", "seconds": out["seconds"],
                  "host_load_s": load_s})
            files[label] = out
            _add_launches(launches, out["launches"])
            del model, out
            torch.cuda.empty_cache()
    finally:
        ex.shutdown(wait=True, cancel_futures=True)
    emit({"phase": "moe_forms", "seconds": {
        label: round(f["seconds"], 1) for label, f in files.items()}})
    new_builds = {k: v for k, v in build.items()
                  if re.search(r"^(flash_prefill|paged_decode) D=192\b", k)}
    emit({"phase": "moe_forms", "builds": new_builds, "card": nvidia_smi})
    check(len(new_builds) == 3 and not any(
        v["spill_bytes"] for v in new_builds.values()),
          f"moe_forms: the D = 192 builds: {new_builds}")
    missing = [k for k in MOE_PATH if launches.get(k, 0) <= 0]
    check(not missing, f"moe_forms: kernels not launched: {missing}")
    return {"launches": launches, "files": files, "rows": rows,
            "builds": new_builds}


# LLaVA-1.5-7B (liuhaotian/llava-v1.5-7b config.json): the LLM is
# Llama-2-7B's widths, depth cut from 32 to 2 layers, Q4_K
LLAVA_LLM = dict(arch="llama", n_vocab=32000, n_embd=4096, n_head=32,
                 n_head_kv=32, head_dim=128, n_layer=2, n_ff=11008)
# its tower, CLIP ViT-L/14-336 (openai/clip-vit-large-patch14-336
# config.json) as llama.cpp's convert_image_encoder_to_gguf.py writes it
# for LLaVA: 23 of the 24 blocks (the last one's output is never used),
# 577 positions (576 patches + CLS), pre-LN, f16 weights; the projector
# 1024 -> 4096 -> 4096 (mm.0, mm.2)
CLIP_L336 = dict(image_size=336, patch=14, hidden=1024, heads=16,
                 n_ff=4096, n_layer=23, proj=(4096, 4096))
# Qwen2-VL-2B (Qwen/Qwen2-VL-2B-Instruct config.json): the LLM at
# published widths, depth cut from 28 to 4 layers, Q4_K: Q/K/V biases,
# tied head, rope base 1e6, M-RoPE sections 16/24/24
QWEN2VL_LLM = dict(arch="qwen2vl", n_vocab=151936, n_embd=1536, n_head=12,
                   n_head_kv=2, head_dim=128, n_layer=4, n_ff=8960,
                   rope_base=1e6, rms_eps=1e-6, tied=True, qkv_bias=True,
                   meta={"rope.dimension_sections": [16, 24, 24, 0]})
# its vision tower at full width and depth: 32 blocks, embed 1280, 16
# heads (D = 80), MLP 5120, quick GELU, patch 14, 2 temporal frames, the
# 2x2 merger to 1536 (llama.cpp's qwen2_vl_surgery.py names, f16)
QWEN2VL_VIT = dict(embed=1280, heads=16, n_ff=5120, n_layer=32, patch=14,
                   out=1536)
QWEN2VL_GRID = (32, 32)     # a 448 x 448 image: 1024 patches, 256 tokens
PEAK_FP32 = 67e12           # H100 SXM non-tensor FP32 flop/s (data sheet)
TOWER_GATE = 1e-6           # a tower's f32 output against its f64 run
MM_DECODE = 16              # greedy decode steps after an image
LLAVA_PROMPT = ("USER: ", "\nDescribe the image in detail. ASSISTANT:")
QWEN2VL_PROMPT = ("<|im_start|>user\n<|vision_start|>",
                  "<|vision_end|>Describe this image.<|im_end|>\n"
                  "<|im_start|>assistant\n")


def f16_weights(rng, *shape) -> np.ndarray:
    """Seeded f16 weights: a random sign and mantissa under one exponent,
    magnitudes in [2^-6, 2^-5) (std ~0.024), from one integer draw (a
    normal draw of the towers' 1 G weights set the phase's host time)."""
    bits = rng.integers(0, 1 << 16, size=shape, dtype=np.uint16)
    return ((bits & np.uint16(0x83FF)) | np.uint16(9 << 10)).view(
        np.float16)


def _f16_block(w, rng, p, e, ff, names) -> None:
    """One pre-LN ViT block (clip.cpp names; names maps the two MLP
    projections, the surgery script's swapped ones for Qwen2-VL): 2-D
    weights f16 (f16_weights), norms and biases F32."""
    from llama_cpp_test_tpu_torch.gguf.constants import GGMLType

    vec = lambda n, mean=0.0: mean + 0.02 * rng.standard_normal(
        n, dtype=np.float32)
    up, down = names
    for name, n, k in (("attn_q", e, e), ("attn_k", e, e), ("attn_v", e, e),
                       ("attn_out", e, e), (up, ff, e), (down, e, ff)):
        w.add_tensor(p + name + ".weight", f16_weights(rng, n, k),
                     ggml_type=GGMLType.F16)
        w.add_tensor(p + name + ".bias", vec(n))
    for name in ("ln1", "ln2"):
        w.add_tensor(p + name + ".weight", vec(e, 1.0))
        w.add_tensor(p + name + ".bias", vec(e))


def write_clip_mmproj(path: str, spec: dict, seed: int) -> None:
    """A llava mmproj GGUF of geometry spec (CLIP_L336) from seeded
    weights (f16_weights; F32 norms and biases), as llama.cpp's converter
    lays it out."""
    from llama_cpp_test_tpu_torch.gguf.constants import GGMLType
    from llama_cpp_test_tpu_torch.gguf.writer import GGUFWriter

    rng = np.random.default_rng(seed)
    e, p, s = spec["hidden"], spec["patch"], spec["image_size"]
    w = GGUFWriter(path, arch="clip")
    for k, v in {"clip.has_vision_encoder": True,
                 "clip.has_llava_projector": True,
                 "clip.projector_type": "mlp", "clip.use_gelu": False,
                 "clip.vision.image_size": s, "clip.vision.patch_size": p,
                 "clip.vision.embedding_length": e,
                 "clip.vision.feed_forward_length": spec["n_ff"],
                 "clip.vision.projection_dim": spec["proj"][1],
                 "clip.vision.block_count": spec["n_layer"],
                 "clip.vision.attention.head_count": spec["heads"],
                 "clip.vision.attention.layer_norm_epsilon": 1e-5}.items():
        w.add_kv(k, v)
    f16 = lambda name, *shape: w.add_tensor(
        name, f16_weights(rng, *shape), ggml_type=GGMLType.F16)
    vec = lambda name, n, mean=0.0: w.add_tensor(
        name, mean + 0.02 * rng.standard_normal(n, dtype=np.float32))
    f16("v.patch_embd.weight", e, 3, p, p)
    vec("v.class_embd", e)
    f16("v.position_embd.weight", (s // p) ** 2 + 1, e)
    vec("v.pre_ln.weight", e, 1.0)
    vec("v.pre_ln.bias", e)
    for i in range(spec["n_layer"]):
        _f16_block(w, rng, f"v.blk.{i}.", e, spec["n_ff"],
                   ("ffn_up", "ffn_down"))
    (m0, m2) = spec["proj"]
    f16("mm.0.weight", m0, e)
    vec("mm.0.bias", m0)
    f16("mm.2.weight", m2, m0)
    vec("mm.2.bias", m2)
    w.write()


def write_qwen2vl_mmproj(path: str, spec: dict, seed: int) -> None:
    """A Qwen2-VL mmproj GGUF of geometry spec (QWEN2VL_VIT) from seeded
    weights (f16_weights; F32 norms and biases), as llama.cpp's
    qwen2_vl_surgery.py writes it: the
    conv3d as two frames, fc1 under ffn_down and fc2 under ffn_up, the
    merger's ln_q as v.post_ln."""
    from llama_cpp_test_tpu_torch.gguf.constants import GGMLType
    from llama_cpp_test_tpu_torch.gguf.writer import GGUFWriter

    rng = np.random.default_rng(seed)
    e, p = spec["embed"], spec["patch"]
    w = GGUFWriter(path, arch="clip")
    for k, v in {"clip.has_vision_encoder": True,
                 "clip.has_qwen2vl_merger": True,
                 "clip.projector_type": "qwen2vl_merger",
                 "clip.vision.image_size": 560, "clip.vision.patch_size": p,
                 "clip.vision.embedding_length": e,
                 "clip.vision.feed_forward_length": 0,
                 "clip.vision.projection_dim": spec["out"],
                 "clip.vision.block_count": spec["n_layer"],
                 "clip.vision.attention.head_count": spec["heads"],
                 "clip.vision.attention.layer_norm_epsilon": 1e-6}.items():
        w.add_kv(k, v)
    f16 = lambda name, *shape: w.add_tensor(
        name, f16_weights(rng, *shape), ggml_type=GGMLType.F16)
    vec = lambda name, n, mean=0.0: w.add_tensor(
        name, mean + 0.02 * rng.standard_normal(n, dtype=np.float32))
    f16("v.patch_embd.weight", e, 3, p, p)
    f16("v.patch_embd.weight.1", e, 3, p, p)
    for i in range(spec["n_layer"]):
        _f16_block(w, rng, f"v.blk.{i}.", e, spec["n_ff"],
                   ("ffn_down", "ffn_up"))
    vec("v.post_ln.weight", e, 1.0)
    vec("v.post_ln.bias", e)
    f16("mm.0.weight", 4 * e, 4 * e)
    vec("mm.0.bias", 4 * e)
    f16("mm.2.weight", spec["out"], 4 * e)
    vec("mm.2.bias", spec["out"])
    w.write()


def _tower_flops(kind: str, spec: dict) -> float:
    """Multiply-adds x 2 of one image through a tower: the patch
    embedding, every block's projections, MLP and attention products,
    and the projector or merger."""
    if kind == "clip":
        e, f, n = spec["hidden"], spec["n_ff"], (
            spec["image_size"] // spec["patch"]) ** 2
        t = n + 1
        m0, m2 = spec["proj"]
        head = 2.0 * n * (3 * spec["patch"] ** 2 * e + e * m0 + m0 * m2)
    else:
        e, f = spec["embed"], spec["n_ff"]
        t = QWEN2VL_GRID[0] * QWEN2VL_GRID[1]
        head = 2.0 * t * 6 * spec["patch"] ** 2 * e + 2.0 * (t // 4) * (
            16 * e * e + 4 * e * spec["out"])
    block = 2.0 * t * (4 * e * e + 2 * e * f) + 4.0 * t * t * e
    return spec["n_layer"] * block + head


def _tower(torch, label, kind, spec, seed, kept_dir) -> tuple:
    """Write and load a tower's mmproj (load_clip / load_qwen2vl_vision on
    cuda), encode one seeded image and hold it against the same tower in
    float64 on the card (NMSE < TOWER_GATE); time the encode (wall, after
    a warm-up; device busy by torch.profiler) against its f32 bound.
    Returns (model, input, embeddings, readings)."""
    from llama_cpp_test_tpu_torch.models import clip
    from llama_cpp_test_tpu_torch.models import qwen2vl_vision as qv

    path = os.path.join(kept_dir, f"{label}.gguf")
    t0 = time.time()
    if kind == "clip":
        write_clip_mmproj(path, spec, seed)
    else:
        write_qwen2vl_mmproj(path, spec, seed)
    t1 = time.time()
    m = (clip.load_clip(path, device="cuda") if kind == "clip" else
         qv.load_qwen2vl_vision(path, device="cuda"))
    load_s = time.time() - t1
    os.remove(path)
    rng = np.random.default_rng(seed + 1)
    if kind == "clip":
        s = spec["image_size"]
        x = torch.from_numpy(rng.standard_normal((3, s, s), dtype=np.float32))
        enc = lambda mm: clip.encode_image(mm, x)
    else:
        gh, gw = QWEN2VL_GRID
        x = torch.from_numpy(0.5 * rng.standard_normal(
            (gh * gw, 6 * spec["patch"] ** 2), dtype=np.float32))
        enc = lambda mm: qv.encode_image(mm, x, gh, gw)
    emb = enc(m)                                  # warm-up, and the output
    hi = m.to(dtype=torch.float64)
    ref = enc(hi)
    del hi
    torch.cuda.empty_cache()
    err = nmse(ref.cpu(), emb.double().cpu())
    torch.cuda.synchronize()
    t2 = time.time()
    enc(m)
    torch.cuda.synchronize()
    wall_ms = (time.time() - t2) * 1e3
    prof = _profiled(torch, lambda: enc(m))
    flops = _tower_flops(kind, spec)
    out = {"tower": label, "layers": len(m.layers), "tokens": emb.shape[0],
           "width": emb.shape[1], "write_s": t1 - t0, "load_s": load_s,
           "nmse_vs_f64": err, "gate": TOWER_GATE,
           "finite": bool(torch.isfinite(emb).all()),
           "encode_wall_ms": wall_ms,
           "encode_busy_ms": prof["device_busy_ms"], "gflop": flops / 1e9,
           "f32_bound_ms": flops / PEAK_FP32 * 1e3,
           "top": prof["top"][:4]}
    emit({"phase": "multimodal", "tower": out})
    check(out["finite"] and err < TOWER_GATE,
          f"{label}: encode_image off its float64 run (NMSE {err})")
    return m, x, emb, out


def _image_turn(torch, ctx, pre, emb, post, grid, tokens=None):
    """The llava CLI's steps after preprocessing: the text before the
    image, the image through prefill_embeds (with grid, Qwen2-VL's (gh,
    gw): its M-RoPE streams, then pos_offset set as the CLI sets it), the
    text after it (every row's logits), then MM_DECODE decode steps on
    `tokens` or greedy. Returns (logits of each step, decode tokens,
    prefill_embeds wall ms)."""
    from llama_cpp_test_tpu_torch.models import qwen2vl_vision as qv

    s = ctx.new_seq()
    rows = [ctx.prefill(s, pre)[None]]
    torch.cuda.synchronize()
    t0 = time.time()
    if grid is None:
        rows.append(ctx.prefill_embeds(s, emb)[None])
    else:
        t_img = s.n_cached + s.pos_offset
        rows.append(ctx.prefill_embeds(
            s, emb, mrope_pos=qv.mrope_image_positions(t_img, *grid))[None])
        s.pos_offset = qv.mrope_delta_after_image(t_img, *grid) - s.n_cached
    embeds_ms = (time.time() - t0) * 1e3
    rows.append(ctx.prefill(s, post)[None])
    toks = []
    for i in range(MM_DECODE):
        toks.append(tokens[i] if tokens else int(np.argmax(rows[-1][-1])))
        rows.append(ctx.decode([s], toks[-1:]))
    ctx.free_seq(s)
    return rows, toks, embeds_ms


def _greedy_parity(rows_k, rows_p, toks) -> dict:
    """The kernel path's greedy tokens against the plain path's argmax on
    the same (teacher-forced) steps: equal, or the first difference where
    the plain path's top-2 gap is within the largest logit difference
    between the two paths on that row."""
    lead = len(rows_k) - len(toks) - 1       # rows before the first token
    for i, t in enumerate(toks):
        lp, lk = rows_p[lead + i][-1], rows_k[lead + i][-1]
        if int(np.argmax(lp)) != t:
            top = np.sort(lp)[-2:]
            gap, diff = float(top[1] - top[0]), float(np.abs(lk - lp).max())
            return {"same": False, "first_diff": i, "plain_gap": gap,
                    "logit_diff": diff, "within": gap <= diff}
    return {"same": True}


def _mm_llm(torch, label, hp, seed, kind, tower, emb, prompt, kept_dir,
            nvidia_smi) -> dict:
    """An LLM of the phase: the file written and loaded (Model on cuda),
    the launch counts zeroed, the image turn driven through the kernels
    (the tower's encode included, as the CLI runs it) and the counts read;
    every kernel of DENSE_PATH must launch. The same turn through a plain
    Context on the same embeddings and tokens: every step's logits within
    LOGITS_GATE, the greedy tokens by _greedy_parity. Then prefill_embeds
    wall and the profile of prefill_embeds + 8 decode steps."""
    from llama_cpp_test_tpu_torch.models import clip
    from llama_cpp_test_tpu_torch.models import qwen2vl_vision as qv
    from llama_cpp_test_tpu_torch.ops import _cuda
    from llama_cpp_test_tpu_torch.runtime.engine import Context, Model

    path = os.path.join(kept_dir, f"{label}.gguf")
    t0 = time.time()
    write_llama_gguf(path, hp, seed=seed, ftype="Q4_K")
    model = Model(path, device="cuda")
    os.remove(path)
    write_load_s = time.time() - t0
    tok = model.tokenizer
    pre = tok.encode(prompt[0], add_special=True)
    post = tok.encode(prompt[1], add_special=False)
    grid = None if kind == "clip" else QWEN2VL_GRID
    m, x = tower
    ctx = lambda **kw: Context(model, n_ctx=1024, n_seq_max=1,
                               block_size=16, **kw)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    img = (clip.encode_image(m, x) if kind == "clip" else
           qv.encode_image(m, x, *QWEN2VL_GRID))
    rows_k, toks, embeds_ms = _image_turn(torch, ctx(), pre, img, post, grid)
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    rows_p, _, _ = _image_turn(torch, ctx(plain=True), pre, emb, post, grid,
                               toks)
    errs = [nmse(a, b) for a, b in zip(rows_p, rows_k)]
    parity = _greedy_parity(rows_k, rows_p, toks)
    # under the profiler, each after a text prefill of the prompt's head:
    # prefill_embeds alone, and prefill_embeds + 8 decode steps
    c = ctx()

    def embeds_decode(n_decode):
        s = c.new_seq()
        c.prefill(s, pre)
        torch.cuda.synchronize()

        def run():
            if grid is None:
                lg = c.prefill_embeds(s, emb)
            else:
                t_img = s.n_cached
                lg = c.prefill_embeds(
                    s, emb, mrope_pos=qv.mrope_image_positions(t_img, *grid))
                s.pos_offset = qv.mrope_delta_after_image(t_img, *grid) - \
                    s.n_cached
            for _ in range(n_decode):
                lg = c.decode([s], [int(np.argmax(lg))])[0]

        out = _profiled(torch, run)
        c.free_seq(s)
        return out

    embeds_prof = embeds_decode(0)
    prof = embeds_decode(8)
    out = {"llm": label, "arch": model.hp.arch, "n_layer": hp["n_layer"],
           "write_load_s": write_load_s, "prompt_tokens": [len(pre),
                                                           len(post)],
           "image_tokens": int(emb.shape[0]), "launches": launches,
           "logits_nmse": errs, "max_nmse": max(errs), "gate": LOGITS_GATE,
           "greedy": parity, "tokens": toks,
           "prefill_embeds_wall_ms": embeds_ms,
           "prefill_embeds_busy_ms": embeds_prof["device_busy_ms"],
           "profile_embeds_decode8": prof, "card": nvidia_smi}
    emit({"phase": "multimodal", "llm": {k: v for k, v in out.items()
                                         if k != "profile_embeds_decode8"},
          "profile": {k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                           "idle_share", "gemv_ms")}})
    missing = [k for k in DENSE_PATH if launches[k] <= 0]
    check(not missing, f"multimodal/{label}: kernels not launched: "
                       f"{missing} ({launches})")
    check(all(np.isfinite(r).all() for r in rows_k) and
          max(errs) < LOGITS_GATE, f"multimodal/{label}: logits off the "
                                   f"plain path: {errs}")
    check(parity["same"] or parity["within"],
          f"multimodal/{label}: greedy tokens differ past the logit "
          f"difference: {parity}")
    out["model"] = model
    return out


def phase_multimodal(torch, kc, nvidia_smi: str) -> dict:
    """Image input at published widths, driven as the llava CLI drives it
    after preprocessing (seeded arrays; PIL is not needed): LLaVA-1.5-7B
    (CLIP ViT-L/14-336, 23 blocks, and its MLP projector, f16; the
    Llama-2-7B LLM at 2 of 32 layers, Q4_K) and Qwen2-VL-2B (its 32-block
    vision tower and merger, f16, a 448 x 448 image of 256 merged tokens;
    the LLM at 4 of 28 layers, Q4_K, with the M-RoPE streams). Each tower
    is held against itself in float64 on the card; each LLM's image turn
    (_mm_llm: text, prefill_embeds, text, MM_DECODE greedy steps) launches
    K1's GEMV and GEMM, K2 and K3 and stays within the logits gate of the
    plain path. Rows: K2 at Llama-2-7B's T = 576 + text and Qwen2-VL's T =
    256 and 512, K3 at both at B = 1 and 8, K1 at Qwen2-VL-2B's gate|up
    (M = 1 and 512). The vision towers keep full width and depth."""
    from llama_cpp_test_tpu_torch.ops import _cuda

    try:
        import PIL
        pil = PIL.__version__
    except ImportError:
        pil = None
    out = {"pil": pil, "towers": {}, "llms": {}, "rows": {}}
    launches = dict.fromkeys(_cuda.LAUNCHES, 0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mm_")
    try:
        for label, kind, spec, seed, llm, hp, lseed, prompt in (
                ("clip_vit_l14_336", "clip", CLIP_L336, 141, "llava_7b",
                 LLAVA_LLM, 142, LLAVA_PROMPT),
                ("qwen2vl_vit", "qwen2vl", QWEN2VL_VIT, 143, "qwen2vl_2b",
                 QWEN2VL_LLM, 144, QWEN2VL_PROMPT)):
            t0 = time.time()
            m, x, emb, out["towers"][label] = _tower(torch, label, kind,
                                                     spec, seed, tmp)
            r = _mm_llm(torch, llm, hp, lseed, kind, (m, x), emb, prompt,
                        tmp, nvidia_smi)
            del m, x, emb
            model = r.pop("model")
            for k, v in r["launches"].items():
                launches[k] += v
            n_text = sum(r["prompt_tokens"])
            if kind == "clip":
                out["rows"]["LLaVA-7B K2 T=576+text"] = kc.flash_prefill(
                    hp, t=576 + n_text)
            else:
                for t in (256, 512):
                    out["rows"][f"Qwen2-VL-2B K2 T={t}"] = kc.flash_prefill(
                        hp, t=t)
                lw = model.weights.layers[0]
                for mm in (1, 512):
                    out["rows"][f"Qwen2-VL-2B gate|up M={mm}"] = kc.qmm(
                        "Qwen2-VL-2B gate|up", "Q4_K", lw.w_gateup, mm)
            for b in (1, 8):
                out["rows"][f"{llm} K3 B={b}"] = kc.paged_decode(hp, b)
            r["seconds"] = time.time() - t0
            out["llms"][llm] = r
            del model
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(not kc.failures, f"kernels outside their gate: {kc.failures}")
    out["launches"] = launches
    emit({"phase": "multimodal", "pil": pil, "seconds": {
        k: round(v["seconds"], 1) for k, v in out["llms"].items()},
          "card": nvidia_smi})
    return out


# ---------------------------------------------------------------------------
# recurrent: the state-space and rwkv families, plain f32 torch (no kernel)

# state-spaces/mamba-130m config.json as the reference's converter reads
# it: d_model 768, n_layer 24, vocab 50277 padded to a multiple of 8
# (50280); d_inner 2 d_model, d_state 16, d_conv 4, dt_rank ceil(768 / 16);
# tied embeddings (no output.weight); full depth
MAMBA_130M = dict(arch="mamba", n_vocab=50280, n_embd=768, n_layer=24,
                  d_inner=1536, d_state=16, d_conv=4, dt_rank=48)
# RWKV/v6-Finch-1B6-HF: hidden 2048, head_size 64, intermediate 7168,
# time_mix_extra_dim 32, time_decay_extra_dim 64, vocab 65536,
# rescale_every 6; depth cut from 24 to 6 layers, so one rescale fires
RWKV6_1B6 = dict(arch="rwkv6", n_vocab=65536, n_embd=2048, n_layer=6,
                 head_size=64, n_ff=7168, lerp_rank=32, decay_rank=64,
                 rescale_every=6)
# fla-hub/rwkv7-1.5B-world: hidden 2048, head_dim 64, intermediate 8192,
# decay / a / v / gate low-rank dims 96 / 96 / 64 / 256, vocab 65536;
# depth cut from 24 to 2 layers, so v_first crosses a layer
RWKV7_1B5 = dict(arch="rwkv7", n_vocab=65536, n_embd=2048, n_layer=2,
                 head_size=64, n_ff=8192, w_rank=96, a_rank=96, v_rank=64,
                 g_rank=256)
# the hybrids at their hosts' widths, with a Qwen2 BPE vocab:
# recursal/QRWKV6-32B-Instruct-Preview-v0.1, Qwen2.5-32B-Instruct's body
# (hidden 5120, 40 heads so head_size 128, 8 KV heads, intermediate
# 27648, vocab 152064, untied head) under RWKV-6 time mixing; lerp and
# decay low ranks 64 and 128 (the upstream converter's defaults at a
# width >= 4096); depth cut from 64 to 1 layer
QRWKV6_32B = dict(arch="rwkv6qwen2", n_vocab=152064, n_embd=5120, n_layer=1,
                  head_size=128, n_ff=27648, n_head_kv=8, lerp_rank=64,
                  decay_rank=128)
# RWKV-Red-Team/ARWKV-R1-1B5, DeepSeek-R1-Distill-Qwen-1.5B's body
# (hidden 1536, intermediate 8960, vocab 151936, untied head) under RWKV-7
# time mixing at head size 64; low ranks w/a/v/g 64/64/32/128 (the
# upstream converter's ARWKV constants, the gate kept); depth cut from 28
# to 2 layers, so v_first crosses a layer
ARWKV7_1B5 = dict(arch="arwkv7", n_vocab=151936, n_embd=1536, n_layer=2,
                  head_size=64, n_ff=8960, w_rank=64, a_rank=64, v_rank=32,
                  g_rank=128)
REC_FILES = (("mamba_130m", MAMBA_130M, 151), ("rwkv6_1b6", RWKV6_1B6, 152),
             ("rwkv7_1b5", RWKV7_1B5, 153),
             ("qrwkv6_32b", QRWKV6_32B, 154), ("arwkv7_1b5", ARWKV7_1B5, 155))
REC_PROMPT = 32      # prefill tokens of the card/CPU and step checks
REC_NEW = 16         # greedy tokens each check continues
# f32 logits on the card against the CPU's, NMSE: the runs measured 1.2e-12
# to 5.3e-12 (PERF.md §6), so a chain computed below f32 (TF32 or bf16
# matmuls) fails it
REC_GATE = 1e-9
REC_POOL_B = 4       # rows of the pool's batched decode
REC_CTX = 48         # the Scheduler's n_ctx: one request runs past it


F16_POOL_STD = 0.0239    # std of f16_weights' magnitudes in [2^-6, 2^-5)


class _F16Pool:
    """Seeded f16 weights as seeded slices of one shared draw
    (f16_weights: magnitudes in [2^-6, 2^-5), random signs), so a GB-size
    file costs one copy a tensor instead of a draw. A tensor larger than
    the draw (a 152k-row embedding) wraps around it from a seeded offset."""

    def __init__(self, rng, n: int):
        self.rng = rng
        self.a = f16_weights(rng, n)

    def take(self, *shape, scale: float = 1.0) -> np.ndarray:
        n = int(np.prod(shape))
        if n > self.a.size:
            off = int(self.rng.integers(0, self.a.size))
            out = np.resize(np.roll(self.a, -off), n).reshape(shape)
        else:
            off = int(self.rng.integers(0, self.a.size - n + 1))
            out = self.a[off:off + n].reshape(shape)
        if scale == 1.0:
            return out
        k = np.log2(scale)
        if k == round(k) and -8 <= k <= 21:
            # a power of two moves the exponent field (every draw has 9):
            # exact, and ~20x faster than numpy's f16 multiply
            return (out.view(np.uint16) + np.uint16((int(k) << 10) & 0xFFFF)
                    ).view(np.float16)
        return out * np.float16(scale)


def rwkv_vocab(n_vocab: int, seed: int) -> dict:
    """Tokenizer metadata of an RWKV World vocab (tokenizer.ggml.model
    "rwkv", the trie tokenizer) laid out as the reference's converter
    writes it: <s> at id 0, then printable ASCII, the words of _WORDS
    with and without a leading space and seeded letter strings of 2-8
    letters up to World's 65530 entries, then [PADn] to n_vocab."""
    rng = np.random.default_rng(seed)
    n_real = min(n_vocab, 65530)
    pieces = dict.fromkeys([chr(c) for c in range(32, 127)] +
                           [" " + w for w in _WORDS] + list(_WORDS))
    letters = np.array(list(_LETTERS))
    while len(pieces) < n_real - 1:
        lens = rng.integers(2, 9, size=4096)
        rows = rng.choice(letters, size=(4096, 8),
                          p=_LETTER_P / _LETTER_P.sum())
        spaces = rng.random(4096) < 0.5
        for n, row, sp in zip(lens, rows, spaces):
            pieces.setdefault((" " if sp else "") + "".join(row[:n]))
    tokens = ["<s>"] + list(pieces)[:n_real - 1]
    types = [3] + [1] * (len(tokens) - 1)
    tokens += [f"[PAD{i}]" for i in range(len(tokens), n_vocab)]
    types += [5] * (n_vocab - len(types))
    return {"tokenizer.ggml.model": "rwkv", "tokenizer.ggml.tokens": tokens,
            "tokenizer.ggml.token_type": np.asarray(types, np.int32),
            "tokenizer.ggml.bos_token_id": 0,
            "tokenizer.ggml.eos_token_id": 0,
            "tokenizer.ggml.add_bos_token": False}


def write_recurrent_gguf(path: str, hp: dict, seed: int, pool) -> None:
    """A recurrent GGUF (mamba, rwkv6, rwkv6qwen2, rwkv7, arwkv7) of
    geometry hp in the reference converter's layout and types: matrices
    F16 (pool slices), vectors, norms, lerps and rwkv6's 3-D time_mix_w2
    F32 (seeded draws in the ranges trained models hold: decays, dt
    biases, lerps in [0, 1], mamba's A = -(1..d_state)); a synthesized
    vocab (bpe_vocab for mamba, the same with Qwen2's pre-tokenizer for
    the hybrids, rwkv_vocab for rwkv6 and rwkv7)."""
    from llama_cpp_test_tpu_torch.gguf.constants import GGMLType
    from llama_cpp_test_tpu_torch.gguf.writer import GGUFWriter

    rng = np.random.default_rng(seed)
    arch, c, v, n_layer = (hp[k] for k in ("arch", "n_embd", "n_vocab",
                                           "n_layer"))
    w = GGUFWriter(path, arch=arch)
    mat = lambda name, *shape, scale=1.0: w.add_tensor(
        name, pool.take(*shape, scale=scale), ggml_type=GGMLType.F16)
    uni = lambda name, lo, hi, *shape: w.add_tensor(
        name, rng.uniform(lo, hi, shape).astype(np.float32))

    def norm(name, bias=True):
        uni(name + ".weight", 0.95, 1.05, c)
        if bias:
            uni(name + ".bias", -0.05, 0.05, c)

    md = {"context_length": 1048576, "embedding_length": c,
          "block_count": n_layer, "vocab_size": v}
    rms = arch in ("mamba", "rwkv6qwen2", "arwkv7")
    md["attention.layer_norm_rms_epsilon" if rms else
       "attention.layer_norm_epsilon"] = 1e-5
    if arch == "mamba":
        di, n, r = hp["d_inner"], hp["d_state"], hp["dt_rank"]
        md.update({"ssm.conv_kernel": hp["d_conv"], "ssm.inner_size": di,
                   "ssm.state_size": n, "ssm.time_step_rank": r})
    else:
        md.update({"wkv.head_size": hp["head_size"],
                   "feed_forward_length": hp["n_ff"],
                   "attention.head_count": 0})
    if arch == "rwkv6":
        md["rescale_every_n_layers"] = hp["rescale_every"]
    if arch in ("rwkv6qwen2", "arwkv7"):
        md["token_shift_count"] = 1
    if arch == "rwkv6qwen2":
        md["attention.head_count_kv"] = hp["n_head_kv"]
    if arch in ("rwkv7", "arwkv7"):
        md.update({"attention.decay_lora_rank": hp["w_rank"],
                   "attention.iclr_lora_rank": hp["a_rank"],
                   "attention.value_residual_mix_lora_rank": hp["v_rank"],
                   "attention.gate_lora_rank": hp["g_rank"]})
    md = {f"{arch}.{k}": val for k, val in md.items()}
    if arch in ("rwkv6", "rwkv7"):
        md.update(rwkv_vocab(v, seed))
    else:
        md.update(bpe_vocab(v, seed))
        if arch != "mamba":
            md["tokenizer.ggml.pre"] = "qwen2"
    for key, val in md.items():
        w.add_kv(key, val)

    mat("token_embd.weight", v, c)
    if arch in ("rwkv6", "rwkv7"):
        norm("token_embd_norm")
    norm("output_norm", bias=not rms)
    if arch != "mamba":              # Mamba-130M ties its head
        mat("output.weight", v, c)
    for i in range(n_layer):
        p = f"blk.{i}."
        norm(p + "attn_norm", bias=not rms)
        if arch == "mamba":
            k = hp["d_conv"]
            mat(p + "ssm_in.weight", 2 * di, c)
            mat(p + "ssm_conv1d.weight", di, k, scale=16.0)
            uni(p + "ssm_conv1d.bias", -0.1, 0.1, di)
            mat(p + "ssm_x.weight", r + 2 * n, di)
            mat(p + "ssm_dt.weight", di, r)
            # softplus of the bias gives dt in [0.01, 0.1], the init range
            uni(p + "ssm_dt.bias", -4.6, -2.3, di)
            w.add_tensor(p + "ssm_a.weight", -np.tile(
                np.arange(1, n + 1, dtype=np.float32), (di, 1)),
                ggml_type=GGMLType.F16)
            uni(p + "ssm_d.weight", 0.9, 1.1, di)
            mat(p + "ssm_out.weight", c, di)
            continue
        hd = hp["head_size"]
        h, ff = c // hd, hp["n_ff"]
        if arch in ("rwkv6", "rwkv7"):
            norm(p + "attn_norm_2")
        else:
            norm(p + "ffn_norm", bias=False)
        if arch.startswith("rwkv6"):
            e, e2 = hp["lerp_rank"], hp["decay_rank"]
            kv = hp.get("n_head_kv", h) * hd
            uni(p + "time_mix_lerp_x.weight", 0.0, 1.0, c)
            uni(p + "time_mix_lerp_fused.weight", 0.0, 1.0, 5, c)
            mat(p + "time_mix_w1.weight", 5 * e, c)
            w.add_tensor(p + "time_mix_w2.weight",
                         pool.take(5, c, e).astype(np.float32))
            uni(p + "time_mix_decay.weight", -6.0, -1.0, c)
            mat(p + "time_mix_decay_w1.weight", e2, c)
            mat(p + "time_mix_decay_w2.weight", c, e2)
            mat(p + "time_mix_key.weight", kv, c)
            mat(p + "time_mix_value.weight", kv, c)
            mat(p + "time_mix_receptance.weight", c, c)
            mat(p + "time_mix_gate.weight", c, c)
            mat(p + "time_mix_output.weight", c, c)
            if arch == "rwkv6":
                mat(p + "time_mix_first.weight", h, hd, scale=32.0)
                norm(p + "time_mix_ln")
                uni(p + "channel_mix_lerp_k.weight", 0.0, 1.0, c)
                uni(p + "channel_mix_lerp_r.weight", 0.0, 1.0, c)
                mat(p + "channel_mix_key.weight", ff, c)
                mat(p + "channel_mix_receptance.weight", c, c)
                mat(p + "channel_mix_value.weight", c, ff)
            else:
                for name, n_out in (("key", kv), ("value", kv),
                                    ("receptance", c)):
                    uni(p + f"time_mix_{name}.bias", -0.1, 0.1, n_out)
        else:
            uni(p + "time_mix_lerp_fused.weight", 0.0, 1.0, 6, c)
            for x, rank, lo, hi in (("w", hp["w_rank"], -2.0, 0.0),
                                    ("a", hp["a_rank"], -0.5, 0.5),
                                    ("v", hp["v_rank"], 0.5, 1.5)):
                # layer 0's v0/v1/v2 are the dummies llama.cpp writes
                uni(p + f"time_mix_{x}0.weight", lo, hi, c)
                mat(p + f"time_mix_{x}1.weight", rank, c)
                mat(p + f"time_mix_{x}2.weight", c, rank)
            mat(p + "time_mix_g1.weight", hp["g_rank"], c)
            mat(p + "time_mix_g2.weight", c, hp["g_rank"])
            uni(p + "time_mix_k_k.weight", 0.5, 1.0, c)
            uni(p + "time_mix_k_a.weight", 0.5, 1.0, c)
            mat(p + "time_mix_r_k.weight", h, hd, scale=16.0)
            for name in ("key", "value", "receptance", "output"):
                mat(p + f"time_mix_{name}.weight", c, c)
            norm(p + "time_mix_ln")
            if arch == "rwkv7":
                uni(p + "channel_mix_lerp_k.weight", 0.0, 1.0, c)
                mat(p + "channel_mix_key.weight", ff, c)
                mat(p + "channel_mix_value.weight", c, ff)
        if arch in ("rwkv6qwen2", "arwkv7"):
            mat(p + "ffn_gate.weight", ff, c)
            mat(p + "ffn_up.weight", ff, c)
            mat(p + "ffn_down.weight", c, ff)
    w.write()


def _rec_parity(rows, ref_rows, toks) -> dict:
    """Greedy tokens of one path against another's logits on the same
    teacher-forced steps (rows[i], ref_rows[i]: the logits each path gave
    before toks[i]): equal, or the first difference where the reference's
    top-2 gap is within the largest logit difference of the two paths on
    that row (_greedy_parity's rule)."""
    diff = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
               for a, b in zip(rows, ref_rows))
    for i, t in enumerate(toks):
        lp = np.asarray(ref_rows[i])
        if int(np.argmax(lp)) != t:
            top = np.sort(lp)[-2:]
            gap = float(top[1] - top[0])
            row_diff = float(np.abs(np.asarray(rows[i]) - lp).max())
            return {"same": False, "first_diff": i, "ref_gap": gap,
                    "logit_diff": row_diff, "within": gap <= row_diff,
                    "max_logit_diff": diff}
    return {"same": True, "max_logit_diff": diff}


def _rec_forced(ctx_cls, model, prompt, toks) -> list:
    """A single-sequence Context's logits before each of toks, the prompt
    prefilled and toks fed one at a time."""
    ctx = ctx_cls(model)
    rows = [ctx.prefill(prompt)]
    for t in toks[:-1]:
        rows.append(ctx.decode(t))
    return rows


def _rec_pool(torch, ctx_cls, model, rng, n_vocab) -> dict:
    """RecurrentContext on the card: five sequences prefilled, the second
    freed and its row taken again by a new one, then REC_POOL_B rows
    decoded greedily together for REC_NEW steps in an order that is not
    the rows'; each sequence's tokens against its solo Context's logits
    on the same steps (_rec_parity), and the wall ms a batched step."""
    from llama_cpp_test_tpu_torch.runtime.recurrent import RecurrentContext

    ctx = RecurrentContext(model, n_ctx=256, n_seq_max=REC_POOL_B + 1)
    prompts = [rng.integers(1, n_vocab, n).tolist() for n in (8, 13, 21, 32,
                                                              5)]
    seqs = [ctx.new_seq() for _ in prompts]
    last = [ctx.prefill(s, p) for s, p in zip(seqs, prompts)]
    freed = seqs[1].row
    ctx.free_seq(seqs[1])
    seqs[1] = ctx.new_seq()
    check(seqs[1].row == freed, "the pool did not reuse a freed row")
    last[1] = ctx.prefill(seqs[1], prompts[4])
    prompts[1] = prompts[4]
    order = [3, 1, 0, 2]
    check(sorted(seqs[i].row for i in order) != [seqs[i].row for i in order],
          "the batch's rows are in order")
    toks = [[int(np.argmax(last[i]))] for i in range(REC_POOL_B)]
    rows = [[last[i]] for i in range(REC_POOL_B)]
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(REC_NEW - 1):
        lg = ctx.decode([seqs[i] for i in order], [toks[i][-1] for i in order])
        for j, i in enumerate(order):
            rows[i].append(lg[j])
            toks[i].append(int(np.argmax(lg[j])))
    step_ms = (time.time() - t0) * 1e3 / (REC_NEW - 1)
    par = [_rec_parity(rows[i], _rec_forced(ctx_cls, model, prompts[i],
                                            toks[i]), toks[i])
           for i in range(REC_POOL_B)]
    return {"rows": [seqs[i].row for i in order], "freed_row": freed,
            "decode_ms_b4": step_ms, "parity": par}


def _rec_solo(ctx_cls, model, prompt, toks, tol: float) -> dict:
    """Greedy tokens of a batched path against a solo Context's logits on
    the same steps: equal, or the first difference where the solo top-2
    gap is within tol (the largest logit difference of batched and solo
    decode the pool check measured on the file)."""
    for i, lg in enumerate(_rec_forced(ctx_cls, model, prompt, toks)):
        if int(np.argmax(lg)) != toks[i]:
            top = np.sort(lg)[-2:]
            gap = float(top[1] - top[0])
            return {"same": False, "first_diff": i, "solo_gap": gap,
                    "tol": tol, "within": gap <= tol}
    return {"same": True}


def _rec_sched(ctx_cls, model, rng, n_vocab, tol: float) -> dict:
    """The Scheduler over a RecurrentContext: 8 mixed requests (four greedy,
    four seeded) on 4 slots at n_ctx REC_CTX, the longest running past it
    (shift_context must fire); every request finishes by length with its
    tokens, and each greedy request's tokens hold against its solo
    Context's logits (_rec_solo)."""
    from llama_cpp_test_tpu_torch.runtime.recurrent import RecurrentContext
    from llama_cpp_test_tpu_torch.runtime.sampling import SamplerParams
    from llama_cpp_test_tpu_torch.runtime.scheduler import GenRequest, Scheduler

    lens = (4, 9, 16, 24, 6, 12, 20, 32)
    new = [REC_NEW] * 7 + [REC_CTX // 2]      # 32 + 24 tokens: past n_ctx
    ctx = RecurrentContext(model, n_ctx=REC_CTX, n_seq_max=4)
    shifts = []
    shift = ctx.shift_context
    ctx.shift_context = lambda s, keep, n: (shifts.append(n),
                                            shift(s, keep, n))
    sched = Scheduler(ctx, n_slots=4, chunk_size=16)
    reqs = []
    for i, (n, m) in enumerate(zip(lens, new)):
        sp = (SamplerParams(temp=0.0) if i % 2 == 0 or i == 7 else
              SamplerParams(temp=0.8, top_k=40, top_p=0.95, min_p=0.05,
                            seed=i))
        reqs.append(sched.submit(GenRequest(
            rng.integers(1, n_vocab, n).tolist(), max_tokens=m,
            ignore_eos=True, sampling=sp)))
    t0 = time.time()
    sched.run()
    wall = time.time() - t0
    check(all(r.finish_reason == "length" and len(r.output_tokens) == m
              for r, m in zip(reqs, new)),
          f"sched: {[(r.finish_reason, len(r.output_tokens)) for r in reqs]}")
    check(shifts, "sched: no context shift past n_ctx")
    par = [_rec_solo(ctx_cls, model, r.prompt_tokens, r.output_tokens, tol)
           for r in reqs if r.sampling.temp == 0.0]
    m = sched.metrics()
    return {"wall_s": wall, "gen_tok_per_s": m["gen_tok_per_s"],
            "prompt_tok_per_s": m["prompt_tok_per_s"],
            "slow_path_tokens": m["gen_tokens_slow_path"],
            "shifts": len(shifts), "greedy_parity": par}


def _rec_token_bytes(model) -> int:
    """f32 bytes one decoded token reads: every layer tensor and the head
    (the tied embedding once); the embedding row is left out."""
    w = model.weights
    n = sum(t.numel() for ly in w.layers for t in vars(ly).values()
            if t is not None)
    n += w.output.numel()
    n += sum(getattr(w, f).numel() for f in ("output_norm", "output_norm_w",
                                             "output_norm_b", "tok_norm_w",
                                             "tok_norm_b")
             if getattr(w, f, None) is not None)
    return 4 * n


def _rec_file(torch, label, hp, path, nvidia_smi,
              profile: bool = False) -> dict:
    """One recurrent file on the card: a REC_PROMPT-token prefill and
    REC_NEW greedy steps (timed: the wall ms of the prefill and of a
    decoded token at B = 1); the prompt and that continuation prefilled at
    once on the card and on the CPU (the card's weights copied there), the
    prompt's rows within REC_GATE and the CPU's argmax on each
    continuation row the card's token (so the CPU's greedy run gives the
    card's tokens; _rec_parity's near tie otherwise); a prefill of T then
    one decode against a prefill of T + 1; the pool (_rec_pool) and the
    Scheduler (_rec_sched); a device profile of 2 decode steps (with
    profile: 8 steps and the prefill too), the launches a decoded token
    and the decode byte bound. On mamba also the CLI and the server
    (_rec_cli_server).
    seconds_by_check holds where the phase's time went."""
    from llama_cpp_test_tpu_torch.runtime.recurrent import classes

    model_cls, ctx_cls = classes(hp["arch"])
    t0 = time.time()
    model = model_cls(path, device="cuda")
    torch.cuda.synchronize()
    out = {"load_s": time.time() - t0, "card": nvidia_smi}
    secs = out["seconds_by_check"] = {}
    rng = np.random.default_rng(hp["n_vocab"] + hp["n_layer"])
    v = hp["n_vocab"]
    prompt = rng.integers(1, v, REC_PROMPT).tolist()
    t_check = time.time()
    ctx = ctx_cls(model)
    t0 = time.time()
    lg = ctx.prefill(prompt)
    out["prefill_ms"] = (time.time() - t0) * 1e3
    toks, rows = [], [lg]
    t0 = time.time()
    for _ in range(REC_NEW):       # generate()'s greedy loop, timed
        toks.append(int(np.argmax(rows[-1])))
        rows.append(ctx.decode(toks[-1]))
    out["decode_ms_b1"] = (time.time() - t0) * 1e3 / REC_NEW
    seq = prompt + toks[:-1]
    lc = ctx_cls(model).prefill(seq, all_logits=True)
    once = ctx_cls(model).prefill(prompt + toks[:1])
    out["step_vs_once_nmse"] = nmse(rows[1], once)
    secs["card"] = time.time() - t_check
    check(np.isfinite(lc).all() and lc.shape == (len(seq), v),
          f"{label}: logits {lc.shape}, finite {np.isfinite(lc).all()}")
    check(out["step_vs_once_nmse"] < REC_GATE,
          f"{label}: prefill T + decode vs prefill T + 1 NMSE "
          f"{out['step_vs_once_nmse']}")
    t0 = time.time()
    cpu = model_cls.from_weights(model.hp, model.weights, device="cpu")
    lp = ctx_cls(cpu).prefill(seq, all_logits=True)
    del cpu
    secs["cpu"] = time.time() - t0
    out["card_vs_cpu_nmse"] = nmse(lc[:REC_PROMPT], lp[:REC_PROMPT])
    out["card_vs_cpu_nmse_continuation"] = nmse(lc[REC_PROMPT:],
                                                lp[REC_PROMPT:])
    out["greedy_vs_cpu"] = _rec_parity(lc[REC_PROMPT - 1:],
                                       lp[REC_PROMPT - 1:], toks)
    check(out["card_vs_cpu_nmse"] < REC_GATE,
          f"{label}: card vs CPU logits NMSE {out['card_vs_cpu_nmse']}")
    check(out["greedy_vs_cpu"]["same"] or out["greedy_vs_cpu"]["within"],
          f"{label}: card greedy {toks} vs CPU: {out['greedy_vs_cpu']}")
    t0 = time.time()
    out["pool"] = _rec_pool(torch, ctx_cls, model, rng, v)
    secs["pool"] = time.time() - t0
    bad = [p for p in out["pool"]["parity"]
           if not (p["same"] or p["within"])]
    check(not bad, f"{label}: pool decode vs solo: {bad}")
    tol = max(p["max_logit_diff"] for p in out["pool"]["parity"])
    t0 = time.time()
    out["sched"] = _rec_sched(ctx_cls, model, rng, v, tol)
    secs["sched"] = time.time() - t0
    bad = [p for p in out["sched"]["greedy_parity"]
           if not (p["same"] or p["within"])]
    check(not bad, f"{label}: Scheduler greedy vs solo: {bad}")
    t0 = time.time()
    nb = _rec_token_bytes(model)
    out["decode_bytes"] = nb
    out["decode_bound_ms"] = nb / PEAK_BYTES * 1e3
    state = {"ctx": ctx_cls(model)}
    state["ctx"].prefill(prompt)
    n = 8 if profile else 2

    def decode_n():
        for t in toks[:n]:
            state["ctx"].decode(t)

    out["profile"] = {f"decode_{n}_steps": _profiled(torch, decode_n)}
    if profile:
        out["profile"]["prefill_32"] = _profiled(
            torch, lambda: ctx_cls(model).prefill(prompt))
    out["launches_per_token"] = out["profile"][f"decode_{n}_steps"][
        "device_kernel_launches"] / n
    for p in out["profile"].values():
        p["top"] = p["top"][:3]
    secs["profile"] = time.time() - t0
    if hp["arch"] == "mamba":
        t0 = time.time()
        out["entry_points"] = _rec_cli_server(torch, path, model, nvidia_smi)
        secs["entry_points"] = time.time() - t0
    del model
    torch.cuda.empty_cache()
    return out


def _rec_cli_server(torch, path, model, nvidia_smi) -> dict:
    """On the Mamba-130M file (model: the file loaded on the card):
    cli.main's printout (-n REC_NEW) equal to the prompt and the pieces
    generate() gives (to an end of generation),
    and the server over HTTP: one greedy /completion equal to generate(),
    one streamed chat request whose deltas join to the unstreamed reply's
    content and to generate()'s pieces on the chat prompt, /embeddings and
    a slot save answering 400."""
    import io

    from llama_cpp_test_tpu_torch.cli import main as cli
    from llama_cpp_test_tpu_torch.models.mamba import MambaContext, generate
    from llama_cpp_test_tpu_torch.ops import _cuda
    from llama_cpp_test_tpu_torch.server.chat import apply_chat_template

    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["-m", path, "-p", CLI_TEXT, "-n", str(REC_NEW)])
    out = {"cli_wall_s": time.time() - t0}
    tok = model.tokenizer
    ids = tok.encode(CLI_TEXT, add_special=True)
    full = list(generate(MambaContext(model), ids, REC_NEW))
    eog = [i for i, t in enumerate(full) if tok.vocab.is_eog(t)]
    toks = full[:eog[0]] if eog else full
    want = CLI_TEXT + "".join(tok.token_to_piece(t) for t in toks) + "\n"
    out["cli_same_as_generate"] = buf.getvalue() == want
    check(rc == 0 and buf.getvalue() == want,
          f"recurrent cli: rc {rc}, printed {buf.getvalue()!r}, generate() "
          f"gives {want!r}")
    pre, launches = dict(_cuda.LAUNCHES), dict.fromkeys(_cuda.LAUNCHES, 0)
    msgs = [{"role": "user", "content": CLI_TEXT}]
    with _server(path, launches, n_ctx=256, n_slots=2) as (srv, c):
        check(srv.recurrent, "the server did not take the recurrent branch")
        body = {"prompt": CLI_TEXT, "n_predict": REC_NEW, "temperature": 0.0,
                "ignore_eos": True}
        status, got = c.post("/completion", body)
        want = tok.decode(full)
        out["completion_same_as_generate"] = status == 200 and \
            _text(got) == want
        check(out["completion_same_as_generate"],
              f"recurrent /completion: {status} {got} vs {want!r}")
        chat = {"messages": msgs, "max_tokens": 8, "temperature": 0.0,
                "ignore_eos": True}
        chunks = c.stream("/v1/chat/completions", chat)
        streamed = "".join(ch["choices"][0]["delta"].get("content") or ""
                           for ch in chunks)
        status, whole = c.post("/v1/chat/completions", chat)
        pids = srv._tokenize_prompt(apply_chat_template(
            srv.model.reader.metadata, msgs))
        gen = list(generate(MambaContext(model), pids, 8))
        # streamed: the pieces; unstreamed: the decoded text
        out["chat"] = {
            "chunks": len(chunks),
            "finish": chunks[-1]["choices"][0]["finish_reason"],
            "stream_same_as_generate": streamed == "".join(
                tok.token_to_piece(t) for t in gen),
            "same_as_generate": status == 200 and
            whole["choices"][0]["message"]["content"] == tok.decode(gen)}
        check(out["chat"]["finish"] == "length" and
              out["chat"]["stream_same_as_generate"] and
              out["chat"]["same_as_generate"],
              f"recurrent chat: {status} {out['chat']} {streamed!r} {whole}")
        status, _ = c.post("/embeddings", {"content": "hello"})
        out["embeddings_status"] = status
        status, body = c.post("/slots/0?action=save", {})
        out["slot_save_status"] = status
        check(out["embeddings_status"] == 400 and status == 400,
              f"recurrent server: /embeddings {out['embeddings_status']}, "
              f"slot save {status} {body}")
    # the client zeroes the counts before each request (_Http): the
    # phase's own go back, with the server's added
    for k in pre:
        _cuda.LAUNCHES[k] = pre[k] + launches[k]
    out["card"] = nvidia_smi
    return out


def phase_recurrent(torch, nvidia_smi: str, profile: bool = False) -> dict:
    """The recurrent families through the port's entry points on the card,
    plain f32 torch as the reference computes them (no kernel of the
    port's runs, so every launch count stays 0): Mamba-130M (24 layers),
    RWKV-6 World 1.6B (6 of 24), RWKV-7 World 1.5B (2 of 24), QRWKV6-32B
    (1 of 64) and ARWKV-R1-1.5B (2 of 28) at published widths from seeded
    F16 files (write_recurrent_gguf, one shared f16 draw, each file written
    on a host thread while the card checks the one before, and removed
    after its checks), each through
    _rec_file; on Mamba-130M also cli.main and the server
    (_rec_cli_server)."""
    from llama_cpp_test_tpu_torch.ops import _cuda

    before = dict(_cuda.LAUNCHES)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rec_")
    out = {"files": {}}
    ex = ThreadPoolExecutor(max_workers=1)
    try:
        t0 = time.time()
        pool = _F16Pool(np.random.default_rng(150), (1 << 27) + (1 << 22))
        emit({"phase": "recurrent", "pool_s": time.time() - t0})

        def write(label, hp, seed):
            t0 = time.time()
            path = os.path.join(tmp, f"{label}.gguf")
            write_recurrent_gguf(path, hp, seed, pool)
            return path, time.time() - t0

        # each file is written on a host thread while the card checks the
        # one before, in REC_FILES' order (the pool's draws stay in order)
        nxt = ex.submit(write, *REC_FILES[0])
        for i, (label, hp, seed) in enumerate(REC_FILES):
            t0 = time.time()
            path, write_s = nxt.result()
            if i + 1 < len(REC_FILES):
                nxt = ex.submit(write, *REC_FILES[i + 1])
            r = _rec_file(torch, label, hp, path, nvidia_smi, profile=profile)
            os.remove(path)
            r["write_s"] = write_s
            r["seconds"] = time.time() - t0
            emit({"phase": f"recurrent/{label}", **r})
            out["files"][label] = r
    finally:
        ex.shutdown(wait=True, cancel_futures=True)
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {k: _cuda.LAUNCHES[k] - before[k] for k in before}
    check(not any(launches.values()),
          f"recurrent: a kernel of the port launched: {launches}")
    emit({"phase": "recurrent", "seconds": {
        k: round(f["seconds"], 1) for k, f in out["files"].items()},
        "card": nvidia_smi})
    return {"launches": launches, "rows": {}, "files": out["files"]}


# ---------------------------------------------------------------------------
# t5: the encoder-decoder family, plain f32 torch (no kernel)

# google/flan-t5-base config.json: d_model 768, d_kv 64, d_ff 2048, 12
# encoder and 12 decoder layers, 12 heads, 32 buckets, vocab 32128,
# gated-gelu, untied head; full depth
FLAN_T5_BASE = dict(arch="t5", n_vocab=32128, n_embd=768, d_kv=64,
                    n_ff=2048, n_layer=12, n_head=12, n_buckets=32,
                    gated=True, tied=False)
# google-t5/t5-small config.json: d_model 512, d_kv 64, d_ff 2048, 6 + 6
# layers, 8 heads, relu, the tied head scaled by d_model^-0.5; full depth.
# The embedding drawn at std 0.5: at HF's init std 1 the fed token's own
# row wins the tied head, and greedy decoding never leaves <pad>
T5_SMALL = dict(arch="t5", n_vocab=32128, n_embd=512, d_kv=64, n_ff=2048,
                n_layer=6, n_head=8, n_buckets=32, gated=False, tied=True,
                embd_std=0.5)
T5_FILES = (("flan_t5_base", FLAN_T5_BASE, 161), ("t5_small", T5_SMALL, 162),
            ("t5_small_encoder", dict(T5_SMALL, arch="t5encoder"), 162))
T5_PROMPT = 64          # encoder tokens of the card/CPU checks
T5_DECODE = 16          # decoder steps held to the CPU
T5_GEN = 32             # generate()'s and the CLI's -n
T5_CTX = 512            # the decoder cache of the checks and timings
# f32 card against CPU, NMSE, as REC_GATE: TF32 or bf16 products would
# sit orders above it
T5_GATE = 1e-9
T5_TEXT = ("translate English to German: the people of the world could "
           "find water in the little house")


def write_t5_gguf(path: str, hp: dict, seed: int, pool) -> None:
    """A t5 / t5encoder GGUF of geometry hp as the reference's converter
    writes it (enc.blk.* / dec.blk.*, attn_o, attn_rel_b on layer 0 only,
    d_kv key/value lengths, the bucket count, decoder_start_token_id 0):
    matrices F16 (pool slices) at the std of HF T5's initialization to
    the nearest power of two (T5PreTrainedModel._init_weights: q (d_model
    d_kv)^-0.5, k, v and wi d_model^-0.5, o (H d_kv)^-0.5, wo d_ff^-0.5,
    the embedding 1, or hp["embd_std"] where given, an untied head
    d_model^-0.5), norms F32 in [0.95, 1.05], the bucket biases F32
    N(0, 0.5); a synthesized T5 unigram vocab (t5_vocab).
    (At the pool's own std, ~0.024 for every matrix, the unscaled
    attention's logits reach a spread of ~10 and the encoder turns f32
    rounding into an NMSE of ~1e-9 against float64.)"""
    from llama_cpp_test_tpu_torch.gguf.constants import GGMLType
    from llama_cpp_test_tpu_torch.gguf.writer import GGUFWriter

    rng = np.random.default_rng(seed)
    arch, c, v, n_layer = (hp[k] for k in ("arch", "n_embd", "n_vocab",
                                           "n_layer"))
    hd, ff, nb = hp["n_head"] * hp["d_kv"], hp["n_ff"], hp["n_buckets"]
    w = GGUFWriter(path, arch=arch)
    md = {"context_length": 512, "embedding_length": c,
          "block_count": n_layer, "feed_forward_length": ff,
          "attention.head_count": hp["n_head"],
          "attention.key_length": hp["d_kv"],
          "attention.value_length": hp["d_kv"],
          "attention.layer_norm_rms_epsilon": 1e-6,
          "attention.relative_buckets_count": nb,
          "decoder_start_token_id": 0}
    md = {f"{arch}.{k}": val for k, val in md.items()}
    md.update(t5_vocab(v, seed))
    for key, val in md.items():
        w.add_kv(key, val)
    def mat(name, *shape, std):
        scale = 2.0 ** round(float(np.log2(std / F16_POOL_STD)))
        w.add_tensor(name, pool.take(*shape, scale=scale),
                     ggml_type=GGMLType.F16)

    norm = lambda name: w.add_tensor(
        name, rng.uniform(0.95, 1.05, c).astype(np.float32))
    sc, sq, so, sf = c ** -0.5, (c * hp["d_kv"]) ** -0.5, hd ** -0.5, \
        ff ** -0.5

    mat("token_embd.weight", v, c, std=hp.get("embd_std", 1.0))
    if not hp["tied"] and arch == "t5":
        mat("output.weight", v, c, std=sc)
    sides = ("enc", "dec") if arch == "t5" else ("enc",)
    for side in sides:
        norm(f"{side}.output_norm.weight")
        for i in range(n_layer):
            p = f"{side}.blk.{i}."
            norm(p + "attn_norm.weight")
            for name, std in (("attn_q", sq), ("attn_k", sc), ("attn_v", sc)):
                mat(p + name + ".weight", hd, c, std=std)
            mat(p + "attn_o.weight", c, hd, std=so)
            if i == 0:
                w.add_tensor(p + "attn_rel_b.weight", 0.5 * rng.standard_normal(
                    (nb, hp["n_head"])).astype(np.float32))
            if side == "dec":
                norm(p + "cross_attn_norm.weight")
                for name, std in (("cross_attn_q", sq), ("cross_attn_k", sc),
                                  ("cross_attn_v", sc)):
                    mat(p + name + ".weight", hd, c, std=std)
                mat(p + "cross_attn_o.weight", c, hd, std=so)
            norm(p + "ffn_norm.weight")
            if hp["gated"]:
                mat(p + "ffn_gate.weight", ff, c, std=sc)
            mat(p + "ffn_up.weight", ff, c, std=sc)
            mat(p + "ffn_down.weight", c, ff, std=sf)
    w.write()


def _t5_encode_flops(hp: dict, t: int) -> float:
    """Multiply-adds x 2 of the encoder over t tokens: every block's
    projections and FFN, its attention products (QK^T and PV)."""
    c, hd, ff = hp["n_embd"], hp["n_head"] * hp["d_kv"], hp["n_ff"]
    per = 4 * c * hd + (3 if hp["gated"] else 2) * c * ff
    return hp["n_layer"] * (2.0 * t * per + 4.0 * t * t * hd)


def _t5_step_bytes(model, n_enc: int, t: int) -> int:
    """f32 bytes one decoder step at position t reads: the decoder's
    tensors but the cross K/V projections (applied once, at encode) and
    the head (the embedding row left out), the cross K/V of n_enc encoder
    rows and t + 1 rows of the self cache, each once."""
    hp = model.hp
    n = sum(x.numel() for b in model.dec for k, x in vars(b).items()
            if x is not None and k not in ("cross_wk", "cross_wv"))
    n += model.dec_norm.numel()
    n += (model.output if model.output is not None else model.tok_embd
          ).numel()
    kv = 2 * hp.n_layer * hp.n_head * hp.d_kv * (n_enc + t + 1)
    return 4 * (n + kv)


def _t5_forced(ctx, start: int, toks) -> list:
    """The decoder's logits before each of toks, fed start then toks[:-1]
    (the prompt encoded already)."""
    ctx.reset_decoder()
    feed = [start] + list(toks[:-1])
    return [ctx.decode(t) for t in feed]


def _t5_timings(torch, model, hp, rng) -> dict:
    """The encoder's wall and busy ms at T = 64 and 512 against the f32
    flop bound, and a decoder step's wall, busy ms and launches at n_ctx
    T5_CTX against the f32 byte bound; the idle shares."""
    from llama_cpp_test_tpu_torch.models.t5 import T5Context, encode_hidden

    out = {}
    v = hp["n_vocab"]
    for t in (T5_PROMPT, 512):
        ids = rng.integers(3, v - 100, t).tolist()
        encode_hidden(model, ids)                      # warm-up
        torch.cuda.synchronize()
        t0 = time.time()
        encode_hidden(model, ids)
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
        prof = _profiled(torch, lambda: encode_hidden(model, ids))
        flops = _t5_encode_flops(hp, t)
        out[f"encode_{t}"] = {
            "wall_ms": wall, "busy_ms": prof["device_busy_ms"],
            "idle_share": 1.0 - prof["device_busy_ms"] / wall,
            "launches": prof["device_kernel_launches"],
            "gflop": flops / 1e9, "f32_bound_ms": flops / PEAK_FP32 * 1e3,
            "top": prof["top"][:3]}
    if model.dec is None:
        return out
    ctx = T5Context(model, n_ctx=T5_CTX)
    ctx.encode(rng.integers(3, v - 100, T5_PROMPT).tolist())
    tok, n = 0, T5_GEN
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(n):
        tok = int(np.argmax(ctx.decode(tok)))
    wall = (time.time() - t0) * 1e3 / n
    state = {"tok": tok}

    def decode8():
        for _ in range(8):
            state["tok"] = int(np.argmax(ctx.decode(state["tok"])))

    prof = _profiled(torch, decode8)
    nb = _t5_step_bytes(model, T5_PROMPT, n + 4)
    out["decode"] = {
        "n_ctx": T5_CTX, "position": n, "wall_ms": wall,
        "busy_ms": prof["device_busy_ms"] / 8,
        "idle_share": prof["idle_share"],
        "launches_per_token": prof["device_kernel_launches"] / 8,
        "bytes": nb, "f32_bound_ms": nb / PEAK_BYTES * 1e3,
        "top": prof["top"][:3]}
    return out


def _t5_cli(torch, path, model) -> dict:
    """cli.main on the file: a t5 file's printout equal to generate()'s
    pieces (-n T5_GEN, EOS the vocab's) and not empty, a t5encoder file
    returning 1 with the reference's message."""
    import io

    from llama_cpp_test_tpu_torch.cli import main as cli
    from llama_cpp_test_tpu_torch.models.t5 import T5Context, generate

    buf, err = io.StringIO(), io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        rc = cli.main(["-m", path, "-p", T5_TEXT, "-n", str(T5_GEN)])
    out = {"rc": rc, "wall_s": time.time() - t0}
    if model.dec is None:
        msg = "t5encoder GGUFs are embedding-only"
        out["message"] = msg in err.getvalue()
        check(rc == 1 and not buf.getvalue() and out["message"],
              f"t5encoder cli: rc {rc}, {buf.getvalue()!r}, "
              f"{err.getvalue()!r}")
        return out
    tok = model.tokenizer
    ids = tok.encode(T5_TEXT, add_special=True)
    check(ids[-1] == tok.vocab.eos_id, "T5's encode did not end with </s>")
    toks = list(generate(T5Context(model, n_ctx=max(64, T5_GEN + 8)), ids,
                         T5_GEN, eos_id=tok.vocab.eos_id))
    want = "".join(tok.token_to_piece(t) for t in toks) + "\n"
    out.update(prompt_tokens=len(ids), generated=len(toks),
               distinct_tokens=sorted(set(toks)),
               same_as_generate=buf.getvalue() == want)
    check(rc == 0 and out["same_as_generate"],
          f"t5 cli: rc {rc}, printed {buf.getvalue()!r}, generate() gives "
          f"{want!r}")
    check(buf.getvalue().strip(), f"t5 cli: printed no piece ({toks})")
    return out


def _t5_file(torch, label, hp, path, nvidia_smi) -> dict:
    """One T5 file on the card, its weights copied to the CPU: a
    T5_PROMPT-token encode on both within T5_GATE; on a t5 file T5_DECODE
    greedy decoder steps on the card (fed its own tokens) against the CPU
    fed the same tokens, every step within T5_GATE and the CPU's argmax
    the card's token, greedy leaving the start token; generate() and
    cli.main (_t5_cli); the timings (_t5_timings)."""
    from llama_cpp_test_tpu_torch.models.t5 import T5Context, T5Model

    t0 = time.time()
    model = T5Model(path, device="cuda")
    torch.cuda.synchronize()
    out = {"load_s": time.time() - t0, "n_layer": hp["n_layer"],
           "card": nvidia_smi}
    secs = out["seconds_by_check"] = {}
    t0 = time.time()
    cpu = T5Model.from_weights(model.hp, model, device="cpu")
    secs["cpu_copy"] = time.time() - t0
    rng = np.random.default_rng(hp["n_embd"] + hp["n_layer"])
    prompt = rng.integers(3, hp["n_vocab"] - 100, T5_PROMPT).tolist()
    ctx, ctx_p = T5Context(model, n_ctx=T5_CTX), T5Context(cpu, n_ctx=T5_CTX)
    t0 = time.time()
    enc_k, enc_p = ctx.encode(prompt), ctx_p.encode(prompt)
    out["encode_nmse"] = nmse(enc_k, enc_p)
    check(np.isfinite(enc_k).all() and enc_k.shape == (T5_PROMPT,
                                                        hp["n_embd"]),
          f"{label}: encoder output {enc_k.shape}")
    check(out["encode_nmse"] < T5_GATE,
          f"{label}: encode card vs CPU NMSE {out['encode_nmse']}")
    if model.dec is not None:
        start, toks, rows = model.hp.dec_start_token, [], []
        tok = start
        for _ in range(T5_DECODE):
            rows.append(ctx.decode(tok))
            tok = int(np.argmax(rows[-1]))
            toks.append(tok)
        rows_p = _t5_forced(ctx_p, start, toks)
        errs = [nmse(a, b) for a, b in zip(rows, rows_p)]
        argmax = [int(np.argmax(r)) for r in rows_p]
        out.update(decode_nmse_max=max(errs), tokens=toks,
                   distinct_tokens=sorted(set(toks)),
                   cpu_argmax_same=argmax == toks)
        check(set(toks) != {start}, f"{label}: greedy decoding stays on "
                                    f"the start token {start}")
        check(all(np.isfinite(r).all() and r.shape == (hp["n_vocab"],)
                  for r in rows), f"{label}: decoder logits")
        check(max(errs) < T5_GATE,
              f"{label}: decode card vs CPU NMSE {errs}")
        check(argmax == toks, f"{label}: card tokens {toks}, CPU argmax "
                              f"{argmax}")
    secs["card_vs_cpu"] = time.time() - t0
    del cpu, ctx_p
    t0 = time.time()
    out["cli"] = _t5_cli(torch, path, model)
    secs["cli"] = time.time() - t0
    t0 = time.time()
    out["timings"] = _t5_timings(torch, model, hp, rng)
    secs["timings"] = time.time() - t0
    del model, ctx
    torch.cuda.empty_cache()
    return out


def phase_t5(torch, nvidia_smi: str) -> dict:
    """The encoder-decoder family through the port's entry points on the
    card, plain f32 torch as the reference computes it (no kernel of the
    port's runs, so every launch count stays 0): flan-t5-base (gated-gelu,
    untied head) and t5-small (relu, the scaled tied head) at published
    widths and full depth, and t5-small's encoder as a t5encoder file,
    from seeded F16 files (write_t5_gguf, one shared f16 draw) with a
    synthesized T5 unigram vocab, each through _t5_file."""
    from llama_cpp_test_tpu_torch.ops import _cuda

    before = dict(_cuda.LAUNCHES)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_t5_")
    out = {"files": {}}
    try:
        pool = _F16Pool(np.random.default_rng(160), 1 << 25)
        for label, hp, seed in T5_FILES:
            t0 = time.time()
            path = os.path.join(tmp, f"{label}.gguf")
            write_t5_gguf(path, hp, seed, pool)
            write_s = time.time() - t0
            r = _t5_file(torch, label, hp, path, nvidia_smi)
            os.remove(path)
            r["write_s"] = write_s
            r["seconds"] = time.time() - t0
            emit({"phase": f"t5/{label}", **r})
            out["files"][label] = r
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {k: _cuda.LAUNCHES[k] - before[k] for k in before}
    check(not any(launches.values()),
          f"t5: a kernel of the port launched: {launches}")
    emit({"phase": "t5", "seconds": {
        k: round(f["seconds"], 1) for k, f in out["files"].items()},
        "card": nvidia_smi})
    return {"launches": launches, "rows": {}, "files": out["files"]}


# ---------------------------------------------------------------------------
# tts: the OuteTTS text-to-codes LLM (K1, K2, K3) and the WavTokenizer
# vocoder (plain f32 torch)

# novateur/WavTokenizer-large-speech-75token as llama.cpp's converter
# writes it (the vocoder of its tts example): features 512, posnet 768 x
# 6, convnext 768 x 12, FFN 2304, 4096 codes, n_fft 1280 (head 1282), hop
# 320, 32 groups; F16 matrices, full depth
WAVTOK_75 = dict(features=512, posnet=768, posnet_layers=6, convnext=768,
                 convnext_layers=12, n_ff=2304, n_codes=4096, n_fft=1280,
                 groups=32)
TTS_HOP = 320           # 24 kHz / 75 codes a second
TTS_RATE = 24000
TTS_CODES = 750         # 10 s of audio through the vocoder on card and CPU
# OuteTTS-0.2-500M (OuteAI/OuteTTS-0.2-500M config.json): Qwen2.5-0.5B's
# body, 896 wide, 14 heads on 2 KV (head 64), FFN 4864, Q/K/V biases,
# rope base 1e6, tied head, vocab 157696; Q8_0 as the tts example's file;
# depth cut from 24 to 2 layers for the clock
OUTETTS_500M = dict(arch="qwen2", n_vocab=157696, n_embd=896, n_head=14,
                    n_head_kv=2, head_dim=64, n_layer=2, n_ff=4864,
                    rope_base=1e6, rms_eps=1e-6, tied=True, qkv_bias=True)
TTS_CHAIN = 40          # codes the OuteTTS file's greedy decoding walks
TTS_TEXT = "Hello world, the people could find water"
TTS_N = 64              # the CLI's -n: the chain ends on <|audio_end|> first


def write_wavtokenizer_gguf(path: str, spec: dict, seed: int, pool) -> None:
    """A wavtokenizer-dec GGUF of geometry spec as llama.cpp's converter
    lays it out: matrices and convolution kernels F16 (pool slices), norms
    F32 in [0.95, 1.05], biases F32 N(0, 0.02), convnext gamma F32 in
    [0.05, 0.15]."""
    from llama_cpp_test_tpu_torch.gguf.constants import GGMLType
    from llama_cpp_test_tpu_torch.gguf.writer import GGUFWriter

    rng = np.random.default_rng(seed)
    a = "wavtokenizer-dec"
    fe, pe, ce, ff = (spec[k] for k in ("features", "posnet", "convnext",
                                        "n_ff"))
    w = GGUFWriter(path, arch=a)
    for k, v in {"features_length": fe, "embedding_length": ce,
                 "posnet.embedding_length": pe,
                 "posnet.block_count": spec["posnet_layers"],
                 "convnext.embedding_length": ce,
                 "convnext.block_count": spec["convnext_layers"],
                 "feed_forward_length": ff,
                 "attention.group_norm_epsilon": 1e-6,
                 "attention.group_norm_groups": spec["groups"],
                 "attention.layer_norm_epsilon": 1e-6,
                 "vocab_size": spec["n_codes"]}.items():
        w.add_kv(f"{a}.{k}", v)
    mat = lambda name, *shape: w.add_tensor(name, pool.take(*shape),
                                            ggml_type=GGMLType.F16)
    vec = lambda name, n, lo, hi: w.add_tensor(
        name, rng.uniform(lo, hi, n).astype(np.float32))
    bias = lambda name, n: w.add_tensor(
        name, 0.02 * rng.standard_normal(n).astype(np.float32))

    def norm(p, n):
        vec(p + ".weight", n, 0.95, 1.05)
        bias(p + ".bias", n)

    mat("token_embd.weight", spec["n_codes"], fe)
    mat("conv1d.weight", pe, fe, 7)
    bias("conv1d.bias", pe)
    norm("token_embd_norm", pe)
    norm("output_norm", ce)
    mat("output.weight", spec["n_fft"] + 2, ce)
    bias("output.bias", spec["n_fft"] + 2)
    for i in range(spec["posnet_layers"]):
        p = f"posnet.{i}."
        if i == 2:
            norm(p + "attn_norm", pe)
            for name in ("attn_q", "attn_k", "attn_v", "attn_output"):
                mat(p + name + ".weight", pe, pe, 1)
                bias(p + name + ".bias", pe)
        elif i == spec["posnet_layers"] - 1:
            norm(p + "norm", pe)
        else:
            for j in (1, 2):
                norm(p + f"norm{j}", pe)
                mat(p + f"conv{j}.weight", pe, pe, 3)
                bias(p + f"conv{j}.bias", pe)
    for i in range(spec["convnext_layers"]):
        p = f"convnext.{i}."
        mat(p + "dw.weight", ce, 1, 7)
        bias(p + "dw.bias", ce)
        norm(p + "norm", ce)
        mat(p + "pw1.weight", ff, ce)
        bias(p + "pw1.bias", ff)
        mat(p + "pw2.weight", ce, ff)
        bias(p + "pw2.bias", ce)
        vec(p + "gamma", ce, 0.05, 0.15)
    w.write()


def _vocoder_flops(spec: dict, t: int) -> float:
    """Multiply-adds x 2 of the vocoder over t codes: the input conv, the
    posnet's convolutions and 1x1-conv attention (its two T x T products
    too), the convnext stack and the head."""
    fe, pe, ce, ff = (spec[k] for k in ("features", "posnet", "convnext",
                                        "n_ff"))
    n_res = spec["posnet_layers"] - 2
    macs = t * pe * fe * 7 + n_res * 2 * t * pe * pe * 3 + \
        4 * t * pe * pe + 2 * t * t * pe + \
        spec["convnext_layers"] * (t * ce * 7 + 2 * t * ce * ff) + \
        t * ce * (spec["n_fft"] + 2)
    return 2.0 * macs


def _vocoder(torch, path, nvidia_smi) -> dict:
    """The vocoder file on the card and its tensors copied to the CPU:
    TTS_CODES seeded codes decoded on both (with cuDNN's TF32 allowed, as
    torch leaves it: decode_codes turns it off for its convolutions), the
    spectra and the host iSTFT's audio within T5_GATE; the wall and busy
    ms of decode_codes, the iSTFT's wall, the real-time factor (audio
    seconds a wall second) and the f32 flop bound. Returns (model,
    readings)."""
    from llama_cpp_test_tpu_torch.models import wavtokenizer as wt

    t0 = time.time()
    voc = wt.load_wavtokenizer(path, device="cuda")
    torch.cuda.synchronize()
    out = {"load_s": time.time() - t0, "card": nvidia_smi}
    check(voc.n_fft == WAVTOK_75["n_fft"] and
          voc.n_codes == WAVTOK_75["n_codes"],
          f"vocoder: n_fft {voc.n_fft}, {voc.n_codes} codes")
    codes = np.random.default_rng(171).integers(0, voc.n_codes, TTS_CODES)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        embd = wt.decode_codes(voc, codes)              # warm-up, and the output
        torch.cuda.synchronize()
        t0 = time.time()
        wt.decode_codes(voc, codes)
        decode_ms = (time.time() - t0) * 1e3
        prof = _profiled(torch, lambda: wt.decode_codes(voc, codes))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    t0 = time.time()
    cpu = wt.convert(voc, "cpu")
    embd_p = wt.decode_codes(cpu, codes)
    out["cpu_s"] = time.time() - t0
    del cpu
    t0 = time.time()
    audio = wt.embd_to_audio(embd, n_fft=voc.n_fft, n_hop=TTS_HOP)
    istft_ms = (time.time() - t0) * 1e3
    audio_p = wt.embd_to_audio(embd_p, n_fft=voc.n_fft, n_hop=TTS_HOP)
    flops = _vocoder_flops(WAVTOK_75, TTS_CODES)
    seconds = audio.size / TTS_RATE
    out.update(codes=TTS_CODES, spectrum_nmse=nmse(embd, embd_p),
               audio_nmse=nmse(audio, audio_p), samples=int(audio.size),
               audio_s=seconds, decode_wall_ms=decode_ms,
               decode_busy_ms=prof["device_busy_ms"],
               idle_share=1.0 - prof["device_busy_ms"] / decode_ms,
               launches=prof["device_kernel_launches"], istft_ms=istft_ms,
               rtf=seconds / ((decode_ms + istft_ms) / 1e3),
               gflop=flops / 1e9, f32_bound_ms=flops / PEAK_FP32 * 1e3,
               top=prof["top"][:4])
    check(np.isfinite(embd).all() and embd.shape == (TTS_CODES,
                                                     voc.n_fft + 2),
          f"vocoder: spectra {embd.shape}")
    check(audio.size == TTS_CODES * TTS_HOP,
          f"vocoder: {audio.size} samples for {TTS_CODES} codes")
    check(out["spectrum_nmse"] < T5_GATE and out["audio_nmse"] < T5_GATE,
          f"vocoder: card vs CPU NMSE {out['spectrum_nmse']} (spectra), "
          f"{out['audio_nmse']} (audio)")
    return voc, out


def _tts_chain(vocab: dict, seed: int) -> tuple:
    """The OuteTTS file's greedy walk (chain_rows): the prompt's last
    token ('\\n', byte token 10), TTS_CHAIN seeded distinct codes with a
    timing token past the code range among them, then <|audio_end|>.
    Returns (the chain, the codes the CLI keeps)."""
    rng = np.random.default_rng(seed)
    codes = rng.choice(WAVTOK_75["n_codes"], TTS_CHAIN, replace=False)
    toks = vocab["tokenizer.ggml.tokens"]
    timing = toks.index("<|t_0.07|>")
    ids = [CODE_TOKEN_OFFSET + int(c) for c in codes]
    ids.insert(TTS_CHAIN // 2, timing)
    return [10] + ids + [toks.index("<|audio_end|>")], codes.astype(np.int32)


def _tts_prediction(model, n_steps: int) -> dict:
    """The launches cli.tts's LLM half must make: the prompt's prefill (one
    chunk) launches K2 once a layer, K1's GEMM once a quantized projection
    plane and its GEMV once for the head (the last position alone); each
    of n_steps decode steps K1's GEMV once a plane and the head
    (_k1_per_step) and K3 once a layer."""
    n_layer, k1 = model.hp.n_layer, _k1_per_step(model)
    return {"flash_prefill": n_layer, "qmm_gemm": k1 - 1,
            "qmm_gemv": 1 + k1 * n_steps, "paged_decode": n_layer * n_steps,
            "paged_decode_q8": 0, "qmm_cache": 0, "gmm_gemv": 0,
            "gmm_gemm": 0}


def _read_wav(path) -> tuple:
    import wave

    with wave.open(path, "rb") as f:
        head = (f.getnchannels(), f.getsampwidth(), f.getframerate())
        return head, np.frombuffer(f.readframes(f.getnframes()), np.int16)


@contextlib.contextmanager
def _record_branches():
    """Collect each layer's attention branch (after wo and its bias) and
    FFN branch (before the down bias), float32 on the host [T, C], as
    (role, array) in call order, by wrapping models.llama._attention and
    _ffn while the block runs: what the layers add to the residual,
    apart from the embedding row it carries."""
    from llama_cpp_test_tpu_torch.models import llama

    orig_attn, orig_ffn, calls = llama._attention, llama._ffn, []

    def attn(*a, **kw):
        y = orig_attn(*a, **kw)
        calls.append(("attn", y[0].float().cpu().numpy()))
        return y

    def ffn(*a, **kw):
        y = orig_ffn(*a, **kw)
        calls.append(("ffn", y[0].float().cpu().numpy()))
        return y

    llama._attention, llama._ffn = attn, ffn
    try:
        yield calls
    finally:
        llama._attention, llama._ffn = orig_attn, orig_ffn


def _branch_nmse(calls_p, calls_k, n_layer: int, n_prompt: int) -> dict:
    """The kernel path's attention and FFN branches (_record_branches)
    against the plain path's, one NMSE a step and role over every layer
    at the step's real positions (the prompt's n_prompt in the prefill,
    one row a decode step)."""
    per = 2 * n_layer
    out = {"attn": [], "ffn": []}
    check(len(calls_p) == len(calls_k) and len(calls_p) % per == 0,
          f"branches: {len(calls_p)} plain and {len(calls_k)} kernel calls")
    for i in range(0, len(calls_p), per):
        for role, errs in out.items():
            pairs = [(p[:n_prompt], k[:n_prompt]) for (r, p), (_, k) in
                     zip(calls_p[i:i + per], calls_k[i:i + per])
                     if r == role]
            errs.append(nmse(np.concatenate([p for p, _ in pairs]),
                             np.concatenate([k for _, k in pairs])))
    return out


def _tts_llm(torch, kc, path, voc_path, voc, chain, codes, tmp,
             nvidia_smi) -> dict:
    """The OuteTTS file: cli.tts's greedy text-to-codes loop
    (generate_codes) on a kernel Context with the launch counts zeroed,
    held to the path's prediction, its tokens the designed chain; the
    kernel and the plain paths teacher-forced on those tokens
    (_launch_counts, the kernel path's launches those of generate_codes):
    every step's logits within LOGITS_GATE, the greedy tokens by
    _greedy_parity, and every step's attention and FFN branches
    (_record_branches) within LOGITS_GATE, which the designed embedding
    rows cannot hide; then cli.tts.main end to end (launches as
    predicted; the WAV at 24 kHz, TTS_HOP samples a kept code, equal
    within 1 LSB to decode_codes + embd_to_audio of those codes) and
    --codes mode on the same codes; K1's int8 GEMV row on a random Q8_0
    plane at the head's geometry."""
    import io

    from llama_cpp_test_tpu_torch.cli import tts
    from llama_cpp_test_tpu_torch.gguf.constants import GGMLType
    from llama_cpp_test_tpu_torch.models import wavtokenizer as wt
    from llama_cpp_test_tpu_torch.ops import _cuda
    from llama_cpp_test_tpu_torch.runtime.engine import Context, Model
    from llama_cpp_test_tpu_torch.weights import qtensor_to_torch

    t0 = time.time()
    model = Model(path, device="cuda")
    out = {"load_s": time.time() - t0, "n_layer": model.hp.n_layer,
           "card": nvidia_smi}
    ctx = lambda **kw: Context(model, n_ctx=512, n_seq_max=1, **kw)
    c = ctx()
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.time()
    toks = tts.generate_codes(model, c, TTS_TEXT, TTS_N)
    torch.cuda.synchronize()
    out["generate_s"] = time.time() - t0
    launches = dict(_cuda.LAUNCHES)
    want = _tts_prediction(model, len(toks))
    out.update(tokens=len(toks), launches=launches, predicted=want,
               chain_walked=toks == chain[1:-1])
    check(out["chain_walked"], f"tts: greedy tokens {toks}, the file's "
                               f"chain {chain[1:-1]}")
    for k, n in want.items():
        check(launches[k] == n, f"tts: {k} launched {launches[k]} times, "
                                f"the path predicts {n}")
    # the kernel and the plain paths teacher-forced on those tokens
    ids = model.tokenizer.encode(tts.build_prompt(TTS_TEXT),
                                 add_special=True)
    with _record_branches() as br_k:
        got = _launch_counts(torch, ctx(), ids, len(toks), toks)
    with _record_branches() as br_p:
        plain = _launch_counts(torch, ctx(plain=True), ids, len(toks), toks)
    forced = {k: got["prefill"][k] + got["decode"][k] for k in launches}
    check(forced == launches, f"tts: teacher-forced launches {forced}, "
                              f"generate_codes {launches}")
    rows_k, rows_p = got["rows"], plain["rows"]
    errs = [nmse(a, b) for a, b in zip(rows_p, rows_k)]
    parity = _greedy_parity([r[None] for r in rows_k],
                            [r[None] for r in rows_p], toks)
    branches = _branch_nmse(br_p, br_k, model.hp.n_layer, len(ids))
    out.update(logits_nmse_max=max(errs), gate=LOGITS_GATE, greedy=parity,
               attn_nmse_max=max(branches["attn"]),
               ffn_nmse_max=max(branches["ffn"]))
    check(all(np.isfinite(r).all() for r in rows_k) and
          max(errs) < LOGITS_GATE, f"tts: logits off the plain path: {errs}")
    check(parity["same"] or parity["within"],
          f"tts: greedy tokens differ past the logit difference: {parity}")
    check(out["attn_nmse_max"] < LOGITS_GATE and
          out["ffn_nmse_max"] < LOGITS_GATE,
          f"tts: layer branches off the plain path: {branches}")
    kept = tts.audio_codes(toks, voc.n_codes)
    check(np.array_equal(kept, codes), f"tts: kept codes {kept.tolist()}")
    # the CLI end to end, then --codes on the same codes
    wav, wav2 = os.path.join(tmp, "tts.wav"), os.path.join(tmp, "codes.wav")
    argv = ["-m", path, "-mv", voc_path, "-p", TTS_TEXT, "-n", str(TTS_N),
            "-c", "512", "-o", wav]
    err = io.StringIO()
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.time()
    with contextlib.redirect_stderr(err):
        rc = tts.main(argv)
    torch.cuda.synchronize()
    out["cli_wall_s"] = time.time() - t0
    out["cli_launches"] = dict(_cuda.LAUNCHES)
    with contextlib.redirect_stderr(err):
        rc2 = tts.main(["-mv", voc_path, "--codes",
                        ",".join(str(x) for x in codes), "-o", wav2])
    check(rc == rc2 == 0, f"tts cli: rc {rc}, --codes rc {rc2}: "
                          f"{err.getvalue()!r}")
    check(out["cli_launches"] == launches,
          f"tts cli: launches {out['cli_launches']}, generate_codes "
          f"{launches}")
    check(f"# generated {len(codes)} audio codes" in err.getvalue(),
          f"tts cli: {err.getvalue()!r}")
    (head, pcm), (head2, pcm2) = _read_wav(wav), _read_wav(wav2)
    ref = os.path.join(tmp, "ref.wav")
    wt.write_wav(ref, wt.embd_to_audio(wt.decode_codes(voc, codes),
                                       n_fft=voc.n_fft, n_hop=TTS_HOP))
    _, pcm_ref = _read_wav(ref)
    out.update(wav_header=head, samples=int(pcm.size),
               wav_vs_decode_lsb=int(np.abs(pcm.astype(np.int32)
                                            - pcm_ref).max()),
               codes_mode_lsb=int(np.abs(pcm2.astype(np.int32)
                                         - pcm_ref).max()))
    check(head == head2 == (1, 2, TTS_RATE) and
          pcm.size == pcm2.size == len(codes) * TTS_HOP,
          f"tts wav: {head} {pcm.size}, --codes {head2} {pcm2.size}")
    check(out["wav_vs_decode_lsb"] <= 1 and out["codes_mode_lsb"] <= 1,
          f"tts wav off decode_codes + embd_to_audio: "
          f"{out['wav_vs_decode_lsb']}, {out['codes_mode_lsb']} LSB")
    # a profile of the prefill and 8 decode steps
    c2 = ctx()
    s2 = c2.new_seq()

    def prefill_decode8():
        c2.prefill(s2, ids)
        for t in toks[:8]:
            c2.decode([s2], [t])

    prof = _profiled(torch, prefill_decode8)
    out["profile_prefill_decode8"] = {
        k: prof[k] for k in ("wall_ms", "device_busy_ms", "idle_share",
                             "gemv_ms", "device_kernel_launches")}
    del model, c, c2
    torch.cuda.empty_cache()
    # K1 at the head's geometry on a random plane: the file's head carries
    # the designed rows, whose outputs would dwarf the others' in the NMSE
    head = _qmm_planes(np.random.default_rng(177), OUTETTS_500M,
                       GGMLType.Q8_0, ["lm_head"])["lm_head"]
    out["rows"] = {"OuteTTS head M=1": kc.qmm(
        "OuteTTS-0.2-500M lm head", "int8", qtensor_to_torch(head, "cuda"),
        1)}
    return out


def phase_tts(torch, kc, nvidia_smi: str) -> dict:
    """llama-tts on the card: WavTokenizer-large-75 (F16, full depth;
    _vocoder: 750 codes on card and CPU) and OuteTTS-0.2-500M (Q8_0 at
    published widths, 2 of 24 layers; _tts_llm through cli.tts). Random
    weights land the argmax anywhere, so the OuteTTS file's tied
    embedding carries designed rows (chain_rows): greedy decoding after
    the prompt walks TTS_CHAIN seeded codes, with a timing token past the
    code range among them (the port drops it, ROADMAP §3 fault 26), then
    <|audio_end|>, which ends the loop before -n."""
    from llama_cpp_test_tpu_torch.ops import _cuda

    tmp = tempfile.mkdtemp(prefix="chip_smoke_tts_")
    out = {"rows": {}}
    try:
        t0 = time.time()
        pool = _F16Pool(np.random.default_rng(170), 1 << 23)
        voc_path = os.path.join(tmp, "wavtokenizer_75.gguf")
        write_wavtokenizer_gguf(voc_path, WAVTOK_75, 172, pool)
        write_s = time.time() - t0
        voc, out["vocoder"] = _vocoder(torch, voc_path, nvidia_smi)
        out["vocoder"]["write_s"] = write_s
        out["vocoder"]["seconds"] = time.time() - t0
        emit({"phase": "tts/vocoder", **out["vocoder"]})
        t0 = time.time()
        vocab = outetts_vocab(OUTETTS_500M["n_vocab"], 173)
        chain, codes = _tts_chain(vocab, 174)
        path = os.path.join(tmp, "outetts_500m.gguf")
        write_llama_gguf(path, dict(OUTETTS_500M, embd_rows=chain_rows(
            OUTETTS_500M["n_embd"], chain, 175)), seed=176, ftype="Q8_0",
            vocab=vocab)
        write_s = time.time() - t0
        r = _tts_llm(torch, kc, path, voc_path, voc, chain, codes, tmp,
                     nvidia_smi)
        r["write_s"] = write_s
        r["seconds"] = time.time() - t0
        out["rows"] = r.pop("rows")
        out["llm"] = r
        emit({"phase": "tts/outetts", **r})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(not kc.failures, f"kernels outside their gate: {kc.failures}")
    out["launches"] = out["llm"]["cli_launches"]
    missing = [k for k in DENSE_PATH if out["launches"][k] <= 0]
    check(not missing, f"tts: kernels not launched: {missing}")
    emit({"phase": "tts", "seconds": {
        "vocoder": round(out["vocoder"]["seconds"], 1),
        "outetts": round(out["llm"]["seconds"], 1)}, "card": nvidia_smi})
    return out


# TinyLlama-1.1B at its published widths as an F16 file, depth cut from
# 22 to 1 layer for the smoke's clock: the quantize phase's source
QUANT_HP = dict(TINYLLAMA, n_layer=1)
QUANT_FTYPE = "Q4_K_M"
QUANT_WORDS = 1100          # seeded calibration words: ~1670 tokens
QUANT_PROMPT = 130          # prefill tokens of the serve checks
QUANT_SPLIT = 4             # tensors a shard of the split check


def _plane_equal(a, b) -> bool:
    """Two host QTensors of one tensor: the same layout and bits."""
    return (a.kind, a.shape, a.group, a.layout) == (
        b.kind, b.shape, b.group, b.layout) and all(
        (x is None and y is None) or (x is not None and y is not None and
                                      x.dtype == y.dtype and
                                      np.array_equal(x, y))
        for x, y in ((a.qs, b.qs), (a.scale, b.scale), (a.min_, b.min_)))


def _load_host(path, native: bool) -> tuple:
    """models.llama.load_weights of the file at path with the native
    repack on or off (host planes, no device): (seconds, weights)."""
    from llama_cpp_test_tpu_torch.gguf.reader import open_gguf
    from llama_cpp_test_tpu_torch.models import llama
    from llama_cpp_test_tpu_torch.quant import repack

    orig = repack.NATIVE
    repack.NATIVE = native
    try:
        with open_gguf(path) as r:
            t0 = time.time()
            _, w = llama.load_weights(r)
            return time.time() - t0, w
    finally:
        repack.NATIVE = orig


def _quant_serve(torch, model, prompt) -> dict:
    """The quantized file served on the card: a prefill of the prompt and
    QUIRK_DECODE greedy steps with K1's GEMV and GEMM, K2 and K3 launched
    as the path predicts (_path_prediction, plus K1's GEMM once a layer
    plane and its GEMV once for the head in the prefill), the logits of
    every prefill row and decode step within the gate of the plain path
    (_kernels_vs_plain), and the greedy tokens against the plain path's
    own greedy decode at the same batch (_greedy_parity)."""
    from llama_cpp_test_tpu_torch.runtime.engine import Context

    pred = _path_prediction(torch, model, prompt, 1024)
    planes = _k1_per_step(model) - 1            # the head is one plane
    want = {"qmm_gemm": planes, "qmm_gemv": 1}
    for k, n in want.items():
        got = pred["launches"]["prefill"][k]
        check(got == n, f"quantize: {k} launched {got} times in the "
                        f"prefill, the path predicts {n}")
    pred["predicted"]["prefill"].update(want)
    checks, bad = _kernels_vs_plain(model, prompt, [("bf16", None)],
                                    QUIRK_DECODE, joint=False)
    check(not bad, f"quantize: logits outside the gate: {bad}")
    ctx = lambda **kw: Context(model, n_ctx=1024, n_seq_max=1,
                               block_size=16, **kw)
    steps_k, toks = _trace(ctx(), prompt, n_decode=QUIRK_DECODE)
    with _plain_min("fold"):
        steps_p, toks_p = _trace(ctx(plain=True), prompt,
                                 n_decode=QUIRK_DECODE)
    parity = _greedy_parity([lg for lg, _ in steps_k],
                            [lg for lg, _ in steps_p], toks)
    parity["tokens_equal"] = toks == toks_p
    check(parity["same"] or parity["within"],
          f"quantize: greedy tokens off the plain path's: {parity}")
    launches = {k: pred["launches"]["prefill"][k] +
                pred["launches"]["decode"][k]
                for k in pred["launches"]["prefill"]}
    return {"path": pred, "plain_vs_kernel_nmse": checks,
            "greedy": {"kernel": toks, "plain": toks_p, **parity},
            "launches": launches}


def _quant_split(torch, path, model, tmp, prompt) -> dict:
    """cli.gguf_split of the quantized file into shards of QUANT_SPLIT
    tensors: the first shard loaded through Model serves the unsplit
    file's greedy tokens; cli.gguf_split --merge of the shards hashes
    (cli.gguf_hash) as the file does."""
    import io

    from llama_cpp_test_tpu_torch.cli import gguf_hash, gguf_split
    from llama_cpp_test_tpu_torch.runtime.engine import Context, Model, generate

    prefix = os.path.join(tmp, "split", "tinyllama")
    os.makedirs(os.path.dirname(prefix))
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        check(gguf_split.main(["--split-max-tensors", str(QUANT_SPLIT), path,
                               prefix]) == 0, "gguf_split returned nonzero")
    shards = sorted(os.listdir(os.path.dirname(prefix)))
    first = os.path.join(os.path.dirname(prefix), shards[0])
    split_model = Model(first, device="cuda")
    gen = lambda m: list(generate(Context(m, n_ctx=1024, n_seq_max=1),
                                  prompt, 16))
    toks, split_toks = gen(model), gen(split_model)
    del split_model
    merged = os.path.join(tmp, "merged.gguf")
    with contextlib.redirect_stdout(io.StringIO()):
        check(gguf_split.main(["--merge", first, merged]) == 0,
              "gguf_split --merge returned nonzero")
    h_file, h_merged = (gguf_hash.hash_gguf(p) for p in (path, merged))
    out = {"shards": len(shards), "tokens": toks,
           "split_tokens_equal": split_toks == toks,
           "merged_hash_equal": h_merged == h_file,
           "model_sha256": h_file["<model>"], "seconds": time.time() - t0}
    check(len(shards) > 1 and out["split_tokens_equal"],
          f"quantize: the split file's greedy tokens {split_toks} differ "
          f"from the file's {toks}")
    check(out["merged_hash_equal"], "quantize: the merged file's tensor "
                                    "hashes differ from the file's")
    return out


def phase_quantize(torch, nvidia_smi: str) -> dict:
    """llama-quantize as a user runs it, on the card where the port runs
    a model: TinyLlama-1.1B (QUANT_HP: published widths, 1 of 22 layers,
    the synthesized SPM vocab) written as F16; runtime.imatrix.main over
    a seeded text on the card; quant.quantize_model.main to Q4_K_M with
    that imatrix (the types by tensor and the seconds printed); the file
    loaded through Model, its Q4_K and Q6_K planes repacked by the native
    repack, load_weights timed with the native and with the numpy repack
    and their planes bit-equal; served (_quant_serve); split, reloaded
    and merged (_quant_split); cli.quantize_stats -l blk.0 -t Q4_K over
    the F16 source."""
    import io
    from collections import Counter

    from llama_cpp_test_tpu_torch.cli import quantize_stats
    from llama_cpp_test_tpu_torch.gguf.reader import GGUFReader
    from llama_cpp_test_tpu_torch.quant import quantize_model
    from llama_cpp_test_tpu_torch.runtime import imatrix
    from llama_cpp_test_tpu_torch.runtime.engine import Model

    tmp = tempfile.mkdtemp(prefix="chip_smoke_quant_")
    out, sec = {"phase": "quantize", "card": nvidia_smi}, {}
    try:
        src, dst = (os.path.join(tmp, f"tinyllama_{t}.gguf")
                    for t in ("f16", "q4_k_m"))
        t0 = time.time()
        write_llama_gguf(src, QUANT_HP, seed=181, ftype="F16")
        sec["write_f16"] = time.time() - t0
        rng = np.random.default_rng(182)
        text = os.path.join(tmp, "calibration.txt")
        with open(text, "w") as f:
            f.write(" ".join(rng.choice(_WORDS, QUANT_WORDS)))
        npz = os.path.join(tmp, "imatrix.npz")
        t0 = time.time()
        with contextlib.redirect_stderr(io.StringIO()) as err:
            check(imatrix.main(["-m", src, "-f", text, "-o", npz]) == 0,
                  "imatrix.main returned nonzero")
        sec["imatrix"] = time.time() - t0
        sums = imatrix.IMatrixCollector.load(npz)
        out["imatrix"] = {"tensors": len(sums),
                          "line": err.getvalue().strip().splitlines()[-1]}
        check(len(sums) == 7 * QUANT_HP["n_layer"] + 1 and all(
            np.isfinite(v).all() and (v > 0).all() for v in sums.values()),
            f"imatrix: {len(sums)} tensors, finite and positive sums")
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()) as so, \
                contextlib.redirect_stderr(io.StringIO()):
            check(quantize_model.main([src, dst, QUANT_FTYPE, "--imatrix",
                                       npz]) == 0,
                  "quantize_model.main returned nonzero")
        sec["quantize"] = time.time() - t0
        with GGUFReader(dst) as r:
            types = {n: i.ggml_type.name for n, i in r.tensors.items()}
        out["quantize"] = {"line": so.getvalue().strip(),
                           "types": dict(Counter(types.values()))}
        check(types["token_embd.weight"] == "Q4_K" and
              types["output.weight"] == "Q6_K" and
              types["blk.0.attn_v.weight"] == "Q6_K" and
              types["blk.0.ffn_down.weight"] == "Q6_K" and
              types["blk.0.attn_q.weight"] == "Q4_K",
              f"quantize: Q4_K_M's per-tensor types: {types}")
        sec["load_weights_native"], wn = _load_host(dst, True)
        sec["load_weights_numpy"], wp = _load_host(dst, False)
        lw_n, lw_p = wn.layers[0], wp.layers[0]
        same = {"Q4_K blk.0.attn_q": _plane_equal(lw_n.wq, lw_p.wq),
                "Q6_K blk.0.ffn_down": _plane_equal(lw_n.w_down, lw_p.w_down),
                "Q6_K output": _plane_equal(wn.output, wp.output),
                "Q4_K token_embd (rows)": _plane_equal(wn.tok_embd,
                                                        wp.tok_embd)}
        out["planes_bit_equal"] = same
        check(all(same.values()), f"quantize: native planes differ: {same}")
        del wn, wp
        t0 = time.time()
        model = Model(dst, device="cuda")
        sec["model_load"] = time.time() - t0
        prompt = np.random.default_rng(183).integers(
            3, QUANT_HP["n_vocab"], QUANT_PROMPT).tolist()
        t0 = time.time()
        out.update(_quant_serve(torch, model, prompt))
        sec["serve_checks"] = time.time() - t0
        out["split"] = _quant_split(torch, dst, model, tmp, prompt)
        sec["split"] = out["split"]["seconds"]
        del model
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()) as so:
            check(quantize_stats.main(["-m", src, "-l", "blk.0", "-t",
                                       "Q4_K"]) == 0,
                  "quantize_stats returned nonzero")
        sec["quantize_stats"] = time.time() - t0
        out["quantize_stats"] = so.getvalue().strip()
        check(out["quantize_stats"].startswith("Q4_K     overall rmse"),
              f"quantize_stats printed {out['quantize_stats']!r}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = sec
    missing = [k for k in DENSE_PATH if out["launches"][k] <= 0]
    check(not missing, f"quantize: kernels not launched: {missing}")
    emit(out)
    return out


_PORT_KERNELS = ("qmm_gemv_kernel", "qmm_gemm_kernel", "qmm_cache_kernel",
                 "flash_prefill_kernel", "paged_decode_kernel",
                 "paged_decode_merge_kernel",
                 "gmm_gemv_kernel", "gmm_gemm_kernel", "probe_gemv_kernel",
                 "stream_colsum_kernel")


def phase_profile(torch, model, n_vocab, label, kv_type,
                  variant=None) -> dict:
    """torch.profiler over 8 decode steps (after a 130-token prefill) and
    over one 512-token prefill, at the Context's qmm variant: wall time,
    device busy time, idle share, the port's kernels' share and the top
    device kernels."""
    with _qmm_variant(variant):
        return _profile_runs(torch, model, n_vocab, label, kv_type)


def _profiled(torch, fn) -> dict:
    """torch.profiler over one call of fn: wall time, device busy time,
    idle share, the port's kernels' share, memsets, GEMV and K3 busy, and
    the top device kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from llama_cpp_test_tpu_torch.ops import _cuda

    torch.cuda.synchronize()
    before = dict(_cuda.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    launched = sum(_cuda.LAUNCHES[k] - before[k] for k in before)
    dev = []   # device-side events only (kernels, memsets, copies)
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            dev.append((ev.key, int(ev.count), float(us)))
    busy_ms = sum(us for _, _, us in dev) / 1e3
    port_ms = sum(us for k, _, us in dev
                  if any(p in k for p in _PORT_KERNELS)) / 1e3
    dev.sort(key=lambda e: -e[2])
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "port_kernels_ms": port_ms,
            "memset_launches": sum(c for k, c, _ in dev
                                   if "memset" in k.lower()),
            "gemv_ms": {k: sum(us for n, _, us in dev if k in n) / 1e3
                        for k in ("qmm_gemv_kernel", "gmm_gemv_kernel",
                                  "paged_decode")},
            "device_kernel_launches": sum(c for _, c, _ in dev),
            # the port's launches, and how many of its kernels the
            # profiler recorded (K3 adds a merge kernel to a split
            # launch): fewer recorded than launched means the profiler
            # dropped device records (PERF.md §7)
            "port_launches": launched,
            "port_kernels_recorded": sum(
                c for k, c, _ in dev if any(p in k for p in _PORT_KERNELS)),
            "top": [{"name": k[:80], "count": c, "ms": us / 1e3}
                    for k, c, us in dev[:8]]}


def _profile_runs(torch, model, n_vocab, label, kv_type) -> dict:
    from llama_cpp_test_tpu_torch.runtime.engine import Context

    ctx = Context(model, n_ctx=1024, n_seq_max=2, block_size=16,
                  kv_type=kv_type)
    rng = np.random.default_rng(5)
    prompt = rng.integers(3, n_vocab, size=512).tolist()
    s = ctx.new_seq()
    logits = ctx.prefill(s, prompt[:130])
    logits = ctx.decode([s], [int(np.argmax(logits))])[0]   # warm-up
    s2 = ctx.new_seq()
    state = {"logits": logits}

    def decode8():
        for _ in range(8):
            state["logits"] = ctx.decode([s], [int(np.argmax(state["logits"]))])[0]

    runs = {"decode_8_steps": decode8,
            "prefill_512": lambda: ctx.prefill(s2, prompt)}
    out = {"phase": "profile", "path": label}
    for name, fn in runs.items():
        out[name] = _profiled(torch, fn)
    check(out["decode_8_steps"]["device_busy_ms"] > 0,
          "the profiler saw no device time")
    emit(out)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="after each serve phase, profile decode steps and a "
                         "512-token prefill with torch.profiler")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import llama_cpp_test_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script ({e})",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kept = Kept()
    seconds, t_start = {}, time.time()

    def timed(name, fn, *a):
        t0 = time.time()
        try:
            return fn(*a)
        finally:
            seconds[name] = round(time.time() - t0, 1)

    try:
        dev = timed("device", phase_device, torch)
        build = timed("build", phase_build)
        from llama_cpp_test_tpu_torch.tools import L2FlushedTimer

        timer = L2FlushedTimer()
        rep, shape_rows = timed("kernels", phase_kernels, torch, timer)
        probe_launches = one_launch_each(torch, _probe_calls(),
                                         "kernels", "probe launches")
        kc = KernelChecks(torch, timer, np.random.default_rng(4321))
        smi, prof = dev["nvidia_smi"], args.profile
        serves = {
            "serve": timed("serve", phase_serve, torch, kept, prof),
            "serve_moe": timed("serve_moe", phase_serve_moe, torch, prof),
            "serve_iq4xs": timed("serve_iq4xs", phase_serve_iq4xs, torch, kc,
                                 prof),
            "serve_lowbit": timed("serve_lowbit", phase_serve_lowbit, torch,
                                  kc, kept, prof),
            "serve_moe_lowbit": timed("serve_moe_lowbit",
                                      phase_serve_moe_lowbit, torch, kc,
                                      prof),
            "probes": timed("probes", phase_probes, torch, kc,
                            probe_launches)}
        serves["cli"] = timed("cli", phase_cli, torch, kept, kc)
        serves["sched"] = timed("sched", phase_sched, torch, kept, smi)
        serves["server"] = timed("server", phase_server, torch, kept, smi)
        serves["adapters"] = timed("adapters", phase_adapters, torch, kept,
                                   smi)
        serves["quirks"] = timed("quirks", phase_quirks, torch, kc, smi,
                                 prof)
        serves["quirks_ln"] = timed("quirks_ln", phase_quirks_ln, torch, kc,
                                    smi, build, prof)
        serves["quirks_body"] = timed("quirks_body", phase_quirks_body,
                                      torch, kc, smi, build, prof)
        serves["positions"] = timed("positions", phase_positions, torch, kc,
                                    smi, prof)
        serves["encoders"] = timed("encoders", phase_encoders, torch, kc, smi,
                                   prof)
        serves["geometry"] = timed("geometry", phase_geometry, torch, kc, smi,
                                   prof)
        serves["moe_forms"] = timed("moe_forms", phase_moe_forms, torch, kc,
                                    smi, kept, build, prof)
        serves["multimodal"] = timed("multimodal", phase_multimodal, torch,
                                     kc, smi)
        serves["recurrent"] = timed("recurrent", phase_recurrent, torch, smi,
                                    prof)
        serves["t5"] = timed("t5", phase_t5, torch, smi)
        serves["tts"] = timed("tts", phase_tts, torch, kc, smi)
        serves["quantize"] = timed("quantize", phase_quantize, torch, smi)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    finally:
        kept.remove()
        emit({"phase": "timings", "seconds": seconds,
              "total_s": round(time.time() - t_start, 1)})
    rep["qmm_cache"] = serves["serve_lowbit"]["files"]["Q2_K"]["rows"][
        "gate|up K5 M=512"]
    rep.update(serves["probes"]["rows"])
    # every shape of the kernels this slice redesigned, K4's GEMM also on
    # the low-bit and BF16 files' gate and down stacks
    for f in serves["serve_moe_lowbit"]["files"].values():
        shape_rows["gmm_gemm"] += [r for r in f["rows"].values()
                                   if r["kernel"] == "gmm_gemm"]
    # and every GEMV row, K1's on the served low-bit planes too
    served = [serves["serve_iq4xs"]["rows"]] + [
        f["rows"] for f in serves["serve_lowbit"]["files"].values()] + [
        f["rows"] for f in serves["serve_moe_lowbit"]["files"].values()]
    for name in ("qmm_gemv", "gmm_gemv"):
        shape_rows[name] += [r for rs in served for r in rs.values()
                             if r["kernel"] == name]
    # and the attention rows at D = 256 (Gemma's geometry), 80 and 96
    # (Phi-2's, Phi-3's), G = 71 (Falcon-7B's), BERT-base's bidirectional
    # K2, the K3 rows of DeciLM-7B's and OpenELM-270M's G, D = 192
    # (DeepSeek's MLA) with K4 at the new routings, and K1's int8 GEMV at
    # OuteTTS's 157696-row head
    for phase in ("quirks", "quirks_ln", "encoders", "geometry",
                  "moe_forms", "multimodal", "cli", "tts"):
        for row in serves[phase]["rows"].values():
            shape_rows.setdefault(row["kernel"], []).append(row)
    kernels = []
    for name, (src, replaces) in TPU_KERNELS.items():
        r = rep[name]
        # launches: the path of the slice that ported the kernel (dense for
        # K1-K3, MoE for K4 and K3-q8, the low-bit cache Contexts for K5,
        # the probe entry points for the probes); launches_by_path: every
        # path
        own = OWN_PATH.get(name, "serve")
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "shape": r["shape"],
                        "launches": serves[own]["launches"][name],
                        "launches_by_path": {p: v["launches"].get(name, 0)
                                             for p, v in serves.items()},
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
        if name in shape_rows:
            kernels[-1]["rows"] = [
                {k: r[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                   "library_ms", "max_abs_err")}
                for r in shape_rows[name]]
    emit({"kernels": kernels})
    print(dev["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
