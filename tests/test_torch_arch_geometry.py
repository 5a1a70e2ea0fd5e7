"""Per-layer geometry and chameleon in the port (llama_cpp_test_tpu_torch
models/{hparams,registry,llama,lora}, runtime/{engine,kv_cache,state,
imatrix,tracing}, cli/{main,gritlm}) against the JAX package, on CPU, on
four tiny F32 fixtures in the reference's tensor layout
(test_torch_arch_body.make_tiny_body):

  openelm         2 layers of 3/4 query heads on 1/2 KV heads and FFN
                  widths 64/96 (GGUF arrays), a fused attn_qkv split at
                  the layer's counts, shared per-head QK RMS norms, NEOX
                  rope, tied head
  deci            4 layers: attention on 2 KV heads, an attention-free
                  layer (n_head 0), a linear-attention layer (n_head_kv 0:
                  wo on the normed input) and attention on 1 KV head; FFN
                  widths 128/96/64/128, NORM rope permuted at each layer's
                  head counts
  chameleon       per-head QK LayerNorms [H, D] with biases, NORM rope
  chameleon-swin  the same with the 34B's swin_norm: no pre-norms, the
                  norms on the branch outputs

Checks, as tests/test_torch_arch_ln.py makes them: hparams (the
per-layer arrays) and the loader's planes equal the JAX package's;
prefill, decode and batched-decode logits at bf16 and q8_0 KV within
NMSE 2e-3 of the jitted JAX engine and within 1e-10 of it run op by op;
greedy tokens equal; the JAX-loaded parameters through the port give the
port's own logits; the CLI, gritlm and the Scheduler. Then on openelm and
deci: KV pools of the reference's per-layer shapes; a session file of
per-layer arrays that round-trips (and a bf16 one restores in the
reference); a context shift and a prompt-cache reuse whose every layer
equals the reference's own K-shift of that layer alone; a block swapped
to the host and back, to the bit. The reference faults on ragged layers:
its block swap stacks the layers' pools (fault 18) and its K-shift
reshapes every layer at layer 0's KV count (fault 19), so both raise; its
deci linear-attention layer drops its wo adapter (fault 20); its load_lora
permutes deci's q/k B rows at the global counts and raises (fault 21). The
port's LoRA on deci's per-layer NORM rows equals a merged file; its
imatrix and tracer follow deci's layers that do not attend (faults 11 and
12); the layouts it does not carry raise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_arch_body import make_tiny_body
from test_torch_arch_ln import (CTX, LOGITS_GATE, PROMPT, check_batched,
                                check_cli, check_greedy, check_hparams,
                                check_loader, check_logits, check_op_by_op,
                                check_reference_parameters, check_scheduler,
                                models, nmse, run, write_fixtures)
from llama_cpp_test_tpu.cli import gritlm as jgritlm
from llama_cpp_test_tpu.gguf.constants import GGMLType
from llama_cpp_test_tpu.gguf.reader import GGUFReader
from llama_cpp_test_tpu.gguf.writer import GGUFWriter
from llama_cpp_test_tpu.models import hparams as jhparams
from llama_cpp_test_tpu.models import llama as jllama
from llama_cpp_test_tpu.models import lora as jlora
from llama_cpp_test_tpu.ops import layers as jlayers
from llama_cpp_test_tpu.runtime import engine as jengine
from llama_cpp_test_tpu.runtime import imatrix as jimatrix
from llama_cpp_test_tpu.runtime import kv_cache as jkv
from llama_cpp_test_tpu.runtime import state as jstate
from llama_cpp_test_tpu_torch.cli import gritlm as pgritlm
from llama_cpp_test_tpu_torch.gguf.reader import GGUFReader as PGGUFReader
from llama_cpp_test_tpu_torch.models import lora as plora
from llama_cpp_test_tpu_torch.runtime import engine as pengine
from llama_cpp_test_tpu_torch.runtime import imatrix as pimatrix
from llama_cpp_test_tpu_torch.runtime import kv_cache as pkv
from llama_cpp_test_tpu_torch.runtime import state as pstate
from llama_cpp_test_tpu_torch.runtime import tracing as ptracing

# fixture -> (arch, make_tiny_body spec); layers: per-layer (hq, hkv, ff)
GEOMETRY = {
    "openelm": ("openelm", dict(qkv="fused", qk_norm="rms", tied=True,
                                layers=[(3, 1, 64), (4, 2, 96)])),
    "deci": ("deci", dict(layers=[(4, 2, 128), (0, 0, 96), (4, 0, 64),
                                  (4, 1, 128)])),
    "chameleon": ("chameleon", dict(qk_norm="ln_bias")),
    "chameleon-swin": ("chameleon", dict(qk_norm="ln_bias",
                                         meta={"swin_norm": True})),
}
NAMES = list(GEOMETRY)
RAGGED = ("openelm", "deci")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs: under pytest-xdist every
    worker's OpenMP pool takes all cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return write_fixtures(tmp_path_factory, {
        name: (lambda p, n=name: make_tiny_body(p, GEOMETRY[n][1],
                                                GEOMETRY[n][0]))
        for name in NAMES})


# ---------------------------------------------------------------------------
# the per-fixture checks


@pytest.mark.parametrize("name", NAMES)
def test_hparams_match_reference(paths, name):
    hp = check_hparams(paths[name])
    assert hp.arch == GEOMETRY[name][0]
    assert hp.uniform_layers == name.startswith("chameleon")
    assert hp.swin_norm == (name == "chameleon-swin")
    if name == "deci":
        assert hp.n_head_layers == (4, 0, 4, 4)
        assert hp.n_head_kv_layers == (2, 0, 0, 1)
        assert hp.n_ff_layers == (128, 96, 64, 128)
        assert (hp.n_head, hp.n_head_kv, hp.n_ff) == (4, 2, 128)


@pytest.mark.parametrize("name", NAMES)
def test_loader_planes_match_reference(paths, name):
    """Planes at each layer's own head counts and FFN width (deci's
    layers that do not attend carry no q/k/v, its attention-free one no
    wo), the QK-norm biases (permuted with the NORM rows) and the swin
    remap into the post-norm slots equal the JAX loader's."""
    pw = check_loader(paths[name])
    hp = check_hparams(paths[name])
    for i, lw in enumerate(pw.layers):
        attends = hp.n_head_of(i) and hp.n_head_kv_of(i)
        assert (lw.wqkv is None and lw.wq is None) == (not attends)
        assert (lw.wo is None) == (hp.n_head_of(i) == 0)
    lw = pw.layers[0]
    assert (lw.attn_q_norm_b is not None) == name.startswith("chameleon")
    assert (lw.attn_norm is None) == (lw.attn_post_norm is not None) == \
        (name == "chameleon-swin")


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
@pytest.mark.parametrize("name", NAMES)
def test_prefill_decode_logits_match_reference(paths, name, kv):
    check_logits(paths[name], kv)


@pytest.mark.parametrize("name", NAMES)
def test_logits_match_reference_op_by_op(paths, name):
    check_op_by_op(paths[name])


@pytest.mark.parametrize("name", NAMES)
def test_greedy_tokens_match_reference(paths, name):
    check_greedy(paths[name])


@pytest.mark.parametrize("name", NAMES)
def test_batched_decode_matches_reference(paths, name):
    check_batched(paths[name])


@pytest.mark.parametrize("name", NAMES)
def test_port_runs_on_reference_parameters(paths, name):
    check_reference_parameters(paths[name])


@pytest.mark.parametrize("name", NAMES)
def test_cli_text_matches_reference(paths, name):
    check_cli(paths[name])


@pytest.mark.parametrize("name", ["openelm", "chameleon"])
def test_gritlm_cli_matches_reference(paths, name):
    """gritlm's bidirectional mean-pooled embeddings: their cosines print
    as the JAX CLI prints them, within 2e-3 of the jitted JAX CLI's; its
    generation prints generate()'s greedy pieces (the tokens the JAX engine
    gives run op by op, test_greedy_tokens_match_reference; jitted XLA
    flips a near tie of this random model)."""
    from test_torch_arch_encoders import same_printout

    _, pm = models(paths[name])
    argv = ["-m", paths[name], "--doc", "the cat sat on the mat", "--doc",
            "hello world", "--query", "a cat", "--query", "the world",
            "-p", "hello", "-n", "6", "-c", "256"]
    want, got = run(jgritlm.main, argv), run(pgritlm.main, argv, device="cpu")
    # four cosine lines, then the generated text and a newline
    cut = lambda out: (out[0], "\n".join(out[1].split("\n", 4)[:4]))
    same_printout(cut(want), cut(got))
    tok = pm.tokenizer
    ids = tok.encode("<|user|>\nhello\n<|assistant|>\n", add_special=True,
                     parse_special=True)
    gen = pengine.generate(pengine.Context(pm, n_ctx=256, n_seq_max=2), ids,
                           6, eos_ids={tok.vocab.eos_id})
    assert got[1].split("\n", 4)[4] == "".join(
        tok.token_to_piece(t) for t in gen) + "\n"


@pytest.mark.parametrize("name", RAGGED)
def test_scheduler_serves_as_generate(paths, name):
    check_scheduler(paths[name])


# ---------------------------------------------------------------------------
# per-layer pools: sizing, sessions, the K-shift, the host swap


@pytest.mark.parametrize("name", RAGGED)
def test_pools_sized_per_layer(paths, name):
    """Each layer's pool has its own KV head count (one head where a deci
    layer does not attend), as the reference's; so do the bytes a token
    takes."""
    jm, pm = models(paths[name])
    for kv in ("bf16", "q8_0"):
        jp = jengine.Context(jm, kv_type=kv, **CTX).pools
        pp = pengine.Context(pm, kv_type=kv, **CTX).pools
        for plist in ("k", "v", "k_scale", "v_scale"):
            a, b = getattr(jp, plist), getattr(pp, plist)
            assert (a is None) == (b is None)
            if a is not None:
                assert [tuple(x.shape) for x in a] == \
                    [tuple(x.shape) for x in b]
    heads = [p.shape[0] for p in pp.k]
    assert heads == [max(pm.hp.n_head_kv_of(i), 1)
                     for i in range(pm.hp.n_layer)]
    assert len(set(heads)) > 1
    assert pkv.kv_bytes_per_token(pm.hp) == jkv.kv_bytes_per_token(jm.hp)
    assert pkv.kv_bytes_per_token(pm.hp, "q8_0") == \
        2 * sum(heads) * (16 + 4)


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
@pytest.mark.parametrize("name", RAGGED)
def test_session_round_trip(paths, tmp_path, name, kv):
    """A saved sequence holds k{li}/v{li} at each layer's KV count; restored
    into a fresh Context, its next decode equals the unsaved one's (to the
    bit at bf16 KV); a bf16 file restores in the reference too, whose next
    decode is within the logits gate."""
    jm, pm = models(paths[name])
    ctx = pengine.Context(pm, kv_type=kv, **CTX)
    s = ctx.new_seq()
    ctx.prefill(s, PROMPT[:11])
    path = str(tmp_path / "seq.npz")
    pstate.save_seq_state(ctx, s, path)
    data = np.load(path)
    assert [data[f"k{i}"].shape for i in range(pm.hp.n_layer)] == \
        [(max(pm.hp.n_head_kv_of(i), 1), 11, 16)
         for i in range(pm.hp.n_layer)]
    want = ctx.decode([s], [5])[0]
    ctx2 = pengine.Context(pm, kv_type=kv, **CTX)
    ctx2.prefill(ctx2.new_seq(), [7, 8])          # other blocks
    s2 = pstate.load_seq_state(ctx2, path)
    got = ctx2.decode([s2], [5])[0]
    if kv == "bf16":
        np.testing.assert_array_equal(want, got)
        jctx = jengine.Context(jm, **CTX)
        js = jstate.load_seq_state(jctx, path)
        assert js.tokens == PROMPT[:11]
        assert nmse(jctx.decode([js], [5])[0], got) < LOGITS_GATE
    else:
        assert nmse(want, got) < 1e-5, nmse(want, got)


def _reference_shift(pools_before, li, src, dst, delta, inv_freq):
    """The reference's own K-shift of layer li alone (a one-layer pool,
    where its reshape holds): (k, v) [KV, NB, BS, D] float32."""
    conv = lambda t: (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                      if t.dtype == torch.bfloat16 else jnp.asarray(t.numpy()))
    one = lambda plist: None if plist is None else [conv(plist[li])]
    p = pools_before
    kq = p.k_scale is not None
    jp = jkv.KVPools(one(p.k), one(p.v), one(p.k_scale), one(p.v_scale))
    out = jkv.apply_shift(jp, jnp.asarray(src, jnp.int32),
                          jnp.asarray(dst, jnp.int32),
                          jnp.asarray(delta, jnp.int32),
                          jnp.asarray(inv_freq), 1.0)
    host = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    k, v = host(out.k[0]), host(out.v[0])
    if kq:
        k = k * host(out.k_scale[0])[..., None]
        v = v * host(out.v_scale[0])[..., None]
    return k, v


def _pools_host(pools, li):
    k = pools.k[li].float().numpy()
    v = pools.v[li].float().numpy()
    if pools.quantized:
        k = k * pools.k_scale[li].numpy()[..., None]
        v = v * pools.v_scale[li].numpy()[..., None]
    return k, v


def _clone(pools):
    c = lambda plist: None if plist is None else [p.clone() for p in plist]
    return pkv.KVPools(c(pools.k), c(pools.v), c(pools.k_scale),
                       c(pools.v_scale))


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
@pytest.mark.parametrize("name", RAGGED)
def test_shift_and_reuse_equal_the_reference_per_layer(paths, name, kv):
    """A context shift (keep 2, drop 5 of 12) and a prompt-cache reuse
    that moves a 5-token chunk: every layer's pools afterwards equal the
    reference's K-shift of that layer alone on the pools before (its own
    shift of the whole cache raises on these files, fault 19), and decode
    goes on from the moved tokens."""
    _, pm = models(paths[name])
    ctx = pengine.Context(pm, kv_type=kv, **CTX)
    s = ctx.new_seq()
    ctx.prefill(s, PROMPT[:12])
    slot = lambda i: ctx._seq_slot(s, i)
    cases = [("shift", [slot(i) for i in range(7, 12)],
              [slot(i) for i in range(2, 7)], [-5] * 5)]
    before = _clone(ctx.pools)
    ctx.shift_context(s, 2, 5)
    assert s.n_cached == 7 and s.tokens == PROMPT[:2] + PROMPT[7:12]
    states = [(before, _clone(ctx.pools))]
    ctx.decode([s], [5])
    # reuse: the cache holds PROMPT[:2] + PROMPT[7:12] + [5]; the new
    # prompt keeps PROMPT[:2] and moves PROMPT[7:12] down one slot
    new = PROMPT[:2] + PROMPT[8:12] + [5, 9]
    before = _clone(ctx.pools)
    cases.append(("reuse", [slot(i) for i in range(3, 8)],
                  [slot(i) for i in range(2, 7)], [-1] * 5))
    assert ctx.compact_reuse(s, new, n_reuse_min=3) == 7
    states.append((before, _clone(ctx.pools)))
    for (label, src, dst, delta), (pre, post) in zip(cases, states):
        for li in range(pm.hp.n_layer):
            ifr = ctx.w.inv_freq_for(0).numpy()
            want = _reference_shift(pre, li, src, dst, delta, ifr)
            got = _pools_host(post, li)
            for a, b in zip(want, got):
                assert nmse(a, b) < 1e-6, (label, li, nmse(a, b))
    logits = ctx.decode([s], [9])[0]
    assert np.isfinite(logits).all()


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
@pytest.mark.parametrize("name", RAGGED)
def test_block_swap_round_trips(paths, name, kv):
    """A sequence whose block was evicted to the host and swapped back
    decodes the same logits, to the bit, as one never evicted; a block's
    payload written to another block reads back the same bits."""
    _, pm = models(paths[name])
    ref = pengine.Context(pm, kv_type=kv, **CTX)
    r = ref.new_seq()
    ref.prefill(r, PROMPT[:14])
    want = ref.decode([r], [5])[0]
    ctx = pengine.Context(pm, kv_type=kv, num_blocks=4, **CTX)
    a = ctx.new_seq()
    ctx.prefill(a, PROMPT[:14])                   # blocks 0-1 of 4
    data = ctx._read_block(a.table.blocks[0])
    b = ctx.new_seq()
    ctx.prefill(b, PROMPT[2:14])                  # fills the pool
    c = ctx.new_seq()
    ctx.prefill(c, PROMPT[:8])                    # evicts a's LRU block
    assert ctx.mgr.swap.n_swapped_out >= 1
    got = ctx.decode([a], [5])[0]                 # swaps it back in
    assert ctx.mgr.swap.n_swapped_in >= 1
    np.testing.assert_array_equal(got, want)
    spare = [x for x in range(4) if x not in a.table.blocks][0]
    pkv.scatter_block(ctx.pools, data, spare)
    for x, y in zip(data, pkv.gather_block(ctx.pools, spare)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("name", RAGGED)
def test_reference_swap_and_shift_raise_on_ragged_layers(paths, name):
    """Faults 18 and 19: the reference's gather_block stacks every layer's
    block into one array, so an eviction on these files raises; its
    apply_shift reshapes every layer at layer 0's KV count, so a context
    shift and a prompt-cache reuse raise. The port runs all three (the
    tests above)."""
    jm, _ = models(paths[name])
    ctx = jengine.Context(jm, num_blocks=4, **CTX)
    ctx.prefill(ctx.new_seq(), PROMPT[:14])
    ctx.prefill(ctx.new_seq(), PROMPT[2:14])
    with pytest.raises(ValueError, match="same shape"):
        ctx.prefill(ctx.new_seq(), PROMPT[:8])
    ctx = jengine.Context(jm, **CTX)
    s = ctx.new_seq()
    ctx.prefill(s, PROMPT[:12])
    with pytest.raises(TypeError, match="reshape"):
        ctx.shift_context(s, 2, 5)
    s = ctx.new_seq()
    ctx.prefill(s, PROMPT[:12])
    with pytest.raises(TypeError, match="reshape"):
        ctx.compact_reuse(s, PROMPT[:2] + PROMPT[3:12], n_reuse_min=3)


# ---------------------------------------------------------------------------
# adapters on deci's layers


def write_deci_adapter(path, hp, layers=None, seed=3, rank=4):
    """A LoRA GGUF over every projection each deci layer has, at the
    layer's own widths (layers: the layer -> targets to keep, default
    all)."""
    rng = np.random.default_rng(seed)
    w = GGUFWriter(path, arch="llama")
    w.add_kv("adapter.type", "lora")
    w.add_kv("adapter.lora.alpha", 8.0)
    c, d = hp.n_embd, hp.head_dim
    for li in range(hp.n_layer):
        h, kvh, ff = hp.n_head_of(li), hp.n_head_kv_of(li), hp.n_ff_of(li)
        dims = {"ffn_gate": (ff, c), "ffn_up": (ff, c), "ffn_down": (c, ff)}
        if h and kvh:
            dims.update({"attn_q": (h * d, c), "attn_k": (kvh * d, c),
                         "attn_v": (kvh * d, c), "attn_output": (c, h * d)})
        elif h:
            dims["attn_output"] = (c, c)
        keep = dims if layers is None else layers.get(li, ())
        for t in dims:
            if t not in keep:
                continue
            n, k = dims[t]
            for suffix, shape in ((".lora_a", (rank, k)),
                                  (".lora_b", (n, rank))):
                w.add_tensor(f"blk.{li}.{t}.weight{suffix}",
                             (rng.standard_normal(shape) * 0.1).astype(
                                 np.float32), ggml_type=GGMLType.F32)
    w.write()
    return path


def _rows_with(path, adapter=None):
    model = pengine.Model(path, device="cpu")
    if adapter is not None:
        plora.attach_lora(model.weights, plora.load_lora(adapter, model.hp))
    ctx = pengine.Context(model, **CTX)
    return ctx.prefill(ctx.new_seq(), PROMPT[:8], all_logits=True)


def test_lora_on_deci_per_layer_rows_equals_the_merged_file(paths, tmp_path):
    """A LoRA over every projection of deci's layers (q/k B rows
    un-permuted at each layer's own head counts; the linear layer's wo
    too) gives the logits of the adapter merged into the file (export-lora,
    F16 planes), far from the base's; the reference's load_lora permutes
    at the global counts and raises on the layer with one KV head (fault
    21)."""
    path = paths["deci"]
    jm, pm = models(path)
    adapter = write_deci_adapter(str(tmp_path / "a.gguf"), pm.hp)
    merged = str(tmp_path / "merged.gguf")
    assert plora.merge_lora(path, adapter, merged) == 7 + 3 + 4 + 7
    got = _rows_with(path, adapter)
    assert nmse(_rows_with(merged), got) < 1e-3     # the F16 merge's rounding
    assert nmse(_rows_with(path), got) > 1e-2
    with pytest.raises(IndexError):
        jlora.load_lora(adapter, jm.hp)


def test_deci_linear_layer_applies_its_wo_adapter(paths, tmp_path):
    """Fault 20: an adapter of the linear-attention layer's wo alone.
    llama.cpp's deci graph applies it (build_lora_mm); the reference's
    linear layer calls a plain matmul and its logits stay the base's. The
    port's move as the merged file's."""
    path = paths["deci"]
    jm, pm = models(path)
    adapter = write_deci_adapter(str(tmp_path / "wo.gguf"), pm.hp,
                                 layers={2: ("attn_output",)})
    merged = str(tmp_path / "merged.gguf")
    assert plora.merge_lora(path, adapter, merged) == 1
    got = _rows_with(path, adapter)
    assert nmse(_rows_with(merged), got) < 1e-3     # the F16 merge's rounding
    assert nmse(_rows_with(path), got) > 1e-2
    jmodel = jengine.Model(path)
    jlora.attach_lora(jmodel.weights, jlora.load_lora(adapter, jmodel.hp))
    jctx, bctx = jengine.Context(jmodel, **CTX), jengine.Context(jm, **CTX)
    np.testing.assert_array_equal(
        jctx.prefill(jctx.new_seq(), PROMPT[:8], all_logits=True),
        bctx.prefill(bctx.new_seq(), PROMPT[:8], all_logits=True))


# ---------------------------------------------------------------------------
# imatrix and the tracer on deci


def deci_layers(path, tokens):
    """The JAX package's own deci model run op by op with dense causal
    attention: the outputs of layers 0 and 1 (an attention layer, then an
    attention-free one)."""
    hp, w = jllama.load_weights(GGUFReader(path))
    t = len(tokens)
    out = []
    with jax.disable_jit():
        pos = jnp.arange(t, dtype=jnp.int32)[None]
        x = jllama.embed(w, jnp.asarray([tokens], jnp.int32))
        mask = jnp.asarray(np.tril(np.ones((t, t), bool)))[None]
        attend = lambda q, k, v: jlayers.attention(
            q, k, v, mask, jhparams.attn_scale_of(hp))
        for li in range(2):
            x = jllama.forward_layer(x, w.layers[li], hp, pos,
                                     w.inv_freq_for(0), w.rope_mscale,
                                     attend, li=li)
            out.append(x)
    return hp, w, [np.asarray(a.astype(jnp.float32))[0] for a in out]


def test_imatrix_and_trace_on_deci_collect_the_served_model(paths):
    """Faults 11 and 12 on deci: the JAX imatrix runs every layer as an
    attention layer and raises on the attention-free one; the port taps
    the attention-free layer's FFN input and the linear layer's input
    under attn_output, equal to the JAX model's own; its tracer gives the
    JAX model's layer outputs."""
    path = paths["deci"]
    jm, pm = models(path)
    toks = [int(t) for t in np.random.default_rng(1).integers(3, 190, 32)]
    hp, w, (x0, x1) = deci_layers(path, toks)
    sq = lambda a: (np.asarray(a, np.float64) ** 2).sum(0)
    bf16 = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    with jax.disable_jit():     # the layers' inputs are bf16, their norms too
        ffn_in = jlayers.rms_norm(bf16(x0), w.layers[1].ffn_norm, hp.rms_eps)
        lin_in = jlayers.rms_norm(bf16(x1), w.layers[2].attn_norm,
                                  hp.rms_eps)
    pc = pimatrix.IMatrixCollector(pm)
    pc.collect(toks, chunk=32)
    for name, want in (("blk.1.ffn_gate.weight", sq(ffn_in)),
                       ("blk.1.ffn_up.weight", sq(ffn_in)),
                       ("blk.2.attn_output.weight", sq(lin_in))):
        got = pc.sums[name]
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-3, name
    assert not any(n.startswith(("blk.1.attn", "blk.2.attn_q"))
                   for n in pc.sums)
    with pytest.raises(Exception), jax.disable_jit():
        jimatrix.IMatrixCollector(jm).collect(toks, chunk=32)
    got = ptracing.trace_eval(pengine.Context(pm, **CTX), toks,
                              keep_values=True)
    by = {t.name: t.values for t in got}
    assert nmse(x0, by["l_out-0"]) < 1e-10
    assert nmse(x1, by["l_out-1"]) < 1e-10


# ---------------------------------------------------------------------------
# layouts the port does not carry


def _edited(src_path, path, arch, kv=None, drop=(), add=None):
    from llama_cpp_test_tpu_torch.gguf.writer import GGUFWriter as PWriter

    src = PGGUFReader(src_path)
    w = PWriter(path, arch=arch)
    for key, val in src.metadata.items():
        if key.startswith(arch + "."):
            w.add_kv(key, val)
    for key, val in (kv or {}).items():
        w.add_kv(f"{arch}.{key}", val)
    for name in src.tensors:
        if name not in drop:
            w.add_tensor(name, src.dequantize(name, np.float32))
    if add is not None:
        w.add_tensor(add[0], np.zeros(add[1], np.float32))
    w.write()
    return path


@pytest.mark.parametrize("name,kv,add,exc,match", [
    ("deci", {"attention.head_count_kv": [2, 0, 0]}, None, ValueError,
     "3 entries for 4 layers"),
    ("deci", None, ("blk.1.attn_q.weight", (64, 64)), NotImplementedError,
     "free-attention layer"),
    ("openelm", None, ("blk.0.attn_q_norm.bias", (16,)),
     NotImplementedError, "another kind of layer"),
], ids=["short-array", "q-in-attention-free-layer", "bias-on-rms-qk-norm"])
def test_geometry_layouts_the_port_does_not_carry_raise(paths, tmp_path,
                                                        name, kv, add, exc,
                                                        match):
    """A per-layer array of the wrong length, attention tensors in an
    attention-free layer and a QK-norm bias beside a shared RMS weight are
    refused before a tensor is read."""
    path = _edited(paths[name], str(tmp_path / "v.gguf"),
                   GEOMETRY[name][0], kv, add=add)
    with pytest.raises(exc, match=match):
        pengine.Model(path, device="cpu")
