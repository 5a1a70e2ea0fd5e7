"""MLA attention in the port (llama_cpp_test_tpu_torch models/{hparams,
llama,lora}, ops/{layers,flash_prefill,paged_attention}, runtime/{engine,
kv_cache,state}) against the JAX package, on CPU, on tiny F32 files
converted from seeded HF checkpoints by tests/test_convert_hf.py's
converter (test_torch_arch_moe.converted and hf_file):

  deepseek2-lite   DeepSeek-V2-Lite's form: a plain attn_q, the kv LoRA,
                   qk 16 + 8 (NORM rope on the pe rows), v 12, a leading
                   dense layer, softmax top-2 of 4 not renormalized, two
                   ungated shared experts, routed scale 2.5
  deepseek-v3      DeepSeek-V3's form on the tiny body: the q LoRA, YaRN
                   x8 (the magnitude folded into the attention scale, the
                   rope at magnitude 1), sigmoid scores, the selection
                   bias exp_probs_b, renormalized weights, routed scale
                   2.5, one shared expert
  minicpm3         MLA with a q LoRA on NEOX rope rows, the mup scales
  deepseek2-d192   the V2/V3 head: qk 128 + 64 = 192, v 128 padded to 192

Checks: every fixture as tests/test_torch_arch_ln.py checks one (hparams
field for field, the loader's planes, logits at bf16 KV (q8_0 on two)
within NMSE 2e-3 of the jitted JAX engine and within 1e-10 of it run op
by op, greedy tokens (neither on deepseek2-d192, whose checks are the KV
cache's), batched decode on two, the JAX-loaded parameters; the CLI, the
Scheduler and the server on one); the plain versions of K2, K3 and K3-q8
at D = 192 against the JAX Pallas kernels in interpret mode (NMSE 2e-4,
the attention suites' gate); the D = 192 pools sized as the reference
sizes them, a session file round trip, a block swap, the K-shift
(reference fault 24: the reference turns the first rope_dim dims of an
MLA K, the nope ones, where the port turns the pe tail) and an adapter
on deepseek2-lite's plain attn_q (fault 23: the reference permutes whole
heads of its B rows, the port the pe tail as its loader does).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers  # noqa: F401  (at module top: ROADMAP §3, sys.modules)

import test_convert_hf as hf_tests
from test_torch_arch_geometry import _rows_with
from test_torch_arch_ln import (CTX, LOGITS_GATE, PROMPT, check_batched,
                                check_cli, check_greedy, check_hparams,
                                check_logits, check_op_by_op,
                                check_reference_parameters, check_scheduler,
                                models, nmse)
from test_torch_arch_moe import converted, hf_file
from test_torch_attention import both, decode_case, f32, prefill_case
from test_torch_engine_pieces import cached_kv
from test_torch_model import assert_same_weights

from llama_cpp_test_tpu.gguf.constants import GGMLType
from llama_cpp_test_tpu.gguf.writer import GGUFWriter
from llama_cpp_test_tpu.models import lora as jlora
from llama_cpp_test_tpu.ops import paged_attention as pa
from llama_cpp_test_tpu.ops.flash_prefill import flash_prefill
from llama_cpp_test_tpu.runtime import engine as jengine
from llama_cpp_test_tpu.runtime import kv_cache as jkv
from llama_cpp_test_tpu.runtime import state as jstate
from llama_cpp_test_tpu_torch.models import lora as plora
from llama_cpp_test_tpu_torch.ops import flash_prefill as pfp
from llama_cpp_test_tpu_torch.ops import paged_attention as ppa
from llama_cpp_test_tpu_torch.runtime import engine as pengine
from llama_cpp_test_tpu_torch.runtime import kv_cache as pkv
from llama_cpp_test_tpu_torch.runtime import state as pstate

ATTN_GATE = 2e-4


# test_convert_deepseek2_qlora_yarn_matches_transformers's YaRN
YARN = {"type": "yarn", "factor": 8.0, "original_max_position_embeddings": 32,
        "beta_fast": 32.0, "beta_slow": 1.0, "mscale": 0.707,
        "mscale_all_dim": 0.707}


def _v3_file(root) -> str:
    """DeepSeek-V3's form on the tiny deepseek2 body (2 layers: a dense
    one, a MoE one): a q LoRA of 24, YaRN x8, sigmoid scores with a seeded
    e_score_correction_bias, renormalized top-2, one shared expert,
    routed scale 2.5."""
    cfg = dict(hf_tests._deepseek_cfg(q_lora=24, rope_scaling=YARN),
               num_hidden_layers=2, scoring_func="sigmoid",
               norm_topk_prob=True, n_shared_experts=1,
               topk_method="noaux_tc")
    rng = np.random.default_rng(24)
    ws = hf_tests._deepseek_ws(rng, cfg, q_lora=24)
    for i in range(cfg["first_k_dense_replace"], cfg["num_hidden_layers"]):
        ws[f"model.layers.{i}.mlp.gate.e_score_correction_bias"] = (
            rng.standard_normal(cfg["n_routed_experts"]) * 0.3).astype(
                np.float32)
    return hf_file(root, cfg, ws)


def _d192_file(root) -> str:
    """The V2/V3 head on a tiny body: 2 heads of qk 128 + 64 and v 128,
    kv LoRA 32, a leading dense layer and a MoE one."""
    cfg = dict(hf_tests._deepseek_cfg(), num_hidden_layers=2,
               num_attention_heads=2, num_key_value_heads=2,
               qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128)
    return hf_file(root, cfg, hf_tests._deepseek_ws(
        np.random.default_rng(25), cfg))


WRITERS = {
    "deepseek2-lite": lambda root: converted(
        hf_tests.test_convert_deepseek2_lite_matches_transformers, root),
    "deepseek-v3": _v3_file,
    "minicpm3": lambda root: converted(
        hf_tests.test_convert_minicpm3_matches_torch_reference, root),
    "deepseek2-d192": _d192_file,
}
NAMES = list(WRITERS)
# each jitted or op-by-op JAX engine check compiles anew a fixture
# (Tier-1's clock): q8_0 beside bf16 and batched decode on two fixtures,
# the op-by-op logits and greedy tokens on all but the D = 192 one
Q8_NAMES = ("deepseek2-lite", "deepseek2-d192")
BATCHED_NAMES = ("deepseek2-lite", "deepseek-v3")
ENGINE_NAMES = NAMES[:-1]


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
    return {name: write(tmp_path_factory.mktemp(name))
            for name, write in WRITERS.items()}


# ---------------------------------------------------------------------------
# the fixtures through the engine

# name -> (head_dim, v_dim, rope_dim, n_lora_q, n_lora_kv, gating)
GEOM = {"deepseek2-lite": (24, 12, 8, 0, 32, "softmax"),
        "deepseek-v3": (24, 12, 8, 24, 32, "sigmoid"),
        "minicpm3": None,
        "deepseek2-d192": (192, 128, 64, 0, 32, "softmax")}


@pytest.mark.parametrize("name", NAMES)
def test_hparams_match_reference(paths, name):
    """Every field equals the JAX package's (the ranks, v_dim, the YaRN
    magnitude in the attention scale, norm_topk by expert_weights_norm,
    the gating)."""
    hp = check_hparams(paths[name])
    if GEOM[name] is not None:
        assert (hp.head_dim, hp.v_dim, hp.rope_dim, hp.n_lora_q,
                hp.n_lora_kv, hp.expert_gating) == GEOM[name]
        assert hp.norm_topk == (name == "deepseek-v3")
        assert hp.n_layer_dense_lead == 1
    else:
        assert hp.arch == "minicpm3" and hp.rope_type == "neox"
        assert hp.n_lora_q > 0 and hp.v_dim < hp.head_dim
    if name == "deepseek-v3":
        m = 1.0 + hp.rope_yarn_log_mul * np.log(hp.rope_scale_factor)
        assert abs(hp.attn_scale - m * m / np.sqrt(hp.head_dim)) < 1e-9
        assert m > 1.1


@pytest.mark.parametrize("name", NAMES)
def test_loader_planes_match_reference(paths, name):
    """The MLA planes (pe rows permuted on the NORM-rope deepseek2 files
    only), their norms, the shared experts, the selection bias and the
    leading dense layer equal the JAX loader's; the rope table of the
    YaRN file (V3's) runs at magnitude 1, as the reference's."""
    assert_same_weights(paths[name])
    _, pm = models(paths[name])
    lw = pm.weights.layers[-1]
    assert lw.wkv_a is not None and lw.wqkv is None and lw.wk is None
    assert (lw.wq_a is not None) == (pm.hp.n_lora_q > 0)
    assert (lw.exp_probs_b is not None) == (name == "deepseek-v3")
    assert pm.weights.rope_mscale == 1.0


@pytest.mark.parametrize("name,kv", [(n, "bf16") for n in NAMES] +
                         [(n, "q8_0") for n in Q8_NAMES])
def test_prefill_decode_logits_match_reference(paths, name, kv):
    check_logits(paths[name], kv)


@pytest.mark.parametrize("name", ENGINE_NAMES)
def test_logits_match_reference_op_by_op(paths, name):
    check_op_by_op(paths[name])


@pytest.mark.parametrize("name", ENGINE_NAMES)
def test_greedy_tokens_match_reference(paths, name):
    check_greedy(paths[name])


@pytest.mark.parametrize("name", BATCHED_NAMES)
def test_batched_decode_matches_reference(paths, name):
    check_batched(paths[name])


@pytest.mark.parametrize("name", NAMES)
def test_port_runs_on_reference_parameters(paths, name):
    check_reference_parameters(paths[name])


def test_cli_text_matches_reference(paths):
    check_cli(paths["deepseek2-lite"])


def test_scheduler_serves_as_generate(paths):
    check_scheduler(paths["deepseek-v3"])


def test_server_completes_as_generate(paths):
    """The server admits an MLA file through check_arch and answers a
    greedy completion of a token prompt with generate()'s text."""
    from test_torch_arch_encoders import _stop
    from test_torch_server import Client

    from llama_cpp_test_tpu_torch.server import app as papp

    _, pm = models(paths["deepseek2-lite"])
    want = list(pengine.generate(pengine.Context(pm, **CTX), [3, 17, 42], 6))
    srv = papp.LlamaServer(paths["deepseek2-lite"], n_ctx=64, n_slots=1,
                           device="cpu")
    srv.engine.start()
    c = Client(srv)
    try:
        status, out = c.post("/v1/completions", {
            "prompt": [3, 17, 42], "max_tokens": 6, "temperature": 0.0,
            "ignore_eos": True})
        assert status == 200, out
        assert out["choices"][0]["text"] == "".join(
            pm.tokenizer.token_to_piece(t) for t in want)
    finally:
        _stop((srv, c))


# ---------------------------------------------------------------------------
# the attention kernels' plain versions at D = 192


@pytest.mark.parametrize("h,kv,window,cap", [(4, 4, 0, 0.0), (8, 2, 5, 30.0)],
                         ids=["G1", "G4-window-softcap"])
def test_flash_prefill_d192_matches_pallas(h, kv, window, cap):
    """K2's plain version at D = 192 (MLA's G = 1, and GQA with a window
    and softcap) against the JAX Pallas kernel in interpret mode."""
    q, kp, vp, pos, kl, bt = prefill_case(h=h, kv=kv, d=192)
    (jq, tq), (jk, tk), (jv, tv) = both(q * 0.07), both(kp), both(vp)
    ints = [both(a, "i32") for a in (pos, kl, bt)]
    ref = flash_prefill(jq, jk, jv, *[j for j, _ in ints], window=window,
                        soft_cap=cap, interpret=True)
    got = pfp.flash_prefill(tq, tk, tv, *[t for _, t in ints], window=window,
                            soft_cap=cap)
    assert got.shape == tuple(ref.shape) and got.dtype == torch.bfloat16
    assert nmse(f32(ref), f32(got)) < ATTN_GATE, nmse(f32(ref), f32(got))


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "q8"])
@pytest.mark.parametrize("g,lengths", [(1, None), (4, [1, 16, 37])],
                         ids=["G1", "G4-short"])
def test_paged_decode_d192_matches_pallas(g, lengths, q8):
    """K3's and K3-q8's plain versions at D = 192 against the JAX Pallas
    kernel (its q8 branch over quantized pages) in interpret mode."""
    q, kp, vp, lens, pages = decode_case(g=g, kv=4 if g == 1 else 2,
                                         seed=g, d=192)
    if lengths is not None:
        lens = np.asarray(lengths, np.int32)
    jq, tq = both(q)
    t = lambda a: torch.from_numpy(np.array(a))
    if q8:
        (kq, ks), (vq, vs) = (jkv.quantize_q8(jnp.asarray(a))
                              for a in (kp, vp))
        ref = pa.paged_attention_decode(
            jq, kq, vq, jnp.asarray(lens), jnp.asarray(pages),
            interpret=True, pages_per_step=2, k_scale=ks, v_scale=vs)
        got = ppa.paged_attention_decode(tq, t(kq), t(vq), t(lens), t(pages),
                                         k_scale=t(ks), v_scale=t(vs))
    else:
        (jk, tk), (jv, tv) = both(kp), both(vp)
        ref = pa.paged_attention_decode(jq, jk, jv, jnp.asarray(lens),
                                        jnp.asarray(pages), interpret=True)
        got = ppa.paged_attention_decode(tq, tk, tv, t(lens), t(pages))
    assert got.shape == tuple(ref.shape)
    assert nmse(f32(ref), f32(got)) < ATTN_GATE, nmse(f32(ref), f32(got))


def test_d192_heads_are_accepted_by_the_kernels():
    """D = 192 joins the head dims K2 and K3 are built for; any other
    still raises on CUDA."""
    assert 192 in pfp.HEAD_DIMS and 192 in ppa.HEAD_DIMS
    assert 160 not in pfp.HEAD_DIMS and 160 not in ppa.HEAD_DIMS


# ---------------------------------------------------------------------------
# the KV cache at D = 192


def test_pools_sized_at_head_dim(paths):
    """An MLA Context's pools hold head_dim (192) rows on the file's KV
    heads, K and V alike (V zero-padded), as the reference's; so do the
    bytes a token takes."""
    jm, pm = models(paths["deepseek2-d192"])
    for kv in ("bf16", "q8_0"):
        jp = jengine.Context(jm, kv_type=kv, **CTX).pools
        pp = pengine.Context(pm, kv_type=kv, **CTX).pools
        assert [tuple(x.shape) for x in jp.k + jp.v] == \
            [tuple(x.shape) for x in pp.k + pp.v]
        assert pp.k[0].shape[-1] == 192 and pp.k[0].shape[0] == 2
    assert pkv.kv_bytes_per_token(pm.hp) == jkv.kv_bytes_per_token(jm.hp)
    assert pkv.kv_bytes_per_token(pm.hp, "q8_0") == 2 * 2 * 2 * (192 + 4)
    ctx = pengine.Context(pm, **CTX)
    s = ctx.new_seq()
    ctx.prefill(s, PROMPT[:5])
    v = cached_kv(ctx, s)[1]
    assert not v[..., 128:].any() and v[..., :128].any()


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
def test_session_round_trip_d192(paths, tmp_path, kv):
    """A saved D = 192 sequence restored into a fresh Context decodes the
    unsaved one's logits (to the bit at bf16 KV); a bf16 file restores in
    the reference too, within the logits gate."""
    jm, pm = models(paths["deepseek2-d192"])
    ctx = pengine.Context(pm, kv_type=kv, **CTX)
    s = ctx.new_seq()
    ctx.prefill(s, PROMPT[:11])
    path = str(tmp_path / "seq.npz")
    pstate.save_seq_state(ctx, s, path)
    assert np.load(path)["k0"].shape[-1] == 192
    want = ctx.decode([s], [5])[0]
    ctx2 = pengine.Context(pm, kv_type=kv, **CTX)
    ctx2.prefill(ctx2.new_seq(), [7, 8])
    s2 = pstate.load_seq_state(ctx2, path)
    got = ctx2.decode([s2], [5])[0]
    if kv == "bf16":
        np.testing.assert_array_equal(want, got)
        jctx = jengine.Context(jm, **CTX)
        js = jstate.load_seq_state(jctx, path)
        assert nmse(jctx.decode([js], [5])[0], got) < LOGITS_GATE
    else:
        assert nmse(want, got) < 1e-5, nmse(want, got)


def test_block_swap_round_trips_d192(paths):
    """A D = 192 sequence whose block was evicted to the host and swapped
    back decodes the same logits, to the bit, as one never evicted."""
    _, pm = models(paths["deepseek2-d192"])
    ref = pengine.Context(pm, **CTX)
    r = ref.new_seq()
    ref.prefill(r, PROMPT[:14])
    want = ref.decode([r], [5])[0]
    ctx = pengine.Context(pm, num_blocks=4, **CTX)
    a = ctx.new_seq()
    ctx.prefill(a, PROMPT[:14])                   # blocks 0-1 of 4
    ctx.prefill(ctx.new_seq(), PROMPT[2:14])      # fills the pool
    ctx.prefill(ctx.new_seq(), PROMPT[:8])        # evicts a's LRU block
    assert ctx.mgr.swap.n_swapped_out >= 1
    np.testing.assert_array_equal(ctx.decode([a], [5])[0], want)
    assert ctx.mgr.swap.n_swapped_in >= 1


@pytest.mark.parametrize("kv", ["bf16", "q8_0"])
def test_shift_turns_the_pe_tail(paths, kv):
    """A context shift (keep 2, drop 5 of 12) on D = 192 MLA pools: each
    moved K row keeps its 128 nope dims to the bit and has its 64 pe dims
    re-roped, so layer 0's K (a function of each token and its position
    alone) equals a fresh prefill of the kept tokens within a rotation's
    rounding, and V moves unchanged. Fault 24: the JAX engine's shift,
    run op by op, turns the first 64 dims (nope ones) and leaves the pe
    tail at the old positions, far from the fresh prefill (shown at bf16
    KV)."""
    jm, pm = models(paths["deepseek2-d192"])
    kw = dict(CTX, kv_type=kv)
    kept = [0, 1] + list(range(7, 12))
    pctx = pengine.Context(pm, **kw)
    ps = pctx.new_seq()
    pctx.prefill(ps, PROMPT[:12])
    before = cached_kv(pctx, ps)
    pctx.shift_context(ps, 2, 5)
    after = cached_kv(pctx, ps)
    fresh = pengine.Context(pm, **kw)
    fs = fresh.new_seq()
    fresh.prefill(fs, [PROMPT[i] for i in kept])
    want = cached_kv(fresh, fs)
    if kv == "bf16":
        np.testing.assert_array_equal(after[0][..., :128],
                                      before[0][:, :, kept][..., :128])
    np.testing.assert_array_equal(after[1], before[1][:, :, kept])
    assert nmse(want[0, 0], after[0, 0]) < 1e-4, nmse(want[0, 0],
                                                      after[0, 0])
    assert np.isfinite(pctx.decode([ps], [11])[0]).all()
    if kv == "q8_0":
        return
    with jax.disable_jit():
        jctx = jengine.Context(jm, **kw)
        js = jctx.new_seq()
        jctx.prefill(js, PROMPT[:12])
        jctx.shift_context(js, 2, 5)
        ref = cached_kv(jctx, js)
    assert nmse(want[0, 0], ref[0, 0]) > 1e-2
    np.testing.assert_array_equal(ref[0, 0][..., 128:],
                                  before[0, 0][:, kept][..., 128:])
    assert nmse(want[0, 0][..., 128:], before[0, 0][:, kept][..., 128:]) \
        > 1e-2


# ---------------------------------------------------------------------------
# an adapter on deepseek2-lite's plain attn_q (NORM-rope pe rows)


def _mla_adapter(path, hp, seed=3, rank=4):
    """A LoRA GGUF over the plain attn_q and attn_output of every layer."""
    rng = np.random.default_rng(seed)
    w = GGUFWriter(path, arch="llama")
    w.add_kv("adapter.type", "lora")
    w.add_kv("adapter.lora.alpha", 8.0)
    c = hp.n_embd
    for li in range(hp.n_layer):
        for t, (n, k) in (("attn_q", (hp.n_head * hp.head_dim, c)),
                          ("attn_output", (c, hp.n_head * hp.v_dim))):
            for suffix, shape in ((".lora_a", (rank, k)),
                                  (".lora_b", (n, rank))):
                w.add_tensor(f"blk.{li}.{t}.weight{suffix}",
                             (rng.standard_normal(shape) * 0.2).astype(
                                 np.float32), ggml_type=GGMLType.F32)
    w.write()
    return path


def test_lora_on_mla_q_equals_the_merged_file(paths, tmp_path):
    """Fault 23: an adapter of deepseek2-lite's plain attn_q and wo. The
    port permutes the attn_q B rows as its loader permutes the plane (the
    pe tail of each head from the NORM layout), so the adapted logits
    equal those of the adapter merged into the file (export-lora, F16
    planes), far from the base's; the reference's load_lora permutes whole
    heads of 24 rows, and its adapted logits are another model's."""
    path = paths["deepseek2-lite"]
    jm, pm = models(path)
    adapter = _mla_adapter(str(tmp_path / "a.gguf"), pm.hp)
    merged = str(tmp_path / "merged.gguf")
    assert plora.merge_lora(path, adapter, merged) == 2 * pm.hp.n_layer
    got = _rows_with(path, adapter)
    assert nmse(_rows_with(merged), got) < 1e-3     # the F16 merge's rounding
    assert nmse(_rows_with(path), got) > 1e-2
    jmodel = jengine.Model(path)
    jlora.attach_lora(jmodel.weights, jlora.load_lora(adapter, jmodel.hp))
    jctx = jengine.Context(jmodel, **CTX)
    ref = jctx.prefill(jctx.new_seq(), PROMPT[:8], all_logits=True)
    mctx = jengine.Context(jengine.Model(merged), **CTX)
    want = mctx.prefill(mctx.new_seq(), PROMPT[:8], all_logits=True)
    assert nmse(want, got) < 1e-3
    assert nmse(want, ref) > 1e-2
