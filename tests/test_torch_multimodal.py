"""Image input of the port (llama_cpp_test_tpu_torch models/{clip,
qwen2vl_vision}, ops/layers.apply_mrope, the qwen2vl arch,
runtime/engine Context.prefill_embeds, cli/llava) against the JAX
package, on CPU, in one process, from numpy seeds:

  clip-mlp       a CLIP mmproj (2 blocks at width 64, CLS, pre-LN) with
                 llava's MLP projector to 64
  clip-gemma3    the same tower without CLS, gemma3's pooled projector
  clip-resampler the same, MiniCPM-V's perceiver resampler (2 heads of 128)
  qwen2vl-vision a Qwen2-VL tower (2 blocks at width 64, 4 heads, quick
                 GELU, patch 4, the surgery script's names: two conv
                 frames, swapped MLP names) merging to 64
  llama          tests/test_engine.make_tiny_gguf (width 64, Q8_0)
  qwen2vl        an F32 qwen2vl text file (biases, tied head, M-RoPE
                 sections 2/3/3 over 8 rope frequencies)

Checks: apply_mrope within 1e-10 of the reference's, equal streams bit
for bit apply_rope; each tower's encode_image within 1e-6 (f32) of the
JAX one, from the same file and through port_*_from_reference;
preprocess_image equal arrays on one PIL image; prefill_embeds logits
within 2e-3 of the jitted JAX engine and the greedy tokens after it
equal; qwen2vl text through Context, Scheduler and cli.main as the JAX
engine; cli.llava's printout equal to the JAX CLI's on both projector
families; and reference fault 25: the JAX llava CLI cannot take a
second qwen2vl image (prefill_embeds refuses a nonzero pos_offset); the
port takes it, its logits those of the reference's step function called
directly with the same streams.
"""
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_engine import make_tiny_gguf, tiny_vocab

from llama_cpp_test_tpu.cli import llava as jllava
from llama_cpp_test_tpu.cli.main import main as jmain
from llama_cpp_test_tpu.gguf.constants import GGMLType
from llama_cpp_test_tpu.gguf.writer import GGUFWriter
from llama_cpp_test_tpu.models import clip as jclip
from llama_cpp_test_tpu.models import qwen2vl_vision as jqv
from llama_cpp_test_tpu.ops import layers as jlayers
from llama_cpp_test_tpu.runtime import engine as jengine
from llama_cpp_test_tpu_torch.cli import llava as pllava
from llama_cpp_test_tpu_torch.cli.main import main as pmain
from llama_cpp_test_tpu_torch.gguf.reader import GGUFReader as PGGUFReader
from llama_cpp_test_tpu_torch.models import clip as pclip
from llama_cpp_test_tpu_torch.models import hparams as phparams
from llama_cpp_test_tpu_torch.models.llama import embed
from llama_cpp_test_tpu_torch.models import qwen2vl_vision as pqv
from llama_cpp_test_tpu_torch.models import registry as pregistry
from llama_cpp_test_tpu_torch.ops import layers as players
from llama_cpp_test_tpu_torch.runtime import engine as pengine
from llama_cpp_test_tpu_torch.runtime.sampling import SamplerParams
from llama_cpp_test_tpu_torch.runtime.scheduler import GenRequest, Scheduler
from llama_cpp_test_tpu_torch.weights import (
    port_clip_from_reference, port_qwen2vl_vision_from_reference)

LOGITS_GATE = 2e-3
TOWER_GATE = 1e-6
C = 64                      # the LLMs' width, every projector's output
HID, HEADS, FF, PATCH, IMG = 64, 4, 128, 8, 32    # the CLIP towers
QP, QGRID = 4, 8            # Qwen2-VL patch and grid: 64 patches, 16 tokens
SECTIONS = [2, 3, 3, 0]     # qwen2vl rope.dimension_sections (head dim 16)
CTX = dict(n_ctx=128, n_seq_max=2, block_size=8)
CLIPS = ["clip-mlp", "clip-gemma3", "clip-resampler"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs (pytest-xdist workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nmse(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(((a - b) ** 2).mean() / ((a * a).mean() + 1e-12))


def _rand(rng):
    return lambda *s: (rng.standard_normal(s) * 0.08).astype(np.float32)


def _block(r, p, e, ff):
    """One pre-LN ViT block's tensors under the clip.cpp names."""
    return {p + "ln1.weight": 1.0 + r(e), p + "ln1.bias": r(e),
            p + "attn_q.weight": r(e, e), p + "attn_q.bias": r(e),
            p + "attn_k.weight": r(e, e), p + "attn_k.bias": r(e),
            p + "attn_v.weight": r(e, e), p + "attn_v.bias": r(e),
            p + "attn_out.weight": r(e, e), p + "attn_out.bias": r(e),
            p + "ln2.weight": 1.0 + r(e), p + "ln2.bias": r(e),
            p + "ffn_up.weight": r(ff, e), p + "ffn_up.bias": r(ff),
            p + "ffn_down.weight": r(e, ff), p + "ffn_down.bias": r(e)}


def _write(path, md, tensors):
    w = GGUFWriter(path, arch="clip")
    for k, v in {"general.architecture": "clip", **md}.items():
        w.add_kv(k, v)
    for name, arr in tensors.items():
        w.add_tensor(name, arr, ggml_type=GGMLType.F32)
    w.write()


def make_clip(path, kind, seed=0):
    """A 2-block CLIP mmproj at width 64 with one of the three projectors
    (test_clip.py's layouts): "mlp" (CLS, pre-LN, mm.0/mm.2), "gemma3"
    (no CLS, pooled by 2, RMS norm, one projection) or "resampler"
    (no CLS; 8 queries, 2 heads of 128)."""
    r = _rand(np.random.default_rng(seed))
    n_pos = (IMG // PATCH) ** 2
    md = {"clip.has_vision_encoder": True, "clip.use_gelu": True,
          "clip.projector_type": kind,
          "clip.vision.image_size": IMG, "clip.vision.patch_size": PATCH,
          "clip.vision.embedding_length": HID,
          "clip.vision.feed_forward_length": FF,
          "clip.vision.block_count": 2,
          "clip.vision.attention.head_count": HEADS,
          "clip.vision.attention.layer_norm_epsilon": 1e-5,
          "clip.vision.image_mean": [0.5, 0.5, 0.5],
          "clip.vision.image_std": [0.3, 0.3, 0.3]}
    t = {"v.patch_embd.weight": r(HID, 3, PATCH, PATCH),
         "v.patch_embd.bias": r(HID)}
    if kind == "mlp":
        md["clip.has_llava_projector"] = True
        t.update({"v.class_embd": r(HID),
                  "v.position_embd.weight": r(n_pos + 1, HID),
                  "v.pre_ln.weight": 1.0 + r(HID), "v.pre_ln.bias": r(HID),
                  "mm.0.weight": r(C, HID), "mm.0.bias": r(C),
                  "mm.2.weight": r(C, C), "mm.2.bias": r(C)})
    elif kind == "gemma3":
        md["clip.vision.projector.scale_factor"] = 2
        t.update({"v.position_embd.weight": r(n_pos, HID),
                  "mm.input_projection.weight": r(C, HID),
                  "mm.soft_emb_norm.weight": 1.0 + r(HID)})
    else:
        hr, nq = 256, 8
        md["clip.has_minicpmv_projector"] = True
        t.update({"v.position_embd.weight": r(n_pos, HID),
                  "resampler.query": r(nq, hr),
                  "resampler.proj.weight": r(C, hr),
                  "resampler.kv.weight": r(hr, HID)})
        for n in ("q", "k", "v", "out"):
            t[f"resampler.attn.{n}.weight"] = r(hr, hr)
            t[f"resampler.attn.{n}.bias"] = r(hr)
        for n in ("ln_q", "ln_kv", "ln_post"):
            t[f"resampler.{n}.weight"] = 1.0 + r(hr)
            t[f"resampler.{n}.bias"] = r(hr)
    for i in range(2):
        t.update(_block(r, f"v.blk.{i}.", HID, FF))
    _write(path, md, t)


def make_qwen2vl_mmproj(path, seed=0):
    """A 2-block Qwen2-VL tower at width 64 (4 heads of 16, MLP 128, quick
    GELU, patch 4) written as llama.cpp's qwen2_vl_surgery.py names it:
    the conv3d as two frames (.weight, .weight.1), fc1 under "ffn_down"
    and fc2 under "ffn_up", the merger's ln_q as v.post_ln."""
    r = _rand(np.random.default_rng(seed))
    e, mlp = 64, 128
    md = {"clip.has_vision_encoder": True, "clip.has_qwen2vl_merger": True,
          "clip.projector_type": "qwen2vl_merger",
          "clip.vision.image_size": 560, "clip.vision.patch_size": QP,
          "clip.vision.embedding_length": e,
          "clip.vision.feed_forward_length": 0,
          "clip.vision.projection_dim": C, "clip.vision.block_count": 2,
          "clip.vision.attention.head_count": 4,
          "clip.vision.attention.layer_norm_epsilon": 1e-6,
          "clip.vision.image_mean": [0.48145466, 0.4578275, 0.40821073],
          "clip.vision.image_std": [0.26862954, 0.26130258, 0.27577711]}
    t = {"v.patch_embd.weight": r(e, 3, QP, QP),
         "v.patch_embd.weight.1": r(e, 3, QP, QP),
         "v.post_ln.weight": 1.0 + r(e), "v.post_ln.bias": r(e),
         "mm.0.weight": r(4 * e, 4 * e), "mm.0.bias": r(4 * e),
         "mm.2.weight": r(C, 4 * e), "mm.2.bias": r(C)}
    for i in range(2):
        b = _block(r, f"v.blk.{i}.", e, mlp)
        # the surgery's swapped names: fc1 [mlp, e] is "ffn_down"
        p = f"v.blk.{i}."
        b[p + "ffn_down.weight"], b[p + "ffn_up.weight"] = (
            b.pop(p + "ffn_up.weight"), b.pop(p + "ffn_down.weight"))
        b[p + "ffn_down.bias"], b[p + "ffn_up.bias"] = (
            b.pop(p + "ffn_up.bias"), b.pop(p + "ffn_down.bias"))
        t.update(b)
    _write(path, md, t)


def make_tiny_qwen2vl(path, seed=0):
    """An F32 qwen2vl text file at test_engine's widths (64, 4 heads on 2,
    head dim 16, FFN 96, 2 layers, vocab 288): Q/K/V biases, a tied head,
    rope base 1e6 and dimension_sections 2/3/3/0."""
    rng = np.random.default_rng(seed)
    r = lambda *s, sd=0.08: (rng.standard_normal(s) * sd).astype(np.float32)
    hq, hkv, d, ff, v = 4, 2, 16, 96, 288
    t = {"token_embd.weight": r(v, C, sd=0.3),
         "output_norm.weight": 1.0 + r(C, sd=0.05)}
    for i in range(2):
        p = f"blk.{i}."
        t.update({p + "attn_norm.weight": 1.0 + r(C, sd=0.05),
                  p + "attn_q.weight": r(hq * d, C),
                  p + "attn_k.weight": r(hkv * d, C),
                  p + "attn_v.weight": r(hkv * d, C),
                  p + "attn_q.bias": r(hq * d, sd=0.05),
                  p + "attn_k.bias": r(hkv * d, sd=0.05),
                  p + "attn_v.bias": r(hkv * d, sd=0.05),
                  p + "attn_output.weight": r(C, hq * d),
                  p + "ffn_norm.weight": 1.0 + r(C, sd=0.05),
                  p + "ffn_gate.weight": r(ff, C),
                  p + "ffn_up.weight": r(ff, C),
                  p + "ffn_down.weight": r(C, ff)})
    md = {"context_length": 4096, "embedding_length": C, "block_count": 2,
          "attention.head_count": hq, "attention.head_count_kv": hkv,
          "attention.key_length": d, "attention.value_length": d,
          "feed_forward_length": ff, "rope.dimension_count": d,
          "rope.freq_base": 1e6, "rope.dimension_sections": SECTIONS,
          "attention.layer_norm_rms_epsilon": 1e-6, "vocab_size": v}
    w = GGUFWriter(path, arch="qwen2vl")
    for k, val in md.items():
        w.add_kv(f"qwen2vl.{k}", val)
    toks, scores, types = tiny_vocab(v)
    for k, val in {"tokenizer.ggml.model": "llama",
                   "tokenizer.ggml.tokens": toks,
                   "tokenizer.ggml.scores": np.asarray(scores, np.float32),
                   "tokenizer.ggml.token_type": np.asarray(types, np.int32),
                   "tokenizer.ggml.bos_token_id": 1,
                   "tokenizer.ggml.eos_token_id": 2,
                   "tokenizer.ggml.unknown_token_id": 0,
                   "tokenizer.ggml.add_bos_token": True}.items():
        w.add_kv(k, val)
    for name, arr in t.items():
        w.add_tensor(name, arr, ggml_type=GGMLType.F32)
    w.write()


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    root = tmp_path_factory.mktemp("multimodal")
    out = {name: str(root / f"{name}.gguf") for name in
           CLIPS + ["qwen2vl-vision", "llama", "qwen2vl"]}
    for i, name in enumerate(CLIPS):
        make_clip(out[name], name.split("-")[1], seed=10 + i)
    make_qwen2vl_mmproj(out["qwen2vl-vision"], seed=20)
    make_tiny_gguf(out["llama"])
    make_tiny_qwen2vl(out["qwen2vl"], seed=21)
    return out


_MODELS: dict = {}


def models(paths, name):
    """(JAX Model, port Model) of an LLM fixture, loaded once a module."""
    if name not in _MODELS:
        p = paths[name]
        _MODELS[name] = (jengine.Model(p), pengine.Model(p, device="cpu"))
    return _MODELS[name]


def run(main, argv, **kw):
    old = sys.stdout
    sys.stdout = io.StringIO()
    try:
        return main(argv, **kw), sys.stdout.getvalue()
    finally:
        sys.stdout = old


def _pixels(seed):
    return np.random.default_rng(seed).standard_normal(
        (3, IMG, IMG)).astype(np.float32)


def _patches(seed, grid=QGRID):
    return (np.random.default_rng(seed).standard_normal(
        (grid * grid, 3 * 2 * QP * QP)) * 0.5).astype(np.float32)


# ---------------------------------------------------------------------------
# M-RoPE, the arch


@pytest.mark.parametrize("rope_dim,mscale", [(16, 1.0), (12, 1.25)])
def test_apply_mrope_matches_reference(rope_dim, mscale):
    """Random q [B, T, H, D] and distinct streams, full and partial rope
    (the unrotated tail kept), within 1e-10 of the reference."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos3 = rng.integers(0, 300, size=(2, 7, 3)).astype(np.int32)
    half = rope_dim // 2
    inv = (1e6 ** (-2.0 * np.arange(half) / rope_dim)).astype(np.float32)
    sections = (1, (half - 1) // 2, half - 1 - (half - 1) // 2)
    want = np.asarray(jlayers.apply_mrope(
        jnp.asarray(x), jnp.asarray(pos3), jnp.asarray(inv), sections, mscale))
    got = players.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                              torch.from_numpy(inv), sections, mscale)
    assert nmse(want, got.numpy()) < 1e-10


def test_apply_mrope_equal_streams_is_apply_rope():
    """Equal t/h/w streams give apply_rope's values bit for bit."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((1, 9, 4, 16)).astype(
        np.float32)).to(torch.bfloat16)
    pos = torch.from_numpy(rng.integers(0, 5000, size=(1, 9)).astype(
        np.int32))
    inv = torch.from_numpy((1e6 ** (-np.arange(8) / 8.0)).astype(np.float32))
    got = players.apply_mrope(x, pos[..., None].expand(1, 9, 3), inv,
                              (2, 3, 3), 1.0)
    assert torch.equal(got, players.apply_rope(x, pos, inv, 1.0))


def test_qwen2vl_is_ported_with_its_sections(paths):
    """qwen2vl is in PORTED, its HParams (mrope_sections the first three
    dimension_sections, NEOX rope) equal the JAX package's, and no
    refusal names item 7 (the paged engine takes it)."""
    from llama_cpp_test_tpu.gguf.reader import GGUFReader
    from llama_cpp_test_tpu.models import hparams as jhparams

    assert "qwen2vl" in pregistry.PORTED
    pregistry.check_arch("qwen2vl")
    with GGUFReader(paths["qwen2vl"]) as r:
        jhp = jhparams.hparams_from_metadata(r.metadata)
    php = phparams.hparams_from_metadata(
        PGGUFReader(paths["qwen2vl"]).metadata)
    assert php.mrope_sections == (2, 3, 3) and php.rope_type == "neox"
    for f in php.__dataclass_fields__:
        assert getattr(php, f) == getattr(jhp, f), f


# ---------------------------------------------------------------------------
# the vision towers


@pytest.mark.parametrize("name", CLIPS)
def test_clip_encode_matches_reference(paths, name):
    """CLIP with each projector: the port loaded from the same file, and
    the reference's loaded parameters through port_clip_from_reference,
    within 1e-6 of the JAX encode_image; two images in one batch too."""
    jm = jclip.load_clip(paths[name])
    pm = pclip.load_clip(paths[name], device="cpu")
    assert (pm.proj_type, pm.n_patches, pm.proj_scale) == \
        (jm.proj_type, jm.n_patches, jm.proj_scale)
    px = np.stack([_pixels(3), _pixels(4)])
    want = jclip.encode_image(jm, px)
    for m in (pm, port_clip_from_reference(jm, device="cpu")):
        got = pclip.encode_image(m, px)
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert nmse(want, got.numpy()) < TOWER_GATE
    one = pclip.encode_image(pm, px[0]).numpy()
    assert nmse(want[: one.shape[0]], one) < TOWER_GATE


def test_qwen2vl_tower_matches_reference(paths):
    """The Qwen2-VL tower (surgery names, two conv frames, swapped MLP
    names, merged-group patch order) within 1e-6 of the JAX one, from the
    file and through port_qwen2vl_vision_from_reference; a non-square
    grid too."""
    path = paths["qwen2vl-vision"]
    jm = jqv.load_qwen2vl_vision(path)
    pm = pqv.load_qwen2vl_vision(path, device="cpu")
    assert (pm.embed, pm.n_head, pm.out_dim, pm.act) == \
        (jm.embed, jm.n_head, jm.out_dim, jm.act)
    for gh, gw, seed in ((QGRID, QGRID, 5), (4, 8, 6)):
        patches = _patches(seed)[: gh * gw]
        want = jqv.encode_image(jm, patches, gh, gw)
        for m in (pm, port_qwen2vl_vision_from_reference(jm, device="cpu")):
            got = pqv.encode_image(m, patches, gh, gw)
            assert got.shape == want.shape == (gh * gw // 4, C)
            assert nmse(want, got.numpy()) < TOWER_GATE
    for a, b in zip(pqv.vision_patch_hw(6, 4), jqv.vision_patch_hw(6, 4)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pqv.mrope_image_positions(9, 6, 4),
                                  jqv.mrope_image_positions(9, 6, 4))
    assert pqv.mrope_delta_after_image(9, 6, 4) == \
        jqv.mrope_delta_after_image(9, 6, 4)
    for hw in ((40, 40), (1000, 700), (30, 5000)):
        assert pqv.smart_resize(*hw) == jqv.smart_resize(*hw)


def test_towers_in_float64_agree(paths):
    """Each tower moved to float64 (the smoke's reference run on the card)
    gives its float32 result within the tower gate, in float64."""
    pm = pclip.load_clip(paths["clip-mlp"], device="cpu")
    px = _pixels(8)
    hi = pclip.encode_image(pm.to(dtype=torch.float64), px)
    assert hi.dtype == torch.float64
    assert nmse(hi.numpy(), pclip.encode_image(pm, px).numpy()) < TOWER_GATE
    qm = pqv.load_qwen2vl_vision(paths["qwen2vl-vision"], device="cpu")
    hi = pqv.encode_image(qm.to(dtype=torch.float64), _patches(9), QGRID,
                          QGRID)
    assert hi.dtype == torch.float64
    assert nmse(hi.numpy(), pqv.encode_image(
        qm, _patches(9), QGRID, QGRID).numpy()) < TOWER_GATE


@pytest.mark.parametrize("tower", ["clip", "qwen2vl"])
def test_preprocess_image_matches_reference(paths, tower):
    """Both packages' preprocess_image on one PIL image (not square, so
    CLIP pads and Qwen2-VL resizes off the patch grid): equal arrays."""
    from PIL import Image

    img = Image.fromarray(np.random.default_rng(7).integers(
        0, 255, (50, 30, 3), dtype=np.uint8))
    if tower == "clip":
        want = jclip.preprocess_image(jclip.load_clip(paths["clip-mlp"]), img)
        got = pclip.preprocess_image(
            pclip.load_clip(paths["clip-mlp"], device="cpu"), img)
        np.testing.assert_array_equal(got, want)
        return
    path = paths["qwen2vl-vision"]
    want = jqv.preprocess_image(jqv.load_qwen2vl_vision(path), img)
    got = pqv.preprocess_image(pqv.load_qwen2vl_vision(path, device="cpu"),
                               img)
    assert got[1:] == want[1:]
    np.testing.assert_array_equal(got[0], want[0])


# ---------------------------------------------------------------------------
# Context.prefill_embeds


def _embeds(paths, name, seed):
    """Image embeddings from the JAX tower, the same array for both
    engines: a CLIP mlp image (16 tokens) or a Qwen2-VL one (16)."""
    if name == "llama":
        return jclip.encode_image(jclip.load_clip(paths["clip-mlp"]),
                                  _pixels(seed))
    return jqv.encode_image(jqv.load_qwen2vl_vision(paths["qwen2vl-vision"]),
                            _patches(seed), QGRID, QGRID)


def _image(ctx, s, name, emb):
    """One image as the llava CLI feeds it: CLIP embeddings at the next
    positions, or Qwen2-VL's with their M-RoPE streams and the text
    after them from the compressed position."""
    if name == "llama":
        return ctx.prefill_embeds(s, emb, placeholder_token=5)
    t_img = s.n_cached + s.pos_offset
    logits = ctx.prefill_embeds(s, emb, placeholder_token=5,
                                mrope_pos=jqv.mrope_image_positions(
                                    t_img, QGRID, QGRID))
    s.pos_offset = jqv.mrope_delta_after_image(t_img, QGRID, QGRID) - \
        s.n_cached
    return logits


def _turn(eng, model, name, emb, n_gen=6):
    """Text, an image, text, then n_gen greedy decode steps: every
    step's logits, the greedy tokens and the sequence state."""
    ctx = eng.Context(model, **CTX)
    s = ctx.new_seq()
    rows = [ctx.prefill(s, [1, 17, 42]), _image(ctx, s, name, emb),
            ctx.prefill(s, [9, 150, 7, 23])]
    toks = []
    for _ in range(n_gen):
        toks.append(int(np.argmax(rows[-1])))
        rows.append(ctx.decode([s], [toks[-1]])[0])
    return rows, toks, (list(s.tokens), s.n_cached, s.pos_offset)


@pytest.mark.parametrize("name", ["llama", "qwen2vl"])
def test_prefill_embeds_matches_reference(paths, name):
    """An image between two text prefills (CLIP embeddings into the llama
    file; Qwen2-VL ones with their M-RoPE streams into the qwen2vl file,
    pos_offset set as the CLI sets it), then 6 greedy decode steps: every
    row within 2e-3 of the jitted JAX engine, the same greedy tokens, the
    placeholder recorded and the same positions."""
    jm, pm = models(paths, name)
    emb = _embeds(paths, name, 3)
    want, want_toks, want_state = _turn(jengine, jm, name, emb)
    got, toks, state = _turn(pengine, pm, name, emb)
    assert toks == want_toks and state == want_state
    assert state[0][3:19] == [5] * 16
    for i, (a, b) in enumerate(zip(want, got)):
        assert np.isfinite(b).all()
        assert nmse(a, b) < LOGITS_GATE, (i, nmse(a, b))


def test_prefill_embeds_of_token_rows_is_prefill(paths):
    """The model's own embedding rows through prefill_embeds give the
    token prefill's logits bit for bit (the rows are bf16 already), and
    decoding continues alike; a tensor input is taken as an array is."""
    _, pm = models(paths, "llama")
    toks = [3, 17, 42, 9]
    a = pengine.Context(pm, **CTX)
    sa = a.new_seq()
    want = a.prefill(sa, toks)
    rows = embed(pm.weights, torch.tensor(toks)).float().numpy()
    b = pengine.Context(pm, **CTX)
    sb = b.new_seq()
    got = b.prefill_embeds(sb, rows)
    assert sb.tokens == [-1] * 4 and sb.n_cached == 4
    np.testing.assert_array_equal(got, want)
    t = int(np.argmax(want))
    np.testing.assert_array_equal(a.decode([sa], [t]), b.decode([sb], [t]))
    c = pengine.Context(pm, **CTX)
    np.testing.assert_array_equal(c.prefill_embeds(c.new_seq(),
                                                   torch.from_numpy(rows)),
                                  want)


def test_prefill_embeds_refusals(paths):
    """A wrong width, an empty list and a Self-Extend offset without
    streams raise, as the reference's do (the width check is the port's)."""
    _, pm = models(paths, "llama")
    ctx = pengine.Context(pm, **CTX)
    s = ctx.new_seq()
    with pytest.raises(ValueError, match="width"):
        ctx.prefill_embeds(s, np.zeros((4, C + 1), np.float32))
    with pytest.raises(ValueError, match="empty"):
        ctx.prefill_embeds(s, np.zeros((0, C), np.float32))
    s.pos_offset = -3
    with pytest.raises(NotImplementedError, match="self_extend"):
        ctx.prefill_embeds(s, np.zeros((4, C), np.float32))


# ---------------------------------------------------------------------------
# qwen2vl text, the llava CLI


def test_qwen2vl_text_matches_reference(paths):
    """qwen2vl text alone (its streams equal, so NEOX rope): generate()'s
    greedy tokens equal the JAX engine's, three Scheduler requests give
    generate()'s tokens, and cli.main prints the JAX CLI's text."""
    jm, pm = models(paths, "qwen2vl")
    prompts = [[1, 17, 42 + i, 9] for i in range(3)]
    want = [list(jengine.generate(jengine.Context(jm, **CTX), p, 10))
            for p in prompts]
    got = [list(pengine.generate(pengine.Context(pm, **CTX), p, 10))
           for p in prompts]
    assert got == want
    sched = Scheduler(pengine.Context(pm, n_ctx=128, n_seq_max=3,
                                      block_size=8), n_slots=3,
                      decode_window=4)
    reqs = [sched.submit(GenRequest(p, max_tokens=10,
                                    sampling=SamplerParams(temp=0.0)))
            for p in prompts]
    sched.run()
    assert [r.output_tokens for r in reqs] == got
    argv = ["-m", paths["qwen2vl"], "-p", "hello world", "-n", "8",
            "--temp", "0"]
    assert run(pmain, argv, device="cpu") == run(jmain, argv)


@pytest.fixture(scope="module")
def png(tmp_path_factory):
    """Two 40 x 40 PNGs (CLIP resizes them to 32; Qwen2-VL to 56, a 14 x
    14 grid of 49 merged tokens)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("images")
    out = []
    for seed in (4, 5):
        p = str(root / f"img{seed}.png")
        Image.fromarray(np.random.default_rng(seed).integers(
            0, 255, (40, 40, 3), dtype=np.uint8)).save(p)
        out.append(p)
    return out


@pytest.mark.parametrize("llm,mmproj,seeded", [
    ("llama", "clip-mlp", False), ("qwen2vl", "qwen2vl-vision", False),
    ("qwen2vl", "qwen2vl-vision", True)])
def test_llava_cli_matches_reference(paths, png, llm, mmproj, seeded):
    """cli.llava on each projector family (the family read from the
    mmproj) prints the JAX CLI's tokens: greedy against the jitted JAX
    CLI; seeded (temp 0.8) against it run op by op (jitted XLA drops bf16
    roundings, ~3e-5 NMSE on these logits, enough to move a draw)."""
    argv = ["-m", paths[llm], "--mmproj", paths[mmproj], "--image", png[0],
            "-p", "a<image>b", "-n", "6"] + (
        ["--temp", "0.8", "-s", "3"] if seeded else ["--temp", "0"])
    with jax.disable_jit(seeded):
        want = run(jllava.main, argv)
    assert run(pllava.main, argv, device="cpu") == want
    assert want[0] == 0 and want[1].strip()


# ---------------------------------------------------------------------------
# reference fault 25


def _jax_embeds_step(ctx, s, emb, streams):
    """The JAX Context.prefill_embeds body without its pos_offset guard:
    the same host arrays into the reference's _prefill_embeds_step."""
    hp = ctx.model.hp
    t0, n = s.n_cached, emb.shape[0]
    slots = s.table.append_tokens(n)
    ctx._drain_copies([s])
    tb = jengine._bucket(n, jengine.TOKEN_BUCKETS)
    x = np.zeros((1, tb, hp.n_embd), np.float32)
    x[0, :n] = emb
    pos = np.zeros((1, tb), np.int32)
    pos[0, :n] = np.arange(t0, t0 + n)
    slot_arr = np.full((1, tb), -1, np.int32)
    slot_arr[0, :n] = slots
    mr = np.zeros((1, tb, 3), np.int32)
    mr[0, :n] = streams
    bt = ctx._table_arr([s])
    s.tokens.extend([5] * n)
    s.n_cached += n
    logits, ctx.pools = jengine._prefill_embeds_step(
        ctx.w, ctx.pools, jnp.asarray(x), pos, bt, slot_arr,
        np.asarray([t0 + n], np.int32), np.asarray([n - 1], np.int32), mr,
        hp=hp)
    return np.asarray(logits[0])


def test_reference_llava_cli_refuses_a_second_qwen2vl_image(paths, png):
    """Fault 25: the JAX llava CLI sets pos_offset after a qwen2vl image,
    and its prefill_embeds refuses any nonzero pos_offset, so a second
    image raises; the port's CLI takes it."""
    argv = ["-m", paths["qwen2vl"], "--mmproj", paths["qwen2vl-vision"],
            "--image", png[0], "--image", png[1], "-p", "a<image>b<image>c",
            "-n", "4", "--temp", "0"]
    with pytest.raises(NotImplementedError, match="self_extend"):
        run(jllava.main, argv)
    rc, out = run(pllava.main, argv, device="cpu")
    assert rc == 0 and out.strip()


def test_second_qwen2vl_image_matches_reference_step(paths):
    """The port's second qwen2vl image (pos_offset nonzero) against the
    reference's step function called directly with the same streams:
    every row within 2e-3, the same greedy tokens and positions."""
    jm, pm = models(paths, "qwen2vl")
    e1, e2 = _embeds(paths, "qwen2vl", 3), _embeds(paths, "qwen2vl", 4)
    out = []
    for eng, model in ((jengine, jm), (pengine, pm)):
        ctx = eng.Context(model, **CTX)
        s = ctx.new_seq()
        rows = [ctx.prefill(s, [1, 17, 42]), _image(ctx, s, "qwen2vl", e1),
                ctx.prefill(s, [9, 150])]
        assert s.pos_offset == -12
        t_img = s.n_cached + s.pos_offset
        streams = jqv.mrope_image_positions(t_img, QGRID, QGRID)
        if eng is jengine:
            with pytest.raises(NotImplementedError, match="self_extend"):
                ctx.prefill_embeds(s, e2, mrope_pos=streams)
            rows.append(_jax_embeds_step(ctx, s, e2, streams))
        else:
            rows.append(ctx.prefill_embeds(s, e2, placeholder_token=5,
                                           mrope_pos=streams))
        s.pos_offset = jqv.mrope_delta_after_image(t_img, QGRID, QGRID) - \
            s.n_cached
        rows.append(ctx.prefill(s, [7, 23]))
        toks = []
        for _ in range(4):
            toks.append(int(np.argmax(rows[-1])))
            rows.append(ctx.decode([s], [toks[-1]])[0])
        out.append((rows, toks, (list(s.tokens), s.n_cached, s.pos_offset)))
    (want, want_toks, want_state), (got, toks, state) = out
    assert toks == want_toks and state == want_state
    for i, (a, b) in enumerate(zip(want, got)):
        assert nmse(a, b) < LOGITS_GATE, (i, nmse(a, b))
