"""The vocoder and the tts CLI of the port (llama_cpp_test_tpu_torch
models/wavtokenizer.py, cli/tts.py) against the JAX package, on CPU, in
one process, from numpy seeds.

The vocoder is tests/test_tts's make_vocoder file (features 32, posnet
64 x 6, convnext 64 x 2, FFN 96, 40 codes, n_fft 64, F32). The
text-to-codes LLM is a tiny qwen2 (width 64, 2 layers, Q8_0, tied head)
with OuteTTS's vocab layout (chip_smoke.outetts_vocab: 151672 + 64
tokens, the codes <|0|> ... <|63|> from 151672), its tied embedding drawn
so that greedy decoding walks a seeded chain of codes and then
<|audio_end|> (chip_smoke.chain_rows).

Checks: decode_codes within NMSE 1e-8 of the reference's at 8 and 37
codes; embd_to_audio against the reference's at n_fft 64 and 1280;
--codes mode writing the JAX CLI's WAV header and samples within 1 LSB;
process_text / build_prompt equal; the whole CLI (LLM, then vocoder)
giving the JAX CLI's codes and WAV; reference fault 26 (ROADMAP §3): the
JAX CLI keeps a generated code past the vocoder's rows and its gather
clamps it to the last row, where the port drops it and refuses such a
code in --codes or decode_codes; port_wavtokenizer_from_reference equal
to the loader; cuDNN's TF32 off inside decode_codes only; and CUDA asked
for by default.
"""
import io
import sys
import wave

import numpy as np
import pytest
import torch

import chip_smoke
from test_tts import VOCAB, make_vocoder

from llama_cpp_test_tpu.cli import tts as jtts
from llama_cpp_test_tpu.models import wavtokenizer as jwt
from llama_cpp_test_tpu_torch.cli import tts as ptts
from llama_cpp_test_tpu_torch.models import wavtokenizer as pwt
from llama_cpp_test_tpu_torch.weights import port_wavtokenizer_from_reference

GATE = 1e-8              # f32 spectra against the JAX run
N_CODES = 64             # the tiny LLM's code tokens (the vocoder has 40)
CHAIN = (5, 17, 3, 38, 0, 22, 9, 31, 14, 27, 1)   # codes greedy decoding walks
PAST = 50                # a code past the vocoder's rows, in the fault chain


def nmse(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(((a - b) ** 2).mean() / ((b * b).mean() + 1e-30))


def make_tts_llm(path, codes, seed=11):
    """The tiny OuteTTS-layout LLM whose greedy decoding after any prompt
    (its last token the '\\n' byte token) walks the code tokens of `codes`
    and then <|audio_end|>."""
    v = chip_smoke.CODE_TOKEN_OFFSET + N_CODES
    vocab = chip_smoke.outetts_vocab(v, seed, n_bpe=2000, n_codes=N_CODES)
    end = vocab["tokenizer.ggml.tokens"].index("<|audio_end|>")
    chain = [10] + [chip_smoke.CODE_TOKEN_OFFSET + c for c in codes] + [end]
    hp = dict(arch="qwen2", n_vocab=v, n_embd=64, n_head=4, n_head_kv=2,
              head_dim=16, n_layer=2, n_ff=128, rope_base=1e6, rms_eps=1e-6,
              tied=True, qkv_bias=True,
              embd_rows=chip_smoke.chain_rows(64, chain, seed))
    chip_smoke.write_llama_gguf(path, hp, seed=seed, ftype="Q8_0",
                                vocab=vocab)
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tts")
    voc = str(tmp / "voc.gguf")
    make_vocoder(voc, np.random.default_rng(0))
    return {"voc": voc, "tmp": tmp,
            "llm": make_tts_llm(str(tmp / "llm.gguf"), CHAIN),
            "past": make_tts_llm(str(tmp / "past.gguf"),
                                 CHAIN[:4] + (PAST,) + CHAIN[4:])}


@pytest.fixture(scope="module")
def vocoders(files):
    return jwt.load_wavtokenizer(files["voc"]), \
        pwt.load_wavtokenizer(files["voc"], device="cpu")


def read_wav(path):
    with wave.open(path, "rb") as f:
        head = (f.getnchannels(), f.getsampwidth(), f.getframerate(),
                f.getnframes())
        return head, np.frombuffer(f.readframes(f.getnframes()), np.int16)


def run(main, argv, **kw):
    old = sys.stderr
    sys.stderr = io.StringIO()
    try:
        return main(argv, **kw), sys.stderr.getvalue()
    finally:
        sys.stderr = old


@pytest.mark.parametrize("n", [8, 37])
def test_decode_codes_matches_reference(vocoders, n):
    jm, pm = vocoders
    assert pm.n_fft == jm.n_fft == 64 and pm.n_codes == VOCAB
    codes = np.random.default_rng(n).integers(0, VOCAB, n).astype(np.int32)
    want = jwt.decode_codes(jm, codes)
    got = pwt.decode_codes(pm, codes)
    assert got.shape == want.shape == (n, 66) and got.dtype == np.float32
    assert nmse(got, want) < GATE, nmse(got, want)


@pytest.mark.parametrize("n_fft,n_hop", [(64, 16), (1280, 320)])
def test_embd_to_audio_matches_reference(n_fft, n_hop):
    rng = np.random.default_rng(n_fft)
    half = n_fft // 2 + 1
    embd = np.concatenate([rng.normal(-1.0, 1.5, (30, half)),
                           rng.uniform(-np.pi, np.pi, (30, half))],
                          axis=1).astype(np.float32)
    want = jwt.embd_to_audio(embd, n_fft=n_fft, n_hop=n_hop)
    got = pwt.embd_to_audio(embd, n_fft=n_fft, n_hop=n_hop)
    assert got.shape == want.shape == (29 * n_hop + n_fft - (n_fft - n_hop)
                                       // 2 * 2,)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_codes_mode_matches_reference(files):
    codes = ",".join(str(c) for c in CHAIN)
    j, p = str(files["tmp"] / "j.wav"), str(files["tmp"] / "p.wav")
    assert run(jtts.main, ["-mv", files["voc"], "--codes", codes,
                           "-o", j])[0] == 0
    assert run(ptts.main, ["-mv", files["voc"], "--codes", codes, "-o", p],
               device="cpu")[0] == 0
    (jh, js), (ph, ps) = read_wav(j), read_wav(p)
    assert ph == jh and jh[:3] == (1, 2, 24000)
    assert np.abs(ps.astype(np.int32) - js).max() <= 1


TEXTS = ["Hello, World! 123", "Good day", "  it's  A-B_c/d.e\\f  ",
         "Ünïcode and ÇAPS", "", "one, two; three: four?"]


def test_process_text_and_prompt_match_reference():
    for t in TEXTS:
        assert ptts.process_text(t) == jtts.process_text(t)
        assert ptts.build_prompt(t) == jtts.build_prompt(t)
    assert ptts.CODE_TOKEN_OFFSET == jtts.CODE_TOKEN_OFFSET


def test_cli_matches_reference(files):
    """Text -> codes through the LLM, then the vocoder: the JAX CLI's
    codes (the designed chain) and WAV."""
    from llama_cpp_test_tpu_torch.runtime.engine import Context, Model

    j, p = str(files["tmp"] / "jc.wav"), str(files["tmp"] / "pc.wav")
    argv = ["-m", files["llm"], "-mv", files["voc"], "-p", "Hello world",
            "-n", "32", "-c", "256"]
    rc, jerr = run(jtts.main, argv + ["-o", j])
    prc, perr = run(ptts.main, argv + ["-o", p], device="cpu")
    assert rc == prc == 0
    line = f"# generated {len(CHAIN)} audio codes"
    assert line in jerr and line in perr
    (jh, js), (ph, ps) = read_wav(j), read_wav(p)
    assert ph == jh and np.abs(ps.astype(np.int32) - js).max() <= 1
    m = Model(files["llm"], device="cpu")
    toks = ptts.generate_codes(m, Context(m, n_ctx=256), "Hello world", 32)
    assert ptts.audio_codes(toks, VOCAB).tolist() == list(CHAIN)
    assert toks == [ptts.CODE_TOKEN_OFFSET + c for c in CHAIN]


def test_reference_clamps_a_code_past_the_codebook(files, vocoders):
    """Fault 26: the JAX CLI keeps every token from CODE_TOKEN_OFFSET up,
    and its gather clamps a code past the vocoder's rows to the last
    row."""
    jm, _ = vocoders
    out = str(files["tmp"] / "jp.wav")
    rc, err = run(jtts.main, ["-m", files["past"], "-mv", files["voc"],
                              "-p", "Hello world", "-n", "32", "-c", "256",
                              "-o", out])
    assert rc == 0 and f"# generated {len(CHAIN) + 1} audio codes" in err
    codes = np.asarray(CHAIN[:4] + (PAST,) + CHAIN[4:], np.int32)
    clamped = np.minimum(codes, VOCAB - 1)
    np.testing.assert_array_equal(jwt.decode_codes(jm, codes),
                                  jwt.decode_codes(jm, clamped))
    ref = str(files["tmp"] / "jclamp.wav")
    jwt.write_wav(ref, jwt.embd_to_audio(jwt.decode_codes(jm, clamped),
                                         n_fft=jm.n_fft))
    assert read_wav(out)[0] == read_wav(ref)[0]
    np.testing.assert_array_equal(read_wav(out)[1], read_wav(ref)[1])


def test_port_drops_a_code_past_the_codebook(files, vocoders):
    """Fault 26: the port keeps the codes the vocoder has, and refuses a
    code past them in --codes and decode_codes."""
    _, pm = vocoders
    out = str(files["tmp"] / "pp.wav")
    rc, err = run(ptts.main, ["-m", files["past"], "-mv", files["voc"],
                              "-p", "Hello world", "-n", "32", "-c", "256",
                              "-o", out], device="cpu")
    assert rc == 0 and f"# generated {len(CHAIN)} audio codes" in err
    ref = str(files["tmp"] / "pdrop.wav")
    pwt.write_wav(ref, pwt.embd_to_audio(pwt.decode_codes(
        pm, np.asarray(CHAIN, np.int32)), n_fft=pm.n_fft))
    assert read_wav(out)[0] == read_wav(ref)[0]
    np.testing.assert_array_equal(read_wav(out)[1], read_wav(ref)[1])
    with pytest.raises(ValueError, match="outside the vocoder's 40 rows"):
        pwt.decode_codes(pm, [3, PAST])
    with pytest.raises(ValueError, match="outside"):
        run(ptts.main, ["-mv", files["voc"], "--codes", f"1,{PAST}",
                        "-o", str(files["tmp"] / "x.wav")], device="cpu")
    with pytest.raises(ValueError, match="outside"):
        pwt.decode_codes(pm, [-1])


def test_port_from_reference_equals_loader(vocoders):
    jm, pm = vocoders
    ported = port_wavtokenizer_from_reference(jm, device="cpu")
    assert sorted(ported.tensors) == sorted(pm.tensors)
    for k, t in pm.tensors.items():
        assert torch.equal(ported.tensors[k], t), k
    assert (ported.n_groups, ported.n_fft) == (pm.n_groups, pm.n_fft)


def test_convolutions_run_without_tf32(vocoders, monkeypatch):
    _, pm = vocoders
    seen = []
    forward = pwt.forward

    def spy(m, codes):
        seen.append(torch.backends.cudnn.allow_tf32)
        return forward(m, codes)

    monkeypatch.setattr(pwt, "forward", spy)
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        pwt.decode_codes(pm, [1, 2, 3])
        assert seen == [False] and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = before


def test_default_device_is_cuda(files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        pwt.load_wavtokenizer(files["voc"])
    with pytest.raises(RuntimeError, match="CUDA"):
        ptts.main(["-mv", files["voc"], "--codes", "1,2"])
