"""Copy of llama_cpp_test_tpu/tokenizer/__init__.py (pure Python: the port keeps its
own copy and imports nothing of the JAX package).

Tokenizers (host-side): SPM greedy-bigram, byte-level BPE with per-model
pretokenizer regexes, special-token partitioning, detokenization.

The analogue of the reference's llama-vocab.cpp (SPM :107, BPE :276,
special-token partition :384); tests/test_torch_tokenizer.py holds it
against the JAX package's tokenizer.
"""
from .vocab import Vocab, Tokenizer, load_tokenizer  # noqa: F401
