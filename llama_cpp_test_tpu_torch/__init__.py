"""PyTorch/CUDA port of llama_cpp_test_tpu's llama serving path: dense
llama and Mixtral-style MoE GGUFs over bf16 or q8_0 paged KV caches.

The JAX package `llama_cpp_test_tpu` is the reference; this package keeps
its module layout (gguf/, quant/, models/, ops/, runtime/) so each module
has a counterpart there. The Pallas kernels of the path (the quantized
matmul, flash prefill, paged decode over bf16 and int8 pages, and the
grouped expert matmul) are CUDA C++ kernels for Hopper (sm_90a) under
csrc/, built with nvcc at first use and bound with ctypes (ops/_cuda.py).

Entry points take `device=` and default to "cuda"; asking for CUDA where
there is none raises (device.py). Tests pass device="cpu", where every
kernel wrapper takes its plain PyTorch version.
"""
