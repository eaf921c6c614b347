"""PyTorch/CUDA port of the GGUF inference engine in ``llama_cpp_gfx906_tpu``.

Single-stream greedy generation of llama GGUF models, with hand-written
Hopper (sm_90a) kernels under ``csrc/`` for the decode GEMV (int8 and
nib4c), decode attention and prefill flash attention.  Imports torch, never
jax, and nothing of the JAX package.
"""
