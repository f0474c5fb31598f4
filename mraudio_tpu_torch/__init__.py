"""PyTorch/CUDA port of mraudio_tpu: X-InstructBLIP moment retrieval on
an NVIDIA H100, with hand-written Hopper kernels under ``csrc/``.

Imports torch and numpy only; it never imports JAX or the JAX package.
"""
