"""PyTorch/CUDA port of ``vavae_tpu`` for NVIDIA Hopper (H100).

Mirrors the JAX package's module names (``models/dit.py`` ↔
``vavae_tpu/models/dit.py`` and so on) and keeps its layouts at the public
functions: NHWC latents and images, ``(B, N, 3, H, D)`` fused qkv, split-half
RoPE. Imports torch, numpy and the standard library only — never JAX and
nothing of ``vavae_tpu``.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; without a GPU they raise instead of carrying on on the CPU.
"""
