"""styletts_zs_torch — the PyTorch/CUDA port of ``styletts_zs_tpu``.

Same layout and names as the JAX package (``ops/``, ``kernels/``,
``models/``, ``pipelines/``) so each module has an obvious counterpart.
Activations are (B, T, C) and attention tensors (B, T, H, D), as in JAX.
The hand-written CUDA kernels live in ``csrc/`` and are built on first use
by ``kernels/build.py``; every kernel has a plain PyTorch version beside it
that CPU tensors take.

This package imports torch and numpy only — never jax, flax, orbax or the
JAX package.
"""
