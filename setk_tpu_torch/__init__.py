"""PyTorch/CUDA port of setk_tpu for one NVIDIA H100.

The JAX package ``setk_tpu`` is the reference; this package imports
neither it nor ``jax``.  Slice 1 covers batched mask-based MVDR
enhancement: ``parallel.executor.BatchEnhancer`` ->
``parallel.enhance_step.enhance_batch`` -> the fused CUDA kernels under
``ops/cuda`` (sources in ``csrc/``).
"""
