"""PyTorch/CUDA port of setk_tpu for one NVIDIA H100.

The JAX package ``setk_tpu`` is the reference; this package imports
neither it nor ``jax``.  It covers batched mask-based enhancement with
the supervised beamformer family (mvdr, gevd, pmwf-0/1, mpdr,
mpdr-whiten) and online (chunked EMA) mvdr:
``parallel.executor.BatchEnhancer`` ->
``parallel.enhance_step.enhance_batch`` -> the fused CUDA kernels under
``ops/cuda`` (sources in ``csrc/``), and the adaptive-beamformer CLI
over it (``python -m setk_tpu_torch.cli``, I/O in ``io/``), with the
clustering, WPE/WPD, mask-estimator, separation and spatial (``spatial/``:
steering grids, localization, spatial features) commands beside it.
"""
