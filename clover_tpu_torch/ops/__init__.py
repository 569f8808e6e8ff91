"""Quantized linear-algebra ops on torch tensors (counterparts of
clover_tpu/ops).  The public names are re-exported by the package root;
this package imports nothing itself, so the kernels' plain versions can use
``ops._core`` without an import cycle."""
