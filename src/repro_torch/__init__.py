"""PyTorch / CUDA port of the Eva reproduction (``src/repro``).

The module layout mirrors the JAX package: ``core/`` (optimizer algebra,
KV capture, bucketing, Eva), ``kernels/`` (hand-written Hopper kernels in
``kernels/csrc`` and their plain PyTorch versions), ``models/``, ``data/``,
``schedule/`` and ``train/``.  It imports no JAX and nothing of ``repro``.
"""
