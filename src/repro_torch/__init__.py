"""PyTorch / CUDA port of the Eva reproduction (``src/repro``).

The module layout mirrors the JAX package: ``core/`` (optimizer algebra,
KV and factor capture, bucketing, Eva and its siblings, K-FAC, Shampoo and
the sharded-factor solve), ``kernels/`` (hand-written Hopper kernels in
``kernels/csrc`` and their plain PyTorch versions), ``models/``, ``data/``,
``schedule/``, ``comm/`` and ``train/``.  It imports no JAX and nothing of
``repro``.
"""
