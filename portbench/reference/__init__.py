"""The plain reference that decides ``correct``: float32 PyTorch, TF32 off.

It imports neither ``jax`` nor the JAX package ``repro`` nor anything of the
program (``repro_torch``), and takes only what the benchmark made: the
weights and token batches drawn from the run's seed (``harness/weights.py``).

Provenance.  The math is written again from the port as it stood at commit
d3d7539 (the same equations, not the same code):

* ``models/moe.py`` (family ``moe``): ``repro_torch/models/transformer.py``
  (the block, the final norm, the head, the loss with the MoE aux),
  ``attention.py`` (GQA with RoPE), ``layers.py`` (``rmsnorm``,
  ``apply_rope``, ``linear``, ``embed``), ``moe.py`` (top-k routing,
  capacity, drop past capacity, combine, the Switch-style aux loss).
* ``models/ssm.py`` (family ``ssm``): ``repro_torch/models/mamba_lm.py``
  and ``ssm.py`` (the Mamba-2 block, the causal conv, the chunked SSD).
* ``common.py``: ``repro_torch/core/kv.py`` (ā of each preconditioned
  linear's input; b̄ as the gradient of a zero tap on its output; per-expert
  means over the valid slots and b̄ rescaled by tokens / slots) and
  ``train/step.py::compute_grads_and_stats``.
* ``optimizers/eva.py``: ``repro_torch/core/eva.py`` (``eva_fused_update``:
  the EMA of ā, b̄ with bias correction, Eq. 13, the momentum folded in, the
  KL clip of Eq. 16), ``core/clipping.py`` (``_nu``), ``kernels/ref.py``
  (``eva_fused_ref``) and ``core/transform.py`` (``scale_by_schedule``,
  ``apply_updates``).
* ``optimizers/sgd.py``: ``repro_torch/core/firstorder.py::sgd`` with
  ``core/transform.py::ema_trace``.

Departures, each on purpose:

* Everything is computed in float32, whatever the configuration's compute
  dtype; parameters are rounded to the configuration's parameter dtype after
  each update, because that is how the configuration stores them.
* Attention is the naive masked softmax (the port runs flash attention: the
  same function), the MoE dispatch finds each assignment's slot by a
  cumulative count over a one-hot (the port sorts: the same slots), and
  each block runs under ``torch.utils.checkpoint`` so that the reference
  fits beside nothing else on the card (checkpointing changes memory, not
  values).
* Momentum buffers stay float32 (the port's SGD keeps its buffer in the
  parameter dtype).
* ``lowp.py`` is not part of the reference: it makes the control, the same
  reference with every value the configuration holds in its compute dtype
  rounded to float8 (e4m3 forward, e5m2 for its gradient, one scale a
  tensor; ``common.Tape.r``).
"""
