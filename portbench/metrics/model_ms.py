"""model_ms: the model layer's forward and backward with Eva's capture
(``repro_torch/models/``, ``core/kv.py``): the mean over the traced run's
timed steps of ``make_phased_step``'s ``grad_fn``, on the host's clock
between synchronizes."""


def read(ctx):
    if not ctx.grad_s:
        return None
    return 1e3 * sum(ctx.grad_s) / len(ctx.grad_s)
