"""optimizer_ms: the optimizer layer (``repro_torch/core/``: Eva's
preconditioning and clip, or SGD's momentum, with ``apply_updates``): the
mean over the traced run's timed steps of ``update_fn`` and ``apply_fn``,
on the host's clock between synchronizes."""


def read(ctx):
    if not ctx.opt_s:
        return None
    return 1e3 * sum(ctx.opt_s) / len(ctx.opt_s)
