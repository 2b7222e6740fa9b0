"""mfu: the whole step's share of the chip's bf16 dense peak: the model's
FLOPs a step (counted from the configuration by the reference model's
``train_flops``: forward and backward, no recomputation, no optimizer)
over the seconds a step of the profiled steps, which are the window's own
call with no synchronize between steps (the host's clock over them, under
a profiler that records the device alone)."""


def read(ctx):
    p = ctx.profile
    if ctx.peaks is None or p is None or p.steps <= 0:
        return None
    t = ctx.cell.traffic
    flops = ctx.ref_model.train_flops(ctx.cell.config, t['batch'], t['seq'])
    return 100.0 * flops / (p.window_s / p.steps * ctx.peaks['bf16_flops'])
