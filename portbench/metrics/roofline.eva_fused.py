"""roofline.eva_fused: the least time of a step's ``eva_fused`` work over
its device time.

Device time: the union of the intervals of the kernels named below, from
the profiler's trace, a step.  Least time: the larger of the bytes over the
HBM rate and the operations over the float32 rate.  Both are counted from
the configuration's preconditioned weights (the reference model's
``precon_paths`` and ``param_specs``), whatever implements the kernel: each
item (a layer's, or a layer's expert's, d_in x d_out weight) reads G in the
parameter dtype, ā (d_in) and b̄ (d_out) and the momentum m in float32 once,
and writes the float32 output and three float32 partials once.  Operations,
an element: aᵀGb (2), the update μ·m + (G − c·a·b)/γ (5), the partials
⟨out, G⟩, ⟨out, out⟩, ⟨G, G⟩ (6).
"""
import math

KERNELS = ('eva_dot_kernel', 'eva_emit_kernel')
OPS_PER_ELEMENT = 13


def work(cfg, ref_model):
    """(bytes, operations) a step."""
    specs = ref_model.param_specs(cfg)
    total_bytes = total_ops = 0
    for p in ref_model.precon_paths(cfg):
        shape, dtype = specs[p][0], specs[p][1]
        g_bytes = 2 if dtype in ('bfloat16', 'float16') else 4
        items, d_in, d_out = math.prod(shape[:-2]), shape[-2], shape[-1]
        elems = items * d_in * d_out
        total_bytes += elems * (g_bytes + 4 + 4) \
            + items * 4 * (d_in + d_out + 3)
        total_ops += OPS_PER_ELEMENT * elems
    return total_bytes, total_ops


def read(ctx):
    p = ctx.profile
    if p is None or ctx.peaks is None:
        return None
    device_s = p.kernel_seconds(KERNELS) / p.steps
    if device_s <= 0:
        return None
    n_bytes, n_ops = work(ctx.cell.config, ctx.ref_model)
    least = max(n_bytes / ctx.peaks['hbm_bytes'],
                n_ops / ctx.peaks['f32_flops'])
    return 100.0 * least / device_s
