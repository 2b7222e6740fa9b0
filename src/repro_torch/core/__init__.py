"""Eva core: vectorized second-order optimization (the paper's contribution).

Public surface, as in ``repro.core``:
  make_optimizer(name, **kw) -> (GradientTransformation, CaptureConfig)
  eva / eva_f / eva_s / kfac / foof / shampoo / mfac / sgd / adagrad / adamw
  kv: capture machinery;  precondition: Sherman-Morrison math

Importing the package builds and loads no kernel: each CUDA library is
built at its first launch (``kernels/build.py``).
"""
from repro_torch.core import bucketing, kv, precondition, transform
from repro_torch.core.bucketing import BucketPlan, build_plan
from repro_torch.core.clipping import (graft_to_grad_magnitude, kl_clip,
                                       kl_clip_trace, kl_normalize)
from repro_torch.core.precondition import precondition_tree
from repro_torch.core.eva import eva, eva_preconditioner
from repro_torch.core.eva_f import eva_f, eva_f_preconditioner
from repro_torch.core.eva_s import eva_s, eva_s_preconditioner
from repro_torch.core.firstorder import adagrad, adamw, sgd
from repro_torch.core.foof import foof, foof_preconditioner
from repro_torch.core.kfac import kfac, kfac_preconditioner
from repro_torch.core.mfac import mfac, mfac_preconditioner
from repro_torch.core.registry import (capture_for, make_optimizer,
                                       optimizer_names)
from repro_torch.core.shampoo import shampoo, shampoo_preconditioner
from repro_torch.core.transform import (Extras, GradientTransformation,
                                        apply_updates, chain)

__all__ = [
    'bucketing', 'BucketPlan', 'build_plan', 'precondition_tree',
    'kv', 'precondition', 'transform', 'Extras', 'GradientTransformation',
    'apply_updates', 'chain', 'make_optimizer', 'optimizer_names', 'capture_for',
    'eva', 'eva_f', 'eva_s', 'kfac', 'foof', 'shampoo', 'mfac',
    'sgd', 'adagrad', 'adamw', 'kl_clip', 'kl_clip_trace', 'kl_normalize',
    'graft_to_grad_magnitude',
    'eva_preconditioner', 'eva_f_preconditioner', 'eva_s_preconditioner',
    'kfac_preconditioner', 'foof_preconditioner', 'shampoo_preconditioner',
    'mfac_preconditioner',
]
