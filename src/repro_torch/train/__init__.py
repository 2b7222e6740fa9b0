"""The train step, the checkpoint and the trainer, as in ``repro.train``.
``abstract_opt_state`` (the reference's dry-run shapes) is not ported."""
from repro_torch.train.checkpoint import (AsyncCheckpointer, available_steps,
                                          gc_old, latest_step, restore, save)
from repro_torch.train.step import (compute_grads_and_stats, init_opt_state,
                                    make_train_step, stats_plan_of)
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ['AsyncCheckpointer', 'available_steps', 'gc_old', 'latest_step',
           'restore', 'save', 'compute_grads_and_stats', 'init_opt_state',
           'make_train_step', 'stats_plan_of', 'Trainer', 'TrainerConfig']
