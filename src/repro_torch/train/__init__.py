"""The train step, the checkpoint and the trainer, as in ``repro.train``,
with ``abstract_opt_state`` (the dry run's optimizer-state stand-ins)."""
from repro_torch.train.checkpoint import (AsyncCheckpointer, available_steps,
                                          gc_old, latest_step, restore, save)
from repro_torch.train.step import (abstract_opt_state,
                                    compute_grads_and_stats, init_opt_state,
                                    make_train_step, stats_plan_of)
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ['AsyncCheckpointer', 'available_steps', 'gc_old', 'latest_step',
           'restore', 'save', 'abstract_opt_state',
           'compute_grads_and_stats', 'init_opt_state',
           'make_train_step', 'stats_plan_of', 'Trainer', 'TrainerConfig']
