"""The system under test: ``repro_torch`` built from the cell's files.

The benchmark hands the program its weights and batches and reads back its
step's outputs, its optimizer state, and the names of its kernels; it
computes nothing of the program's.  The configuration's sizes override the
program's registry entry field by field, and the program's parameter layout
and preconditioned weights must be the reference's, else the run stops.
"""
from __future__ import annotations

import dataclasses

import torch


class Program:

    def __init__(self, cell, ref_model, device):
        from repro_torch.configs.base import ArchConfig
        from repro_torch.configs.registry import get_config
        from repro_torch.core.registry import make_optimizer
        from repro_torch.models import module as M
        from repro_torch.models.registry import build_model
        from repro_torch.train import step as step_mod
        known = {f.name for f in dataclasses.fields(ArchConfig)}
        unknown = sorted(set(cell.config) - known)
        if unknown:
            raise ValueError(f'{cell.config_name}: keys {unknown} are not '
                             'fields of the program\'s ArchConfig')
        arch = cell.config_meta['arch']
        self.arch = get_config(arch).replace(**cell.config)
        self.model = build_model(self.arch)
        self.device = torch.device(device)
        self.step_mod = step_mod
        opts = dict(cell.traffic['options'])
        self.opt, self.capture = make_optimizer(cell.traffic['optimizer'],
                                                **opts)
        specs = ref_model.param_specs(cell.config)
        got = {p: (tuple(s.shape), str(s.dtype).rsplit('.', 1)[-1])
               for p, s in M.flatten_specs(self.model.param_specs()).items()}
        want = {p: (tuple(s[0]), s[1]) for p, s in specs.items()}
        if got != want:
            raise ValueError(f'{arch}: the program\'s parameters '
                             f'{sorted(set(got.items()) ^ set(want.items()))}'
                             ' differ from the reference\'s')
        pre = set(self.model.precon_paths())
        if self.capture.active and pre != set(ref_model.precon_paths(
                cell.config)):
            raise ValueError(f'{arch}: the program preconditions '
                             f'{sorted(pre)}')

    def init_state(self, params, batch):
        return self.step_mod.init_opt_state(
            self.model, self.opt, self.capture, params, batch,
            device=self.device)

    def train_step(self):
        """``make_train_step``: one call a step, as users run it."""
        return self.step_mod.make_train_step(self.model, self.opt,
                                             self.capture,
                                             device=self.device)

    def phased_step(self):
        """(grad_fn, update_fn, apply_fn) of ``make_phased_step``, whose
        composition is ``make_train_step``'s step bit for bit."""
        return self.step_mod.make_phased_step(self.model, self.opt,
                                              self.capture,
                                              device=self.device)


def buffer_of(state) -> dict:
    """The momentum buffer of the program's optimizer state, {path: tensor}:
    the first state in its chain that holds a ``trace``."""
    for inner in getattr(state, 'inner', ()):
        trace = getattr(inner, 'trace', None)
        if isinstance(trace, dict):
            return trace
    raise ValueError('the optimizer state holds no momentum buffer')
