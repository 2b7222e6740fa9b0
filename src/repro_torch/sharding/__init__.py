"""Layouts over a ``torch.distributed`` DeviceMesh, as in ``repro.sharding``:
the mesh in scope (``compat``), logical-axis resolution (``logical``) and
the activation constraints (``constraints``)."""
from repro_torch.sharding import compat
from repro_torch.sharding.logical import (RULES, batch_pspec, cache_shardings,
                                          input_shardings, mirror_pspec,
                                          opt_state_shardings,
                                          param_shardings, resolve_pspec)

__all__ = ['RULES', 'batch_pspec', 'cache_shardings', 'compat',
           'input_shardings', 'mirror_pspec', 'opt_state_shardings',
           'param_shardings', 'resolve_pspec']
