"""Versioned, schema-typed telemetry records and the JSONL ``Recorder`` —
the port's own copy of the parts of ``repro/obs/events.py`` that the
trainer emits through.

Every record is one JSON object per line with an ``event`` type and the
schema version ``v``; every other key is typed by ``SCHEMAS[event]`` and an
unknown key is an error.  The schemas here are the reference's for the
records ``Trainer.fit`` and ``Trainer.fit_elastic`` emit (``step``,
``refresh``, ``refresh_ownership``, ``reshard``, ``comm_exchange``,
``straggler``, ``span`` and ``profile``) and for the ``bench`` rows the
report reads, so a record the port writes passes the reference's
validator and the two validators refuse the same records.  The scheduler's, the pipeline's and the sharded
factor's step fields come from their modules' ``METRIC_FIELDS``.  The
``Recorder`` owns a run-scoped view of the exchange byte counters
(``comm/metrics.py``): the sites recorded while it is open belong to its
run.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Optional

from repro_torch.comm import metrics as comm_metrics
from repro_torch.core import factor_sharded as _fsh
from repro_torch.schedule import pipeline as _pipemod
from repro_torch.schedule import runtime as _schedrt

SCHEMA_VERSION = 1

_NUM = (int, float)
_INT = (int,)
_STR = (str,)
_DICT = (dict,)


@dataclasses.dataclass(frozen=True)
class Field:
    """One schema field: accepted JSON types, requiredness, display unit."""
    types: tuple
    required: bool = False
    unit: str = ''


def _declared(module) -> dict[str, Field]:
    """METRIC_FIELDS of a producer module -> schema fields."""
    kinds = {'int': _INT, 'num': _NUM}
    return {name: Field(kinds[kind], unit=unit)
            for name, (kind, unit) in module.METRIC_FIELDS.items()}


SCHEMAS: dict[str, dict[str, Field]] = {
    'step': {
        'step': Field(_INT, required=True, unit='index'),
        'loss': Field(_NUM, required=True),
        'grad_norm': Field(_NUM),
        'step_time_s': Field(_NUM, unit='s'),
        'exchanged_mb_cum': Field(_NUM, unit='MiB'),
        # the kernel dispatch: the requested impl and the latest resolved
        # impl and configuration per op (kernels.dispatch.choices_snapshot)
        'kernel_impl': Field(_STR, unit="requested impl ('auto'|...)"),
        'kernel_tiles': Field(_DICT, unit='op -> resolved impl+tiles'),
        **_declared(_schedrt),
        **_declared(_pipemod),
        **_declared(_fsh),
    },
    'refresh': {
        'step': Field(_INT, required=True, unit='index'),
        'refreshes': Field(_INT, required=True, unit='cumulative refreshes'),
        'step_time_s': Field(_NUM, unit='s'),
    },
    'refresh_ownership': {
        'world': Field(_INT, required=True, unit='workers'),
        'owners': Field(_DICT, required=True,
                        unit='bucket -> per-worker slice counts'),
    },
    # elastic resize: a checkpoint written at world_from resumed at
    # world_to, or a live resize between steps (Trainer.fit_elastic)
    'reshard': {
        'world_from': Field(_INT, required=True, unit='workers'),
        'world_to': Field(_INT, required=True, unit='workers'),
        'pipeline': Field(_STR, required=True,
                          unit="in-flight buffers: 'drained'|'kept'|'none'"),
        'source': Field(_STR, required=True,
                        unit="'checkpoint' (restore) | 'live' (between steps)"),
        'step': Field(_INT, unit='index'),
        'slices_total': Field(_INT, unit='owned refresh slices'),
        'slices_moved': Field(_INT, unit='slices with a new owner'),
    },
    # per-call-site logical exchange bytes (each site dict is checked by
    # _validate_site; codec extras stay open)
    'comm_exchange': {
        'sites': Field(_DICT, required=True),
    },
    'straggler': {
        'step': Field(_INT, required=True, unit='index'),
        'step_time_s': Field(_NUM, required=True, unit='s'),
        'median_s': Field(_NUM, required=True, unit='s'),
        'factor': Field(_NUM, unit='trigger threshold x median'),
    },
    'span': {
        'name': Field(_STR, required=True),
        'ms': Field(_NUM, required=True, unit='ms'),
        'step': Field(_INT, unit='index'),
        'seq': Field(_INT, unit='emission order'),
        'depth': Field(_INT, unit='nesting depth'),
        'parent': Field(_STR + (type(None),)),
    },
    'profile': {
        'step': Field(_INT, required=True, unit='index'),
        'live_buffer_mb': Field(_NUM, unit='MiB'),
        'device_bytes_in_use': Field(_INT, unit='bytes'),
        'fns': Field(_DICT, unit='fn -> cost summary'),
    },
    # one BENCH_*.json row (the reference's benchmarks/common.write_json)
    'bench': {
        'name': Field(_STR, required=True),
        'us_per_call': Field(_NUM, required=True, unit='us'),
        'derived': Field(_STR),
        'fields': Field(_DICT),
    },
}


_SITE_FIELDS = {
    'bytes_per_call': Field(_INT, required=True, unit='B'),
    'codec': Field(_STR, required=True),
    'mode': Field(_STR, required=True),
    'traces': Field(_INT),
    'world': Field(_INT),
    'pods': Field((list, tuple), unit='(n_pods, pod_size)'),
    'ici_bytes': Field(_INT, unit='B'),
    'dcn_bytes': Field(_INT, unit='B'),
    # sharded-factor apply sites (factor/*)
    'solve_iters': Field(_INT, unit='iterations per solve'),
    'factor_shard_bytes': Field(_INT, unit='B of factor band per worker'),
}


class SchemaError(ValueError):
    pass


def _check(value, fld: Field, where: str) -> list[str]:
    # bool is an int subclass in Python; never a valid numeric field here
    if isinstance(value, bool) or not isinstance(value, fld.types):
        return [f'{where}: expected {"/".join(t.__name__ for t in fld.types)}'
                f', got {type(value).__name__} ({value!r})']
    return []


def _validate_site(site: str, rec: Any) -> list[str]:
    where = f'comm_exchange.sites[{site!r}]'
    if not isinstance(rec, dict):
        return [f'{where}: expected object, got {type(rec).__name__}']
    errs = []
    for name, fld in _SITE_FIELDS.items():
        if name in rec:
            errs += _check(rec[name], fld, f'{where}.{name}')
        elif fld.required:
            errs.append(f'{where}: missing required field {name!r}')
    return errs


def infer_event(rec: dict) -> Optional[str]:
    """Event type of a record; an envelope-less step dict counts."""
    ev = rec.get('event')
    if ev is None and 'step' in rec and 'loss' in rec:
        return 'step'
    return ev


def validate_record(rec: Any) -> list[str]:
    """All schema violations of one record ([] = valid)."""
    if not isinstance(rec, dict):
        return [f'record is not an object: {rec!r}']
    ev = infer_event(rec)
    if ev is None:
        return [f'missing event type (keys: {sorted(rec)[:6]})']
    if ev not in SCHEMAS:
        return [f'unknown event type {ev!r} (have {sorted(SCHEMAS)})']
    errs: list[str] = []
    v = rec.get('v')
    if v is not None and v != SCHEMA_VERSION:
        errs.append(f'{ev}: schema version {v} != {SCHEMA_VERSION}')
    schema = SCHEMAS[ev]
    for name, fld in schema.items():
        if fld.required and name not in rec:
            errs.append(f'{ev}: missing required field {name!r}')
    for key, value in rec.items():
        if key in ('event', 'v'):
            continue
        fld = schema.get(key)
        if fld is None and '/' in key:
            fld = schema.get(key.split('/', 1)[0] + '/*')
        if fld is None:
            errs.append(f'{ev}: unknown field {key!r}')
            continue
        errs += _check(value, fld, f'{ev}.{key}')
    if ev == 'comm_exchange' and isinstance(rec.get('sites'), dict):
        for site, srec in rec['sites'].items():
            errs += _validate_site(site, srec)
    return errs


def step_fields(metrics: dict) -> dict:
    """Typed host-side step-record fields from the step's metrics (0-d
    tensors: reading them waits for the card)."""
    out: dict[str, Any] = {}
    if 'refreshes' in metrics:
        out['refreshes'] = int(metrics['refreshes'])
        out['staleness'] = float(metrics['staleness'])
        out['refresh_since'] = int(metrics['refresh_since'])
    for key, value in metrics.items():
        if key.startswith('pipeline_lag'):
            out[key] = int(value)
    if 'factor_solve_iters' in metrics:
        out['factor_solve_iters'] = int(metrics['factor_solve_iters'])
        out['factor_shard_bytes'] = float(metrics['factor_shard_bytes'])
    return out


class Recorder:
    """JSONL sink and run-scoped comm-counter view.  ``emit`` stamps the
    envelope (``event``, ``v``), validates the record (a malformed record
    raises at its emit site), appends one line and returns the record.
    ``path=None`` keeps the records in memory only."""

    def __init__(self, path: Optional[Any] = None, validate: bool = True):
        self._f = Path(path).open('a') if path is not None else None
        self._validate = validate
        self._scope = comm_metrics.push_scope()
        self.records: list[dict] = []

    def emit(self, event: str, **fields: Any) -> dict:
        rec = {'event': event, 'v': SCHEMA_VERSION, **fields}
        if self._validate:
            errs = validate_record(rec)
            if errs:
                raise SchemaError('; '.join(errs))
        self.records.append(rec)
        if self._f is not None:
            self._f.write(json.dumps(rec) + '\n')
            self._f.flush()
        return rec

    def comm_sites(self) -> dict:
        """The exchange sites recorded while this recorder was open."""
        return self._scope.snapshot() if self._scope is not None else {}

    def close(self) -> None:
        if self._scope is not None:
            comm_metrics.pop_scope(self._scope)
            self._scope = None
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> 'Recorder':
        return self

    def __exit__(self, *exc) -> None:
        self.close()
