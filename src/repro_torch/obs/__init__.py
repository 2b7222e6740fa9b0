"""Telemetry, as in ``repro.obs``: typed event records (``events``), phase
spans and the straggler watchdog (``spans``), and the run report
(``report``, ``scripts/obs_report_torch.py``).  The reference's XLA cost
summaries (``hlo_costs``, ``compiled_fn_costs``, ``live_buffer_mb``) are
not ported."""
from repro_torch.obs.events import (SCHEMA_VERSION, SCHEMAS, Recorder,
                                    SchemaError, infer_event, step_fields,
                                    validate_record)
from repro_torch.obs.spans import (SpanTracker, StragglerWatchdog,
                                   device_bytes_in_use)

__all__ = [
    'SCHEMA_VERSION', 'SCHEMAS', 'Recorder', 'SchemaError', 'infer_event',
    'step_fields', 'validate_record',
    'SpanTracker', 'StragglerWatchdog', 'device_bytes_in_use',
]
