"""Telemetry, as in ``repro.obs``: typed event records (``events``), spans
and counters, the straggler watchdog and the profile-mode samplers
(``spans``), and the run report (``report``, ``scripts/obs_report_torch.py``)."""
from repro_torch.obs.events import (SCHEMA_VERSION, SCHEMAS, Recorder,
                                    SchemaError, infer_event, step_fields,
                                    validate_record)
from repro_torch.obs.spans import (SpanTracker, StragglerWatchdog,
                                   compiled_fn_costs, device_bytes_in_use,
                                   hlo_costs, live_buffer_mb)

__all__ = [
    'SCHEMA_VERSION', 'SCHEMAS', 'Recorder', 'SchemaError', 'infer_event',
    'step_fields', 'validate_record',
    'SpanTracker', 'StragglerWatchdog', 'compiled_fn_costs',
    'device_bytes_in_use', 'hlo_costs', 'live_buffer_mb',
]
