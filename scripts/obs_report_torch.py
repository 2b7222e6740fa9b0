#!/usr/bin/env python
"""Telemetry run-analysis CLI of the PyTorch port — a thin wrapper over
``repro_torch.obs.report``.

    PYTHONPATH=src python scripts/obs_report_torch.py runs/a/metrics.jsonl
    PYTHONPATH=src python scripts/obs_report_torch.py --validate BENCH_*.json
    PYTHONPATH=src python scripts/obs_report_torch.py --diff a.jsonl b.jsonl \\
        --max-regress 25

Exit codes: 0 ok · 1 schema-validation errors · 2 gated perf regression.
"""
import sys

from repro_torch.obs import report

if __name__ == '__main__':
    sys.exit(report.main(sys.argv[1:]))
