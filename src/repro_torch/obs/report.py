"""Run analysis over telemetry artifacts — PyTorch port of
``repro/obs/report.py`` (``scripts/obs_report_torch.py``).

Loads one or more ``metrics.jsonl`` (trainer telemetry) and/or
``BENCH_*.json`` (benchmark rows) files, validates every record against the
versioned schema (``repro_torch.obs.events``), and renders:

* a per-run breakdown — per-phase time (from spans when the run profiled,
  plus the refresh time derived differentially from refresh-firing vs
  cached steps), exchanged bytes per site with the ICI/DCN topology split,
  staleness/pipeline-lag, the refresh-owner map, and the profile record;
* an A-vs-B diff with a regression gate: ``--max-regress PCT`` exits 2
  when any *gated* metric (mean step time, benchmark ``us_per_call`` rows)
  regressed by more than PCT percent.

Exit codes: 0 ok · 1 schema-validation errors · 2 gated regression.

Phase-attribution notes:
  * span times exist only for profiled runs; the first step's spans are
    dropped (warm-up);
  * ``refresh`` time is the firing-vs-cached step-time differential — it
    runs *inside* the precondition phase, so it is a sub-row, not an
    addend;
  * ``exchange`` is reported in logical bytes, from the exchange's own
    counters (``comm/metrics.py``); its time falls inside grad+precondition;

The breakdown of a run is the reference's, key for key, so the two reports
agree on one run's records.
"""
from __future__ import annotations

import argparse
import json
import statistics
from pathlib import Path
from typing import Any, Optional

from repro_torch.obs import events


# ---------------------------------------------------------------------------
# Loading / validation


def load_records(path: str) -> list[dict]:
    """Records from a ``.jsonl`` telemetry file or a ``BENCH_*.json`` row
    list (rows are wrapped as ``bench`` events).  Unparseable lines become
    ``_parse_error`` records so validation can report them by line."""
    p = Path(path)
    text = p.read_text()
    if text.lstrip().startswith('['):
        rows = json.loads(text)
        return [row if isinstance(row, dict) and 'event' in row
                else {'event': 'bench', **row} if isinstance(row, dict)
                else {'_parse_error': f'non-object bench row {row!r}'}
                for row in rows]
    recs = []
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
            if not isinstance(rec, dict):
                rec = {'_parse_error': f'line {lineno}: not an object'}
        except json.JSONDecodeError as e:
            rec = {'_parse_error': f'line {lineno}: {e}'}
        recs.append(rec)
    return recs


def validate_records(records: list[dict]) -> list[str]:
    errs = []
    for i, rec in enumerate(records, 1):
        if '_parse_error' in rec:
            errs.append(f'record {i}: {rec["_parse_error"]}')
            continue
        errs += [f'record {i}: {e}' for e in events.validate_record(rec)]
    return errs


def _of(records: list[dict], event: str) -> list[dict]:
    return [r for r in records if events.infer_event(r) == event]


# ---------------------------------------------------------------------------
# Breakdown


def breakdown(records: list[dict]) -> dict:
    """Aggregate one run's records into the summary ``render`` prints."""
    bd: dict[str, Any] = {}
    steps = sorted(_of(records, 'step'), key=lambda r: r['step'])
    bd['n_step_records'] = len(steps)
    warm: list[dict] = []
    if steps:
        bd['step_range'] = (steps[0]['step'], steps[-1]['step'])
        bd['first_loss'] = float(steps[0]['loss'])
        bd['final_loss'] = float(steps[-1]['loss'])
        warm = [r for r in steps
                if r['step'] > steps[0]['step'] and 'step_time_s' in r]
        times = [float(r['step_time_s']) for r in warm]
        if times:
            bd['mean_step_ms'] = statistics.fmean(times) * 1e3
            bd['p50_step_ms'] = statistics.median(times) * 1e3
        stal = [float(r['staleness']) for r in steps if 'staleness' in r]
        if stal:
            bd['staleness'] = {'final': stal[-1], 'max': max(stal)}
        if 'pipeline_lag' in steps[-1]:
            bd['pipeline_lag'] = int(steps[-1]['pipeline_lag'])
        if 'exchanged_mb_cum' in steps[-1]:
            bd['exchanged_mb_cum'] = float(steps[-1]['exchanged_mb_cum'])

    spans = _of(records, 'span')
    if spans:
        first = min(r.get('step', 0) for r in spans)
        warm_spans = [r for r in spans if r.get('step', first) != first]
        warm_spans = warm_spans or spans  # single-step runs: keep something
        per_phase: dict[str, list[float]] = {}
        for r in warm_spans:
            per_phase.setdefault(r['name'], []).append(float(r['ms']))
        bd['phases'] = {
            name: {'count': len(ms), 'mean_ms': statistics.fmean(ms),
                   'total_ms': sum(ms)}
            for name, ms in per_phase.items()}

    # refresh: realized count + the firing-vs-cached step-time differential
    refresh: dict[str, Any] = {}
    refr = _of(records, 'refresh')
    firing_steps = {r['step'] for r in refr}
    if not firing_steps and len(steps) >= 2:
        for prev, cur in zip(steps, steps[1:]):
            if cur.get('refreshes', 0) > prev.get('refreshes', 0):
                firing_steps.add(cur['step'])
    if refr:
        refresh['count'] = len(refr)
    elif steps and 'refreshes' in steps[-1]:
        refresh['count'] = int(steps[-1]['refreshes'])
    if firing_steps and warm:
        fire = [float(r['step_time_s']) for r in warm
                if r['step'] in firing_steps]
        cached = [float(r['step_time_s']) for r in warm
                  if r['step'] not in firing_steps]
        if fire and cached:
            refresh['mean_firing_ms'] = statistics.fmean(fire) * 1e3
            refresh['mean_cached_ms'] = statistics.fmean(cached) * 1e3
            refresh['extra_ms_per_refresh'] = (refresh['mean_firing_ms']
                                               - refresh['mean_cached_ms'])
            refresh['amortized_ms_per_step'] = (
                refresh['extra_ms_per_refresh'] * len(fire) / len(warm))
    if refresh:
        bd['refresh'] = refresh

    comm = _of(records, 'comm_exchange')
    if comm:
        sites = comm[-1]['sites']
        step_b = sum(int(v['bytes_per_call']) for s, v in sites.items()
                     if not s.startswith('refresh/'))
        refresh_b = sum(int(v['bytes_per_call']) for s, v in sites.items()
                        if s.startswith('refresh/'))
        ici = sum(int(v.get('ici_bytes', 0)) for v in sites.values())
        dcn = sum(int(v.get('dcn_bytes', 0)) for v in sites.values())
        bd['exchange'] = {'sites': sites, 'step_bytes': step_b,
                          'refresh_bytes': refresh_b}
        if ici or dcn:
            bd['exchange']['ici_bytes'] = ici
            bd['exchange']['dcn_bytes'] = dcn

    own = _of(records, 'refresh_ownership')
    if own:
        bd['ownership'] = {'world': own[-1]['world'],
                           'owners': own[-1]['owners']}
    stragglers = _of(records, 'straggler')
    if stragglers:
        bd['stragglers'] = len(stragglers)
    prof = _of(records, 'profile')
    if prof:
        # latest memory numbers; cost summaries ('fns') land in the first
        # profiled step: merge them forward
        bd['profile'] = dict(prof[-1])
        if 'fns' not in bd['profile']:
            for p in prof:
                if 'fns' in p:
                    bd['profile']['fns'] = p['fns']
                    break
    bench = _of(records, 'bench')
    if bench:
        bd['bench'] = {r['name']: r for r in bench if 'name' in r}
    return bd


# ---------------------------------------------------------------------------
# Rendering


def _mib(n_bytes: float) -> str:
    return f'{n_bytes / 2**20:.2f} MiB'


_PHASE_ORDER = ('data', 'grad', 'precondition', 'refresh', 'exchange',
                'apply', 'step')


def render(bd: dict, title: str = '') -> str:
    out = [f'== {title} ==' if title else '== run ==']
    if bd.get('n_step_records'):
        lo, hi = bd['step_range']
        out.append(f"steps: {bd['n_step_records']} records "
                   f"(step {lo}..{hi})   loss {bd['first_loss']:.4f} -> "
                   f"{bd['final_loss']:.4f}")
    if 'mean_step_ms' in bd:
        out.append(f"mean step time: {bd['mean_step_ms']:.2f} ms "
                   f"(p50 {bd['p50_step_ms']:.2f}, first step dropped)")
    line = []
    if 'staleness' in bd:
        line.append(f"staleness final {bd['staleness']['final']:.3g} "
                    f"max {bd['staleness']['max']:.3g}")
    if 'pipeline_lag' in bd:
        line.append(f"pipeline lag {bd['pipeline_lag']}")
    if 'stragglers' in bd:
        line.append(f"stragglers {bd['stragglers']}")
    if line:
        out.append('   '.join(line))

    # unified per-phase table: span-timed phases + the derived refresh and
    # byte-accounted exchange rows
    phases = dict(bd.get('phases', {}))
    refresh = bd.get('refresh', {})
    exch = bd.get('exchange', {})
    if phases or refresh or exch:
        out.append('')
        out.append(f"{'phase':<14} {'ms/step':>10} {'share':>7}   bytes")
        step_ms = (phases.get('step', {}).get('mean_ms')
                   or bd.get('mean_step_ms'))

        def row(name, ms, byt='-', note=''):
            share = (f'{100 * ms / step_ms:.1f}%'
                     if ms is not None and step_ms else '')
            ms_s = f'{ms:.3f}' if ms is not None else '-'
            out.append(f'{name:<14} {ms_s:>10} {share:>7}   {byt}{note}')

        for name in _PHASE_ORDER:
            if name == 'refresh':
                if refresh:
                    ms = refresh.get('amortized_ms_per_step')
                    note = f"  ({refresh.get('count', '?')} realized"
                    if 'extra_ms_per_refresh' in refresh:
                        note += (f", +{refresh['extra_ms_per_refresh']:.3f}"
                                 ' ms each, inside precondition')
                    note += ')'
                    byt = (_mib(exch['refresh_bytes']) + '/refresh'
                           if exch.get('refresh_bytes') else '-')
                    row('refresh', ms, byt, note)
            elif name == 'exchange':
                if exch:
                    byt = _mib(exch['step_bytes']) + '/step'
                    if exch.get('refresh_bytes'):
                        byt += f" + {_mib(exch['refresh_bytes'])}/refresh"
                    row('exchange', None, byt,
                        '  (logical; time inside grad+precondition)')
            elif name in phases:
                row(name, phases[name]['mean_ms'])
        for name in sorted(set(phases) - set(_PHASE_ORDER)):
            row(name, phases[name]['mean_ms'])

    if exch:
        out.append('')
        out.append('exchange sites (logical bytes one worker contributes '
                   'per call):')
        for site, v in sorted(exch['sites'].items()):
            cadence = ('per-refresh' if site.startswith('refresh/')
                       else 'per-step')
            extra = ''
            if v.get('ici_bytes') or v.get('dcn_bytes'):
                extra = (f"  ici {_mib(v.get('ici_bytes', 0))} / "
                         f"dcn {_mib(v.get('dcn_bytes', 0))}")
            out.append(f"  {site:<24} {v['bytes_per_call']:>12} B  "
                       f"{v['codec']:<5} {v['mode']:<12} {cadence}{extra}")
        if 'ici_bytes' in exch:
            out.append(f"  topology split: ICI {_mib(exch['ici_bytes'])} vs "
                       f"DCN {_mib(exch['dcn_bytes'])} per refresh")
        if 'exchanged_mb_cum' in bd:
            out.append(f"  cumulative this run: "
                       f"{bd['exchanged_mb_cum']:.2f} MiB")

    if 'ownership' in bd:
        own = bd['ownership']
        out.append('')
        out.append(f"refresh ownership (world={own['world']}, per-worker "
                   'slice counts):')
        for bucket, counts in sorted(own['owners'].items()):
            out.append(f'  {bucket:<24} {counts}')

    if 'profile' in bd:
        prof = bd['profile']
        out.append('')
        parts = [f"profile @ step {prof.get('step', '?')}:"]
        if 'live_buffer_mb' in prof:
            parts.append(f"live buffers {prof['live_buffer_mb']:.1f} MiB")
        if prof.get('device_bytes_in_use') is not None:
            parts.append(f"device {_mib(prof['device_bytes_in_use'])}")
        out.append(' '.join(parts))
        for fn, c in sorted(prof.get('fns', {}).items()):
            out.append(f"  {fn:<14} {c.get('flops', 0)/1e9:8.3f} GFLOP  "
                       f"traffic {_mib(c.get('traffic_bytes', 0)):>12}  "
                       f"collectives {c.get('collective_count', 0)} "
                       f"({c.get('blocking_collectives', 0)} blocking, "
                       f"dep-dot {c.get('dependent_dot_flop_frac', 0.0)})")

    if 'bench' in bd:
        out.append('')
        out.append(f"bench rows: {len(bd['bench'])}")
        for name, r in sorted(bd['bench'].items()):
            us = r.get('us_per_call', 0.0)
            derived = r.get('derived', '')
            out.append(f'  {name:<40} {us:>10.1f} us  {derived}')
    return '\n'.join(out) + '\n'


# ---------------------------------------------------------------------------
# A-vs-B diff


def _pct(a: float, b: float) -> Optional[float]:
    if not a:
        return None
    return (b - a) / a * 100.0


def diff(bd_a: dict, bd_b: dict, label_a: str = 'A', label_b: str = 'B'
         ) -> tuple[str, Optional[float]]:
    """Comparison table + the worst regression (in %) over *gated*
    metrics: mean step time and benchmark ``us_per_call`` rows.  Positive
    percentages mean B is slower/larger than A."""
    rows: list[tuple[str, float, float, bool]] = []
    if 'mean_step_ms' in bd_a and 'mean_step_ms' in bd_b:
        rows.append(('mean step ms', bd_a['mean_step_ms'],
                     bd_b['mean_step_ms'], True))
    for name in sorted(set(bd_a.get('phases', {})) & set(bd_b.get('phases', {}))):
        rows.append((f'phase {name} ms', bd_a['phases'][name]['mean_ms'],
                     bd_b['phases'][name]['mean_ms'], False))
    if 'final_loss' in bd_a and 'final_loss' in bd_b:
        rows.append(('final loss', bd_a['final_loss'], bd_b['final_loss'],
                     False))
    for key in ('step_bytes', 'refresh_bytes'):
        a = bd_a.get('exchange', {}).get(key)
        b = bd_b.get('exchange', {}).get(key)
        if a is not None and b is not None:
            rows.append((f'exchange {key}', float(a), float(b), False))
    bench_a, bench_b = bd_a.get('bench', {}), bd_b.get('bench', {})
    for name in sorted(set(bench_a) & set(bench_b)):
        ua = float(bench_a[name].get('us_per_call', 0.0))
        ub = float(bench_b[name].get('us_per_call', 0.0))
        if ua > 0 and ub > 0:
            rows.append((f'bench {name} us', ua, ub, True))

    out = [f'== diff: A={label_a} vs B={label_b} ==']
    if not rows:
        out.append('(no comparable metrics)')
        return '\n'.join(out) + '\n', None
    out.append(f"{'metric':<44} {'A':>12} {'B':>12} {'delta':>9}")
    worst: Optional[float] = None
    for name, a, b, gated in rows:
        pct = _pct(a, b)
        pct_s = f'{pct:+.1f}%' if pct is not None else 'n/a'
        tag = '  [gate]' if gated else ''
        out.append(f'{name:<44} {a:>12.3f} {b:>12.3f} {pct_s:>9}{tag}')
        if gated and pct is not None:
            worst = pct if worst is None else max(worst, pct)
    return '\n'.join(out) + '\n', worst


# ---------------------------------------------------------------------------
# CLI


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog='obs_report_torch',
        description='Validate / break down / diff telemetry artifacts '
                    '(metrics.jsonl, BENCH_*.json). Exit codes: 0 ok, '
                    '1 validation errors, 2 gated regression.')
    ap.add_argument('files', nargs='+',
                    help='metrics.jsonl and/or BENCH_*.json paths')
    ap.add_argument('--validate', action='store_true',
                    help='schema-validate every record, then exit '
                         '(1 on any error)')
    ap.add_argument('--diff', action='store_true',
                    help='A-vs-B diff of exactly two files')
    ap.add_argument('--max-regress', type=float, default=None, metavar='PCT',
                    help='with two files: exit 2 if any gated metric '
                         '(mean step time, bench us/call) regressed >PCT%%')
    args = ap.parse_args(argv)

    loaded = [(f, load_records(f)) for f in args.files]

    if args.validate:
        n_err = 0
        for f, recs in loaded:
            errs = validate_records(recs)
            if errs:
                print(f'{f}: {len(errs)} schema error(s)')
                for e in errs[:50]:
                    print(f'  {e}')
                n_err += len(errs)
            else:
                print(f'{f}: {len(recs)} records OK '
                      f'(schema v{events.SCHEMA_VERSION})')
        return 1 if n_err else 0

    want_diff = args.diff or args.max_regress is not None
    if want_diff and len(loaded) != 2:
        ap.error('--diff/--max-regress need exactly two files')

    if not args.diff:
        for f, recs in loaded:
            print(render(breakdown(recs), title=f))

    if len(loaded) == 2:
        (fa, ra), (fb, rb) = loaded
        text, worst = diff(breakdown(ra), breakdown(rb), fa, fb)
        print(text)
        if args.max_regress is not None and worst is not None \
                and worst > args.max_regress:
            print(f'REGRESSION: worst gated metric {worst:+.1f}% exceeds '
                  f'--max-regress {args.max_regress:g}%')
            return 2
    return 0
