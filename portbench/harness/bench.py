"""One run of one cell: set-up, the timed window (``--trace 0``) or the
traced run (``--trace 1``), then the check of ``correct`` against the plain
reference, and the result line.

Set-up builds the program's step with its model and optimizer state, and
drives it through its first ``check.STEPS`` steps with the same call the
window makes (which warms every shape and kernel up), reading what the
check compares: each step's loss, the optimizer's momentum buffer after
step 1 and the parameters' change after the last.  The same objects go on
into the window, which cycles through the traffic's batches.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from typing import Callable, Optional

import torch

from portbench.harness import check, manifest
from portbench.harness.peaks import peaks_of
from portbench.harness.program import Program, buffer_of
from portbench.harness.trace import Profile, profile_steps
from portbench.harness.weights import make_weights, token_batches

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'repro')
PROFILE_SECONDS = 8.0     # profiled steps: about this long, 3 to 10 steps
PROFILE_STEPS = (3, 10)
GIB = 2 ** 30


def sync(device) -> None:
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


class Session:
    """The program set up for one seed: weights, batches, the step (one
    call, or its three phases), the optimizer state after the first steps
    and the readings the check compares.  ``fault`` wraps the step (the
    fault tests and the fault readings; ``harness/faults.py``)."""

    def __init__(self, cell, seed: int, device, phased: bool = False,
                 fault: Optional[Callable] = None):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.ref_model = manifest.reference_model(cell.config)
        self.program = Program(cell, self.ref_model, self.device)
        self.specs = self.ref_model.param_specs(cell.config)
        self.params = make_weights(self.specs, seed, self.device)
        self.batches = token_batches(cell.traffic, cell.config['vocab'],
                                     seed, self.device)
        self.state = self.program.init_state(self.params, self.batches[0])
        if phased:
            self.grad_fn, self.update_fn, self.apply_fn = \
                self.program.phased_step()
            step = self._composed
        else:
            step = self.program.train_step()
        self.step = fault(step) if fault is not None else step
        self.done = 0
        losses = []
        for i in range(check.STEPS):
            losses.append(self.advance())
            if i == 0:
                buffer1 = check.norms(buffer_of(self.state))
                sample1 = check.sample(buffer_of(self.state), seed)
        self.readings = {
            'losses': [float(x) for x in losses], 'buffer1': buffer1,
            'sample1': sample1,
            'delta3': check.change_norms(self.params, self.specs, seed,
                                         self.device)}

    def _composed(self, params, state, batch):
        loss, grads, stats = self.grad_fn(params, batch)
        updates, state, metrics = self.update_fn(grads, stats, loss, state,
                                                 params)
        return self.apply_fn(params, updates), state, metrics

    def next_batch(self) -> dict:
        return self.batches[self.done % len(self.batches)]

    def advance(self):
        """One step on the next batch; its loss (a device scalar)."""
        self.params, self.state, metrics = self.step(
            self.params, self.state, self.next_batch())
        self.done += 1
        return metrics['loss']

    def timed_phases(self):
        """One step in its three phases, each ended by a synchronize:
        (forward + backward seconds, update + apply seconds, loss)."""
        t0 = time.perf_counter()
        loss, grads, stats = self.grad_fn(self.params, self.next_batch())
        sync(self.device)
        t1 = time.perf_counter()
        updates, self.state, metrics = self.update_fn(
            grads, stats, loss, self.state, self.params)
        del grads, stats
        self.params = self.apply_fn(self.params, updates)
        sync(self.device)
        self.done += 1
        return t1 - t0, time.perf_counter() - t1, metrics['loss']

    def close(self) -> None:
        """Free the program's state, the batches kept for the check."""
        for name in ('params', 'state', 'step', 'grad_fn', 'update_fn',
                     'apply_fn', 'program'):
            self.__dict__.pop(name, None)
        gc.collect()
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()


@dataclasses.dataclass
class TraceContext:
    """What a per-layer metric's reader gets."""
    cell: manifest.Cell
    ref_model: object
    peaks: Optional[dict]
    grad_s: list
    opt_s: list
    profile: Optional[Profile]


def _window(sess: Session, seconds: float) -> tuple[int, float, list]:
    """Steps until ``seconds`` have passed on the host's clock, then one
    synchronize: (steps, seconds to the end of the last, their losses)."""
    losses, t0 = [], time.perf_counter()
    while True:
        losses.append(sess.advance())
        if time.perf_counter() - t0 >= seconds:
            break
    sync(sess.device)
    return len(losses), time.perf_counter() - t0, losses


def _traced(sess: Session, seconds: float):
    """The phases timed for ``seconds``, then about PROFILE_SECONDS of
    composed steps (the window's call) under the profiler."""
    grad_s, opt_s, losses, t0 = [], [], [], time.perf_counter()
    while True:
        g, o, loss = sess.timed_phases()
        grad_s.append(g)
        opt_s.append(o)
        losses.append(loss)
        if time.perf_counter() - t0 >= seconds:
            break
    timed_s = time.perf_counter() - t0
    prof = None
    if sess.device.type == 'cuda':
        lo, hi = PROFILE_STEPS
        k = min(hi, max(lo, math.ceil(PROFILE_SECONDS * len(grad_s)
                                      / timed_s)))
        prof = profile_steps(lambda k: [losses.append(sess.advance())
                                        for _ in range(k)], k)
    return grad_s, opt_s, prof, losses


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=power.limit',
                              '--format=csv,noheader,nounits', '-i', '0'],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _metric(entry: dict, value: float) -> dict:
    return {'value': value, 'unit': entry['unit']}


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        limits: dict, fault: Optional[Callable] = None) -> dict:
    """One run; returns the result line's fields and the readings."""
    dev = torch.device(device)
    on_card = dev.type == 'cuda'
    sess = Session(cell, seed, dev, phased=trace, fault=fault)
    # what set-up left is kept out of the collector's scans, so that a
    # collection in the window walks only the window's own objects
    gc.collect()
    gc.freeze()
    sync(dev)
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    kind = torch.cuda.get_device_name(0) if on_card else None
    metrics, breakdown, extra = {}, None, {}
    if not trace:
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        steps, elapsed, losses = _window(sess, seconds)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        values = {'tokens_per_s': steps * cell.tokens_per_step / elapsed,
                  'setup_s': setup_s}
        if on_card:
            values['peak_mem_gib'] = peak / GIB
        metrics = {m['name']: _metric(m, values[m['name']])
                   for m in cell.end_to_end if m['name'] in values}
    else:
        grad_s, opt_s, prof, losses = _traced(sess, seconds)
        steps = len(losses)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        ctx = TraceContext(cell, sess.ref_model, peaks_of(kind),
                           grad_s, opt_s, prof)
        for m in cell.per_layer:
            value = manifest.metric_reader(m['name']).read(ctx)
            if value is not None:
                metrics[m['name']] = _metric(m, value)
        if prof is not None:
            extra = {'busy_s': prof.busy_s, 'window_s': prof.window_s}
            breakdown = {'device_ops': prof.device_ops,
                         'idle_gaps': prof.idle_gaps}
    finite = torch.isfinite(torch.stack(losses).float()).cpu()
    failed = int((~finite).sum())
    got = sess.readings
    batches = sess.batches[:check.STEPS]
    sess.close()
    gc.unfreeze()
    del losses
    ref = check.reference_readings(cell, seed, batches, dev)
    numbers = check.compare(got, ref)
    correct, checks = check.judge(numbers, limits)
    checks['window_nonfinite'] = {'value': failed, 'limit': 0,
                                  'at': f'{steps} steps'}
    device_info = {'platform': 'gpu' if on_card else 'cpu', 'kind': kind,
                   'count': cell.chips,
                   'memory_peak_bytes': max(setup_peak, peak), **extra}
    if on_card:
        device_info['power_limit_w'] = power_limit_w()
    out = {'correct': bool(correct and failed == 0), 'attempted': steps,
           'failed': failed, 'metrics': metrics, 'device': device_info}
    if breakdown is not None:
        out['breakdown'] = breakdown
    out['checks'] = checks
    return {'result': out, 'program': got, 'reference': ref,
            'numbers': numbers}


def forbidden_modules() -> list:
    return sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog='portbench/run.py')
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    cell = manifest.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f'portbench: {cell.name} needs {cell.chips} CUDA device(s); '
              f'torch sees {have}.  The benchmark measures the card and has '
              'no CPU fallback.', file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    limits = manifest.limits(cell.name)
    out = run(cell, args.seed, args.seconds, bool(args.trace), 'cuda',
              t_start, limits)
    bad = forbidden_modules()
    if bad:
        print(f'portbench: the run loaded {bad}; the port must not load '
              'JAX or the JAX package', file=sys.stderr)
        return 3
    res = out['result']
    for name, m in res['metrics'].items():
        print(f'metric {name} = {m["value"]!r} {m["unit"]}', file=sys.stderr)
    for name, (value, where) in out['numbers'].items():
        if name not in res['checks']:
            print(f'reading {name} = {value!r} (not compared, {where})',
                  file=sys.stderr)
    for name, c in res['checks'].items():
        print(f'check {name} = {c["value"]!r} (limit {c["limit"]!r}, '
              f'{c["at"]})', file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0
