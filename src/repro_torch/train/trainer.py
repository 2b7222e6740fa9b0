"""The training loop on one device — PyTorch port of ``Trainer.fit`` in
``repro/train/trainer.py``.

``fit`` keeps every behaviour of the reference's single-device loop:

  * it resumes from the latest checkpoint of ``<out_dir>/ckpt`` (the data
    must be seekable, ``batch_at(step)``, so a resumed run sees the same
    batches and continues the uninterrupted run bit for bit);
  * it checkpoints every ``ckpt_every`` steps asynchronously
    (``checkpoint.AsyncCheckpointer``), keeping the newest ``keep_ckpts``;
  * on SIGTERM or SIGINT it writes a synchronous checkpoint and returns;
  * the straggler watchdog (``obs.spans.StragglerWatchdog``) flags steps
    slower than ``straggler_factor`` × the running median;
  * ``metrics.jsonl`` gets schema-typed ``step`` and ``refresh`` records
    with the refresh counters of ``schedule_metrics``, and one
    ``refresh_ownership`` record at W = 1;
  * ``profile=True`` runs the step as ``make_phased_step``'s three phases
    under spans fenced by ``torch.cuda.synchronize()``, with a ``profile``
    record of the card's allocated bytes per logged step.

The port's step returns new tensors and never writes its inputs, so
``fit`` never modifies the caller's tensors and ``TrainerConfig`` has no
``donate`` (the reference's buffer donation).  ``fit_elastic`` (the
multi-worker loop) and an autotuned kernel cache are not ported.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Any, Callable, Optional

from repro_torch.core import kv as kvlib
from repro_torch.core.transform import GradientTransformation
from repro_torch.device import resolve_device
from repro_torch.obs import events as obs_events
from repro_torch.obs import spans as obs_spans
from repro_torch.schedule import runtime as schedrt
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.step import (init_opt_state, make_phased_step,
                                    make_train_step, stats_plan_of)


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    log_every: int = 10
    ckpt_every: int = 0            # 0 = no checkpointing
    keep_ckpts: int = 3
    out_dir: str = 'runs/default'
    straggler_factor: float = 3.0
    profile: bool = False          # span-fenced phased step + memory records


class Trainer:
    def __init__(self, model, opt: GradientTransformation,
                 capture: kvlib.CaptureConfig, cfg: TrainerConfig,
                 taps_fn: Optional[Callable] = None,
                 sched: Optional[schedrt.RefreshRuntime] = None,
                 comm=None, factor=None, kernel=None, device='cuda'):
        if comm is not None:
            raise NotImplementedError(
                'comm= (the gradient and statistics exchange) needs several '
                'workers and is not ported (ROADMAP.md §1 item 12)')
        if kernel is not None:
            if getattr(kernel, 'autotune_cache', None):
                raise NotImplementedError(
                    'kernel.autotune_cache: the autotuned tile cache is not '
                    'ported (ROADMAP.md §1 item 13)')
            raise ValueError('the port picks the kernel impl per optimizer '
                             "(make_optimizer(..., kernel_impl=...)) and "
                             "per factor config (FactorShardConfig.impl); "
                             'pass kernel=None')
        self.device = resolve_device(device)
        self.model = model
        self.opt = opt
        self.capture = capture
        self.cfg = cfg
        self.taps_fn = taps_fn
        self.sched = sched if sched is not None else schedrt.RefreshRuntime()
        self.factor = factor
        self.out_dir = Path(cfg.out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.ckpt_dir = self.out_dir / 'ckpt'
        self._ckptr = ckpt.AsyncCheckpointer(self.ckpt_dir, cfg.keep_ckpts)
        self.step_fn = make_train_step(model, opt, capture, taps_fn=taps_fn,
                                       sched=self.sched, factor=factor,
                                       device=self.device)
        self._phases = None
        if cfg.profile:
            self._phases = make_phased_step(
                model, opt, capture, taps_fn=taps_fn, sched=self.sched,
                factor=factor, device=self.device)
        self._watchdog = obs_spans.StragglerWatchdog(cfg.straggler_factor)
        self._preempted = False
        self.metrics_path = self.out_dir / 'metrics.jsonl'

    def _init_state(self, params, batch):
        return init_opt_state(self.model, self.opt, self.capture, params,
                              batch, taps_fn=self.taps_fn, sched=self.sched,
                              factor=self.factor, device=self.device)

    def _log_ownership(self, recorder, params, batch) -> None:
        """One startup record: the per-bucket refresh-owner map, at W = 1
        every slice worker 0's.  Never fatal."""
        try:
            plan = stats_plan_of(self.model, self.capture, params, batch,
                                 taps_fn=self.taps_fn, device=self.device)
        except Exception:
            plan = None
        body = schedrt.ownership_event(plan)
        if body is None:
            return
        recorder.emit('refresh_ownership', **body)
        print(f"[trainer] refresh ownership over W={body['world']}: "
              + ' '.join(f'{k}:{v}' for k, v in body['owners'].items()),
              flush=True)

    # -- preemption ---------------------------------------------------------

    def _install_signal_handlers(self):
        import signal

        def handler(signum, frame):
            del frame
            print(f'[trainer] caught signal {signum}: checkpoint-and-exit '
                  f'requested', flush=True)
            self._preempted = True

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, handler)
            except ValueError:
                pass  # not in the main thread

    # -- profile-mode step ----------------------------------------------------

    def _profiled_step(self, tracker, step, data, params, opt_state):
        """One step through the phased functions under fenced spans; the
        same (params, opt_state, metrics) as ``step_fn``."""
        grad_fn, update_fn, apply_fn = self._phases
        with tracker.span('step', step=step) as sp_all:
            with tracker.span('data', step=step):
                batch = data.batch_at(step)
            with tracker.span('grad', step=step) as sp:
                loss, grads, stats = grad_fn(params, batch)
                sp.fence((loss, grads))
            with tracker.span('precondition', step=step) as sp:
                updates, opt_state, metrics = update_fn(grads, stats, loss,
                                                        opt_state, params)
                sp.fence(updates)
            with tracker.span('apply', step=step) as sp:
                params = apply_fn(params, updates)
                sp.fence(params)
            sp_all.fence(params)
        return params, opt_state, metrics

    def _emit_profile(self, recorder, step):
        rec: dict[str, Any] = {'step': step}
        dev = obs_spans.device_bytes_in_use()
        if dev is not None:
            rec['device_bytes_in_use'] = dev
        recorder.emit('profile', **rec)

    # -- main loop ------------------------------------------------------------

    def fit(self, params, data: Any, start_step: int = 0,
            opt_state=None, resume: bool = True):
        """Train to ``cfg.total_steps``.  ``data`` exposes ``batch_at(step)``.
        Returns ``(params, opt_state, history of losses)``."""
        cfg = self.cfg
        self._install_signal_handlers()

        if resume and cfg.ckpt_every:
            latest = ckpt.latest_step(self.ckpt_dir)
            if latest is not None:
                template = {'params': params,
                            'opt_state': opt_state if opt_state is not None
                            else self._init_state(params, data.batch_at(0))}
                state, meta = ckpt.restore(self.ckpt_dir, latest, template,
                                           device=self.device)
                params, opt_state = state['params'], state['opt_state']
                start_step = meta.get('next_step', latest)
                print(f'[trainer] resumed from step {latest}', flush=True)

        first = data.batch_at(start_step)
        if opt_state is None:
            opt_state = self._init_state(params, first)

        # refreshes already in a restored state: the refresh records count
        # this run's crossings of the cumulative counter
        base_sched = schedrt.schedule_metrics(opt_state)
        ref_base = int(base_sched['refreshes']) if base_sched else 0

        recorder = obs_events.Recorder(self.metrics_path)
        self._watchdog.recorder = recorder
        tracker = obs_spans.SpanTracker(recorder)
        self._log_ownership(recorder, params, first)
        history = []
        prev_ref = ref_base
        try:
            for step in range(start_step, cfg.total_steps):
                if self._phases is not None:
                    t0 = time.perf_counter()
                    params, opt_state, metrics = self._profiled_step(
                        tracker, step, data, params, opt_state)
                    loss = float(metrics['loss'])
                    dt = time.perf_counter() - t0
                else:
                    batch = first if step == start_step \
                        else data.batch_at(step)
                    t0 = time.perf_counter()
                    params, opt_state, metrics = self.step_fn(
                        params, opt_state, batch)
                    loss = float(metrics['loss'])  # waits for the card
                    dt = time.perf_counter() - t0
                self._watchdog.observe(step, dt)
                history.append(loss)
                sched_fields = obs_events.step_fields(metrics)
                if 'refreshes' in sched_fields:
                    cur_ref = sched_fields['refreshes']
                    if cur_ref > prev_ref:
                        recorder.emit('refresh', step=step,
                                      refreshes=cur_ref,
                                      step_time_s=round(dt, 6))
                    prev_ref = cur_ref
                if step % cfg.log_every == 0 or step == cfg.total_steps - 1:
                    rec = {'step': step, 'loss': loss,
                           'grad_norm': float(metrics['grad_norm']),
                           'step_time_s': round(dt, 4), **sched_fields}
                    sched_line = ''
                    if 'refreshes' in rec:
                        sched_line = (f" refreshes {rec['refreshes']}"
                                      f" staleness {rec['staleness']:.3g}")
                    recorder.emit('step', **rec)
                    if self._phases is not None:
                        self._emit_profile(recorder, step)
                    print(f'[trainer] step {step:6d} loss {loss:.4f} '
                          f'({dt*1e3:.0f} ms){sched_line}', flush=True)
                if cfg.ckpt_every and (step + 1) % cfg.ckpt_every == 0:
                    self._ckptr.save(
                        step + 1, {'params': params, 'opt_state': opt_state},
                        {'next_step': step + 1})
                if self._preempted:
                    print('[trainer] preemption: synchronous checkpoint at '
                          f'step {step + 1}', flush=True)
                    self._ckptr.wait()
                    ckpt.save(self.ckpt_dir, step + 1,
                              {'params': params, 'opt_state': opt_state},
                              {'next_step': step + 1, 'preempted': True})
                    break
        finally:
            self._ckptr.wait()
            self._watchdog.recorder = None
            recorder.close()
        return params, opt_state, history

    def fit_elastic(self, *args, **kwargs):
        raise NotImplementedError(
            'fit_elastic (restore at another world size, live resizes) '
            'needs several workers and is not ported (ROADMAP.md §1 item '
            '12); use fit on one device')
