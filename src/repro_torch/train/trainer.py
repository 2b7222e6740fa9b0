"""The training loop — PyTorch port of ``Trainer.fit`` and
``Trainer.fit_elastic`` in ``repro/train/trainer.py``.

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
    with the refresh counters of ``schedule_metrics``, one
    ``refresh_ownership`` record at W = 1 and, after the first step, one
    ``comm_exchange`` record of the exchange sites the step recorded;
  * ``profile=True`` runs the step as ``make_phased_step``'s three phases
    under spans fenced by a synchronize of each card the fence's tensors
    lie on, with a ``profile`` record per logged step (live tensor MiB, the
    allocator's bytes) and, on the first, each phase's cost summary
    (``fns``, from the cost trace of ``launch/hlo_analysis.py``).

The port's step returns new tensors and never writes its inputs, so
``fit`` never modifies the caller's tensors and ``TrainerConfig`` has no
``donate`` (the reference's buffer donation).  :meth:`Trainer.fit_elastic`
is the multi-worker loop over ``torch.distributed``.  ``kernel`` (a
``kernels.dispatch.KernelConfig``) installs its autotune cache at
construction and goes into every step's ``Extras``; with it, each ``step``
record carries ``kernel_impl`` and ``kernel_tiles``, as in the reference.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.core import kv as kvlib
from repro_torch.core.transform import GradientTransformation, tree_map
from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch as kdispatch
from repro_torch.launch import workers
from repro_torch.obs import events as obs_events
from repro_torch.obs import spans as obs_spans
from repro_torch.schedule import pipeline as pipemod
from repro_torch.schedule import reshard as reshard_mod
from repro_torch.schedule import runtime as schedrt
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.step import (init_opt_state, make_dp_step,
                                    make_phased_step, make_train_step,
                                    stats_plan_of)


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
        self.device = resolve_device(device)
        self.model = model
        self.opt = opt
        self.capture = capture
        self.cfg = cfg
        self.taps_fn = taps_fn
        self.sched = sched if sched is not None else schedrt.RefreshRuntime()
        self.comm = comm
        self.factor = factor
        # the kernel dispatch request (kernels.dispatch.KernelConfig); its
        # cache is installed here, in every process that builds a Trainer
        self.kernel = kernel
        if kernel is not None and kernel.autotune_cache:
            kdispatch.install_cache(kernel.autotune_cache)
        self.out_dir = Path(cfg.out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.ckpt_dir = self.out_dir / 'ckpt'
        self._ckptr = ckpt.AsyncCheckpointer(self.ckpt_dir, cfg.keep_ckpts)
        self.step_fn = make_train_step(model, opt, capture, taps_fn=taps_fn,
                                       sched=self.sched, comm=comm,
                                       factor=factor, kernel=kernel,
                                       device=self.device)
        self._phases = None
        if cfg.profile:
            self._phases = make_phased_step(
                model, opt, capture, taps_fn=taps_fn, sched=self.sched,
                comm=comm, factor=factor, kernel=kernel, device=self.device)
        self._watchdog = obs_spans.StragglerWatchdog(cfg.straggler_factor)
        self._preempted = False
        self.metrics_path = self.out_dir / 'metrics.jsonl'

    def _init_state(self, params, batch):
        return init_opt_state(self.model, self.opt, self.capture, params,
                              batch, taps_fn=self.taps_fn, sched=self.sched,
                              comm=self.comm, factor=self.factor,
                              kernel=self.kernel, device=self.device)

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

    def _log_comm(self, recorder, sites) -> None:
        """One record after the first step: the logical exchange bytes per
        call site that this run's step recorded (none when nothing in the
        run exchanges)."""
        if not sites:
            return
        recorder.emit('comm_exchange', sites=sites)
        print('[trainer] comm exchange: ' + ' '.join(
            f"{s}:{v['bytes_per_call']}B/{v['codec']}/{v['mode']}"
            for s, v in sorted(sites.items())), flush=True)

    def _exchanged_mb(self, sites, steps: int, refreshes: int) -> float:
        """Cumulative exchanged MiB: the per-step sites every step, the
        refresh sites once a realized refresh."""
        step_b = sum(v['bytes_per_call'] for s, v in sites.items()
                     if not s.startswith('refresh/'))
        refresh_b = sum(v['bytes_per_call'] for s, v in sites.items()
                        if s.startswith('refresh/'))
        return round((step_b * steps + refresh_b * refreshes) / 2 ** 20, 3)

    def _kernel_fields(self) -> dict:
        """The step record's kernel fields: the requested impl and the
        latest resolved choice per op; none without a ``KernelConfig``."""
        if self.kernel is None:
            return {}
        out = {'kernel_impl': self.kernel.impl}
        tiles = kdispatch.choices_snapshot()
        if tiles:
            out['kernel_tiles'] = tiles
        return out

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
        same (params, opt_state, metrics) as ``step_fn``, and each phase's
        function with the arguments it took (the one-shot cost pass)."""
        grad_fn, update_fn, apply_fn = self._phases
        with tracker.span('step', step=step) as sp_all:
            with tracker.span('data', step=step):
                batch = data.batch_at(step)
            with tracker.span('grad', step=step) as sp:
                loss, grads, stats = grad_fn(params, batch)
                sp.fence((loss, grads))
            phase_args = {'grad': (grad_fn, (params, batch)),
                          'precondition': (update_fn, (grads, stats, loss,
                                                       opt_state, params))}
            with tracker.span('precondition', step=step) as sp:
                updates, opt_state, metrics = update_fn(grads, stats, loss,
                                                        opt_state, params)
                sp.fence(updates)
            phase_args['apply'] = (apply_fn, (params, updates))
            with tracker.span('apply', step=step) as sp:
                params = apply_fn(params, updates)
                sp.fence(params)
            sp_all.fence(params)
        tracker.resolve()      # fenced: frees the spans' events at once
        return params, opt_state, metrics, phase_args

    def _emit_profile(self, recorder, step, phase_args, one_shot_hlo):
        """The ``profile`` record: live tensor bytes, the allocator's bytes
        in use, and on ``one_shot_hlo`` each phase's cost summary, traced
        on fake copies of the arguments it took (nothing runs or
        launches)."""
        rec: dict[str, Any] = {'step': step,
                               'live_buffer_mb': obs_spans.live_buffer_mb()}
        dev = obs_spans.device_bytes_in_use()
        if dev is not None:
            rec['device_bytes_in_use'] = dev
        if one_shot_hlo:
            try:
                rec['fns'] = {
                    name: obs_spans.compiled_fn_costs(fn, *args)
                    for name, (fn, args) in phase_args.items()}
            except Exception as e:  # never fatal: a phase may read the host
                print(f'[trainer] profile: cost pass skipped ({e})',
                      flush=True)
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
                    params, opt_state, metrics, phase_args = \
                        self._profiled_step(tracker, step, data, params,
                                            opt_state)
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
                if step == start_step:
                    sites = recorder.comm_sites()
                    self._log_comm(recorder, sites)
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
                    if 'pipeline_lag' in rec:
                        sched_line += f" lag {rec['pipeline_lag']}"
                    if sites:
                        rec['exchanged_mb_cum'] = self._exchanged_mb(
                            sites, step + 1 - start_step,
                            rec.get('refreshes', ref_base) - ref_base)
                    rec.update(self._kernel_fields())
                    recorder.emit('step', **rec)
                    if self._phases is not None:
                        self._emit_profile(recorder, step, phase_args,
                                           one_shot_hlo=(step == start_step))
                    print(f'[trainer] step {step:6d} loss {loss:.4f} '
                          f'({dt*1e3:.0f} ms){sched_line}', flush=True)
                if cfg.ckpt_every and (step + 1) % cfg.ckpt_every == 0:
                    opt_state = pipemod.settle(opt_state)
                    self._ckptr.save(
                        step + 1, {'params': params, 'opt_state': opt_state},
                        {'next_step': step + 1})
                if self._preempted:
                    print('[trainer] preemption: synchronous checkpoint at '
                          f'step {step + 1}', flush=True)
                    opt_state = pipemod.settle(opt_state)
                    self._ckptr.wait()
                    ckpt.save(self.ckpt_dir, step + 1,
                              {'params': params, 'opt_state': opt_state},
                              {'next_step': step + 1, 'preempted': True})
                    break
        finally:
            self._ckptr.wait()
            self._watchdog.recorder = None
            recorder.close()
        opt_state = pipemod.settle(opt_state)
        return params, opt_state, history

    # -- elastic outer loop ---------------------------------------------------

    def _flag_device(self) -> torch.device:
        return self.device if dist.get_backend() == 'nccl' \
            else torch.device('cpu')

    def _any_preempted(self) -> bool:
        """Whether any rank of the default group caught a signal: one MAX
        over the group a step, so every rank checkpoints and stops at the
        same step."""
        flag = torch.tensor([int(self._preempted)], dtype=torch.int32,
                            device=self._flag_device())
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    @staticmethod
    def _broadcast(tree, group):
        """``tree`` with every tensor replaced by rank 0's copy over
        ``group`` (fresh tensors: the caller's are never written)."""
        def one(x):
            if not torch.is_tensor(x):
                return x
            y = x.detach().clone()
            dist.broadcast(y, src=0, group=group)
            return y
        return tree_map(one, tree)

    def fit_elastic(self, params, data: Any, world: Optional[int] = None,
                    world_fn: Optional[Callable[[int], Optional[int]]] = None,
                    start_step: int = 0, resume: bool = True):
        """Elastic training over ``torch.distributed``: called in every rank
        of a started group (``launch.workers.init_workers`` or ``spawn``).

        The run is a sequence of constant-W phases over the first W ranks
        (``workers.data_group``), each step the explicit-DP
        ``make_dp_step`` on the global batch ``data.batch_at(step)``.  W
        starts at ``world`` (default: every rank) and changes two ways:

        * restore: a checkpoint written at another W (its elastic metadata
          block, ``docs/CHECKPOINT_FORMAT.md``) is restored leaf for leaf on
          every rank and resharded;
        * live: ``world_fn(step)`` (None: keep W) asks for a new W between
          steps.  Ranks past W idle and keep their state; on a regrow rank
          0 broadcasts the parameters and the state to the new group.

        Either way the state goes through ``schedule.reshard.reshard_state``
        (pipeline buffers drained) and rank 0 emits a ``reshard`` record and
        a fresh ``refresh_ownership`` record.  Rank 0 writes every
        checkpoint, with the elastic block, while the others wait at a
        barrier; SIGTERM on every rank gives a synchronous checkpoint and a
        clean return at the same step on all of them (one flag MAX a
        step).  At W = 1 the trajectory is :meth:`fit`'s bit for bit.
        ``profile`` mode raises.

        Returns ``(params, opt_state, history)``, ``history`` the
        ``(step, loss)`` pairs of the steps this rank took part in."""
        cfg = self.cfg
        if cfg.profile:
            raise ValueError('profile mode is not supported by fit_elastic '
                             '(use fit for span-fenced phase profiling)')
        if not dist.is_initialized():
            raise RuntimeError('fit_elastic runs in every rank of a started '
                               'group: launch.workers.init_workers or spawn')
        self._install_signal_handlers()
        rank = dist.get_rank()
        world = int(world) if world else dist.get_world_size()
        try:
            plan = stats_plan_of(self.model, self.capture, params,
                                 data.batch_at(start_step),
                                 taps_fn=self.taps_fn, device=self.device)
        except Exception:
            plan = None

        opt_state = None
        world_from = world
        source = 'init'
        if resume and cfg.ckpt_every:
            latest = ckpt.latest_step(self.ckpt_dir)
            if latest is not None:
                template = {'params': params, 'opt_state': self._init_state(
                    params, data.batch_at(0))}
                state, meta = ckpt.restore(self.ckpt_dir, latest, template,
                                           device=self.device)
                params, opt_state = state['params'], state['opt_state']
                start_step = meta.get('next_step', latest)
                ck_world = reshard_mod.check_metadata(
                    meta.get(reshard_mod.ELASTIC_KEY), plan=plan,
                    pipeline=self.sched.pipeline)
                world_from = ck_world if ck_world else world
                source = 'checkpoint'
                if rank == 0:
                    print(f'[trainer] resumed from step {latest} '
                          f'(checkpoint W={world_from})', flush=True)
        if opt_state is None:
            opt_state = self._init_state(params, data.batch_at(start_step))

        base_sched = schedrt.schedule_metrics(opt_state)
        ref_base = int(base_sched['refreshes']) if base_sched else 0
        recorder = obs_events.Recorder(self.metrics_path if rank == 0
                                       else None)
        self._watchdog.recorder = recorder
        step_fns: dict[int, Callable] = {}
        cur = {'world': world, 'step_fn': None, 'check_batch': True}

        def resize(w_from, w_to, at_step, src):
            nonlocal params, opt_state
            cur['check_batch'] = True
            opt_state, body = reshard_mod.reshard_state(
                opt_state, world_from=w_from, world_to=w_to, plan=plan,
                step=at_step, source=src)
            group = workers.data_group(w_to)      # collective: every rank
            if rank < w_to and src == 'live' and w_to > w_from:
                # the ranks that idled kept an old state: rank 0's wins
                params = self._broadcast(params, group)
                opt_state = self._broadcast(opt_state, group)
            if rank < w_to and w_to not in step_fns:
                step_fns[w_to] = make_dp_step(
                    self.model, self.opt, self.capture, group,
                    taps_fn=self.taps_fn, sched=self.sched, comm=self.comm,
                    factor=self.factor, kernel=self.kernel,
                    device=self.device)
            cur['step_fn'] = step_fns.get(w_to)
            cur['world'] = w_to
            if w_from != w_to:
                recorder.emit('reshard', **body)
                if rank == 0:
                    print(f'[trainer] reshard W={w_from} -> W={w_to} at '
                          f"step {at_step} (pipeline buffers: "
                          f"{body['pipeline']}, owners moved: "
                          f"{body.get('slices_moved', 0)}/"
                          f"{body.get('slices_total', 0)})", flush=True)
            own = schedrt.ownership_event(plan, world=w_to)
            if own is not None:
                recorder.emit('refresh_ownership', **own)

        def meta(next_step, **extra):
            return {'next_step': next_step,
                    reshard_mod.ELASTIC_KEY: reshard_mod.elastic_metadata(
                        cur['world'], plan=plan,
                        pipeline=self.sched.pipeline), **extra}

        resize(world_from, world, start_step, source)
        history: list[tuple[int, float]] = []
        prev_ref = ref_base
        sites = None
        try:
            for step in range(start_step, cfg.total_steps):
                if world_fn is not None:
                    want = world_fn(step)
                    if want and int(want) != cur['world']:
                        resize(cur['world'], int(want), step, 'live')
                batch = data.batch_at(step)
                if cur['check_batch']:
                    reshard_mod.check_batch_divisible(batch, cur['world'])
                    cur['check_batch'] = False
                if rank < cur['world']:
                    t0 = time.perf_counter()
                    params, opt_state, metrics = cur['step_fn'](
                        params, opt_state, batch)
                    loss = float(metrics['loss'])  # waits for the card
                    dt = time.perf_counter() - t0
                    if sites is None:
                        sites = recorder.comm_sites()
                        if rank == 0:
                            self._log_comm(recorder, sites)
                    self._watchdog.observe(step, dt)
                    history.append((step, loss))
                    sched_fields = obs_events.step_fields(metrics)
                    if 'refreshes' in sched_fields:
                        cur_ref = sched_fields['refreshes']
                        if cur_ref > prev_ref:
                            recorder.emit('refresh', step=step,
                                          refreshes=cur_ref,
                                          step_time_s=round(dt, 6))
                        prev_ref = cur_ref
                    if step % cfg.log_every == 0 or \
                            step == cfg.total_steps - 1:
                        recorder.emit('step', step=step, loss=loss,
                                      grad_norm=float(metrics['grad_norm']),
                                      step_time_s=round(dt, 4),
                                      **sched_fields, **self._kernel_fields())
                        if rank == 0:
                            print(f'[trainer] step {step:6d} loss '
                                  f'{loss:.4f} ({dt*1e3:.0f} ms) '
                                  f"W={cur['world']}", flush=True)
                if cfg.ckpt_every and (step + 1) % cfg.ckpt_every == 0:
                    opt_state = pipemod.settle(opt_state)
                    if rank == 0:
                        self._ckptr.save(step + 1, {'params': params,
                                                    'opt_state': opt_state},
                                         meta(step + 1))
                    dist.barrier()
                if self._any_preempted():
                    if rank == 0:
                        print('[trainer] preemption: synchronous checkpoint '
                              f'at step {step + 1}', flush=True)
                        opt_state = pipemod.settle(opt_state)
                        self._ckptr.wait()
                        ckpt.save(self.ckpt_dir, step + 1,
                                  {'params': params, 'opt_state': opt_state},
                                  meta(step + 1, preempted=True))
                    dist.barrier()
                    break
        finally:
            self._ckptr.wait()
            self._watchdog.recorder = None
            recorder.close()
        # every rank returns after rank 0's checkpoints are on disk
        dist.barrier()
        opt_state = pipemod.settle(opt_state)
        return params, opt_state, history
