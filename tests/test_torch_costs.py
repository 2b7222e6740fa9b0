"""The port's cost trace (``repro_torch.launch.hlo_analysis``) and the
profile record's cost summaries (``obs/spans.py``), on the CPU.

* A hand-written MLP step (forward, backward by explicit products, two
  gradient all-reduces over a four-rank ``'fake'`` group, the update):
  dot FLOPs, HBM traffic and collective bytes equal the hand count
  exactly.
* Ring bytes of an all-reduce, an all-gather and a reduce-scatter at
  g = 4 follow the reference's ``_collective_bytes`` exactly.
* The same reduced qwen2 prefill traced by the port and compiled by the
  reference (``hlo_analysis.analyze`` of its HLO text): dot FLOPs within
  1% (measured: equal, 12,042,240).  Its Eva train step: the port counts
  0.21% fewer (41,604,640 against 41,692,704; held to 0-0.5%): XLA lowers
  eight whole-leaf inner products of the update (the KL trust region's)
  to ``dot`` ops of one output element, 88,064 FLOPs, which the port
  computes as products and sums; every matrix product agrees.
* K-FAC's worker-sharded refresh on the reference's toy at W = 4: in
  'sync' more than half the dot FLOPs depend on a collective issued in the
  step, in 'onestep' none (the reference's ``tests/test_pipeline.py``
  check), with the blocking collectives counted.
* A profiled ``Trainer.fit`` writes ``fns`` (three phases, six fields) on
  its first ``profile`` record; both validators pass it and both reports
  render its cost lines alike.
* ``live_buffer_mb`` rises by 4 MiB (to the 1e-3 MiB rounding) around a
  4 MiB tensor.
* A fake CUDA tensor reaching each kernel wrapper records one custom call
  (operand plus output bytes) and launches nothing.
"""
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip('torch')

import numpy as np  # noqa: E402

from repro_torch.launch import hlo_analysis as H  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).parent))


@pytest.fixture
def fake_group():
    """A four-rank 'fake' default group for the test (collectives move
    nothing), gone after it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():          # a group an earlier file left
        dist.destroy_process_group()
    dist.init_process_group('fake', store=FakeStore(), rank=0, world_size=4)
    try:
        yield dist
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The hand-counted step

B, D, HID, O = 6, 5, 7, 3
F32 = 4


def _mlp_step(x, t, w1, w2):
    import torch.distributed as dist
    h = x @ w1
    a = torch.relu(h)
    y = a @ w2
    g_y = y - t
    g_w2 = a.t() @ g_y
    g_a = g_y @ w2.t()
    g_h = g_a * (h > 0)
    g_w1 = x.t() @ g_h
    dist.all_reduce(g_w1)
    dist.all_reduce(g_w2)
    return torch.sub(w1, g_w1, alpha=0.1), torch.sub(w2, g_w2, alpha=0.1)


def test_hand_counted_mlp_step(fake_group):
    rng = np.random.default_rng(0)
    args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((B, D), (B, O), (D, HID), (HID, O))]
    costs = H.analyze(_mlp_step, *args)
    flops = 2 * (B * HID * D + B * O * HID + HID * O * B + B * HID * O
                 + D * HID * B)
    bh, bo, dh, ho, bd = B * HID, B * O, D * HID, HID * O, B * D
    traffic = F32 * (
        (bd + dh + bh)             # h = x @ w1
        + 2 * bh                   # relu
        + (bh + ho + bo)           # y = a @ w2
        + 3 * bo                   # y - t
        + (bh + bo + ho)           # a.t() @ g_y (the transpose is a view)
        + (bo + ho + bh)           # g_y @ w2.t()
        + bh                       # h > 0 reads h ...
        + 2 * bh                   # ... g_a * mask reads g_a, writes g_h
        + (bd + bh + dh)           # x.t() @ g_h
        + 2 * dh + 2 * ho          # the in-place all-reduces: read, write
        + 3 * dh + 3 * ho)         # the two updates
    traffic += 2 * bh              # the bool mask: written, read (1 B)
    coll = 2.0 * F32 * (dh + ho) * 3 / 4
    assert costs.flops == flops
    assert costs.traffic_bytes == traffic
    assert costs.collective_bytes == coll
    assert costs.collective_count == 2
    assert costs.collective_by_op == {'all-reduce': coll}
    assert costs.dot_flops_by_op == {'aten::mm': flops}
    assert costs.library_flops == flops     # torch.utils.flop_counter
    # the overlap: both gradient all-reduces feed no dot of the step
    rep = H.collective_overlap(_mlp_step, *args)
    assert (rep.collective_count, rep.blocking_collectives) == (2, 0)
    assert rep.total_dots == 5 and rep.dependent_fraction == 0.0


@pytest.mark.parametrize('kind', ['all-reduce', 'all-gather',
                                  'reduce-scatter'])
def test_ring_bytes_at_g4(fake_group, kind):
    import torch.distributed._functional_collectives as fc
    group = fake_group.group.WORLD
    x = torch.zeros(8, 16)
    size = x.numel() * F32

    def fn(x):
        if kind == 'all-reduce':
            return fc.all_reduce(x, 'sum', group)
        if kind == 'all-gather':
            return fc.all_gather_tensor(x, 0, group)
        return fc.reduce_scatter_tensor(x, 'sum', 0, group)
    costs = H.analyze(fn, x)
    want = {'all-reduce': 2.0 * size * 3 / 4,       # 2·size·(g−1)/g
            'all-gather': 4 * size * 3 / 4,         # gathered output
            'reduce-scatter': size / 4 * 3}[kind]   # the shard·(g−1)
    assert costs.collective_by_op == {kind: want}
    assert costs.collective_count == 1


# ---------------------------------------------------------------------------
# Against the reference's HLO analysis

_REF_SCRIPT = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_reduced
    from repro.core.registry import make_optimizer
    from repro.launch import hlo_analysis
    from repro.models import build_model
    from repro.models import module as M
    from repro.train.step import init_opt_state, make_train_step
    cfg = get_reduced('qwen2-0.5b')
    model = build_model(cfg)
    params = M.init_params(model.param_specs(), jax.random.PRNGKey(0))
    toks = jnp.asarray(np.arange(2 * 16).reshape(2, 16) % cfg.vocab,
                       jnp.int32)
    pre = jax.jit(model.prefill_fn).lower(params, {'tokens': toks})
    opt, cap = make_optimizer('eva', lr=0.01)
    batch = {'tokens': toks, 'labels': toks}
    state = init_opt_state(model, opt, cap, params, batch)
    step = jax.jit(make_train_step(model, opt, cap)).lower(params, state,
                                                           batch)
    print(json.dumps({
        'prefill': hlo_analysis.analyze(pre.compile().as_text()).flops,
        'train': hlo_analysis.analyze(step.compile().as_text()).flops}))
""")


def test_flops_against_the_reference_hlo_analysis():
    import json

    from repro_torch.configs import get_reduced
    from repro_torch.core.registry import make_optimizer
    from repro_torch.models import build_model
    from repro_torch.models import module as M
    from repro_torch.train.step import init_opt_state, make_train_step
    out = subprocess.run([sys.executable, '-c', _REF_SCRIPT],
                         capture_output=True, text=True, timeout=600,
                         cwd=ROOT, env={**os.environ, 'PYTHONPATH': 'src',
                                        'JAX_PLATFORMS': 'cpu'})
    assert out.returncode == 0, out.stderr[-3000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    cfg = get_reduced('qwen2-0.5b')
    model = build_model(cfg)
    params = M.abstract_params(model.param_specs())
    toks = torch.empty(2, 16, dtype=torch.int32, device='meta')
    pre = H.analyze(model.prefill_fn, params, {'tokens': toks})
    assert abs(pre.flops - ref['prefill']) <= 0.01 * ref['prefill']
    opt, cap = make_optimizer('eva', lr=0.01)
    batch = {'tokens': torch.zeros(2, 16, dtype=torch.int32),
             'labels': torch.zeros(2, 16, dtype=torch.int32)}
    real = M.init_params(model.param_specs(),
                         torch.Generator().manual_seed(0), device='cpu')
    state = init_opt_state(model, opt, cap, real, batch, device='cpu')
    step = make_train_step(model, opt, cap, device='cpu')
    train = H.analyze(step, real, state, batch)
    gap = ref['train'] - train.flops
    assert 0 <= gap <= 0.005 * ref['train']


# ---------------------------------------------------------------------------
# Overlap: the reference's pipeline check on its toy, at W = 4


@pytest.mark.parametrize('mode', ['sync', 'onestep'])
def test_dependent_fraction_by_pipeline_mode(fake_group, mode):
    import torch_dist_cases as C

    from repro_torch.comm import group as group_mod
    from repro_torch.core.kfac import kfac_preconditioner
    from repro_torch.core.transform import Extras
    from repro_torch.schedule.policy import every_k
    from repro_torch.schedule.runtime import RefreshRuntime
    opt = kfac_preconditioner(0.03, 0.9, policy=every_k(2))
    grads, stats = C._t_grads(0), C._t_stats(0)
    rt = RefreshRuntime(pipeline=mode, shard_refresh=True)
    with group_mod.in_scope(group_mod.scope_of(None)):
        state = opt.init(grads, Extras(stats=stats, sched=rt))

        def body(g, s, st):
            return opt.update(g, s, extras=Extras(stats=st, sched=rt))
        rep = H.collective_overlap(body, grads, state, stats)
    assert rep.collective_count > 0 and rep.total_dots > 0
    if mode == 'sync':
        assert rep.dependent_fraction > 0.5
        assert rep.blocking_collectives > 0
    else:
        assert rep.dependent_fraction == 0.0
        assert rep.dependent_dots == 0 and rep.blocking_collectives == 0


# ---------------------------------------------------------------------------
# The profile record, the samplers, the kernels


def test_profile_fns_validate_and_render_in_both(tmp_path):
    from repro.obs import report as jreport
    from repro_torch.core.registry import make_optimizer
    from repro_torch.data.synthetic import ClassStream
    from repro_torch.models import module as M
    from repro_torch.models.simple import MLP, classifier_loss_fn
    from repro_torch.obs import report
    from repro_torch.train import Trainer, TrainerConfig
    model = MLP((16, 32, 4))
    model.loss_fn = classifier_loss_fn(model)
    params = M.init_params(model.param_specs(),
                           torch.Generator().manual_seed(0), device='cpu')
    opt, capture = make_optimizer('eva', lr=0.03, fused=True)
    cfg = TrainerConfig(total_steps=3, log_every=1, out_dir=str(tmp_path),
                        profile=True)
    stream = ClassStream(batch=8, dim=16, classes=4, seed=0, device='cpu')
    Trainer(model, opt, capture, cfg, device='cpu').fit(params, stream)
    path = str(tmp_path / 'metrics.jsonl')
    recs, jrecs = report.load_records(path), jreport.load_records(path)
    assert report.validate_records(recs) == []
    assert jreport.validate_records(jrecs) == []
    prof = [r for r in recs if r['event'] == 'profile']
    assert len(prof) == 3 and 'fns' in prof[0]
    assert not any('fns' in r for r in prof[1:])
    assert all(r['live_buffer_mb'] > 0 for r in prof)
    fields = {'flops', 'traffic_bytes', 'collective_bytes',
              'collective_count', 'blocking_collectives',
              'dependent_dot_flop_frac'}
    fns = prof[0]['fns']
    assert set(fns) == {'grad', 'precondition', 'apply'}
    assert all(set(v) == fields for v in fns.values())
    assert fns['grad']['flops'] > 0 and fns['apply']['flops'] == 0
    bd, jbd = report.breakdown(recs), jreport.breakdown(jrecs)
    assert bd['profile'] == jbd['profile']
    text, jtext = report.render(bd, 'run'), jreport.render(jbd, 'run')
    lines = [ln for ln in text.splitlines() if 'GFLOP' in ln]
    assert len(lines) == 3
    assert lines == [ln for ln in jtext.splitlines() if 'GFLOP' in ln]


def test_live_buffer_mb_sees_a_4mib_tensor():
    import gc

    from repro_torch.obs import spans
    gc.collect()
    before = spans.live_buffer_mb()
    x = torch.ones(1024, 1024)         # 4 MiB of f32
    during = spans.live_buffer_mb()
    del x
    gc.collect()
    after = spans.live_buffer_mb()
    assert math.isclose(during - before, 4.0, abs_tol=2e-3)
    assert math.isclose(during - after, 4.0, abs_tol=2e-3)


def _kernel_cases():
    """(name, wrapper, the maker of its args, plain twin) of each kernel
    wrapper, stacked and unstacked forms."""
    from repro_torch.kernels import bilinear, fused, matvec, rank1_update
    from repro_torch.kernels import ref
    L, m, n, R = 3, 12, 10, 4

    def v(*s, dt=torch.float32):
        return torch.empty(s, dtype=dt, device='cuda')
    return [
        ('bilinear', bilinear.bilinear_and_norms_stacked,
         lambda: (v(L, m, n), v(L, m), v(L, n)), ref.bilinear_and_norms_ref),
        ('bilinear', bilinear.bilinear_and_norms,
         lambda: (v(m, n), v(m), v(n)), ref.bilinear_and_norms_ref),
        ('rank1_update', rank1_update.rank1_update_stacked,
         lambda: (v(L, m, n, dt=torch.bfloat16), v(L, m), v(L, n), v(L, 2)),
         lambda g, a, b, c: ref.rank1_update_ref(g, a, b, c.select(-1, 0),
                                                 c.select(-1, 1))),
        ('rank1_update', rank1_update.rank1_update,
         lambda: (v(m, n), v(m), v(n), v(), v()),
         ref.rank1_update_ref),
        ('eva_fused', lambda g, a, b, mm: fused.eva_fused_stacked(
            g, a, b, 0.03, mm, 0.9),
         lambda: (v(L, m, n), v(L, m), v(L, n), v(L, m, n)),
         lambda g, a, b, mm: ref.eva_fused_ref(g, a, b, 0.03, mm, 0.9)),
        ('matvec', matvec.matvec_and_norm_stacked,
         lambda: (v(L, m, n), v(L, m)), ref.matvec_and_norm_ref),
        ('matvec', matvec.matvec_and_norm,
         lambda: (v(m, n), v(m)), ref.matvec_and_norm_ref),
        ('eva_f_fused', lambda g, a, mm: fused.eva_f_fused_stacked(
            g, a, 0.03, mm, 0.9),
         lambda: (v(L, m, n), v(L, m), v(L, m, n)),
         lambda g, a, mm: ref.eva_f_fused_ref(g, a, 0.03, mm, 0.9)),
        ('matvec_cols', matvec.matvec_cols_stacked,
         lambda: (v(L, m, n), v(L, R, m)), ref.matvec_cols_ref),
        ('matvec_cols', matvec.matvec_cols,
         lambda: (v(m, n), v(R, m)), ref.matvec_cols_ref),
    ]


@pytest.mark.parametrize('case', range(10))
def test_fake_tensor_at_a_kernel_is_one_custom_call(case):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import launches
    name, wrapper, build, plain = _kernel_cases()[case]
    with FakeTensorMode():
        args = build()
        want = plain(*args)
    before = launches.snapshot()
    record, out = H.trace(wrapper, *args)
    assert launches.snapshot() == before         # nothing launched
    outs = H._tensors(out)
    wants = H._tensors(want)
    assert [(t.shape, t.dtype, t.device.type) for t in outs] == \
        [(t.shape, t.dtype, t.device.type) for t in wants]
    nbytes = H.shape_bytes(H._unique(H._tensors(args))) + \
        H.shape_bytes(H._unique(outs))
    assert record.costs.custom_calls == {name: {'count': 1,
                                                'bytes': nbytes}}
    assert record.costs.flops == 0 and not record.dots
    assert record.costs.traffic_bytes == nbytes
    from repro_torch.kernels import launch
    assert launch.tracers == []                  # the trace unregistered


def test_span_fence_synchronizes_the_fence_devices():
    """A span's fence synchronizes each CUDA device its tensors lie on (a
    rank computing on cuda:1 waits for cuda:1), not the current device;
    a fence of CPU tensors synchronizes nothing.  Fake CUDA tensors stand
    in for the cards, a stub for ``torch.cuda.synchronize``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.obs import spans
    with FakeTensorMode():
        on1 = torch.empty(3, device='cuda:1')
        on0 = torch.empty(2, device='cuda:0')
    synced = []
    fence = {'loss': on1, 'grads': (on1, [on0, torch.zeros(2)])}
    got = spans.fence_devices(fence, synchronize=synced.append)
    assert synced == got == [torch.device('cuda', 0),
                             torch.device('cuda', 1)]
    synced.clear()
    assert spans.fence_devices((torch.zeros(2),),
                               synchronize=synced.append) == []
    assert synced == []
    # the tracker fences through fence_devices, on the span's own tensors
    calls = []
    tracker = spans.SpanTracker()
    orig = spans.fence_devices
    try:
        spans.fence_devices = lambda f: calls.append(
            orig(f, synchronize=lambda d: None))
        with tracker.span('grad') as sp:
            sp.fence({'x': on1})
        with tracker.span('apply'):
            pass
    finally:
        spans.fence_devices = orig
    assert calls == [[torch.device('cuda', 1)]]
    assert [r['name'] for r in tracker.records] == ['grad', 'apply']
