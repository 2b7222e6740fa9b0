"""The port's run report (``repro_torch.obs.report``) and its schemas
against the reference's (``repro.obs.report``, ``repro.obs.events``).

* Both validators refuse the same mistyped sharded-factor site (two errors:
  ``solve_iters`` a string, ``factor_shard_bytes`` a float) and accept it
  well typed; both validate a ``bench`` row.
* On the checked-in fixtures both reports' ``breakdown`` give equal dicts
  (floats to 1e-12 relative), their diffs the same worst gated regression,
  and ``main`` the reference's exit codes (``tests/test_obs.py``'s cases).
* A short profiled ``Trainer.fit`` of the port (``log_every=1``) writes a
  ``metrics.jsonl`` that both validators pass and both breakdowns read
  alike.
"""
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip('torch')

from repro.obs import events as jevents  # noqa: E402
from repro.obs import report as jreport  # noqa: E402
from repro_torch.core.factor_sharded import FactorShardConfig  # noqa: E402
from repro_torch.core.registry import make_optimizer  # noqa: E402
from repro_torch.data.synthetic import ClassStream  # noqa: E402
from repro_torch.models import module as M  # noqa: E402
from repro_torch.models.simple import MLP, classifier_loss_fn  # noqa: E402
from repro_torch.obs import events, report  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DATA = Path(__file__).parent / 'data'
FIX_A = str(DATA / 'obs_fixture_a.jsonl')
FIX_B = str(DATA / 'obs_fixture_b.jsonl')
REL = 1e-12

SITE = {'traces': 1, 'bytes_per_call': 4096, 'codec': 'f32', 'mode': 'psum',
        'solve_iters': 32, 'factor_shard_bytes': 262144}
BENCH = {'event': 'bench', 'v': 1, 'name': 'table5/eva', 'us_per_call': 12.5,
         'derived': 'x=1', 'fields': {'x': '1'}}


def _close(a, b, where='bd'):
    """Equal trees: the same keys, sequences and strings; floats within
    ``REL`` relative."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), where
        for k in a:
            _close(a[k], b[k], f'{where}.{k}')
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f'{where}[{i}]')
    elif isinstance(a, float) or isinstance(b, float):
        assert math.isclose(a, b, rel_tol=REL, abs_tol=0.0), (where, a, b)
    else:
        assert a == b and type(a) is type(b), (where, a, b)


def _site_record(**site):
    return {'event': 'comm_exchange', 'v': 1,
            'sites': {'factor/kfac': {**SITE, **site}}}


def test_mistyped_factor_site_fails_both_validators():
    bad = _site_record(solve_iters='32', factor_shard_bytes=1.5)
    errs = events.validate_record(bad)
    ref_errs = jevents.validate_record(bad)
    assert len(errs) == len(ref_errs) == 2
    assert any('solve_iters' in e for e in errs)
    assert any('factor_shard_bytes' in e for e in errs)
    assert errs == ref_errs
    good = _site_record()
    assert events.validate_record(good) == jevents.validate_record(good) == []


def test_bench_rows_validate_in_both():
    assert events.validate_record(BENCH) == []
    assert jevents.validate_record(BENCH) == []
    for key in ('name', 'us_per_call'):
        rec = {k: v for k, v in BENCH.items() if k != key}
        assert events.validate_record(rec) == jevents.validate_record(rec)
        assert len(events.validate_record(rec)) == 1
    typo = {**BENCH, 'us_per_call': '12.5'}
    assert events.validate_record(typo) == jevents.validate_record(typo)
    assert events.validate_record(typo)


# the step record's kernel-choice fields come with the dispatch layer
# (ROADMAP item 13d)
WAITING_13D = {'kernel_impl', 'kernel_tiles'}


def test_schemas_name_the_reference_fields():
    """Every record type and site field of the reference is the port's,
    with the same types and requiredness, but the step record's two
    kernel-choice fields."""
    assert set(events.SCHEMAS) == set(jevents.SCHEMAS)
    assert WAITING_13D <= set(jevents.SCHEMAS['step'])
    for ev, fields in jevents.SCHEMAS.items():
        fields = {k: f for k, f in fields.items()
                  if ev != 'step' or k not in WAITING_13D}
        assert set(events.SCHEMAS[ev]) == set(fields), ev
        for name, fld in fields.items():
            mine = events.SCHEMAS[ev][name]
            assert (mine.types, mine.required) == (fld.types,
                                                   fld.required), (ev, name)
    assert {k: (f.types, f.required) for k, f in
            events._SITE_FIELDS.items()} == {
        k: (f.types, f.required) for k, f in jevents._SITE_FIELDS.items()}


@pytest.mark.parametrize('path', [FIX_A, FIX_B], ids=['a', 'b'])
def test_breakdown_equals_reference_on_fixtures(path):
    bd = report.breakdown(report.load_records(path))
    ref = jreport.breakdown(jreport.load_records(path))
    _close(bd, ref)
    assert bd['n_step_records'] > 0


def test_diff_and_render_like_reference():
    bd_a = report.breakdown(report.load_records(FIX_A))
    bd_b = report.breakdown(report.load_records(FIX_B))
    text, worst = report.diff(bd_a, bd_b)
    _, ref_worst = jreport.diff(jreport.breakdown(jreport.load_records(FIX_A)),
                                jreport.breakdown(jreport.load_records(FIX_B)))
    assert worst == pytest.approx(15.0) and worst == ref_worst
    assert '[gate]' in text and '+15.0%' in text
    out = report.render(bd_a, 'A')
    for piece in ('mean step time: 20.00 ms', 'stats/kfac', 'refresh/kfac',
                  'ici 1.50 MiB / dcn 0.50 MiB', 'refresh ownership (world=4',
                  'GFLOP'):
        assert piece in out


def _bench_file(path, us):
    rows = [{'event': 'bench', 'v': events.SCHEMA_VERSION, 'name': 'cell/x',
             'us_per_call': us, 'derived': 'n=1'}]
    Path(path).write_text(json.dumps(rows))


def _corrupt_file(path):
    Path(path).write_text('{"event": "step", "loss": 1.0}\n'
                          'not json at all\n'
                          '{"event": "wat", "x": 1}\n')


EXIT_CASES = {
    'validate_fixtures': ([FIX_A, FIX_B, '--validate'], 0),
    'diff_under_gate': ([FIX_A, FIX_B, '--diff', '--max-regress', '20'], 0),
    'diff_over_gate': ([FIX_A, FIX_B, '--diff', '--max-regress', '10'], 2),
    'corrupt': ([':bad', '--validate'], 1),
    'bench_validate': ([':a', ':b', '--validate'], 0),
    'bench_under_gate': ([':a', ':b', '--diff', '--max-regress', '50'], 0),
    'bench_over_gate': ([':a', ':b', '--diff', '--max-regress', '25'], 2),
    'breakdown': ([FIX_A], 0),
}


@pytest.mark.parametrize('case', list(EXIT_CASES))
def test_main_exit_codes_match_reference(case, tmp_path, capsys):
    argv, want = EXIT_CASES[case]
    _bench_file(tmp_path / 'a.json', 100.0)
    _bench_file(tmp_path / 'b.json', 140.0)
    _corrupt_file(tmp_path / 'bad.jsonl')
    files = {':a': 'a.json', ':b': 'b.json', ':bad': 'bad.jsonl'}
    argv = [str(tmp_path / files[a]) if a in files else a for a in argv]
    assert report.main(argv) == want
    out = capsys.readouterr().out
    assert jreport.main(argv) == want
    ref_out = capsys.readouterr().out
    if case == 'corrupt':
        assert '3 schema error' in out and '3 schema error' in ref_out


def test_script_validates_and_breaks_down():
    env = {'PYTHONPATH': str(ROOT / 'src')}
    script = str(ROOT / 'scripts' / 'obs_report_torch.py')
    ok = subprocess.run([sys.executable, script, '--validate', FIX_A],
                        capture_output=True, text=True, env=env, timeout=120)
    assert ok.returncode == 0, ok.stderr
    assert 'records OK' in ok.stdout
    gate = subprocess.run([sys.executable, script, FIX_A, FIX_B,
                           '--max-regress', '10'], capture_output=True,
                          text=True, env=env, timeout=120)
    assert gate.returncode == 2, gate.stderr
    assert 'REGRESSION' in gate.stdout and '== diff' in gate.stdout


def _fit(out_dir, name, factor=None):
    stream = ClassStream(batch=16, dim=8, classes=4, spread=1.5, seed=0,
                         device='cpu')
    model = MLP([8, 16, 4])
    model.loss_fn = classifier_loss_fn(model)
    params = M.init_params(model.param_specs(),
                           torch.Generator().manual_seed(0), device='cpu')
    opt, capture = make_optimizer(name, lr=0.05)
    cfg = TrainerConfig(total_steps=4, log_every=1, ckpt_every=0,
                        out_dir=str(out_dir), profile=True)
    Trainer(model, opt, capture, cfg, factor=factor,
            device='cpu').fit(params, stream)
    return str(out_dir / 'metrics.jsonl')


@pytest.mark.parametrize('name', ['eva', 'kfac_shard'])
def test_port_run_reads_alike_in_both_reports(name, tmp_path):
    factor = FactorShardConfig(head_policy='shard', shard_threshold=16,
                               solve_iters=8) if name == 'kfac_shard' else None
    path = _fit(tmp_path / 'run', name.split('_')[0], factor)
    recs = report.load_records(path)
    ref_recs = jreport.load_records(path)
    assert report.validate_records(recs) == []
    assert jreport.validate_records(ref_recs) == []
    bd = report.breakdown(recs)
    _close(bd, jreport.breakdown(ref_recs))
    assert bd['n_step_records'] == 4
    assert {'data', 'grad', 'precondition', 'apply', 'step'} <= set(
        bd['phases'])
    assert 'fns' not in bd['profile']
    sites = bd['exchange']['sites']
    if name == 'kfac_shard':
        fac = sites['factor/kfac']
        assert isinstance(fac['solve_iters'], int) and fac['solve_iters'] == 8
        assert isinstance(fac['factor_shard_bytes'], int)
    else:
        assert 'stats/eva' in sites
    text = report.render(bd, 'port')
    assert 'mean step time' in text and 'profile @ step 3' in text
