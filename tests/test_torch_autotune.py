"""The port's autotuner (``repro_torch/kernels/autotune.py``) and its CLI
(``scripts/autotune_torch.py``) on the CPU, against the reference's
determinism cases of ``tests/test_dispatch.py``.

Every measurement comes from an injected bench, so no candidate runs:
a candidate builds its operands at its first call, and the kernels'
``'cuda'`` candidates are listed, timed by the fake and installed without a
card.  The output bytes are the same for the same measurements, and
``dumps`` of one dict gives the reference's bytes.  The shipped
``tile_defaults.json`` parses, and no entry of it names anything but a
kernel's own plan, so by default each kernel runs the configuration the
chip check times.  ``--update-defaults`` tunes ``'cuda'`` alone.  A fixture
resets both packages' dispatch state.
"""
import importlib.util
import json
from pathlib import Path

import pytest

torch = pytest.importorskip('torch')

from repro.kernels import autotune as jautotune  # noqa: E402
from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro_torch.kernels import autotune, dispatch, launches  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
F32 = torch.float32
SHAPES = [(64, 48), (200, 136)]


def _reset():
    for mod in (dispatch, jdispatch):
        mod.reset_cache()
        mod.set_default_impl('auto')
    jdispatch._choices.clear()


@pytest.fixture(autouse=True)
def _clean_dispatch_state():
    _reset()
    yield
    _reset()


def _fake_bench():
    """Strictly increasing times: the first candidate wins everywhere."""
    calls = {'n': 0}

    def bench(fn):
        del fn
        calls['n'] += 1
        return float(calls['n'])
    return bench


def test_autotune_deterministic_bytes():
    s1 = autotune.dumps(autotune.tune(SHAPES, bench=_fake_bench(),
                                      device='cpu'))
    s2 = autotune.dumps(autotune.tune(SHAPES, bench=_fake_bench(),
                                      device='cpu'))
    assert s1 == s2
    data = json.loads(s1)
    assert data['version'] == 1 and data['backend'] == 'cpu'
    assert len(data['entries']) == len(SHAPES) * len(autotune.OPS)
    assert autotune.OPS == jautotune.OPS
    assert autotune.FUSED_OPS == jautotune.FUSED_OPS


def test_autotune_first_candidate_wins_fixed_order():
    """'torch' is the first candidate, so it wins every strictly increasing
    sweep, the kernels' configurations among the candidates or not."""
    ops = autotune.OPS + autotune.FUSED_OPS
    for impls in (None, ('torch', 'cuda'), ('cuda', 'torch')):
        cache = autotune.tune([(64, 48)], ops=ops, impls=impls,
                              bench=_fake_bench(), device='cpu')
        assert all((e['impl'], e['block_in'], e['block_out']) ==
                   ('torch', 0, 0) for e in cache['entries'].values())


def test_cuda_candidates_listed_in_the_kernels_order():
    """Over the kernels alone, with a bench that never calls the candidate,
    each op's configurations come in ``dispatch.configurations`` order:
    times that fall make the last one win, times that rise the first; ties
    go to the smaller blocks.  Nothing is built or launched."""
    ops = autotune.OPS + autotune.FUSED_OPS
    for d_in, d_out in SHAPES:
        for op in ops:
            assert autotune._candidates(op, d_in, d_out, ('cuda',)) == [
                ('cuda', bi, bo)
                for bi, bo in dispatch.configurations(op, d_in, d_out)]
            assert autotune._candidates(op, d_in, d_out, ('torch', 'cuda')
                                        )[0] == ('torch', 0, 0)
    seen = []

    def falling(fn):
        seen.append(fn)
        return 1000.0 - len(seen)
    launches.reset()
    cache = autotune.tune(SHAPES, ops=ops, impls=('cuda',), bench=falling,
                          device='cpu')
    assert not any(launches.snapshot().values())
    assert len(seen) == sum(len(dispatch.configurations(op, *s))
                            for s in SHAPES for op in ops)
    for (d_in, d_out) in SHAPES:
        for op in ops:
            e = cache['entries'][dispatch.cache_key(op, d_in, d_out, F32,
                                                    'cpu')]
            last = dispatch.configurations(op, d_in, d_out)[-1]
            assert (e['impl'], e['block_in'], e['block_out']) == \
                ('cuda',) + last
    tied = autotune.tune([(64, 48)], ops=('matvec',), impls=('cuda',),
                         bench=lambda fn: 5.0, device='cpu')
    (e,) = tied['entries'].values()
    assert (e['block_in'], e['block_out']) == (128, 16)


def test_autotune_winner_installs_and_resolves(tmp_path):
    """A 'cuda' winner (the third warps of matvec) installs and resolves to
    its configuration on the card; a 'torch' winner sends 'auto' there."""
    third = iter(range(100))
    cache = autotune.tune(
        [(64, 48)], ops=('matvec', 'bilinear'), impls=('torch', 'cuda'),
        bench=lambda fn: 0.5 if next(third) == 3 else 9.0,
        backend_name='cuda', device='cpu')
    entries = cache['entries']
    assert entries['cuda/matvec/float32/64x48'] == {
        'impl': 'cuda', 'block_in': 384, 'block_out': 16, 'us': 0.5}
    assert entries['cuda/bilinear/float32/64x48']['impl'] == 'torch'
    path = autotune.write(cache, tmp_path / 'win.json')
    assert dispatch.install_cache(path) >= 2
    assert dispatch.resolve('matvec', 64, 48, F32, 'auto', 'cuda') == \
        dispatch.Choice('cuda', 384, 16)
    assert dispatch.resolve('bilinear', 64, 48, F32, 'auto', 'cuda') == \
        dispatch.Choice('torch', 0, 0)
    # a 'cuda' winner under the CPU's key cannot run there
    cpu = autotune.tune([(64, 48)], ops=('matvec',), impls=('cuda',),
                        bench=lambda fn: 1.0, device='cpu')
    dispatch.install_cache(cpu)
    with pytest.raises(ValueError, match='CUDA tensors'):
        dispatch.resolve('matvec', 64, 48, F32, 'auto', 'cpu')


def test_candidates_build_operands_at_first_call():
    """A plain candidate on the CPU runs when the bench calls it: the
    default bench's median of host µs."""
    calls = []

    def bench(fn):
        out = autotune.default_bench(fn, reps=3, warmup=1)
        calls.append(out)
        return out
    cache = autotune.tune([(16, 8)], ops=autotune.OPS + autotune.FUSED_OPS,
                          bench=bench, device='cpu')
    assert len(calls) == 5 and all(us > 0 for us in calls)
    assert all(e['impl'] == 'torch' for e in cache['entries'].values())
    n = []
    assert autotune.default_bench(lambda: n.append(1), reps=5,
                                  warmup=2) >= 0 and len(n) == 7
    with pytest.raises(ValueError, match='the tuner picks'):
        autotune.tune([(16, 8)], impls=('xla',), bench=bench, device='cpu')


def test_autotune_merge_new_wins_and_dumps_match_the_reference():
    base = {'version': 1, 'entries': {'k1': {'impl': 'torch'},
                                      'k2': {'impl': 'torch'}}}
    new = {'version': 1, 'backend': 'cuda',
           'entries': {'k2': {'impl': 'cuda'}}}
    merged = autotune.merge(base, new)
    assert merged['entries']['k1']['impl'] == 'torch'
    assert merged['entries']['k2']['impl'] == 'cuda'
    assert merged == jautotune.merge(base, new)
    cache = autotune.tune(SHAPES, bench=_fake_bench(), device='cpu')
    assert autotune.dumps(cache) == jautotune.dumps(cache)
    assert autotune.dumps(merged) == jautotune.dumps(merged)


def test_tile_defaults_parse_and_name_only_cuda():
    """The shipped file is the tuner's format, and an entry, if any, names
    'cuda' at the kernel's own plan: the configuration the kernel runs with
    no entry, which the chip check times."""
    data = json.loads(dispatch._DEFAULTS_FILE.read_text())
    assert data['version'] == 1 and data['backend'] == 'cuda'
    assert isinstance(data['entries'], dict)
    for key, e in data['entries'].items():
        assert key.startswith('cuda/') and e['impl'] == 'cuda', key
        _, op, _, shape = key.split('/')
        d_in, d_out = map(int, shape.split('x'))
        assert (e['block_in'], e['block_out']) == \
            dispatch._default_blocks(op, d_in, d_out), key
    assert autotune.dumps(data) == dispatch._DEFAULTS_FILE.read_text()
    assert dispatch._shipped_defaults() == data['entries']


def _script():
    spec = importlib.util.spec_from_file_location(
        'autotune_torch_script', ROOT / 'scripts' / 'autotune_torch.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_script_writes_a_cache_that_installs(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(autotune, 'default_bench',
                        lambda fn, reps=3, warmup=1: 7.0)
    shipped = dispatch._DEFAULTS_FILE.read_text()
    defaults = tmp_path / 'tile_defaults.json'
    defaults.write_text(json.dumps({'version': 1, 'backend': 'cuda',
                                    'entries': {'cuda/x/float32/1x1': {
                                        'impl': 'cuda'}}}))
    monkeypatch.setattr(dispatch, '_DEFAULTS_FILE', defaults)
    out = tmp_path / 'cache.json'
    script = _script()
    assert script.main(['--shapes', '64x48', '--out', str(out),
                        '--device', 'cpu']) == 0
    data = json.loads(out.read_text())
    assert capsys.readouterr().out == autotune.dumps(data)
    assert sorted(data['entries']) == sorted(
        f'cpu/{op}/float32/64x48' for op in autotune.OPS)
    assert all(e['impl'] == 'torch' and e['us'] == 7.0
               for e in data['entries'].values())
    assert dispatch.install_cache(out) == 4
    assert dispatch.resolve('rank1_update', 64, 48, F32, 'auto', 'cpu') == \
        dispatch.Choice('torch', 0, 0)
    assert script.main(['--shapes', '64x48', '--ops', 'matvec',
                        '--impls', 'cuda', '--update-defaults',
                        '--device', 'cpu']) == 0
    merged = json.loads(defaults.read_text())
    assert set(merged['entries']) == {'cuda/x/float32/1x1',
                                      'cpu/matvec/float32/64x48'}
    assert merged['entries']['cpu/matvec/float32/64x48']['impl'] == 'cuda'
    assert (ROOT / 'src' / 'repro_torch' / 'kernels' /
            'tile_defaults.json').read_text() == shipped
    assert script.parse_shapes('768x2048,2048X768') == [(768, 2048),
                                                         (2048, 768)]


@pytest.mark.parametrize('impls', [None, 'torch', 'torch,cuda'])
def test_script_update_defaults_tunes_cuda_only(tmp_path, monkeypatch,
                                                impls):
    """--update-defaults never writes a 'torch' winner into the shipped
    file: without --impls it tunes 'cuda' alone, and any --impls naming
    'torch' is refused before anything is tuned or written."""
    monkeypatch.setattr(autotune, 'default_bench',
                        lambda fn, reps=3, warmup=1: 7.0)
    defaults = tmp_path / 'tile_defaults.json'
    defaults.write_text(autotune.dumps({'version': 1, 'backend': 'cuda',
                                        'entries': {}}))
    monkeypatch.setattr(dispatch, '_DEFAULTS_FILE', defaults)
    script = _script()
    argv = ['--shapes', '64x48', '--ops', 'rank1_update', '--device', 'cpu',
            '--update-defaults'] + ([] if impls is None else
                                    ['--impls', impls])
    if impls is not None:
        with pytest.raises(SystemExit):
            script.main(argv)
        assert json.loads(defaults.read_text())['entries'] == {}
        return
    assert script.main(argv) == 0
    entries = json.loads(defaults.read_text())['entries']
    assert entries == {'cpu/rank1_update/float32/64x48': {
        'impl': 'cuda', 'block_in': 1, 'block_out': 256, 'us': 7.0}}
