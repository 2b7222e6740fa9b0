"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix, limit and metric resolves to its file by name, and the
manifest keeps the shape of the benchmark's contract."""
import json
import re

import pytest

from portbench_cpu import CELLS, ROOT

MAN = json.loads((ROOT / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def test_top_level_keys():
    assert set(MAN) == {'command', 'paths', 'run_seconds', 'configs',
                        'workloads', 'end_to_end', 'per_layer'}
    assert MAN['command'] == ['python3', 'portbench/run.py']
    assert MAN['paths'] == ['portbench']
    assert 1 <= MAN['run_seconds'] <= 51


def test_names_units_and_keys():
    names = []
    for c in MAN['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        names.append(c['name'])
        for k in c['reduced']:
            assert NAME.match(k)
    for w in MAN['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['chips'] == 1 and len(w['why']) <= 200
        assert NAME.match(w['traffic'])
        names.append(w['name'])
    for m in MAN['end_to_end'] + MAN['per_layer']:
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
        names.append(m['name'])
    for m in MAN['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    for m in MAN['per_layer']:
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}
        assert m['moves'] in {e['name'] for e in MAN['end_to_end']}
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))


@pytest.mark.parametrize('cell', CELLS)
def test_cell_resolves(cell):
    from portbench.harness import manifest
    c = manifest.load_cell(cell)
    assert c.config['family'] in ('moe', 'ssm')
    assert manifest.reference_model(c.config).param_specs(c.config)
    assert manifest.reference_optimizer(c.traffic).CAPTURE in (True, False)
    assert set(manifest.limits(cell)) <= {'loss', 'grad1', 'grad1_median',
                                          'grad1_diff', 'grad1_diff_median',
                                          'delta3', 'delta3_median'}
    assert [m['name'] for m in c.end_to_end] == ['tokens_per_s',
                                                 'peak_mem_gib', 'setup_s']
    assert {'model_ms', 'optimizer_ms', 'mfu',
            'device_idle_share'} <= {m['name'] for m in c.per_layer}


@pytest.mark.parametrize('metric', [m['name'] for m in MAN['per_layer']])
def test_metric_reader_resolves(metric):
    from portbench.harness import manifest
    assert callable(manifest.metric_reader(metric).read)


@pytest.mark.parametrize('config', [c['name'] for c in MAN['configs']])
def test_config_file_matches_the_program_registry(config):
    """Every size in the file is the port's registry entry's, but the keys
    the file lists as reduced."""
    from portbench.harness import manifest
    from repro_torch.configs.registry import get_config
    entry = next(c for c in MAN['configs'] if c['name'] == config)
    raw = json.loads((ROOT / entry['file']).read_text())
    assert raw['source'] == entry['source']
    assert raw['reduced'] == entry['reduced']
    reg = get_config(raw['arch'])
    differ = sorted(k for k, v in raw.items()
                    if k not in manifest.CONFIG_META and getattr(reg, k) != v)
    assert differ == sorted(entry['reduced'])
