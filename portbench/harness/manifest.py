"""Everything a run needs, found by name: the cell in ``BENCHMARK.json``,
its configuration (``configs/<config>.json``), its traffic
(``traffic/<traffic>.json``), the limits of its check
(``limits/<cell>.json``), each per-layer metric's reader
(``metrics/<metric>.py``), and the reference model and optimizer
(``reference/models/<family>.py``, ``reference/optimizers/<name>.py``)."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parents[1]          # portbench/
ROOT = HERE.parent                                   # the checkout
MANIFEST = ROOT / 'BENCHMARK.json'
# keys of a configuration file that describe it rather than size the model
CONFIG_META = ('arch', 'source', 'reduced', 'assumed', 'published')


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict          # the sizes as run, without CONFIG_META keys
    config_meta: dict
    traffic_name: str
    traffic: dict
    end_to_end: tuple     # the manifest's entries this cell reports
    per_layer: tuple

    @property
    def tokens_per_step(self) -> int:
        return self.traffic['batch'] * self.traffic['seq']


def _read(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f'{path.relative_to(ROOT)} is missing')
    return json.loads(path.read_text())


def _reports(entry: dict, cell: str) -> bool:
    return cell in entry.get('workloads', [cell])


def load_cell(name: str, manifest: dict | None = None) -> Cell:
    man = manifest if manifest is not None else _read(MANIFEST)
    found = [w for w in man['workloads'] if w['name'] == name]
    if not found:
        raise KeyError(f'no workload {name!r} in BENCHMARK.json; have '
                       f'{[w["name"] for w in man["workloads"]]}')
    w = found[0]
    raw = _read(HERE / 'configs' / f'{w["config"]}.json')
    return Cell(
        name=name, chips=w['chips'], config_name=w['config'],
        config={k: v for k, v in raw.items() if k not in CONFIG_META},
        config_meta={k: raw[k] for k in CONFIG_META if k in raw},
        traffic_name=w['traffic'],
        traffic=_read(HERE / 'traffic' / f'{w["traffic"]}.json'),
        end_to_end=tuple(m for m in man['end_to_end'] if _reports(m, name)),
        per_layer=tuple(m for m in man['per_layer'] if _reports(m, name)))


def limits(cell: str) -> dict:
    """{number: {'limit': ..., ...}} of the cell's check."""
    return _read(HERE / 'limits' / f'{cell}.json')['limits']


def metric_reader(name: str) -> ModuleType:
    """The module ``metrics/<name>.py`` (names may hold dots), whose
    ``read(ctx)`` gives the metric or None."""
    path = HERE / 'metrics' / f'{name}.py'
    if not path.is_file():
        raise FileNotFoundError(f'no reader metrics/{name}.py')
    spec = importlib.util.spec_from_file_location(
        f'portbench_metric_{name.replace(".", "_")}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_model(cfg: dict) -> ModuleType:
    return importlib.import_module(
        f'portbench.reference.models.{cfg["family"]}')


def reference_optimizer(traffic: dict) -> ModuleType:
    return importlib.import_module(
        f'portbench.reference.optimizers.{traffic["optimizer"]}')
