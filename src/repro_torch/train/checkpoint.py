"""Checkpointing: atomic, asynchronous, keep-K — PyTorch port of
``repro/train/checkpoint.py``, in the on-disk layout of
``docs/CHECKPOINT_FORMAT.md``::

  <dir>/step_<N:08d>/manifest.json   leaf paths, shapes, dtypes, metadata
  <dir>/step_<N:08d>/leaf_<i>.npy    one full array per leaf
  <dir>/step_<N:08d>/.complete       commit marker, written last

A save writes ``step_<N>.tmp`` and renames it into place, so a crash never
leaves a half-written checkpoint that :func:`available_steps` would list.

Leaves are addressed by the path string ``jax.tree_util.keystr`` gives the
same leaf of the reference's tree: ``['key']`` for a dict key, ``.field``
for a NamedTuple field, ``[i]`` for a sequence entry; None subtrees have no
leaf.  The port keeps parameter-shaped trees as flat dicts keyed by
'/'-joined paths where the reference nests dicts, so a key ``'fc0/w'`` is
written ``['fc0']['w']``.  Checkpoints therefore cross between the packages
in both directions.  Leaves are the full logical tensors, so a checkpoint
written at one world size restores at another (``schedule/reshard.py``,
``Trainer.fit_elastic``).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, '_fields')


def _dict_key(k) -> str:
    if isinstance(k, str):
        return ''.join(f'[{part!r}]' for part in k.split('/'))
    return f'[{k!r}]'


def _rebuild(tree: Any, fn: Callable[[str, Any], Any], prefix: str = ''):
    """``tree`` with each leaf replaced by ``fn(keystr path, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, prefix + _dict_key(k))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(v, fn, f'{prefix}.{f}')
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, fn, f'{prefix}[{i}]')
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def leaf_paths(tree: Any) -> list[tuple[str, Any]]:
    """[(keystr path, leaf)] in walk order."""
    out: list[tuple[str, Any]] = []
    _rebuild(tree, lambda path, leaf: out.append((path, leaf)))
    return out


def _leaf_id(i: int) -> str:
    return f'leaf_{i:05d}'


def _to_host(x) -> np.ndarray:
    """A host copy of a leaf (tensor, numpy array or scalar).  numpy has no
    bfloat16, so such a leaf raises rather than being cast."""
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            raise TypeError('checkpoint: bfloat16 leaves have no .npy form '
                            'here; cast them to float32 first')
        return x.detach().to('cpu', copy=True).numpy()
    return np.array(x, copy=True)


def save(ckpt_dir, step: int, tree: Any,
         metadata: Optional[dict] = None) -> Path:
    """Synchronous atomic save of a tree of tensors."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f'step_{step:08d}'
    tmp = ckpt_dir / f'step_{step:08d}.tmp'
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {'step': step, 'metadata': metadata or {},
                'time': time.time(), 'leaves': []}
    for i, (path, leaf) in enumerate(leaf_paths(tree)):
        arr = leaf if isinstance(leaf, np.ndarray) else _to_host(leaf)
        np.save(tmp / f'{_leaf_id(i)}.npy', arr)
        manifest['leaves'].append({'id': _leaf_id(i), 'path': path,
                                   'shape': list(arr.shape),
                                   'dtype': str(arr.dtype)})
    (tmp / 'manifest.json').write_text(json.dumps(manifest, indent=1))
    (tmp / '.complete').write_text('ok')
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def available_steps(ckpt_dir) -> list[int]:
    """The committed steps (those with a ``.complete`` marker), sorted."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    steps = []
    for d in ckpt_dir.iterdir():
        m = re.fullmatch(r'step_(\d+)', d.name)
        if m and (d / '.complete').exists():
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(ckpt_dir) -> Optional[int]:
    steps = available_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir, step: int, template: Any,
            device='cuda') -> tuple[Any, dict]:
    """Fill the structure of ``template`` leaf by leaf from step ``step``,
    each leaf on ``device``.  A template leaf the checkpoint lacks raises
    ``KeyError``; a shape that differs raises ``ValueError`` naming the
    leaf.  Returns ``(tree, metadata)``."""
    dev = resolve_device(device)
    d = Path(ckpt_dir) / f'step_{step:08d}'
    manifest = json.loads((d / 'manifest.json').read_text())
    by_path = {entry['path']: entry for entry in manifest['leaves']}

    def load(path, leaf):
        if path not in by_path:
            raise KeyError(f'checkpoint missing leaf {path}')
        arr = np.load(d / f'{by_path[path]["id"]}.npy')
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f'{path}: shape {arr.shape} != template '
                             f'{tuple(leaf.shape)}')
        return torch.from_numpy(arr).to(dev)

    return _rebuild(template, load), manifest['metadata']


def gc_old(ckpt_dir, keep: int) -> None:
    """Delete all but the newest ``keep`` committed checkpoints; ``keep <=
    0`` deletes nothing, and uncommitted directories are left alone."""
    steps = available_steps(ckpt_dir)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(Path(ckpt_dir) / f'step_{s:08d}', ignore_errors=True)


class AsyncCheckpointer:
    """Copy to host memory synchronously, write in a background thread."""

    def __init__(self, ckpt_dir, keep: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save(self, step: int, tree: Any,
             metadata: Optional[dict] = None) -> None:
        self.wait()
        host_tree = _rebuild(tree, lambda path, x: _to_host(x))

        def _write():
            try:
                save(self.ckpt_dir, step, host_tree, metadata)
                gc_old(self.ckpt_dir, self.keep)
            except BaseException as e:  # noqa: BLE001
                self.last_error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
