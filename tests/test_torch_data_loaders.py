"""The port's LM data path: ``MemmapLM`` gives the reference's windows byte
for byte (ranks 0 and 1 of W=2, across an epoch boundary), disjoint across
the ranks; ``Prefetcher`` serves the stream's batches in order and seeks
(as ``tests/test_checkpoint_data.py``); ``batch_at`` runs on the card unless
the caller asks for the CPU.  Exact comparisons throughout."""
import json

import pytest

torch = pytest.importorskip('torch')

import numpy as np  # noqa: E402

from repro.data.memmap_loader import MemmapLM as JMemmapLM  # noqa: E402
from repro.data.memmap_loader import write_tokens as jwrite  # noqa: E402
from repro_torch.data.memmap_loader import MemmapLM, write_tokens  # noqa
from repro_torch.data.pipeline import Prefetcher  # noqa: E402
from repro_torch.data.synthetic import ClassStream  # noqa: E402


def _corpus(tmp_path, n=10_000, vocab=251):
    toks = (np.arange(n) * 7919) % vocab
    write_tokens(tmp_path / 'corpus', toks)
    return toks


def test_write_tokens_matches_reference(tmp_path):
    toks = (np.arange(5000) * 17) % 70000   # past 2**16: int32
    write_tokens(tmp_path / 'port', toks)
    jwrite(tmp_path / 'ref', toks)
    assert (tmp_path / 'port.bin').read_bytes() == \
        (tmp_path / 'ref.bin').read_bytes()
    assert json.loads((tmp_path / 'port.json').read_text()) == \
        json.loads((tmp_path / 'ref.json').read_text()) == \
        {'dtype': 'int32', 'n_tokens': 5000}


@pytest.mark.parametrize('rank', [0, 1])
def test_memmap_batches_equal_reference(tmp_path, rank):
    _corpus(tmp_path)
    kw = dict(seq_len=32, batch=4, rank=rank, world=2, seed=3)
    port = MemmapLM(str(tmp_path / 'corpus'), device='cpu', **kw)
    ref = JMemmapLM(str(tmp_path / 'corpus'), **kw)
    steps_per_epoch = port._windows_per_epoch // 8
    for step in (0, 1, steps_per_epoch - 1, steps_per_epoch,
                 3 * steps_per_epoch + 2):
        got, want = port.batch_at(step), ref.batch_at(step)
        for k in ('tokens', 'labels'):
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]),
                                          err_msg=f'{k} at step {step}')


def test_memmap_ranks_disjoint_and_deterministic(tmp_path):
    _corpus(tmp_path)
    firsts = []
    for r in range(2):
        ds = MemmapLM(str(tmp_path / 'corpus'), seq_len=32, batch=4, rank=r,
                      world=2, seed=0, device='cpu')
        windows = ds.windows_at(0)
        firsts.append({tuple(w[:8].tolist()) for w in windows})
        again = MemmapLM(str(tmp_path / 'corpus'), seq_len=32, batch=4,
                         rank=r, world=2, seed=0, device='cpu')
        np.testing.assert_array_equal(again.windows_at(0), windows)
    assert not firsts[0] & firsts[1]


def test_memmap_too_small_raises(tmp_path):
    _corpus(tmp_path, n=100)
    with pytest.raises(ValueError, match='too small'):
        MemmapLM(str(tmp_path / 'corpus'), seq_len=32, batch=4,
                 device='cpu')


def test_memmap_batch_at_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default device is usable')
    _corpus(tmp_path)
    ds = MemmapLM(str(tmp_path / 'corpus'), seq_len=32, batch=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ds.batch_at(0)


def test_prefetcher_matches_stream_and_seeks():
    s = ClassStream(batch=4, dim=8, classes=3, seed=1, device='cpu')
    p = Prefetcher(s, depth=2)
    try:
        for i in range(3):
            assert torch.equal(p.batch_at(i)['x'], s.batch_at(i)['x'])
        assert torch.equal(p.batch_at(10)['x'], s.batch_at(10)['x'])  # seek
        assert torch.equal(p.batch_at(11)['x'], s.batch_at(11)['x'])
        assert torch.equal(p.batch_at(2)['x'], s.batch_at(2)['x'])   # back
        assert len(p.host_ms) >= 5 and min(p.host_ms) >= 0.0
    finally:
        p.close()


def test_prefetcher_over_memmap(tmp_path):
    _corpus(tmp_path)
    ds = MemmapLM(str(tmp_path / 'corpus'), seq_len=32, batch=4, seed=0,
                  device='cpu')
    p = Prefetcher(ds, depth=3, start_step=5)
    try:
        for i in range(5, 9):
            got = p.batch_at(i)
            want = ds.batch_at(i)
            assert torch.equal(got['tokens'], want['tokens'])
            assert torch.equal(got['labels'], want['labels'])
    finally:
        p.close()
