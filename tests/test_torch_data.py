"""The port's synthetic streams give the reference's batches byte for byte."""
import pytest

torch = pytest.importorskip('torch')

import numpy as np  # noqa: E402

from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402


def _same_bytes(want, got):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize('kw', [dict(batch=32, side=8), dict(batch=7),
                                dict(batch=16, side=12, rank=3, seed=5)])
def test_ae_stream_bytes(kw):
    ref, port = jsyn.AEStream(**kw), tsyn.AEStream(**kw, device='cpu')
    for step in (0, 1, 17):
        _same_bytes(ref.batch_at(step)['x'], port.batch_at(step)['x'])


@pytest.mark.parametrize('kw', [
    dict(batch=64, dim=16, classes=4, spread=1.5),
    dict(batch=33, dim=784, classes=10, seed=3)])
def test_class_stream_bytes(kw):
    ref, port = jsyn.ClassStream(**kw), tsyn.ClassStream(**kw, device='cpu')
    for step in (0, 2, 9):
        want, got = ref.batch_at(step), port.batch_at(step)
        _same_bytes(want['x'], got['x'])
        _same_bytes(want['y'], got['y'])


def test_stream_defaults_to_the_card():
    """Without a card, a stream left on its default device raises."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default is usable')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsyn.AEStream(batch=2, side=4).batch_at(0)
