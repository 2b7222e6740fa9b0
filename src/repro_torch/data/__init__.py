"""Seekable data streams and the prefetcher, as in ``repro.data``."""
from repro_torch.data.memmap_loader import MemmapLM, write_tokens
from repro_torch.data.pipeline import Prefetcher
from repro_torch.data.synthetic import AEStream, ClassStream, LMStream

__all__ = ['MemmapLM', 'write_tokens', 'Prefetcher', 'AEStream',
           'ClassStream', 'LMStream']
