"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/*.cu`` source compiles on its own, with a plain C interface and
no PyTorch headers, into one shared library::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o lib<name>.so csrc/<name>.cu

All sources start together, one ``nvcc`` each.  The libraries land in
``build/repro_torch/<hash>/`` at the root of the checkout, where ``<hash>``
covers every file in ``csrc/``: an edited source builds anew.  There is no
fallback: without ``nvcc`` or on a failed build, :func:`library` raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).with_name('csrc')
BUILD_ROOT = Path(__file__).resolve().parents[3] / 'build' / 'repro_torch'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

# Loaded libraries, one per source, for the life of the process.
_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> list[Path]:
    return sorted(CSRC.glob('*.cu'))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / source_hash()


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    fixed = Path('/usr/local/cuda/bin/nvcc')
    if fixed.exists():
        return str(fixed)
    raise RuntimeError('nvcc not found: the CUDA kernels of repro_torch are '
                       'built from source at first use and need the CUDA '
                       'toolkit (put nvcc on PATH)')


def build_all() -> float:
    """Compile every source whose library is missing, all in parallel.

    Returns the seconds spent (0.0 when everything was built already).  The
    compiler's output, register and spill counts included, is kept beside
    each library as ``lib<name>.log``.
    """
    out_dir = build_dir()
    todo = [s for s in sources() if not (out_dir / f'lib{s.stem}.so').exists()]
    if not todo:
        return 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in todo:
        tmp = out_dir / f'lib{src.stem}.so.{os.getpid()}.tmp'
        log = open(out_dir / f'lib{src.stem}.log', 'w')
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, '-o', str(tmp), str(src)],
                                stdout=log, stderr=subprocess.STDOUT)
        jobs.append((src, tmp, log, proc))
    failed = []
    for src, tmp, log, proc in jobs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f'{src.name} (rc={rc}, see {log.name})')
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out_dir / f'lib{src.stem}.so')
    if failed:
        raise RuntimeError(f'nvcc failed for {", ".join(failed)} in {out_dir}')
    return time.perf_counter() - t0


def library(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, built first if needed.

    ``signatures`` maps each C entry to its ctypes ``argtypes``; every entry
    returns an ``int`` (a ``cudaError_t``).
    """
    lib = _loaded.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(build_dir() / f'lib{name}.so'))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (a refused launch)."""
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f'{what}: CUDA error {err}: {msg}')


P = ctypes.c_void_p      # device pointer or stream
I64 = ctypes.c_longlong
I32 = ctypes.c_int
