"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

prints as the last line of its standard output one JSON object: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, both with ``correct`` and the numbers it was decided by.
Without a CUDA device it exits with code 2 and prints no result.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / 'build' / 'portbench'
# every build and kernel cache at a fixed place inside the checkout (the
# port's own nvcc builds land in build/repro_torch/, see its kernels/build.py)
for var, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                 ('TRITON_CACHE_DIR', 'triton'),
                 ('TORCHINDUCTOR_CACHE_DIR', 'inductor'),
                 ('CUDA_CACHE_PATH', 'nv_compute')):
    os.environ[var] = str(CACHE / sub)
# one host thread for PyTorch's CPU ops: the card does the work, and idle
# worker threads contending with the thread that launches it spread the
# window's rate from run to run
os.environ['OMP_NUM_THREADS'] = '1'
sys.path[:0] = [str(ROOT), str(ROOT / 'src')]

if __name__ == '__main__':
    from portbench.harness import bench
    sys.exit(bench.main(sys.argv[1:], T_START))
