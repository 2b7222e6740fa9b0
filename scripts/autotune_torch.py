#!/usr/bin/env python
"""Kernel impl/configuration autotuner CLI of the PyTorch port — a thin
wrapper over ``repro_torch.kernels.autotune``.

    PYTHONPATH=src python scripts/autotune_torch.py --shapes 768x2048,2048x768 \\
        --out runs/tile_cache.json
    PYTHONPATH=src python scripts/autotune_torch.py --shapes 64x48 \\
        --device cpu --out runs/tile_cache_cpu.json

Times each (op, shape, dtype) across the plain PyTorch version and each
launch-time configuration of the hand-written kernel (on the card; on the
CPU the plain version only, unless ``--impls`` names more), writes the
deterministic winner cache (the format ``dispatch.install_cache`` and
``KernelConfig(autotune_cache=...)`` read), and with ``--update-defaults``
merges it into the shipped ``src/repro_torch/kernels/tile_defaults.json``.
The shipped file names only kernel configurations, so ``--update-defaults``
tunes ``--impls cuda`` alone and refuses any other ``--impls``.
"""
import argparse
import json
import sys
from pathlib import Path


def parse_shapes(text):
    shapes = []
    for tok in text.split(','):
        d_in, d_out = tok.lower().split('x')
        shapes.append((int(d_in), int(d_out)))
    return shapes


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--shapes', required=True,
                    help='comma list of d_inxd_out, e.g. 768x2048,2048x768')
    ap.add_argument('--ops', default=None,
                    help='comma list from bilinear,matvec,rank1_update,'
                         'eva_fused,eva_f_fused (default: the three '
                         'primitives)')
    ap.add_argument('--dtypes', default='float32',
                    help='comma list of dtypes (default float32)')
    ap.add_argument('--impls', default=None,
                    help="comma list from torch,cuda (default: both on the "
                         "card, torch on the CPU)")
    ap.add_argument('--reps', type=int, default=3)
    ap.add_argument('--out', default=None,
                    help='write the cache JSON here')
    ap.add_argument('--update-defaults', action='store_true',
                    help="merge winners into the shipped tile_defaults.json "
                         "(tunes 'cuda' configurations only)")
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    impls = tuple(args.impls.split(',')) if args.impls else None
    if args.update_defaults:
        if impls not in (None, ('cuda',)):
            ap.error("--update-defaults takes --impls cuda only: the shipped "
                     "defaults may name only 'cuda'")
        impls = ('cuda',)

    from repro_torch.kernels import autotune, dispatch

    cache = autotune.tune(
        parse_shapes(args.shapes),
        ops=tuple(args.ops.split(',')) if args.ops else autotune.OPS,
        dtypes=tuple(args.dtypes.split(',')),
        impls=impls,
        bench=lambda fn: autotune.default_bench(fn, reps=args.reps),
        device=args.device)
    sys.stdout.write(autotune.dumps(cache))
    if args.out:
        autotune.write(cache, args.out)
        print(f'wrote {args.out}', file=sys.stderr)
    if args.update_defaults:
        path = dispatch._DEFAULTS_FILE
        base = json.loads(path.read_text()) if path.exists() else {}
        autotune.write(autotune.merge(base, cache), path)
        print(f'updated {path}', file=sys.stderr)
    return 0


if __name__ == '__main__':
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / 'src'))
    sys.exit(main())
