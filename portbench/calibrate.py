"""The readings the limits of ``correct`` are set from, on the card at the
cell's own sizes (the benchmark's runs never run this):

* the program's numbers against the reference over ``--seeds`` (the lower
  readings: the largest of sound runs);
* the control's over ``--control-seeds``: the reference computed in
  float8 e4m3 where the configuration computes in bfloat16
  (``reference/lowp.py``), put in the program's place (the upper readings:
  the smallest);
* each planted fault named in ``--faults`` (``harness/faults.py``;
  half_batch unless named) over ``--fault-seeds`` (a state left unchanged
  reads 1 by construction and need not run);
* over ``--witness-seeds``, a second witness: the program and the
  reference both at float32 parameters and compute, the same sizes.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3 --fault-seeds 1,2,3 \\
        [--faults half_batch,params_unapplied] --out <file.json>

One JSON line a seed on standard output, the summary last; ``--out``
keeps them all.  Only the weights, batches and readings of one seed are on
the card at a time.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / 'src')]


def _plain(x):
    """A sampled tensor in a row: its length and root mean square."""
    return {'n': x.numel(), 'rms': float(x.pow(2).mean().sqrt())}


def _ints(text):
    return [int(x) for x in text.split(',') if x]


def main(argv) -> int:
    import torch

    from portbench.harness import check, faults, manifest
    from portbench.harness.bench import Session
    from portbench.reference.lowp import fp8
    ap = argparse.ArgumentParser(prog='portbench/calibrate.py')
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=_ints, required=True)
    ap.add_argument('--control-seeds', type=_ints, default=[])
    ap.add_argument('--fault-seeds', type=_ints, default=[])
    ap.add_argument('--faults', default='half_batch',
                    type=lambda s: [f for f in s.split(',') if f])
    ap.add_argument('--witness-seeds', type=_ints, default=[])
    ap.add_argument('--out')
    args = ap.parse_args(argv)
    unknown = sorted(set(args.faults) - set(faults.FAULTS))
    if unknown:
        ap.error(f'no fault {unknown}; have {sorted(faults.FAULTS)}')
    if not torch.cuda.is_available():
        print('calibrate: no CUDA device', file=sys.stderr)
        return 2
    cell = manifest.load_cell(args.workload)
    limits = manifest.limits(cell.name)
    rows = []

    def program(seed, fault=None, cell=cell):
        sess = Session(cell, seed, 'cuda', fault=fault)
        got, batches = sess.readings, sess.batches[:check.STEPS]
        sess.close()
        return got, batches

    def emit(row):
        rows.append(row)
        print(json.dumps({k: v for k, v in row.items()
                          if not k.endswith(('readings', 'reference'))}),
              flush=True)

    for seed in sorted(set(args.seeds) | set(args.control_seeds)
                       | set(args.fault_seeds)):
        t0 = time.perf_counter()
        got, batches = program(seed)
        ref = check.reference_readings(cell, seed, batches, 'cuda')
        row = {'seed': seed, 'reference': ref}
        if seed in args.seeds:
            row['program'] = check.compare(got, ref)
            row['program_readings'] = got
        if seed in args.control_seeds:
            ctl = check.reference_readings(cell, seed, batches, 'cuda',
                                           quant=fp8)
            row['control'] = check.compare(ctl, ref)
            row['control_readings'] = ctl
        if seed in args.fault_seeds:
            for name in args.faults:
                bad, _ = program(seed, faults.FAULTS[name])
                row[name] = check.compare(bad, ref)
        row['judged_correct'] = {
            k: check.judge(row[k], limits)[0]
            for k in ('program', 'control', *args.faults) if k in row}
        row['seconds'] = time.perf_counter() - t0
        emit(row)

    wide = dataclasses.replace(cell, config=dict(
        cell.config, param_dtype='float32', compute_dtype='float32'))
    for seed in args.witness_seeds:
        got, batches = program(seed, cell=wide)
        ref = check.reference_readings(wide, seed, batches, 'cuda')
        emit({'seed': seed, 'witness_f32': check.compare(got, ref),
              'witness_readings': got, 'witness_reference': ref})

    summary = {'workload': cell.name, 'seconds': time.perf_counter() - T_START,
               'device': torch.cuda.get_device_name(0)}
    for kind, pick in (('program', max), ('control', min),
                       *((f, min) for f in args.faults),
                       ('witness_f32', max)):
        got = [r[kind] for r in rows if kind in r]
        if got:
            summary[kind] = {n: pick(g[n][0] for g in got) for n in got[0]}
    summary['state_unchanged'] = {'grad1': 1.0, 'delta3': 1.0}
    print(json.dumps({'summary': summary}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text('\n'.join(json.dumps(r, default=_plain)
                                            for r in rows
                                            + [{'summary': summary}]) + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
