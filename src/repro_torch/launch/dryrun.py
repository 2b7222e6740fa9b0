"""Multi-pod dry run — the port's counterpart of ``repro/launch/dryrun.py``.

For every (architecture × input shape × mesh) cell: lay the step's abstract
parameters, optimizer state and inputs out on a 256-rank single-pod or
512-rank multi-pod ``DeviceMesh`` by the production layouts
(``sharding/logical.py``), run the step (train), ``prefill_fn`` or
``decode_fn`` once on fake tensors under the cost trace
(``launch/hlo_analysis.py``), and record one rank's FLOPs, HBM traffic,
collective bytes and memory into ``results/dryrun/*.json``.

How a cell runs:
  * the mesh's ranks are a ``'fake'`` process group of 256 or 512 ranks in
    this one process (``FakeStore``; collectives move nothing), re-made when
    the mesh changes size;
  * every tensor is a DTensor over fake local tensors (shapes and dtypes,
    no memory), so nothing is computed, allocated or launched, and no card
    is touched;
  * ops DTensor has no sharding strategy for run on replicated operands
    (the all-gather GSPMD would insert), and each is logged in
    ``sharding_fallbacks`` beside the layout resolver's fallbacks;
  * the step runs ``KernelConfig(impl='torch')``: the reference's dry run
    runs its partitionable ``'xla'`` einsum path, and a hand kernel on a
    sharded operand has no partitioner either.

The record has the reference's fields.  The port compiles nothing:
``lower_s`` is the seconds spent building and laying out the abstract
arguments, ``compile_s`` the seconds of the traced run.
``cost_analysis_flops`` is ``torch.utils.flop_counter``'s count of the same
local ops (the library's own count, as XLA's ``cost_analysis`` is the
reference's) and ``cost_analysis_bytes`` the trace's traffic.  ``memory``:
``argument_bytes`` is the sum over leaves of one rank's shard bytes,
``temp_bytes`` the peak of the live bytes the run allocated (the arguments
excluded), ``output_bytes`` one rank's outputs, ``alias_bytes`` the outputs
that share an argument's storage, and ``total_bytes`` arguments + temp −
alias (outputs are inside the peak).

The roofline uses the data sheet of an NVIDIA H100 SXM 80GB (700 W): HBM3
3.35 TB/s, dense bf16 989 TFLOP/s (f32 67 TFLOP/s for an f32 config), and
50 GB/s a GPU of 400 Gb/s InfiniBand for the collectives, since a 256-rank
mesh spans nodes.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                 # all
  ... --arch qwen2-0.5b --shape decode_32k --mesh single          # one
  ... --list                                                      # plan
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
import weakref
from pathlib import Path

import torch

from repro_torch.configs import SHAPES, cell_skip_reason, get_config
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.core.registry import make_optimizer
from repro_torch.kernels.dispatch import KernelConfig
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import (build_model, decode_specs,
                                prefill_batch_specs, train_batch_specs)
from repro_torch.models import module as M
from repro_torch.sharding import (cache_shardings, compat, input_shardings,
                                  opt_state_shardings, param_shardings)
from repro_torch.train.step import abstract_opt_state, make_train_step

# NVIDIA H100 SXM 80GB (700 W), data sheet
H100 = dict(peak_flops_bf16=989e12, peak_flops_f32=67e12, hbm_bw=3.35e12,
            net_bw=50e9)


def active_param_counts(specs) -> tuple[int, int]:
    """(total, active) params; MoE expert weights count at top_k/n_experts
    (corrected by :func:`model_flop_params`)."""
    total = sum(math.prod(s.shape) for s in M.flatten_specs(specs).values())
    return total, total


def model_flop_params(cfg, specs) -> tuple[int, int]:
    flat = M.flatten_specs(specs)
    total = sum(math.prod(s.shape) for s in flat.values())
    expert = sum(math.prod(s.shape) for p, s in flat.items()
                 if '/moe/' in f'/{p}' and not p.endswith('router/w'))
    if cfg.n_experts:
        active = total - expert + expert * (cfg.top_k / cfg.n_experts)
    else:
        active = total
    return int(total), int(active)


def build_cell(cfg, shape, mesh, fallback_log):
    """Returns (fn, args, specs, donate, tokens_processed, kind): ``args``
    as meta tensors and ``specs`` the layout of each of their leaves."""
    model = build_model(cfg)
    specs = model.param_specs()
    params = M.abstract_params(specs)
    p_spec = M.flatten_specs(param_shardings(specs, mesh, fallback_log))
    kernel = KernelConfig(impl='torch')

    if shape.kind == 'train':
        opt, capture = make_optimizer('eva', lr=0.01)
        batch = train_batch_specs(cfg, shape)
        opt_sds = abstract_opt_state(model, opt, capture, params, batch,
                                     kernel=kernel)
        o_spec = opt_state_shardings(opt_sds, specs, mesh)
        b_spec = input_shardings(batch, mesh)
        fn = make_train_step(model, opt, capture,
                             microbatches=cfg.microbatches, kernel=kernel,
                             device='cpu')
        tokens = shape.global_batch * shape.seq_len
        return (fn, (params, opt_sds, batch), (p_spec, o_spec, b_spec),
                (0, 1), tokens, 'train')
    if shape.kind == 'prefill':
        batch = prefill_batch_specs(cfg, shape)
        b_spec = input_shardings(batch, mesh)
        tokens = shape.global_batch * shape.seq_len
        return (model.prefill_fn, (params, batch), (p_spec, b_spec), (),
                tokens, 'prefill')
    cache_sds, tok_sds, pos_sds = decode_specs(cfg, shape)
    c_spec = cache_shardings(cache_sds, mesh)
    t_spec = input_shardings(tok_sds, mesh, seq_dim=None)
    pos_spec = input_shardings(pos_sds, mesh, seq_dim=None)
    tokens = shape.global_batch  # one new token per sequence
    return (model.decode_fn, (params, cache_sds, tok_sds, pos_sds),
            (p_spec, c_spec, t_spec, pos_spec), (1,), tokens, 'decode')


def _leaf_pairs(args, specs) -> list:
    """(meta tensor, spec) of every tensor leaf, in tree order."""
    out = []

    def walk(a, s):
        if isinstance(a, torch.Tensor):
            out.append((a, s))
        elif isinstance(a, dict):
            for k in a:
                walk(a[k], s[k])
        elif isinstance(a, (tuple, list)):
            for x, y in zip(a, s):
                walk(x, y)
    walk(args, specs)
    return out


def argument_bytes(args, specs, mesh) -> int:
    """One rank's bytes of the arguments: each leaf's shard under its spec
    on ``mesh``."""
    return sum(math.prod(compat.local_shape(a.shape, s, mesh))
               * a.element_size() for a, s in _leaf_pairs(args, specs))


def distribute_args(args, specs, mesh, mode):
    """The meta ``args`` as DTensors over fake local shards made in
    ``mode``, laid out by ``specs``."""
    def walk(a, s):
        if isinstance(a, torch.Tensor):
            with mode:
                fake = torch.empty(a.shape, dtype=a.dtype, device='cpu')
            return compat.distribute(fake, s, mesh)
        if isinstance(a, dict):
            return {k: walk(a[k], s[k]) for k in a}
        if isinstance(a, tuple) and hasattr(a, '_fields'):
            return type(a)(*(walk(x, y) for x, y in zip(a, s)))
        if isinstance(a, (tuple, list)):
            return type(a)(walk(x, y) for x, y in zip(a, s))
        return a
    return walk(args, specs)


def local_tensor(x):
    return x.to_local() if hasattr(x, 'to_local') else x


class _Allocations:
    """Live bytes of the tensors a traced run allocates (each new storage
    from its first tensor until that tensor dies; a view keeps its base
    alive), and their peak."""

    def __init__(self, known: set):
        self.known = set(known)
        self.live = 0
        self.peak = 0

    def see(self, out) -> None:
        for t in hlo_analysis._tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self.known:
                continue
            self.known.add(key)
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._free, key, n)

    def _free(self, key, n) -> None:
        self.live -= n
        self.known.discard(key)


def fake_world(n: int) -> None:
    """Make the default process group a ``'fake'`` one of ``n`` ranks (this
    process rank 0), re-making it when its size differs."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == 'fake' and dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group('fake', store=FakeStore(), rank=0, world_size=n)


def measure(cfg, shape, mesh, fallback_log: list) -> dict:
    """One cell's record fields on the DeviceMesh ``mesh`` (its ranks a
    process group of this process, real or fake)."""
    t0 = time.time()
    fn, args, specs, donate, tokens, kind = build_cell(cfg, shape, mesh,
                                                       fallback_log)
    del donate          # eager steps write new tensors: nothing is donated
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    dargs = distribute_args(args, specs, mesh, mode)
    arg_b = argument_bytes(args, specs, mesh)
    known = {local_tensor(t).untyped_storage()._cdata
             for t in hlo_analysis._tensors(dargs)}
    t_lower = time.time() - t0

    alloc = _Allocations(known)
    t0 = time.time()
    with compat.set_mesh(mesh, fallback_log):
        record, out = hlo_analysis.trace(fn, *dargs, log=fallback_log,
                                         on_outputs=alloc.see)
    t_compile = time.time() - t0
    hlo = record.costs

    outs = [local_tensor(t) for t in hlo_analysis._tensors(out)]
    out_b = sum(t.numel() * t.element_size() for t in outs)
    alias_b = sum(t.numel() * t.element_size() for t in outs
                  if t.untyped_storage()._cdata in known)

    n_chips = compat.mesh_size(mesh)
    total_p, active_p = model_flop_params(cfg, build_model(cfg).param_specs())
    model_flops = (6.0 if kind == 'train' else 2.0) * active_p * tokens
    peak = H100['peak_flops_f32'] if cfg.cdtype == torch.float32 \
        else H100['peak_flops_bf16']
    per_dev = dict(
        hlo_flops=hlo.flops,
        hbm_traffic_bytes=hlo.traffic_bytes,
        collective_bytes=hlo.collective_bytes,
        cost_analysis_flops=hlo.library_flops,
        cost_analysis_bytes=hlo.traffic_bytes,
    )
    roofline = dict(
        compute_s=hlo.flops / peak,
        memory_s=hlo.traffic_bytes / H100['hbm_bw'],
        collective_s=hlo.collective_bytes / H100['net_bw'],
    )
    return dict(
        n_chips=n_chips,
        params_total=total_p, params_active=active_p,
        tokens_per_step=tokens,
        model_flops_total=model_flops,
        model_flops_per_chip=model_flops / n_chips,
        useful_flop_ratio=(model_flops / n_chips) / max(hlo.flops, 1.0),
        per_device=per_dev,
        roofline_s=roofline,
        dominant=max(roofline, key=roofline.get),
        collective_by_op=hlo.collective_by_op,
        collective_count=hlo.collective_count,
        memory=dict(
            argument_bytes=arg_b,
            output_bytes=out_b,
            temp_bytes=alloc.peak,
            alias_bytes=alias_b,
            total_bytes=arg_b + alloc.peak - alias_b,
        ),
        lower_s=round(t_lower, 2), compile_s=round(t_compile, 2),
        sharding_fallbacks=sorted(set(fallback_log)),
    )


def run_cell(arch_id: str, shape, multi_pod: bool, out_dir: Path,
             force: bool = False) -> dict:
    mesh_name = 'multi' if multi_pod else 'single'
    out_path = out_dir / f'{arch_id}__{shape.name}__{mesh_name}.json'
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    cfg = get_config(arch_id)
    skip = cell_skip_reason(cfg, shape)
    rec = {'arch': arch_id, 'shape': shape.name, 'mesh': mesh_name,
           'seq_len': shape.seq_len, 'global_batch': shape.global_batch,
           'kind': shape.kind}
    if skip:
        rec['skipped'] = skip
        out_path.write_text(json.dumps(rec, indent=1))
        return rec
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type='cpu')
    rec.update(measure(cfg, shape, mesh, []))
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument('--arch', default=None)
    ap.add_argument('--shape', default=None)
    ap.add_argument('--mesh', default='both',
                    choices=['single', 'multi', 'both'])
    ap.add_argument('--out', default='results/dryrun')
    ap.add_argument('--force', action='store_true')
    ap.add_argument('--list', action='store_true')
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [s for s in SHAPES if args.shape in (None, s.name)]
    meshes = {'single': [False], 'multi': [True],
              'both': [False, True]}[args.mesh]

    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f'{arch} × {shape.name} × {"multi" if mp else "single"}'
                if args.list:
                    print(tag)
                    continue
                try:
                    rec = run_cell(arch, shape, mp, out_dir, force=args.force)
                    if 'skipped' in rec:
                        print(f'SKIP  {tag}: {rec["skipped"]}')
                    else:
                        r = rec['roofline_s']
                        print(f'OK    {tag}: trace={rec["compile_s"]}s '
                              f'mem={rec["memory"]["total_bytes"]/2**30:.2f}'
                              f'GiB/dev '
                              f'compute={r["compute_s"]*1e3:.1f}ms '
                              f'mem_t={r["memory_s"]*1e3:.1f}ms '
                              f'coll={r["collective_s"]*1e3:.1f}ms '
                              f'dom={rec["dominant"]}', flush=True)
                except Exception as e:  # noqa: BLE001 — record and go on
                    failures.append((tag, repr(e)))
                    print(f'FAIL  {tag}: {e!r}', flush=True)
                    traceback.print_exc()
    if failures:
        raise SystemExit(f'{len(failures)} cells failed: '
                         + '; '.join(t for t, _ in failures))


if __name__ == '__main__':
    main()
