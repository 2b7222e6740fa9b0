"""The check of ``correct``: the program's first steps against the plain
reference's from the same weights and batches.

The numbers, each of losses or taken leaf by leaf over the reference's
leaves (a gap over the reference's value of that leaf or of the median
leaf, whichever is larger):

* ``loss``: the largest relative gap of the loss over the checked steps;
* ``grad1``: the momentum buffer of the optimizer state after step 1, the
  first gradient as the optimizer takes it in (Eva: ν·P(G); SGD:
  (1 − μ)·G): the gap of the norms, the worst leaf; ``grad1_median`` the
  median leaf's gap;
* ``grad1_diff``: the same buffer element by element, on a sample of each
  leaf drawn from the seed: the root mean square of the difference over
  the reference's, the worst leaf; ``grad1_diff_median`` the median
  leaf's;
* ``delta3``: the parameters' change over the checked steps, the gap of
  the norms, the worst leaf; ``delta3_median`` the median leaf's gap.  Both
  over the leaves whose first gradient in the reference is at least a
  thousandth of the median leaf's (below that a leaf moves by rounding).

Each cell's ``limits/<cell>.json`` holds the numbers it is judged by; the
others are read and reported.
"""
from __future__ import annotations

import statistics

import torch

from portbench.harness import manifest
from portbench.harness.weights import draw_leaf, stream_seed
from portbench.reference.common import F32, grads_and_stats, strict_f32

STEPS = 3                 # the steps the reference follows
QUIET_LEAF = 1e-3         # of the median leaf's first gradient
SAMPLE = 1 << 20          # elements of a leaf compared one by one


def norms(tree: dict) -> dict:
    return {p: float(torch.linalg.vector_norm(v.detach().to(F32)))
            for p, v in tree.items()}


def sample(tree: dict, seed: int) -> dict:
    """Up to SAMPLE elements of each leaf, at places drawn from the seed
    (all of a smaller leaf), as float32 on the host."""
    out = {}
    for p in sorted(tree):
        flat = tree[p].detach().reshape(-1)
        if flat.numel() <= SAMPLE:
            out[p] = flat.to(F32).cpu().clone()
            continue
        gen = torch.Generator(device=flat.device).manual_seed(
            stream_seed(seed, f'sample/{p}'))
        idx = torch.randint(0, flat.numel(), (SAMPLE,), generator=gen,
                            device=flat.device)
        out[p] = flat[idx].to(F32).cpu()
    return out


def change_norms(params: dict, specs: dict, seed: int, device) -> dict:
    """‖w − w₀‖ of each leaf, w₀ drawn again from the seed leaf by leaf."""
    out = {}
    for p in sorted(params):
        w0 = draw_leaf(specs[p], seed, p, device)
        out[p] = float(torch.linalg.vector_norm(params[p].to(F32)
                                                - w0.to(F32)))
        del w0
    return out


def reference_readings(cell, seed: int, batches: list, device,
                       quant=None) -> dict:
    """The reference's losses, first gradients, buffers after step 1 (norms
    and sample) and change after STEPS steps, from the weights drawn from
    ``seed``; with ``quant`` (``reference.lowp.fp8``) the control's."""
    model = manifest.reference_model(cell.config)
    opt = manifest.reference_optimizer(cell.traffic)
    specs = model.param_specs(cell.config)
    opts = cell.traffic['options']
    losses = []
    with strict_f32():
        params = {p: draw_leaf(specs[p], seed, p, device).to(F32)
                  for p in sorted(specs)}
        state = opt.init(params, model.precon_paths(cell.config))
        for i in range(STEPS):
            loss, grads, a, b = grads_and_stats(model, cell.config, params,
                                                batches[i], opt.CAPTURE,
                                                quant)
            losses.append(float(loss))
            if i == 0:
                grad1 = norms(grads)
            opt.step(state, params, grads, a, b, opts)
            del grads, a, b
            for p, w in params.items():     # stored in the config's dtype
                w.copy_(w.to(getattr(torch, specs[p][1])))
            if i == 0:
                buffer1 = norms(state['m'])
                sample1 = sample(state['m'], seed)
        del state
        delta3 = change_norms(params, specs, seed, device)
    return {'losses': losses, 'grad1': grad1, 'buffer1': buffer1,
            'sample1': sample1, 'delta3': delta3}


def _rms(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x) / max(x.numel(), 1) ** 0.5)


def _gaps(got: dict, want: dict, paths) -> dict:
    paths = sorted(paths)
    median = statistics.median(want[p] for p in paths)
    return {p: abs(got[p] - want[p]) / max(want[p], median, 1e-30)
            for p in paths}


def _worst(gaps: dict) -> tuple:
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def compare(got: dict, ref: dict) -> dict:
    """{number: (value, where)} of the readings ``got`` (the program's, or
    the control's) against the reference's ``ref``."""
    loss = max(abs(g - r) / abs(r) for g, r in zip(got['losses'],
                                                   ref['losses']))
    out = {'loss': (loss, 'steps 1-3')}
    gaps = _gaps(got['buffer1'], ref['buffer1'], ref['buffer1'])
    out['grad1'] = _worst(gaps)
    out['grad1_median'] = (statistics.median(gaps.values()),
                           f'{len(gaps)} leaves')
    scale = {p: _rms(v) for p, v in ref['sample1'].items()}
    diff = {p: _rms(got['sample1'][p] - v) for p, v in ref['sample1'].items()}
    median = statistics.median(scale.values())
    gaps = {p: diff[p] / max(scale[p], median, 1e-30) for p in scale}
    out['grad1_diff'] = _worst(gaps)
    out['grad1_diff_median'] = (statistics.median(gaps.values()),
                                f'{len(gaps)} leaves')
    median = statistics.median(ref['grad1'].values())
    moving = [p for p, v in ref['grad1'].items() if v >= QUIET_LEAF * median]
    gaps = _gaps(got['delta3'], ref['delta3'], moving)
    out['delta3'] = _worst(gaps)
    out['delta3_median'] = (statistics.median(gaps.values()),
                            f'{len(gaps)} leaves')
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {'value', 'limit', 'at'}}) over the numbers that
    have a limit; the others are left out and not judged."""
    checks, ok = {}, True
    for name, (value, where) in numbers.items():
        lim = limits.get(name)
        if lim is None:
            continue
        checks[name] = {'value': value, 'limit': lim['limit'], 'at': where}
        ok = ok and value <= lim['limit']
    return ok, checks
