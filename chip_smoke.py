#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one NVIDIA H100::

    python3 chip_smoke.py

Phases; any failure stops the run with a non-zero exit:

1. device   — needs ``torch.cuda``; prints the card's name and power limit;
              turns TF32 off for matmuls and convolutions.
2. build    — compiles ``src/repro_torch/kernels/csrc/*.cu`` with ``nvcc``.
3. kernels  — each kernel (bilinear, rank1_update, eva_fused, matvec,
              eva_f_fused) against its plain PyTorch version at the
              autoencoder's layer shapes, two stacks and two ragged shapes,
              f32 and bf16; stacked against per-item bit for bit; each fused
              kernel with ``fold_momentum=False`` against its composed op
              (``ops.eva_precondition``, ``ops.eva_f_precondition``) bit for
              bit in f32.  rank1_update bit for bit, from the (L, 2) pairs and
              from two coefficient tensors alike, also on a G one element
              past a 16-byte boundary.  matvec_cols on the reference test's
              band shapes, the autoencoder's 784 and 500 x 1000 x 1000 and a
              37 x 129 x 131 stack aligned in neither operand, f32 and bf16:
              against its plain version, its W=2 and W=4 band partials
              summed against the float64 product, stacked against per item
              bit for bit.  bilinear, matvec, eva_fused and eva_f_fused
              (both folds): three calls in a row, and a CUDA graph of one
              call replayed three times, give the first call's bits (the
              kernels keep their arrival counters at zero), f32 and bf16, on
              784 x 1000, 3 x 1000 x 1000 and 2 x 129 x 127; capturing a
              call that would grow its stream's workspace raises.
4. main     — the paper's full-width autoencoder
              (784-1000-500-250-30-250-500-1000-784, batch 1000) trained by
              Eva, Eva-f and Eva-s, 20 steps composed and 20 fused each,
              through ``make_optimizer`` / ``init_opt_state`` /
              ``make_train_step``; launch counts, loss falls, and the same
              steps with ``kernel_impl='torch'`` as the yardstick: each
              step's losses, and each step's parameter change against the
              plain step's from the same state; each kernel against its
              plain version on the last inputs the path gave it.
4b. solvers — the same autoencoder trained by K-FAC (CG) and Shampoo (the
              binomial series) with the factor sides of width 1000 sharded
              (``FactorShardConfig(head_policy='shard',
              shard_threshold=1000, solve_iters=32)``), 20 steps composed and
              20 fused each, held to the plain path (``impl='torch'``) as in
              phase 4, 128 matvec_cols launches per step; then 20 dense
              steps of each (no hand kernel) and how far the first shard
              step lies from the dense one; then 10 shard steps of each
              refreshing every 10 steps beside every step: held to the
              plain path, the host-clock ms of each step, and the device
              kernels of the refresh and a skip step (no dense inverse or
              eigh in the skip step; Shampoo's skip steps at least 25 ms
              below its every-step median).
5. stacked  — a few Eva, Eva-f and K-FAC (sharded) steps of MLP
              784-1000-1000-1000-1000-10, whose three 1000x1000 layers form
              one stacked bucket.
6. times    — CUDA-event times of each kernel, its plain version and the
              one-call library equivalent at the autoencoder's shapes, eager
              and replayed from a CUDA graph, and the host µs per call of the
              kernel's wrapper and the library call; the device launches of
              one wrapper call (the profiler's kernels, all and the port's
              own: 2 for eva_fused and eva_f_fused, 1 for the others, and
              no PyTorch kernel); the launch floor (an
              empty kernel); rank1_update on its largest layer alone; the
              step times of each optimizer, the forward + backward alone,
              and a torch.profiler breakdown of each step.
7. lm       — the demo transformer LM at full width, demo_lm('100m') (12
              layers of d_model 768, 12 heads and 4 KV heads, d_ff 2048,
              vocab 32768, remat 'dots'; 125,848,320 parameters) on
              LMStream batches of 16 x 512 tokens: Eva and Eva-f, 10 steps
              composed and 10 fused each, held to the plain path as in
              phase 4, one launch per weight and step (each 12-deep layer
              stack folded into one stacked launch); K-FAC with the head's
              32768-wide output side sharded, 3 steps held the same way, 32
              matvec_cols launches a step, each step's host-clock ms; the
              loss on each run's first batch falls; serving: decode of the
              16th token after a 15-token prefill against a prefill over
              all 16, then 8 greedy decode steps.  Then the LM's times,
              added to phase 6's rows: each kernel's calls of one LM step
              (row 9: all 32 band products in each timed run) from a CUDA
              graph and eager, beside its plain version, bound and library
              call; matvec alone on the tall G (mlp/down, 12 x 2048 x 768);
              step times and a profile of each step.
8. rest     — the rest of the optimizer set and the trainer.  8a: on the
              full-width autoencoder, 20 steps each of FOOF (composed,
              fused, every 10 steps), M-FAC (m=32), AdamW, Adagrad, and
              K-FAC and Eva under warmup_then_k(5, 10): finite, falling
              losses; the first 3 card steps within 1e-4 of the same steps
              on this machine's CPU; the skip steps of FOOF@10 and K-FAC
              launch no dense inverse.  8b: Eva composed and fused and Eva-f
              fused under adaptive(0.05) and warmup_then_k(5, 10) through
              the kernels, each step held to the plain step from the same
              state, the refresh counts printed.  8c: Trainer.fit of
              demo-100m (Eva fused under adaptive(0.05)) over a MemmapLM
              corpus from phase 7's LMStream behind a Prefetcher,
              checkpoints every 4 steps: 12 steps unbroken against 6 steps,
              then a fresh Trainer resuming from step 4 to 12, equal bit for
              bit under torch.use_deterministic_algorithms; every record
              validates; fit's step ms, the checkpoint's bytes and save and
              restore rates, the prefetcher's host ms.  8d: the paper's
              Table 5 on demo-100m (SGD, Eva, Eva-f, FOOF, AdamW, M-FAC
              m=8): step ms, optimizer-state bytes and peak device memory,
              each beside SGD's.
9. families — the other model families through rows 1-8.  9a:
              qwen3-moe-30b-a3b at every published width (d_model 2048,
              32 heads of 128, 4 KV heads, 128 experts of d_ff 768, top-8,
              vocab 151936, bf16, flash attention, remat 'dots'), depth 4
              of 48 (3,114,813,440 parameters), 2 x 2048 tokens a step at
              capacity factor 1.25: Eva and Eva-f, composed and fused, 3
              steps each, every f32 update held to the plain update from
              the same state (1e-4 of its norm, per leaf and step) and the
              next batch's loss after either; one launch per weight and
              step (each expert stack folded to 512 items); the kernels
              held to their plain versions on the path's own inputs; step
              ms, a profiled step's device busy time, peak memory, SGD's
              step, the dropped assignments per layer; each kernel's calls
              of one step on operands of the path's shapes (bf16 G) from a
              CUDA graph and eager beside its plain version, bound and
              library call.  Serving: a 2 x 2048 prefill, the cache grown,
              16 decode steps, against one prefill over all 2064 tokens
              (dropless capacity 16), with f32 compute held to 2e-2 and the
              argmax equal, bf16 compute read.  9b: mamba2-780m whole (48
              layers, bf16, 2 x 2048), Eva composed and fused, held the
              same way; serving likewise.  9c: whisper-tiny whole on 8 x
              1024 frames and 256 decoder tokens, Eva fused; serving.  9d:
              jamba-v0.1-52b, one whole period of 8 layers at published
              widths (13,267,656,416 parameters, 26.5 GB of bf16 weights):
              serving 1 x 2048 and 16 decode steps; Eva composed and fused
              at its reduced config.
10. workers — the multi-worker layers over torch.distributed.  10a, a
              one-rank NCCL group in this process: make_dp_step equals
              make_train_step bit for bit on the full-width autoencoder
              (Eva fused, Eva-f fused, K-FAC and Shampoo shard, 10 steps
              each; both steps' host-clock ms: the DP path's own
              overhead), and fit_elastic(world=1) equals fit on demo-100m
              (8 steps), deterministic algorithms on.  10b, four ranks
              spawned over gloo sharing the one card (NCCL refuses two
              ranks on one GPU), 250 samples a rank, 10 steps each of Eva
              composed and fused, Eva-f fused, K-FAC and Shampoo shard and
              FOOF: rank 0 takes each step at W = 1 from the same state as
              well, on the whole batch and as the one-process twin of the
              four shard means; the W = 4 update within 1e-4 of the twin's
              norm, and of the whole-batch step's (or twice the twin's own
              distance to it, where the method is that sensitive to the
              split); each rank multiplies only its own 250-row band of a
              sharded factor (matvec_cols on 1 x 250 x 1000, held to its
              plain version on the path's inputs); exchange='gather'
              equals 'psum' bit for bit (K-FAC, FOOF, Shampoo); 'onestep'
              (Eva fused, K-FAC shard) starts from the cold buffers; the
              MLP of phase 5 with its stacked 3 x 1000 x 1000 bucket banded
              (3 x 250 x 1000); the int8 DP step reports comm_saturation 0;
              each call site's bytes.  10c: Eva and K-FAC trained by
              fit_elastic at W = 4, SIGTERM at step 8, restored at W = 2,
              SIGTERM at 16, restored at W = 4 to step 24: every step once,
              each loss within 1e-4 of the uninterrupted run's, the
              reshard records (4, 2) and (2, 4); a live world_fn 4 -> 2 ->
              4 likewise.  The launches of 10a and of 10b summed over the
              ranks go into the kernel rows.
11. cli     — the training CLI and the examples on the card.  11a:
              ``repro_torch.launch.train.main`` in this process on
              demo_lm('100m') at 16 x 512 tokens: Eva fused with
              ``--profile`` (4 steps, checkpoints every 2), Eva composed
              with ``--kernel-impl cuda`` (2 steps) and K-FAC with the
              head's 32768-wide side sharded (2 steps), each beside its
              ``--kernel-impl torch`` twin from the same weights: every
              step's loss within 1e-4 of the twin's, the wrapper launches
              exact (eva_fused 8 a step, bilinear and rank1_update 8,
              matvec_cols 32) and none in the twin, the port's device
              kernels in a trace of each Eva run at most the wrapper count
              times each kernel's launches a call and at most 1% short,
              every record valid; the host ms of one LMStream batch.  11b:
              ``scripts/obs_report_torch.py --validate`` and the breakdown
              of the profiled run; 11c: ``python -m
              repro_torch.launch.train --arch demo --steps 4`` and the five
              ``examples/*_torch.py`` at a few steps; 11b and 11c as
              processes started together, each exiting 0.  The launches
              of 11a go into the kernel rows.

The line before the card line is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / 'src'

AE_SHAPES = [(784, 1000), (1000, 500), (500, 250), (250, 30), (30, 250),
             (250, 500), (500, 1000), (1000, 784)]
STACKS = [(3, 1000, 1000), (2, 129, 127)]
RAGGED = [(1000, 513), (200, 136)]
GAMMA, MU = 0.03, 0.9
TOL = {'float32': 1e-5, 'bfloat16': 3e-2}   # tests/test_kernels.py
# matvec against its plain version: both read the same G values and add in
# f32, so bf16 is held as tightly as f32 (of each column's scale)
MATVEC_TOL = 1e-5
FUSED_TOL = 1e-6                            # tests/test_fused.py
TRAJ_RTOL = 1e-4                            # cuda vs torch loss, per step
PARAM_RTOL = 1e-4                           # cuda vs torch, a leaf's step
# kernel -> (the port's device launches a wrapper call, all device launches
# a call): one for bilinear, rank1_update, matvec and matvec_cols, two for
# eva_fused and eva_f_fused (the second a programmatic dependent of the
# first), and no PyTorch kernel beside them: every wrapper takes the lean
# launch path of kernels/launch.py
DEVICE_LAUNCHES = {'bilinear': (1.0, 1.0), 'rank1_update': (1.0, 1.0),
                   'eva_fused': (2.0, 2.0), 'matvec': (1.0, 1.0),
                   'eva_f_fused': (2.0, 2.0), 'matvec_cols': (1.0, 1.0)}
HBM_BYTES_PER_S = 3.35e12                   # H100 SXM data sheet
F32_FLOPS = 67e12                           # H100 SXM f32, no tensor cores
STEPS = 20
# optimizer -> (lr of benchmarks/fig4_autoencoder.py, more options,
# kernels launched once per layer and step composed, the same fused)
MAIN_PATHS = {
    'eva': (0.15, {}, ('bilinear', 'rank1_update'), ('eva_fused',)),
    'eva_f': (0.15, {}, ('matvec', 'rank1_update'), ('eva_f_fused',)),
    'eva_s': (0.3, {}, ('bilinear', 'rank1_update'), ('eva_fused',)),
}
# matvec_cols: (R, m, n) band shapes of tests/test_kernels.py (R = 5), the
# autoencoder's 784- and 500-row gradients against a 1000-wide factor, and
# a shape whose rows are 16-byte aligned in neither operand (odd m and n)
COLS_PATH = (784, 1000, 1000)
COLS_SHAPES = [(5, 64, 48), (5, 200, 136), (5, 512, 384), COLS_PATH,
               (500, 1000, 1000), (37, 129, 131)]
COLS_TOL = 1e-5                 # of each output's scale Σ_k |a_rk g_kc|
# optimizer -> (lr of benchmarks/fig4_autoencoder.py, the sharded-factor
# config): the four factor sides of width 1000 trip, 32 band products each
SHARD = dict(head_policy='shard', shard_threshold=1000, solve_iters=32)
SOLVER_PATHS = {
    'kfac': (0.15, dict(SHARD, solver='cg')),
    'shampoo': (0.3, dict(SHARD, solver='binomial')),
}
# the paper's kfac@10 and shampoo@10: a refresh every INTERVAL steps; the
# steps between skip the twelve dense sides' inverses (K-FAC: cuBLAS's LU
# and triangular solves) or eigh (Shampoo: cuSOLVER's Jacobi and divide and
# conquer, about 51 ms of its device time a step), whose kernels carry these
# names; Shampoo's skip steps must save at least half of that
INTERVAL = 10
DENSE_REFRESH_KERNELS = ('getrf', 'trsm', 'syev', 'sytrd', 'stedc')
INTERVAL_SAVING_MS = 25.0
# phase 7: demo_lm('100m') (125,848,320 parameters) on LMStream batches of
# 16 x 512 tokens; Eva at examples/quickstart.py's options, Eva-f at its lr
LM_PARAMS = 125_848_320
LM_STREAM = dict(vocab=32768, seq_len=512, batch=16, seed=0)
LM_STEPS = 10
LM_PATHS = {
    'eva': (0.05, dict(gamma=0.03, kl_kappa=1e-3), ('bilinear',
                                                    'rank1_update'),
            ('eva_fused',)),
    'eva_f': (0.05, {}, ('matvec', 'rank1_update'), ('eva_f_fused',)),
}
# K-FAC with the head's 32768-wide output side sharded (the one side that
# trips), CG with 32 band products a step; a few steps, each about 2 s
LM_SHARD = dict(head_policy='shard', shard_threshold=32768, solve_iters=32,
                solver='cg')
LM_KFAC_LR = 0.05
LM_KFAC_STEPS = 3
LM_TIME_ITERS = 20
SERVE_TOL = 2e-2                            # tests/test_serving_consistency.py
LM_WEIGHTS = 8          # preconditioned weights of demo-100m, a call each
# phase 8a: tag -> (optimizer, lr of benchmarks/fig4_autoencoder.py's
# LRS.get(name, 0.1), adamw's of tests/test_optimizers.py, more options,
# fused, a skip step whose device kernels are read or None).  Two lrs are
# lower, because these runs diverge at the named ones on this full-width
# autoencoder, on the CPU as on the card: foof@10 at 0.1 (rising from two
# steps after its second refresh) and mfac at 0.01 (off the history's span
# its step is 1/λ = 1000x the gradient)
WARMUP_THEN_K = ('warmup_then_k', dict(warmup=5, k=10))
REST_PATHS = {
    'foof': ('foof', 0.1, {}, False, None),
    'foof fused': ('foof', 0.1, {}, True, None),
    'foof@10': ('foof', 0.05, {'interval': 10}, False, 1),
    'mfac m=32': ('mfac', 1e-3, {'m': 32}, False, None),
    'adamw': ('adamw', 1e-3, {}, False, None),
    'adagrad': ('adagrad', 0.05, {}, False, None),
    'kfac warmup_then_k(5,10)': ('kfac', 0.15, {'policy': WARMUP_THEN_K},
                                 False, 6),
    'eva warmup_then_k(5,10)': ('eva', 0.15, {'policy': WARMUP_THEN_K},
                                False, None),
}
REST_CPU_STEPS = 3      # card steps held to the same steps on the CPU
# phase 8b: the snapshot policies through the kernels
POLICY_PATHS = [('adaptive', dict(threshold=0.05)), WARMUP_THEN_K]
# phase 8c: Trainer.fit of demo-100m, Eva fused under adaptive(0.05)
FIT_STEPS, FIT_CUT, FIT_BATCH, FIT_SEQ = 12, 6, 16, 512
FIT_THRESHOLD = 0.05
FIT_FALLBACK_RTOL = 1e-6    # only should an op lack a deterministic form
# phase 8d: benchmarks/table5_itertime.py's set and lr on demo-100m
TABLE5_OPTS = {'sgd': {}, 'eva': {}, 'eva_f': {}, 'foof': {}, 'adamw': {},
               'mfac': {'m': 8}}
TABLE5_LR = 0.01
TABLE5_WARMUP, TABLE5_ROUNDS, TABLE5_PER_ROUND, TABLE5_BATCHES = 2, 3, 3, 4
# phase 9: the other families at published widths.  Each optimizer of
# FAMILY_PATHS (LM_PATHS' lr and options; 'both': composed and fused)
# takes FAMILY_STEPS steps, each update held to the plain update from the
# same state within UPDATE_RTOL (f32 updates, per leaf), and the next
# batch's loss after either within BF16_LOSS_RTOL for bf16 parameters:
# their 8-bit mantissa rounds the two updates' 1e-4 differences apart in a
# few parameters (one ulp is 2^-8 = 3.9e-3 relative), and the forward runs
# in bf16
FAMILY_PATHS = {name: v + ('both',) for name, v in LM_PATHS.items()}
FAMILY_STEPS = 3
UPDATE_RTOL = 1e-4
BF16_LOSS_RTOL = 1e-2
SERVE_GEN = 16          # decode steps after each prefill
# bf16 serving: decode's distance to the f32-compute prefill on the same
# weights at most BF16_DECODE_RATIO times the bf16 prefill's own, plus two
# bf16 roundings (2^-7) of the largest logit.  Twice the largest ratio
# that tests/test_torch_serving_bf16.py measures on the CPU for the
# reference and the port (1.41, the reference's on jamba); the
# decode-vs-prefill gap itself is read, not held: the reference shows it
# too (up to 2.4e-2 of the largest logit at the reduced configs)
BF16_DECODE_RATIO = 3.0
# 9a: qwen3-moe-30b-a3b at every published width, depth cut to 4 of 48
# (623.1M parameters a layer, 622.3M in the embedding and the head)
MOE_ARCH, MOE_DEPTH, MOE_PARAMS = 'qwen3-moe-30b-a3b', 4, 3_114_813_440
MOE_BATCH, MOE_SEQ = 2, 2048
MOE_TIME_ITERS, MOE_TIME_REPEATS = 2, 2
# 9b: mamba2-780m whole, 4 x 2048 tokens a step: sequences of 2048 (8
# chunks of 256), four of them; a step peaks near 24 GB on an H100
MAMBA_BATCH, MAMBA_SEQ = 4, 2048
# 9c: whisper-tiny whole on 1024 frames (a multiple of the 512 / 1024
# chunks; Whisper's own 1500 is not, though its attention is naive here, as
# in the reference) and 256 decoder tokens
WHISPER_BATCH, WHISPER_FRAMES = 8, 1024
# 9d: jamba-v0.1-52b, one whole period of 8 layers at published widths
JAMBA_DEPTH, JAMBA_PARAMS, JAMBA_PROMPT = 8, 13_267_656_416, 2048
# phase 11: the training CLI (repro_torch.launch.train.main) on demo-100m at
# full width, 16 x 512 tokens a step; tag -> (flags, the port's kernel
# launches a step, whether the run is traced).  Each run beside its
# --kernel-impl torch twin from the same weights, step by step within
# TRAJ_RTOL.  A trace may lose a device event (CUPTI once dropped one) but
# never gain one: its port kernels at most the wrapper count times
# DEVICE_LAUNCHES, and short by at most CLI_TRACE_SHORT of it.  A trace
# costs about 0.45 ms an event on the host (K-FAC's two steps took 15 s
# more traced on an H100 host), so K-FAC's run is not traced:
# matvec_cols' one device launch a call is phase 6's check
CLI_BASE = ['--arch', 'demo-100m', '--batch', '16', '--seq-len', '512',
            '--log-every', '1']
CLI_RUNS = {
    'cli eva fused profile': (['--opt', 'eva', '--fused', '--profile',
                               '--steps', '4', '--ckpt-every', '2'],
                              {'eva_fused': LM_WEIGHTS}, True),
    'cli eva composed cuda': (['--opt', 'eva', '--kernel-impl', 'cuda',
                               '--steps', '2'],
                              {'bilinear': LM_WEIGHTS,
                               'rank1_update': LM_WEIGHTS}, True),
    'cli kfac head shard': (['--opt', 'kfac', '--head-policy', 'shard',
                             '--head-threshold', '32768', '--steps', '2'],
                            {'matvec_cols': LM_SHARD['solve_iters']}, False),
}
CLI_TRACE_SHORT = 0.01
# 11c: the CLI on demo_lm('small') and the five examples, as subprocesses
# started together, each at a few steps
CLI_SUBPROCESSES = {
    'cli demo': ['-m', 'repro_torch.launch.train', '--arch', 'demo',
                 '--steps', '4', '--out-dir', 'build/smoke_cli/sub'],
    'quickstart': ['examples/quickstart_torch.py'],
    'train_lm': ['examples/train_lm_torch.py', '--steps', '4',
                 '--log-every', '1', '--out-dir', 'build/smoke_cli/ex'],
    'autoencoder_eva': ['examples/autoencoder_eva_torch.py', '--steps', '3'],
    'optimizer_comparison': ['examples/optimizer_comparison_torch.py',
                             '--steps', '3'],
    'serve_lm': ['examples/serve_lm_torch.py'],
}
CLI_SUB_TIMEOUT = 300


def fail(msg: str):
    raise SystemExit(f'chip_smoke: FAILED: {msg}')


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


T_START = time.perf_counter()


def phase(name: str) -> None:
    print(f'== {name} [{time.perf_counter() - T_START:.1f} s]', flush=True)


# ---------------------------------------------------------------------------
# 1. device


def device_phase(torch):
    phase('1 device')
    require(torch.cuda.is_available(), 'torch.cuda is not available')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'python {sys.version.split()[0]}')
    print(f'allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} '
          f'cudnn={torch.backends.cudnn.allow_tf32}')
    return smi


# ---------------------------------------------------------------------------
# 2. build


def build_phase():
    phase('2 build')
    from repro_torch.kernels import build
    secs = build.build_all()
    print(f'built {[s.name for s in build.sources()]} in {secs:.2f} s '
          f'into {build.build_dir()}')
    for log in sorted(build.build_dir().glob('*.log')):
        for line in log.read_text().splitlines():
            if 'registers' in line or 'spill' in line or 'error' in line:
                print(f'  {log.stem}: {line.strip()}')


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions


def _inputs(torch, shape, dtype, seed):
    gen = torch.Generator(device='cuda').manual_seed(seed)
    *lead, d_in, d_out = shape
    g = torch.randn(shape, generator=gen, device='cuda').to(dtype)
    a = torch.randn((*lead, d_in), generator=gen, device='cuda')
    b = torch.randn((*lead, d_out), generator=gen, device='cuda')
    m = torch.randn(shape, generator=gen, device='cuda')
    return g, a, b, m


def _cs(torch, g, a, b, dot):
    denom = GAMMA + (a * a).sum(-1) * (b * b).sum(-1)
    return torch.stack([dot / denom, torch.full_like(denom, 1.0 / GAMMA)], -1)


def kernels_phase(torch):
    phase('3 kernels against plain versions')
    from repro_torch.kernels import bilinear as bil
    from repro_torch.kernels import fused, ops, ref
    from repro_torch.kernels import rank1_update as r1

    err = {'bilinear': 0.0, 'rank1_update': 0.0, 'eva_fused': 0.0,
           'matvec': 0.0, 'eva_f_fused': 0.0, 'matvec_cols': 0.0}
    cases = [((1,) + s, True) for s in AE_SHAPES] + \
        [(s, False) for s in STACKS] + [((1,) + s, False) for s in RAGGED]
    for seed, (shape, on_path) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).rsplit('.', 1)[-1]
            tol = TOL[name]
            g, a, b, m = _inputs(torch, shape, dtype, seed)
            tag = f'{"x".join(map(str, shape))} {name}'

            # bilinear: error held against the sum's own scale Σ|a_i g_ij b_j|
            dot, sq = bil.bilinear_and_norms_stacked(g, a, b)
            want, sq_want = ref.bilinear_and_norms_ref(g, a, b)
            require(torch.allclose(sq, sq_want, rtol=1e-5, atol=0),
                    f'bilinear norms {tag}')
            scale = ref.bilinear_ref(g.abs(), a.abs(), b.abs())
            e = (dot - want).abs()
            require(bool((e <= tol * scale).all()),
                    f'bilinear {tag}: err {e.max().item():.3e} > '
                    f'{tol} x scale')
            # rank1_update: the plain version's bits, from the (L, 2) pairs
            # and from two tensors (strided views of the pairs, and
            # contiguous copies) alike
            cs = _cs(torch, g, a, b, want)
            p = r1.rank1_update_stacked(g, a, b, cs)
            p_want = ref.rank1_update_ref(g, a, b, cs[:, 0], cs[:, 1])
            require(p.dtype == g.dtype, f'rank1_update {tag}: dtype {p.dtype}')
            ep = (p.float() - p_want.float()).abs()
            require(torch.equal(p, p_want),
                    f'rank1_update {tag}: err {ep.max().item():.3e}, not the '
                    f'plain version\'s bits')
            for c2, s2 in ((cs[:, 0], cs[:, 1]),
                           (cs[:, 0].contiguous(), cs[:, 1].contiguous())):
                require(torch.equal(r1.rank1_update_stacked(g, a, b, c2, s2),
                                    p), f'rank1_update {tag}: two-tensor '
                        f'form != pair form')
            # fused, both folds, held on the γ-scaled output as test_fused.py
            for fold in (False, True):
                out, aux = fused.eva_fused_stacked(g, a, b, GAMMA, m, MU, fold)
                o_want, a_want = ref.eva_fused_ref(g, a, b, GAMMA, m, MU, fold)
                eo = (GAMMA * out - GAMMA * o_want).abs()
                require(bool((eo <= FUSED_TOL + FUSED_TOL *
                              (GAMMA * o_want).abs()).all()),
                        f'eva_fused fold={fold} {tag}: err '
                        f'{eo.max().item():.3e}')
                ea = (aux - a_want).abs()
                require(bool((ea <= 1e-4 + 2e-5 * a_want.abs()).all()),
                        f'eva_fused aux fold={fold} {tag}: err '
                        f'{ea.max().item():.3e}')
                if on_path and name == 'float32':
                    err['eva_fused'] = max(err['eva_fused'],
                                           (out - o_want).abs().max().item())
            # without the fold the kernel reads no m: a null m, same bits
            out, aux = fused.eva_fused_stacked(g, a, b, GAMMA, m, MU, False)
            o0, x0 = fused.eva_fused_stacked(g, a, b, GAMMA, None, MU, False)
            require(torch.equal(o0, out) and torch.equal(x0, aux),
                    f'eva_fused m=None != m given {tag}')
            # fused (fold off) against composed Eva (bilinear, PyTorch's
            # coeff = dot / (γ + ‖a‖²‖b‖²), rank1_update): the same bits,
            # since bilinear finishes eva_fused's dot and norms in its order;
            # in f32 only, since the composed P is rounded to G's dtype
            ec = torch.zeros(())
            if name == 'float32':
                comp = ops.eva_precondition(g, a, b, GAMMA, impl='cuda')
                ec = (out - comp).abs()
                require(torch.equal(out, comp),
                        f'eva_fused (fold off) vs composed Eva {tag}: err '
                        f'{ec.max().item():.3e}, not the same bits')
            # stacked ≡ per item, bit for bit
            if shape[0] > 1:
                out_s, aux_s = fused.eva_fused_stacked(g, a, b, GAMMA, m, MU,
                                                       True)
                for i in range(shape[0]):
                    sl = slice(i, i + 1)
                    d1, s1 = bil.bilinear_and_norms_stacked(g[sl], a[sl],
                                                            b[sl])
                    require(torch.equal(d1, dot[sl]) and
                            torch.equal(s1, sq[sl]),
                            f'bilinear stacked != item {i} {tag}')
                    require(torch.equal(r1.rank1_update_stacked(
                        g[sl], a[sl], b[sl], cs[sl]), p[sl]),
                        f'rank1_update stacked != item {i} {tag}')
                    o1, x1 = fused.eva_fused_stacked(g[sl], a[sl], b[sl],
                                                     GAMMA, m[sl], MU, True)
                    require(torch.equal(o1, out_s[sl]) and
                            torch.equal(x1, aux_s[sl]),
                            f'eva_fused stacked != item {i} {tag}')
                    # the composed op on a bucket stack against one leaf
                    require(torch.equal(
                        ops.eva_precondition(g[i], a[i], b[i], GAMMA),
                        ops.eva_precondition(g, a, b, GAMMA)[i]),
                        f'ops.eva_precondition stacked != leaf {i} {tag}')
            if on_path and name == 'float32':
                err['bilinear'] = max(err['bilinear'], e.max().item())
                err['rank1_update'] = max(err['rank1_update'],
                                          ep.max().item())
            emv, emv_rel, efc, efc_comp = _eva_f_checks(
                torch, g, a, m, tag, float32=name == 'float32')
            if on_path and name == 'float32':
                err['matvec'] = max(err['matvec'], emv)
                err['eva_f_fused'] = max(err['eva_f_fused'], efc)
            print(f'  ok {tag}: bilinear err {e.max().item():.2e}, '
                  f'rank1 err {ep.max().item():.2e}, fused-vs-composed '
                  f'{ec.max().item():.2e}; matvec err {emv:.2e} '
                  f'({emv_rel:.2e} of scale), eva_f_fused err {efc:.2e}, '
                  f'vs composed {efc_comp:.2e}', flush=True)
    _rank1_offset_checks(torch)
    _repeat_and_replay_checks(torch)
    for seed, rmn in enumerate(COLS_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            e = _matvec_cols_checks(torch, rmn, dtype, 50 + seed)
            if rmn == COLS_PATH and dtype == torch.float32:
                err['matvec_cols'] = e
                print(f'  matvec_cols {"x".join(map(str, rmn))} f32: max abs '
                      f'err against the plain version {e!r}', flush=True)
    torch.cuda.synchronize()
    return err


def _rank1_offset_checks(torch):
    """rank1_update on a G that starts one element past a 16-byte boundary
    (a view with a storage offset of one), f32 and bf16, at the ragged
    1000 x 513 (odd d_out) and the 784 x 1000 layer: the plain version's
    bits, unstacked and stacked, from two 0-d tensors and from the pair."""
    from repro_torch.kernels import rank1_update as r1
    from repro_torch.kernels import ref
    for seed, shape in enumerate([(1000, 513), (784, 1000)]):
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device='cuda').manual_seed(70 + seed)
            flat = torch.randn(1 + shape[0] * shape[1], generator=gen,
                               device='cuda').to(dtype)
            g = flat[1:].view(shape)
            a = torch.randn(shape[:1], generator=gen, device='cuda')
            b = torch.randn(shape[1:], generator=gen, device='cuda')
            c = torch.tensor(0.37, device='cuda')
            s = torch.tensor(2.5, device='cuda')
            tag = (f'rank1_update offset view {"x".join(map(str, shape))} '
                   f'{str(dtype).rsplit(".", 1)[-1]}')
            require(g.storage_offset() == 1 and g.data_ptr() % 16 != 0, tag)
            p = r1.rank1_update(g, a, b, c, s)
            require(torch.equal(p, ref.rank1_update_ref(g, a, b, c, s)),
                    f'{tag}: not the plain version\'s bits')
            require(torch.equal(r1.rank1_update(g, a, b, torch.stack([c, s])),
                                p), f'{tag}: pair form != two tensors')
            require(torch.equal(r1.rank1_update_stacked(
                g[None], a[None], b[None], c[None], s[None])[0], p),
                f'{tag}: stacked != unstacked')
            print(f'  ok {tag}: bit for bit', flush=True)


def _capture(torch, fn):
    """A CUDA graph of one call of ``fn`` and the graph's outputs: three
    eager calls on a side stream, which grow that stream's kernel
    workspace, then the capture on the same stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        outs = fn()
    return graph, outs


def _repeat_and_replay_checks(torch):
    """The kernels redesigned to one or two launches (bilinear, matvec,
    eva_fused, eva_f_fused): three calls in a row, and a CUDA graph of one
    call replayed three times, each give the first call's bits (so the
    arrival counters are back at zero after every call).  Then a capture
    that would grow a stream's workspace raises, for each kernel that
    takes one."""
    from repro_torch.kernels import bilinear as bil
    from repro_torch.kernels import fused, launch
    from repro_torch.kernels import matvec as mv
    for seed, shape in enumerate([(1, 784, 1000), (3, 1000, 1000),
                                  (2, 129, 127)]):
        for dtype in (torch.float32, torch.bfloat16):
            g, a, b, m = _inputs(torch, shape, dtype, 80 + seed)
            tag = f'{"x".join(map(str, shape))} {str(dtype).rsplit(".", 1)[-1]}'
            calls = {
                'bilinear': lambda: bil.bilinear_and_norms_stacked(g, a, b),
                'matvec': lambda: mv.matvec_and_norm_stacked(g, a),
                'eva_fused': lambda: fused.eva_fused_stacked(
                    g, a, b, GAMMA, m, MU, True),
                'eva_fused fold=False': lambda: fused.eva_fused_stacked(
                    g, a, b, GAMMA, None, MU, False),
                'eva_f_fused': lambda: fused.eva_f_fused_stacked(
                    g, a, GAMMA, m, MU, True),
                'eva_f_fused fold=False': lambda: fused.eva_f_fused_stacked(
                    g, a, GAMMA, None, MU, False),
            }
            for name, fn in calls.items():
                first = [x.clone() for x in fn()]
                for i in range(2):
                    require(all(torch.equal(x, y) for x, y in
                                zip(fn(), first)),
                            f'{name} {tag}: call {i + 2} != call 1')
                graph, outs = _capture(torch, fn)
                for i in range(3):
                    graph.replay()
                    torch.cuda.synchronize()
                    require(all(torch.equal(x, y) for x, y in
                                zip(outs, first)),
                            f'{name} {tag}: graph replay {i + 1} != call 1')
            print(f'  ok {tag}: {", ".join(calls)}: 3 calls and 3 graph '
                  f'replays bit for bit', flush=True)
    # a capture that would grow its stream's workspace raises, and leaves
    # the workspace as it was; each capture takes a stream of its own
    index = torch.cuda.current_device()
    g, a, b, m = _inputs(torch, (1, 250, 30), torch.float32, 89)
    growers = {
        'bilinear': lambda: bil.bilinear_and_norms_stacked(g, a, b),
        'eva_fused': lambda: fused.eva_fused_stacked(g, a, b, GAMMA, m, MU,
                                                     True),
        'eva_f_fused': lambda: fused.eva_f_fused_stacked(g, a, GAMMA, m, MU,
                                                         True),
    }
    for name, fn in growers.items():
        side = torch.cuda.Stream()
        key = (index, side.cuda_stream)
        kept = launch._workspaces.pop(key, None)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=side):
                fn()
            fail(f'{name}: a capture that grows the kernel workspace did not '
                 'raise')
        except RuntimeError as e:
            require('before capture' in str(e),
                    f'{name}: capture growth raised {e!r}')
        finally:
            launch._workspaces.pop(key, None)
            if kept is not None:
                launch._workspaces[key] = kept
    print(f'  ok: growing the workspace during capture raises '
          f'({", ".join(growers)})', flush=True)


def _matvec_cols_checks(torch, rmn, dtype, seed):
    """Rows 9-10 on one (R, m, n) case, a stack of two: the kernel within
    COLS_TOL of each output's scale of its plain version; the W=2 and W=4
    band partials (``factor_sharded._band`` / ``_matvec_partial`` with
    explicit ranks, through the kernel) summed on the card against the
    float64 product within tests/test_kernels.py's atol 1e-4·√m, rtol 1e-4;
    stacked against per item bit for bit.  Returns the max abs error
    against the plain version."""
    from repro_torch.core import factor_sharded as fsh
    from repro_torch.kernels import matvec as mv
    from repro_torch.kernels import ref
    r, m, n = rmn
    gen = torch.Generator(device='cuda').manual_seed(seed)
    g = torch.randn((2, m, n), generator=gen, device='cuda').to(dtype)
    a = torch.randn((2, r, m), generator=gen, device='cuda')
    tag = f'matvec_cols {r}x{m}x{n} {str(dtype).rsplit(".", 1)[-1]}'
    u = mv.matvec_cols_stacked(g, a)
    e = (u - ref.matvec_cols_ref(g, a)).abs()
    scale = ref.matvec_cols_ref(g.abs(), a.abs())
    require(bool((e <= COLS_TOL * scale).all()),
            f'{tag}: err {e.max().item():.3e} > {COLS_TOL} x scale')
    whole = torch.matmul(a.double(), g.double())
    worst = {}
    for world in (2, 4):
        total = sum(fsh._matvec_partial(fsh._band(g, world, rank), a, world,
                                        rank, impl='cuda')
                    for rank in range(world))
        ew = (total.double() - whole).abs()
        lim = 1e-4 * m ** 0.5 + 1e-4 * whole.abs()
        require(bool((ew <= lim).all()),
                f'{tag}: W={world} band sum err {ew.max().item():.3e}')
        worst[world] = (ew / lim).max().item()
    for i in range(2):
        require(torch.equal(mv.matvec_cols(g[i], a[i]), u[i]),
                f'{tag}: stacked != item {i}')
    plan = mv.cols_plan(r, n, mv._sm_count(g.get_device()))
    print(f'  ok {tag}: err {e.max().item():.2e} '
          f'({(e / scale).max().item():.2e} of scale); band sums W=2 '
          f'{worst[2]:.2e}, W=4 {worst[4]:.2e} of their limit; tile '
          f'{plan[1]}x{plan[2]}, grid {plan[3]}x{plan[4]}x2', flush=True)
    return e.max().item()


def _eva_f_checks(torch, g, a, m, tag, float32):
    """Rows 6-8 on one case: matvec and eva_f_fused against their plain
    versions, the fused kernel (fold off) against the composed matvec +
    rank1_update kernels, and stacked against per item bit for bit.
    Returns matvec's max abs error and its largest ratio to the column
    scale, the fused output's max abs error against the plain version, and
    (f32) its max abs difference from composed Eva-f, held to 0."""
    from repro_torch.kernels import fused, ops, ref
    from repro_torch.kernels import matvec as mv
    # matvec: each column held against its own scale Σ|a_i g_ij|
    u, asq = mv.matvec_and_norm_stacked(g, a)
    e = (u - ref.matvec_ref(g, a)).abs()
    col_scale = ref.matvec_ref(g.abs(), a.abs())
    require(bool((e <= MATVEC_TOL * col_scale).all()),
            f'matvec {tag}: err {e.max().item():.3e} > {MATVEC_TOL} x scale')
    require(torch.allclose(asq, (a * a).sum(-1), rtol=1e-5, atol=0),
            f'matvec norm {tag}')
    e_fused = 0.0
    outs = {}
    for fold in (False, True):
        out, aux = fused.eva_f_fused_stacked(g, a, GAMMA, m, MU, fold)
        o_want, a_want = ref.eva_f_fused_ref(g, a, GAMMA, m, MU, fold)
        eo = (GAMMA * out - GAMMA * o_want).abs()
        require(bool((eo <= FUSED_TOL + FUSED_TOL *
                      (GAMMA * o_want).abs()).all()),
                f'eva_f_fused fold={fold} {tag}: err {eo.max().item():.3e}')
        ea = (aux - a_want).abs()
        require(bool((ea <= 1e-4 + 2e-5 * a_want.abs()).all()),
                f'eva_f_fused aux fold={fold} {tag}: err '
                f'{ea.max().item():.3e}')
        e_fused = max(e_fused, (out - o_want).abs().max().item())
        outs[fold] = (out, aux)
    # without the fold the kernel reads no m: a null m gives the same bits
    o0, x0 = fused.eva_f_fused_stacked(g, a, GAMMA, None, MU, False)
    require(torch.equal(o0, outs[False][0]) and
            torch.equal(x0, outs[False][1]),
            f'eva_f_fused m=None != m given {tag}')
    # fold off against composed Eva-f (matvec, PyTorch's c = 1 / (γ +
    # ‖a‖²), rank1_update): the same bits, since the emit kernel rounds c
    # and each element as those do; in f32 only, since the composed P is
    # rounded to G's dtype
    e_comp = 0.0
    if float32:
        comp = ops.eva_f_precondition(g, a, GAMMA, impl='cuda')
        e_comp = (outs[False][0] - comp).abs().max().item()
        require(torch.equal(outs[False][0], comp),
                f'eva_f_fused (fold off) vs composed Eva-f {tag}: err '
                f'{e_comp:.3e}, not the same bits')
    for i in range(g.shape[0] if g.shape[0] > 1 else 0):
        sl = slice(i, i + 1)
        u1, asq1 = mv.matvec_and_norm_stacked(g[sl], a[sl])
        require(torch.equal(u1, u[sl]) and torch.equal(asq1, asq[sl]),
                f'matvec stacked != item {i} {tag}')
        for fold, (out, aux) in outs.items():
            o1, x1 = fused.eva_f_fused_stacked(g[sl], a[sl], GAMMA, m[sl],
                                               MU, fold)
            require(torch.equal(o1, out[sl]) and torch.equal(x1, aux[sl]),
                    f'eva_f_fused fold={fold} stacked != item {i} {tag}')
        require(torch.equal(ops.eva_f_precondition(g[i], a[i], GAMMA),
                            ops.eva_f_precondition(g, a, GAMMA)[i]),
                f'ops.eva_f_precondition stacked != leaf {i} {tag}')
    return (e.max().item(), (e / col_scale).max().item(), e_fused, e_comp)


# ---------------------------------------------------------------------------
# 4. the main path: full-width autoencoder, composed and fused


def _make_opt(name, lr, fused, impl, shard=None, interval=1, opt_kw=None):
    """(optimizer, capture, factor config): the rank-one optimizers take
    the kernel impl as ``kernel_impl``; K-FAC and Shampoo take it with the
    sharded-factor config ``shard`` (None: every factor dense), and
    refresh their inverses or roots every ``interval`` steps.  ``opt_kw``:
    more options of the optimizer."""
    from repro_torch.core.factor_sharded import FactorShardConfig
    from repro_torch.core.registry import make_optimizer
    opt_kw = opt_kw or {}
    if name in MAIN_PATHS:
        opt, cap = make_optimizer(name, lr=lr, fused=fused, kernel_impl=impl,
                                  **opt_kw)
        return opt, cap, None
    if name not in ('kfac', 'shampoo', 'foof'):
        # the first-order chains and M-FAC: no fused tail, no interval
        opt, cap = make_optimizer(name, lr=lr, **opt_kw)
        return opt, cap, None
    opt, cap = make_optimizer(name, lr=lr, fused=fused, interval=interval,
                              **opt_kw)
    return opt, cap, (None if shard is None
                      else FactorShardConfig(**shard, impl=impl))


def _train(torch, model, params0, batches, *, fused, impl, lr, name='eva',
           shard=None, interval=1, taps_fn=None, opt_kw=None, step_ms=None):
    """(losses, step, params, state) after a step on each batch; each
    step's host-clock ms (synchronized) goes to the list ``step_ms`` where
    one is given."""
    from repro_torch.train.step import init_opt_state, make_train_step
    opt, cap, factor = _make_opt(name, lr, fused, impl, shard, interval,
                                 opt_kw)
    state = init_opt_state(model, opt, cap, params0, batches[0],
                           taps_fn=taps_fn, factor=factor, device='cuda')
    step = make_train_step(model, opt, cap, taps_fn=taps_fn, factor=factor,
                           device='cuda')
    params, losses = params0, []
    for batch in batches:
        if step_ms is not None:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        params, state, metrics = step(params, state, batch)
        if step_ms is not None:
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics['loss'])
    return torch.stack(losses).cpu().tolist(), step, params, state


def _compare_trajectories(kernel, plain, what):
    for i, (k, p) in enumerate(zip(kernel, plain)):
        require(abs(k - p) <= TRAJ_RTOL * abs(p),
                f'{what}: step {i} loss {k!r} (kernels) vs {p!r} (plain), '
                f'beyond {TRAJ_RTOL} relative')


def _compare_steps(torch, model, params0, batches, *, fused, lr, name,
                   what, shard=None, taps_fn=None, opt_kw=None):
    """Take each step of the kernel path's run a second time with the plain
    step, from the same parameters, state and batch, and hold each leaf's
    change to PARAM_RTOL of the plain change's norm.  The parameters keep
    moving where the loss barely does, and one step from one state carries
    no drift from earlier steps.  Returns the largest ratio."""
    from repro_torch.train.step import init_opt_state, make_train_step
    steps = {}
    for impl in ('auto', 'torch'):
        opt, cap, factor = _make_opt(name, lr, fused, impl, shard,
                                     opt_kw=opt_kw)
        steps[impl] = make_train_step(model, opt, cap, taps_fn=taps_fn,
                                      factor=factor, device='cuda')
    state = init_opt_state(model, opt, cap, params0, batches[0],
                           taps_fn=taps_fn, factor=factor, device='cuda')
    params, worst = params0, 0.0
    for i, batch in enumerate(batches):
        plain, _, _ = steps['torch'](params, state, batch)
        nxt, state, _ = steps['auto'](params, state, batch)
        for path, p in params.items():
            dk = nxt[path].float() - p.float()
            dp = plain[path].float() - p.float()
            ref_norm = torch.linalg.vector_norm(dp).item()
            require(ref_norm > 0, f'{what}: step {i} left {path} unmoved')
            rel = torch.linalg.vector_norm(dk - dp).item() / ref_norm
            require(rel <= PARAM_RTOL,
                    f'{what}: step {i} changes {path} by {rel:.3e} of the '
                    f'plain change away from it, beyond {PARAM_RTOL}')
            worst = max(worst, rel)
        params = nxt
    return worst


def _path_kernels():
    """kernel -> (wrapper module, wrapper's name, its plain version on the
    same arguments).  Each kernel's unstacked wrapper calls the one named
    (its stacked wrapper; rank1_update's and matvec's launch function), so
    these see every call."""
    from repro_torch.kernels import (bilinear, dispatch, fused, matvec,
                                     rank1_update, ref)
    return {
        'bilinear': (bilinear, 'bilinear_and_norms_stacked',
                     ref.bilinear_and_norms_ref),
        'rank1_update': (rank1_update, '_launch',
                         lambda g, a, b, c, s, *_: ref.rank1_update_ref(
                             g, a, b, *dispatch._pair(c, s))),
        'matvec': (matvec, '_launch',
                   lambda g, a, *_: ref.matvec_and_norm_ref(g, a)),
        'eva_fused': (fused, 'eva_fused_stacked', ref.eva_fused_ref),
        'eva_f_fused': (fused, 'eva_f_fused_stacked', ref.eva_f_fused_ref),
        'matvec_cols': (matvec, 'matvec_cols_stacked', ref.matvec_cols_ref),
    }


@contextlib.contextmanager
def _recording(torch, host=False):
    """While a path runs, keep a copy of the arguments of each kernel's last
    call per operand shape (in host memory with ``host``), and count the
    calls per shape; yields ``({(kernel, shape): (args, kwargs)},
    {(kernel, shape): calls})``."""
    seen, calls, saved = {}, collections.Counter(), []
    copy = (lambda x: x.to('cpu', copy=True)) if host else \
        (lambda x: x.clone())
    for name, (mod, attr, _) in _path_kernels().items():
        fn = getattr(mod, attr)

        def spy(*args, _fn=fn, _name=name, **kw):
            key = (_name, tuple(args[0].shape))
            seen[key] = (
                [copy(x) if torch.is_tensor(x) else x for x in args], kw)
            calls[key] += 1
            return _fn(*args, **kw)
        saved.append((mod, attr, fn))
        setattr(mod, attr, spy)
    try:
        yield seen, calls
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def _check_path_inputs(torch, seen, what):
    """Hold each recorded call against its plain version on the very inputs
    the path gave it, with phase 3's limits.  Returns, per kernel, the
    largest error as a share of its limit, and for each rank1_update call
    the share of its elements that the rank-one term moves off s·G (0 where
    the term is below G's rounding)."""
    from repro_torch.kernels import dispatch, ref
    kernels = _path_kernels()
    worst, moved = {}, []
    for (name, shape), (args, kw) in sorted(seen.items()):
        mod, attr, plain = kernels[name]
        args = [x.cuda() if torch.is_tensor(x) else x for x in args]
        got, want = getattr(mod, attr)(*args, **kw), plain(*args, **kw)
        g, a = args[0], args[1]
        tol = TOL[str(g.dtype).rsplit('.', 1)[-1]]
        tag = f'{what}: {name} on the path\'s {"x".join(map(str, shape))}'
        if name == 'matvec_cols':
            lim = COLS_TOL * ref.matvec_cols_ref(g.abs(), a.abs())
            e = (got - want).abs()
            require(bool((e <= lim).all()), f'{tag}: err {e.max().item():.3e}'
                    f' beyond its limit')
            share = (e / torch.where(lim > 0, lim, 1.0)).max().item()
        elif name in ('bilinear', 'matvec'):
            if name == 'bilinear':
                lim = tol * ref.bilinear_ref(g.abs(), a.abs(), args[2].abs())
            else:
                lim = MATVEC_TOL * ref.matvec_ref(g.abs(), a.abs())
            e = (got[0] - want[0]).abs()
            require(bool((e <= lim).all()), f'{tag}: err {e.max().item():.3e}'
                    f' beyond its limit')
            share = (e / torch.where(lim > 0, lim, 1.0)).max().item()
            require(torch.allclose(got[1], want[1], rtol=1e-5, atol=0),
                    f'{tag}: norms')
        elif name == 'rank1_update':
            e = (got.float() - want.float()).abs()
            share = (e / (tol + tol * want.float().abs())).max().item()
            scale = dispatch._pair(args[3], args[4])[1]
            sg = (scale[..., None, None] * g.float()).to(g.dtype)
            moved.append((got != sg).float().mean().item())
        else:
            gamma = args[3] if name == 'eva_fused' else args[2]
            eo = (gamma * got[0] - gamma * want[0]).abs()
            share = (eo / (FUSED_TOL + FUSED_TOL * (gamma * want[0]).abs())
                     ).max().item()
            ea = (got[1] - want[1]).abs()
            require(bool((ea <= 1e-4 + 2e-5 * want[1].abs()).all()),
                    f'{tag}: aux err {ea.max().item():.3e}')
        require(share <= 1.0, f'{tag}: err {share:.3e} of its limit')
        worst[name] = max(worst.get(name, 0.0), share)
    return worst, moved


def ae_setup(torch):
    from repro_torch.data.synthetic import AEStream
    from repro_torch.models import module as M
    from repro_torch.models.simple import ae_loss_fn, autoencoder
    model = autoencoder()
    model.loss_fn = ae_loss_fn(model)
    params0 = M.init_params(model.param_specs(),
                            torch.Generator().manual_seed(0), device='cuda')
    data = AEStream(batch=1000, device='cuda')
    batches = [data.batch_at(i) for i in range(STEPS)]
    return model, params0, batches


def _check_path(torch, model, params0, batches, *, name, lr, fused, want,
                learned, tag, shard=None, taps_fn=None, opt_kw=None):
    """One optimizer's run with the kernels (``impl='auto'``), held to the
    plain run (``'torch'``): exactly the launches ``want`` ({kernel:
    launches in the run}), finite losses, ``learned(losses, params, tag)``
    (raises unless the run learned, returns what it read), no launch on the
    plain path, each step's loss within TRAJ_RTOL and each step's change
    within PARAM_RTOL of the plain path's, and each kernel launched against
    its plain version on the last inputs the path gave it.  Returns what it
    read."""
    from repro_torch.kernels import launches
    kw = dict(fused=fused, lr=lr, name=name, shard=shard, taps_fn=taps_fn,
              opt_kw=opt_kw)
    step_ms = []
    with _recording(torch) as (seen, calls):
        launches.reset()
        run = _train(torch, model, params0, batches, impl='auto',
                     step_ms=step_ms, **kw)
        got = launches.snapshot()
    losses, params = run[0], run[2]
    del run
    want = {k: want.get(k, 0) for k in launches.COUNTS}
    require(got == want, f'{tag}: launches {got} != {want}')
    require(all(map(math.isfinite, losses)),
            f'{tag}: non-finite loss {losses}')
    learnt = learned(losses, params, tag)
    del params
    launches.reset()
    plain = _train(torch, model, params0, batches, impl='torch', **kw)[0]
    require(sum(launches.snapshot().values()) == 0,
            f"{tag}: impl='torch' launched a kernel")
    _compare_trajectories(losses, plain, tag)
    prel = _compare_steps(torch, model, params0, batches, what=tag, **kw)
    kerr, moved = _check_path_inputs(torch, seen, tag)
    require(set(kerr) == {k for k, v in want.items() if v},
            f'{tag}: kernels checked {sorted(kerr)}')
    rel = max(abs(k - p) / abs(p) for k, p in zip(losses, plain))
    print(f'  {tag}: launches {got}; loss {losses[0]:.6f} -> '
          f'{losses[-1]:.6f}'
          + ('' if learnt is None else
             f' (first batch {learnt[0]:.6f} -> {learnt[1]:.6f})')
          + f'; max rel diff to plain {rel:.2e}; step change vs plain '
          f'{prel:.2e} of its norm; on the path\'s last inputs, error as a '
          f'share of its limit '
          f'{ {k: float(f"{v:.2e}") for k, v in kerr.items()} }'
          + (f'; the rank-one term moves {min(moved):.2e} to '
             f'{max(moved):.2e} of P\'s elements' if moved else ''),
          flush=True)
    return {'launches': got, 'calls': dict(calls), 'losses': losses,
            'plain_losses': plain, 'learned': learnt,
            'max_rel_loss_diff': rel, 'step_change_vs_plain': prel,
            'err_share_of_limit': kerr, 'step_ms': step_ms}


def _falls(losses, params, tag):
    """``learned`` of the autoencoder's runs: the loss falls over the run."""
    _finite_and_falling(losses, tag)


def main_phase(torch, model, params0, batches, paths, learned, what):
    """Each optimizer of ``paths`` ({name: (lr, more options, kernels
    launched once per preconditioned weight and step composed, the same
    fused)}), composed and fused, held by _check_path; ``what`` names the
    model in tags and JSON keys.  Returns the launches of all runs and the
    launches per step of each."""
    from repro_torch.kernels import launches
    calls = len(model.precon_paths())
    counts = {k: 0 for k in launches.COUNTS}
    per_step, info = {}, {}
    for name, (lr, kw, composed, fused_names) in paths.items():
        for fused in (False, True):
            tag = f'{what} {name} fused={fused}'
            want = {k: calls * len(batches)
                    for k in (fused_names if fused else composed)}
            res = _check_path(torch, model, params0, batches, name=name,
                              lr=lr, fused=fused, want=want, learned=learned,
                              tag=tag, opt_kw=kw)
            for k, v in res['launches'].items():
                counts[k] += v
            per_step[tag] = {k: v // len(batches)
                             for k, v in res['launches'].items() if v}
            info[tag] = {k: v for k, v in res.items()
                         if k not in ('launches', 'calls')}
    print(json.dumps({f'{what}_checks': info}))
    print(json.dumps({f'{what}_launches_per_step': per_step}))
    return counts, per_step


# ---------------------------------------------------------------------------
# 4b. K-FAC and Shampoo with sharded factor heads


def _finite_and_falling(losses, tag):
    require(all(map(lambda x: x == x and abs(x) < float('inf'), losses)),
            f'{tag}: non-finite loss {losses}')
    require(losses[-1] < losses[0],
            f'{tag}: loss did not fall ({losses[0]} -> {losses[-1]})')


def _rel_change(p0, pa, pb):
    """‖Δa − Δb‖ / ‖Δb‖ over all leaves, Δ = p − p0."""
    num = den = 0.0
    for k, v in p0.items():
        da, db = pa[k].double() - v.double(), pb[k].double() - v.double()
        num += ((da - db) ** 2).sum().item()
        den += (db ** 2).sum().item()
    return (num / den) ** 0.5


def solver_phase(torch, model, params0, batches):
    phase('4b solvers: K-FAC and Shampoo, factor sides of width 1000 '
          'sharded, on the full-width autoencoder')
    from repro_torch.core import bucketing
    from repro_torch.core import factor_sharded as fsh
    from repro_torch.kernels import launches
    plan = bucketing.build_plan({p: params0[p]
                                 for p in sorted(model.precon_paths())})
    _, heads = fsh.split_plan(plan, fsh.FactorShardConfig(**SHARD))
    sides = sum(p == 'shard' for pol in heads.values() for p in pol)
    require(sides == 4, f'{sides} sharded sides at threshold 1000: {heads}')
    want = {'matvec_cols': sides * SHARD['solve_iters'] * STEPS}
    counts = {k: 0 for k in launches.COUNTS}
    per_step, info = {}, {}
    for name, (lr, shard) in SOLVER_PATHS.items():
        for fused in (False, True):
            tag = f'ae {name} shard fused={fused}'
            res = _check_path(torch, model, params0, batches, name=name,
                              lr=lr, fused=fused, want=want, learned=_falls,
                              tag=tag, shard=shard)
            for k, v in res['launches'].items():
                counts[k] += v
            per_step[tag] = {k: v // STEPS
                             for k, v in res['launches'].items() if v}
            info[tag] = {k: v for k, v in res.items()
                         if k not in ('launches', 'calls', 'learned')}
        # dense: explicit inverses (K-FAC) or eigh roots (Shampoo) of every
        # side, no hand kernel; how far the shard step lies from it
        launches.reset()
        dense, *_ = _train(torch, model, params0, batches, fused=False,
                           impl='auto', lr=lr, name=name)
        require(sum(launches.snapshot().values()) == 0,
                f'{name} dense launched a kernel')
        _finite_and_falling(dense, f'{name} dense')
        _, _, p_dense1, _ = _train(torch, model, params0, batches[:1],
                                   fused=False, impl='auto', lr=lr,
                                   name=name)
        _, _, p_shard1, _ = _train(torch, model, params0, batches[:1],
                                   fused=False, impl='auto', lr=lr,
                                   name=name, shard=shard)
        gap = _rel_change(params0, p_shard1, p_dense1)
        shard_losses = info[f'ae {name} shard fused=False']['losses']
        info[f'ae {name} dense'] = {'losses': dense,
                                    'first_step_shard_vs_dense': gap}
        print(f'  {name} dense: loss {dense[0]:.6f} -> {dense[-1]:.6f} '
              f'(shard: {shard_losses[-1]:.6f}); the first shard step lies '
              f'{gap:.3e} of the dense step\'s norm from it (information, '
              f'not a gate)', flush=True)
    print(json.dumps({'solver_checks': info}))
    print(json.dumps({'solver_launches_per_step': per_step}))
    i_counts = _interval_checks(torch, model, params0, batches)
    counts = {k: counts[k] + i_counts[k] for k in counts}
    return counts, per_step


def _dense_refresh_kernels(names):
    """The kernels among ``names`` that belong to a dense inverse or eigh."""
    return sorted(k for k in names
                  if any(p in k.lower() for p in DENSE_REFRESH_KERNELS))


def _step_device_kernels(torch, step, params, state, batch):
    """{device kernel: launches} of one step, from the profiler, and the
    step's outputs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        params, state, _ = step(params, state, batch)
        torch.cuda.synchronize()
    return ({e.key: e.count for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA}, params, state)


def _interval_checks(torch, model, params0, batches):
    """K-FAC and Shampoo (shard) refreshing every INTERVAL steps beside
    every step, INTERVAL steps each from the same start: the kernel path
    within TRAJ_RTOL of the plain path per step, 128 matvec_cols launches a
    step, each step's host-clock ms (ending in a synchronize); the
    profiler's device kernels of the refresh step (step 0) and of a skip
    step (step 1): the dense inverses or eigh in the first and none in the
    second.  Shampoo's skip steps, whose twelve dense sides keep their
    roots, are held to a median at least INTERVAL_SAVING_MS below the
    every-step median of the same call.  Returns the launch counts."""
    from repro_torch.kernels import launches
    from repro_torch.train.step import init_opt_state, make_train_step
    counts = {k: 0 for k in launches.COUNTS}
    out = {}
    run = batches[:INTERVAL]
    for name, (lr, shard) in SOLVER_PATHS.items():
        ms = {}
        for interval in (1, INTERVAL):
            opt, cap, factor = _make_opt(name, lr, False, 'auto', shard,
                                         interval)
            step = make_train_step(model, opt, cap, factor=factor,
                                   device='cuda')
            state = init_opt_state(model, opt, cap, params0, run[0],
                                   factor=factor, device='cuda')
            params, times, losses = params0, [], []
            launches.reset()
            for batch in run:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, state, met = step(params, state, batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                losses.append(met['loss'])
            got = launches.snapshot()
            want = {k: (128 * len(run) if k == 'matvec_cols' else 0)
                    for k in launches.COUNTS}
            require(got == want, f'{name} interval={interval}: launches '
                    f'{got} != {want}')
            for k, v in got.items():
                counts[k] += v
            losses = torch.stack(losses).cpu().tolist()
            _finite_and_falling(losses, f'{name} interval={interval}')
            ms[interval] = times
            if interval == INTERVAL:
                plain, *_ = _train(torch, model, params0, run, fused=False,
                                   impl='torch', lr=lr, name=name,
                                   shard=shard, interval=interval)
                _compare_trajectories(losses, plain,
                                      f'autoencoder {name} shard interval='
                                      f'{interval}')
                rel = max(abs(k - p) / abs(p) for k, p in zip(losses, plain))
        # the device kernels of the refresh step and of a skip step
        opt, cap, factor = _make_opt(name, lr, False, 'auto', shard, INTERVAL)
        step = make_train_step(model, opt, cap, factor=factor, device='cuda')
        state = init_opt_state(model, opt, cap, params0, run[0],
                               factor=factor, device='cuda')
        k_refresh, params, state = _step_device_kernels(torch, step, params0,
                                                        state, run[0])
        k_skip, _, _ = _step_device_kernels(torch, step, params, state,
                                            run[1])
        dense_refresh = _dense_refresh_kernels(k_refresh)
        dense_skip = _dense_refresh_kernels(k_skip)
        require(dense_refresh, f'{name}: no dense inverse or eigh kernel '
                f'found in the refresh step: {sorted(k_refresh)}')
        require(not dense_skip, f'{name}: the skip step launched {dense_skip}')
        every = statistics.median(ms[1])
        skip = statistics.median(ms[INTERVAL][1:])
        out[name] = {
            'every_step_ms': ms[1], 'interval_ms': ms[INTERVAL],
            'every_step_median_ms': every, 'skip_median_ms': skip,
            'refresh_step_ms': ms[INTERVAL][0],
            'max_rel_loss_diff_to_plain': rel,
            'refresh_step_device_kernels': sum(k_refresh.values()),
            'skip_step_device_kernels': sum(k_skip.values()),
            'refresh_step_dense_kernels': {k[:80]: k_refresh[k]
                                           for k in dense_refresh},
            'refresh_only_kernels': [k[:80] for k in sorted(
                set(k_refresh) - set(k_skip))][:20],
        }
        print(f'  {name} shard interval={INTERVAL}: skip steps median '
              f'{skip:.2f} ms, every-step median {every:.2f} ms, refresh '
              f'step {ms[INTERVAL][0]:.2f} ms; device kernels refresh '
              f'{sum(k_refresh.values())}, skip {sum(k_skip.values())}; '
              f'dense refresh kernels only in the refresh step '
              f'({len(dense_refresh)} names); max rel loss diff to plain '
              f'{rel:.2e}', flush=True)
        if name == 'shampoo':
            require(skip <= every - INTERVAL_SAVING_MS,
                    f'shampoo: skip steps median {skip:.2f} ms not '
                    f'{INTERVAL_SAVING_MS} ms below the every-step median '
                    f'{every:.2f} ms')
    print(json.dumps({'solver_interval': out}))
    return counts


# ---------------------------------------------------------------------------
# 5. a stacked bucket


def stacked_phase(torch):
    phase('5 stacked bucket: MLP 784-1000-1000-1000-1000-10, Eva, Eva-f '
          'and K-FAC (sharded)')
    from repro_torch.core import bucketing
    from repro_torch.data.synthetic import ClassStream
    from repro_torch.kernels import launches
    from repro_torch.models import module as M
    from repro_torch.models.simple import MLP, classifier_loss_fn
    model = MLP([784, 1000, 1000, 1000, 1000, 10])
    model.loss_fn = classifier_loss_fn(model)
    params0 = M.init_params(model.param_specs(),
                            torch.Generator().manual_seed(1), device='cuda')
    plan = bucketing.build_plan({p: params0[p]
                                 for p in sorted(model.precon_paths())})
    stacked = [b.key for b in plan.buckets if b.stacked]
    require(stacked == ['float32_1000x1000'], f'stacked buckets {stacked}')
    data = ClassStream(batch=512, dim=784, classes=10, device='cuda')
    batches = [data.batch_at(i) for i in range(5)]
    per_step = len(plan.buckets)         # one call per bucket or 1-path leaf
    for name in ('eva', 'eva_f'):
        _, _, composed, fused_names = MAIN_PATHS[name]
        for fused in (False, True):
            launches.reset()
            losses, *_ = _train(torch, model, params0, batches, fused=fused,
                                impl='auto', lr=0.1, name=name)
            got = launches.snapshot()
            names = fused_names if fused else composed
            require(all(got[k] == per_step * len(batches) for k in names),
                    f'stacked {name} fused={fused}: launches {got}')
            plain, *_ = _train(torch, model, params0, batches, fused=fused,
                               impl='torch', lr=0.1, name=name)
            _compare_trajectories(losses, plain, f'MLP {name} fused={fused}')
            require(losses[-1] < losses[0],
                    f'MLP {name} fused={fused}: loss did not fall '
                    f'({losses[0]} -> {losses[-1]})')
            print(f'  {name} fused={fused}: buckets '
                  f'{[b.key for b in plan.buckets]}; launches {got}; loss '
                  f'{losses[0]:.4f} -> {losses[-1]:.4f}', flush=True)
    # K-FAC, threshold 1000: the 3x1000x1000 bucket shards both sides
    # (matvec_cols_stacked, L=3), fc0 its out side and fc4 its in side
    # (matvec_cols); 32 CG iterations each
    _, shard = SOLVER_PATHS['kfac']
    iters = shard['solve_iters']
    for fused in (False, True):
        tag = f'MLP kfac shard fused={fused}'
        with _recording(torch) as (seen, calls):
            launches.reset()
            losses, *_ = _train(torch, model, params0, batches, fused=fused,
                                impl='auto', lr=0.1, name='kfac',
                                shard=shard)
            got = launches.snapshot()
        n = len(batches)
        # fc0's out and fc4's in factor are both 1000 x 1000 bands
        want_calls = {('matvec_cols', (3, 1000, 1000)): 2 * iters * n,
                      ('matvec_cols', (1, 1000, 1000)): 2 * iters * n}
        require(dict(calls) == want_calls, f'{tag}: calls {dict(calls)}')
        require(got['matvec_cols'] == 4 * iters * n and
                sum(got.values()) == got['matvec_cols'],
                f'{tag}: launches {got}')
        plain, *_ = _train(torch, model, params0, batches, fused=fused,
                           impl='torch', lr=0.1, name='kfac', shard=shard)
        _compare_trajectories(losses, plain, tag)
        prel = _compare_steps(torch, model, params0, batches, fused=fused,
                              lr=0.1, name='kfac', what=tag, shard=shard)
        kerr, _ = _check_path_inputs(torch, seen, tag)
        _finite_and_falling(losses, tag)
        print(f'  kfac shard fused={fused}: launches per step '
              f'{got["matvec_cols"] // n} ({2 * iters} stacked L=3); loss '
              f'{losses[0]:.4f} -> {losses[-1]:.4f}; step change vs plain '
              f'{prel:.2e} of its norm; matvec_cols err '
              f'{kerr["matvec_cols"]:.2e} of its limit', flush=True)


# ---------------------------------------------------------------------------
# 6. times


def _time_ms(torch, fn, iters, repeats=3, warmup=5):
    """Median over ``repeats`` of the mean ms per call of ``fn`` between two
    CUDA events, after ``warmup`` calls.  Host launch gaps count: the card
    waits for them too."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(repeats):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        e1.synchronize()
        means.append(e0.elapsed_time(e1) / iters)
    return statistics.median(means)


def _graph_ms(torch, fn, iters, warmup=5, repeats=3):
    """The same, with ``fn`` captured into a CUDA graph and replayed: the
    device time without the host's launch cost."""
    graph, _ = _capture(torch, fn)
    return _time_ms(torch, graph.replay, iters, repeats, warmup=warmup)


def _device_launches(torch, fn, calls, traces=3):
    """Device kernels per wrapper call in one run of ``fn`` (``calls``
    wrapper calls), from the profiler: (all of them, the port's own).
    A trace can lose a kernel's event (CUPTI dropped one of eight bilinear
    launches in one run on an H100), so a trace may count a launch short
    but never one over: each count is the largest of ``traces`` traced
    runs, which still sees every launch too many."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    every, port = 0, 0
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        every = max(every, sum(e.count for e in events))
        port = max(port, sum(e.count for e in events if 'repro::' in e.key))
    return every / calls, port / calls


def _host_us(torch, fn, reps, calls):
    """Host µs per wrapper call: the enqueue rate of ``reps`` runs of
    ``fn`` (``calls`` wrapper calls each) on an idle card, with no
    synchronize inside the window."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / (reps * calls)


def _launch_floor(torch):
    """µs per launch of a kernel that does nothing (``repro_empty`` of
    common.cuh, one 32-thread block), 100 launches replayed from a CUDA
    graph, and the host µs per eager launch through ctypes."""
    from repro_torch.kernels import build
    lib = build.library('rank1_update', {})
    lib.repro_empty.argtypes = [build.P]
    lib.repro_empty.restype = build.I32

    def hundred():
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(100):
            lib.repro_empty(stream)
    return {'graph_us_per_launch': _graph_ms(torch, hundred, 20) * 10,
            'eager_us_per_launch': _time_ms(torch, hundred, 20) * 10,
            'host_us_per_launch': _host_us(torch, hundred, 5, 100)}


def _rank1_largest(torch, layer):
    """rank1_update on the largest layer (784 x 1000) alone, beside
    torch.addr on it: µs per call, 20 calls replayed from one graph, against
    the byte bound.  G and P (6.3 MB) stay in the 50 MB L2 from one call to
    the next, as the gradient does between the backward pass and the
    optimizer."""
    from repro_torch.kernels import rank1_update as r1
    g, a, b, _, c, s, ac = layer
    n_bytes = 4 * (2 * g.numel() + a.numel() + b.numel() + 2)
    bound_us = _bound(n_bytes, 4 * g.numel())[0] * 1e3
    graph_us = _graph_ms(torch, lambda: [r1.rank1_update(g, a, b, c, s)
                                         for _ in range(20)], 50) * 1e3 / 20
    addr_us = _graph_ms(torch, lambda: [torch.addr(g, ac, b, beta=1 / GAMMA,
                                                   alpha=-1 / GAMMA)
                                        for _ in range(20)], 50) * 1e3 / 20
    return {'largest_layer': 'x'.join(map(str, g.shape)),
            'largest_layer_graph_us': graph_us,
            'largest_layer_library_graph_us': addr_us,
            'largest_layer_bound_us': bound_us,
            'largest_layer_bound_share': bound_us / graph_us}


def _bound(n_bytes, n_flops):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def _layer_inputs(torch, shapes, seed, dtype=None):
    """One step's operands of rows 1-8, one weight of each shape in
    ``shapes`` (its layer stack leading where it has one): a random G (of
    ``dtype``, f32 by default), a, b and m, the rank-one coefficients c and
    s as the path hands them (device tensors: 0-d for a 2-D G, (L,) for a
    stack), and a pre-scaled by c for the library's one call."""
    from repro_torch.kernels import ref
    layers = []
    for i, shape in enumerate(shapes):
        g, a, b, m = _inputs(torch, tuple(shape), dtype or torch.float32,
                             seed + i)
        denom = GAMMA + (a * a).sum(-1) * (b * b).sum(-1)
        c = ref.bilinear_ref(g, a, b) / denom
        s = torch.full_like(denom, 1.0 / GAMMA)
        layers.append((g, a, b, m, c, s, a * c[..., None]))
    return layers


def _kernel_fns(torch, layers):
    """Rows 1-8 on one step's ``layers``: kernel -> (its wrapper calls, a
    call per weight, as the path makes them; their plain versions; the
    one-call library equivalent or None), and kernel -> (bytes: each input
    read once, each output written once; operations).  The library calls
    take the vectors in G's dtype (a bf16 G makes them bf16 products)."""
    from repro_torch.kernels import bilinear as bil
    from repro_torch.kernels import fused, ref
    from repro_torch.kernels import matvec as mv
    from repro_torch.kernels import rank1_update as r1
    # the fused kernels take every weight as a stack, a 2-D one as one of 1
    stacks = [(g, a, b, m) if g.dim() == 3 else (g[None], a[None], b[None],
                                                 m[None])
              for g, a, b, m, *_ in layers]
    sf = 1.0 / GAMMA
    fns = {
        'bilinear': (
            lambda: [bil.bilinear_and_norms(g, a, b) if g.dim() == 2 else
                     bil.bilinear_and_norms_stacked(g, a, b)
                     for g, a, b, *_ in layers],
            lambda: [ref.bilinear_and_norms_ref(g, a, b)
                     for g, a, b, *_ in layers],
            lambda: [torch.einsum('...io,...i,...o->...', g, a.to(g.dtype),
                                  b.to(g.dtype))
                     for g, a, b, *_ in layers]),
        'rank1_update': (
            lambda: [r1.rank1_update(g, a, b, c, s) if g.dim() == 2 else
                     r1.rank1_update_stacked(g, a, b, c, s)
                     for g, a, b, m, c, s, _ in layers],
            lambda: [ref.rank1_update_ref(g, a, b, c, s)
                     for g, a, b, m, c, s, _ in layers],
            # s·(G − (c a) bᵀ), a pre-scaled by each item's c: addr on a 2-D
            # G, baddbmm on a stack
            lambda: [torch.addr(g, ac.to(g.dtype), b.to(g.dtype), beta=sf,
                                alpha=-sf)
                     if g.dim() == 2 else
                     torch.baddbmm(g, ac.to(g.dtype)[..., None],
                                   b.to(g.dtype)[:, None, :], beta=sf,
                                   alpha=-sf)
                     for g, a, b, m, c, s, ac in layers]),
        'eva_fused': (
            lambda: [fused.eva_fused_stacked(g, a, b, GAMMA, m, MU, True)
                     for g, a, b, m in stacks],
            lambda: [ref.eva_fused_ref(g, a, b, GAMMA, m, MU, True)
                     for g, a, b, m, *_ in layers],
            None),
        'matvec': (
            lambda: [mv.matvec_and_norm(g, a) if g.dim() == 2 else
                     mv.matvec_and_norm_stacked(g, a)
                     for g, a, *_ in layers],
            lambda: [ref.matvec_and_norm_ref(g, a) for g, a, *_ in layers],
            lambda: [torch.einsum('...io,...i->...o', g, a.to(g.dtype))
                     for g, a, *_ in layers]),
        # fold_momentum=False, as on the path: m is not read
        'eva_f_fused': (
            lambda: [fused.eva_f_fused_stacked(g, a, GAMMA, None, MU, False)
                     for g, a, b, m in stacks],
            lambda: [ref.eva_f_fused_ref(g, a, GAMMA, m, MU, False)
                     for g, a, b, m, *_ in layers],
            None),
    }
    n = sum(g.numel() for g, *_ in layers)
    gb = sum(g.numel() * g.element_size() for g, *_ in layers)  # G, P
    vec_in = sum(a.numel() for _, a, *_ in layers)
    vec = vec_in + sum(b.numel() for _, _, b, *_ in layers)
    k = sum(c.numel() for *_, c, _, _ in layers)
    # G and rank1_update's P in G's dtype; m and the fused outputs f32
    work = {
        'bilinear': (gb + 4 * (vec + k), 3 * n),
        'rank1_update': (2 * gb + 4 * (vec + 2 * k), 4 * n),
        'eva_fused': (gb + 4 * (2 * n + vec + 3 * k), 15 * n),
        'matvec': (gb + 4 * (vec + k), 2 * n),
        'eva_f_fused': (gb + 4 * (n + vec_in + 3 * k), 12 * n),
    }
    return fns, work


def _times(torch, kern, plain, lib, work, calls, iters, warmup=5,
           host_reps=None, repeats=3):
    """ms of one run of each of ``kern``, ``plain`` and ``lib`` (``calls``
    wrapper calls each), eager and replayed from a CUDA graph (the median
    of ``repeats``), beside the bound of ``work`` (bytes, operations); host
    µs per call of ``kern`` and ``lib``."""
    bound_ms, bound_by = _bound(*work)
    host_reps = host_reps or max(1, 160 // calls)
    t = lambda fn: _time_ms(torch, fn, iters, repeats,  # noqa: E731
                            warmup=warmup)
    gr = lambda fn: _graph_ms(torch, fn, iters, warmup,  # noqa: E731
                              repeats)
    return {
        'ms': t(kern), 'graph_ms': gr(kern),
        'plain_ms': t(plain), 'plain_graph_ms': gr(plain),
        'bound_ms': bound_ms, 'bound_by': bound_by,
        'library_ms': None if lib is None else t(lib),
        'library_graph_ms': None if lib is None else gr(lib),
        'host_us_per_call': _host_us(torch, kern, host_reps, calls),
        'library_host_us_per_call': None if lib is None
        else _host_us(torch, lib, host_reps, calls),
    }


def _print_times(name, times):
    print(f'  {name}: ' + ', '.join(
        f'{key} {v:.4f}' for key, v in times.items()
        if isinstance(v, (int, float))), flush=True)


def times_phase(torch, err, counts, per_step, model, params0, batches):
    phase('6 times at the autoencoder shapes (one step = 8 layers; rows 9-10:'
          ' one step = 128 band products)')
    from repro_torch.kernels import matvec as mv
    layers = _layer_inputs(torch, AE_SHAPES, 100)
    fns, work = _kernel_fns(torch, layers)
    meta = {
        'bilinear': ('src/repro_torch/kernels/csrc/bilinear.cu',
                     'src/repro/kernels/bilinear.py:76', [1, 2]),
        'rank1_update': ('src/repro_torch/kernels/csrc/rank1_update.cu',
                         'src/repro/kernels/rank1_update.py:51', [3, 4]),
        'eva_fused': ('src/repro_torch/kernels/csrc/eva_fused.cu',
                      'src/repro/kernels/fused.py:142', [5]),
        'matvec': ('src/repro_torch/kernels/csrc/matvec.cu',
                   'src/repro/kernels/matvec.py:57', [6, 7]),
        'eva_f_fused': ('src/repro_torch/kernels/csrc/eva_f_fused.cu',
                        'src/repro/kernels/fused.py:194', [8]),
        'matvec_cols': ('src/repro_torch/kernels/csrc/matvec_cols.cu',
                        'src/repro/kernels/matvec.py:96', [9, 10]),
    }
    # rows 9-10: one K-FAC or Shampoo step's band products, 32 solver
    # iterations on each sharded side (R = 784, 500, 500, 784 vectors
    # against a symmetric 1000 x 1000 factor): 128 calls
    cols = []
    for seed, r in enumerate((784, 500, 500, 784)):
        gen = torch.Generator(device='cuda').manual_seed(200 + seed)
        x = torch.randn((1000, 1000), generator=gen, device='cuda')
        cols.append((((x + x.T) / 2).contiguous(),
                     torch.randn((r, 1000), generator=gen, device='cuda')))
    reps = SHARD['solve_iters']
    fns['matvec_cols'], work['matvec_cols'] = _cols_fns(torch, cols, reps)
    row_iters = {'matvec_cols': 5}
    # launches per call from one call on each band shape: the profiler may
    # drop events from a run of 128
    launch_probe = {'matvec_cols': (
        lambda: [mv.matvec_cols(g, a) for g, a in cols], len(cols))}
    calls = {name: len(layers) for name in fns}
    calls['matvec_cols'] = reps * len(cols)
    rows = []
    for name, (kern, plain, lib) in fns.items():
        per_call, port_per_call = _device_launches(
            torch, *launch_probe.get(name, (kern, calls[name])))
        port_want, all_want = DEVICE_LAUNCHES[name]
        require(port_per_call == port_want and
                all_want in (None, per_call),
                f'{name}: {per_call} device launches a call, {port_per_call} '
                f'of them the port\'s, not {(port_want, all_want)}')
        row = {
            'name': name, 'route': 'cuda', 'source': meta[name][0],
            'replaces': meta[name][1], 'jax_rows': meta[name][2],
            'launches': counts[name],
            'device_launches_per_call': per_call,
            'port_launches_per_call': port_per_call,
            'launches_per_step': {tag: c[name] for tag, c in per_step.items()
                                  if name in c},
            'max_abs_err': err[name],
            **_times(torch, kern, plain, lib, work[name], calls[name],
                     row_iters.get(name, 100)),
        }
        if name == 'matvec_cols':
            row['library'] = ('torch.matmul, allow_tf32='
                              f'{torch.backends.cuda.matmul.allow_tf32}')
        if name == 'rank1_update':
            row.update(_rank1_largest(torch, layers[0]))
        rows.append(row)
        _print_times(name, {k: v for k, v in row.items()
                            if k.endswith(('ms', 'call'))})
    print(json.dumps({'launch_floor': _launch_floor(torch)}), flush=True)

    _steps_and_profile(torch, model, params0, batches,
                       _rank_one_variants(MAIN_PATHS), list(MAIN_PATHS),
                       rounds=3, per_round=10, key='ae')
    # K-FAC and Shampoo: fewer, shorter rounds (Shampoo's dense sides run
    # eigh every step)
    _steps_and_profile(torch, model, params0, batches, _solver_variants(),
                       ['kfac'], rounds=2, per_round=3, key='solver')
    return rows


def _cols_fns(torch, cols, reps):
    """One solve's band products, ``reps`` iterations over ``cols`` ((G, A)
    pairs): (the kernel's calls, their plain versions, the library's), and
    (bytes, operations)."""
    from repro_torch.kernels import matvec as mv
    from repro_torch.kernels import ref
    work = (reps * sum(4 * (a.numel() + g.numel() + a.shape[0] * g.shape[1])
                       for g, a in cols),
            reps * sum(2 * a.shape[0] * g.shape[0] * g.shape[1]
                       for g, a in cols))
    return (
        lambda: [mv.matvec_cols(g, a) for _ in range(reps) for g, a in cols],
        lambda: [ref.matvec_cols_ref(g, a) for _ in range(reps)
                 for g, a in cols],
        # TF32 is off (phase 1): the library product is full f32
        lambda: [torch.matmul(a, g) for _ in range(reps) for g, a in cols],
    ), work


def _median_spread(xs):
    return {'median': statistics.median(xs), 'min': min(xs), 'max': max(xs)}


def _step_times(torch, model, params0, batches, variants, grads_only,
                rounds, per_round):
    """ms per step on the host clock (each timed window ends in a
    synchronize): the forward + backward alone with each optimizer's
    capture in ``grads_only``, and each step of ``variants`` ({key: (name,
    lr, fused, impl, shard, more options)}).  The variants run in turns, the
    order reversed every round, and each reports its median and range over
    the rounds."""
    from repro_torch.core.registry import capture_for
    from repro_torch.train.step import compute_grads_and_stats

    runs = {}
    for name in grads_only:
        def only(_, cap=capture_for(name)):
            for batch in batches[:per_round]:
                compute_grads_and_stats(model, params0, batch, cap)
        runs[f'grads_only_{name}_ms'] = only
    for key, (name, lr, fused_flag, impl, shard, opt_kw) in variants.items():
        *_, step, params, state = _train(
            torch, model, params0, batches[:3], fused=fused_flag, impl=impl,
            lr=lr, name=name, shard=shard, opt_kw=opt_kw)
        carry = {'params': params, 'state': state}

        def run(_, step=step, carry=carry):
            for batch in batches[:per_round]:
                carry['params'], carry['state'], _m = step(
                    carry['params'], carry['state'], batch)
        runs[key] = run
    times = {k: [] for k in runs}
    for r in range(rounds):
        for key in (list(runs) if r % 2 == 0 else list(reversed(runs))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[key](None)
            torch.cuda.synchronize()
            times[key].append((time.perf_counter() - t0) * 1e3 / per_round)
    return {k: _median_spread(v) for k, v in times.items()}


def _rank_one_variants(paths):
    return {f'{name}_{"fused" if fused else "composed"}_'
            f'{"cuda" if impl == "auto" else "torch"}_ms':
            (name, lr, fused, impl, None, kw)
            for name, (lr, kw, *_) in paths.items()
            for fused in (False, True) for impl in ('auto', 'torch')}


def _solver_variants():
    out = {}
    for name, (lr, shard) in SOLVER_PATHS.items():
        for fused in (False, True):
            for impl in ('auto', 'torch'):
                out[f'{name}_shard_{"fused" if fused else "composed"}_'
                    f'{"cuda" if impl == "auto" else "torch"}_ms'] = (
                    name, lr, fused, impl, shard, {})
        out[f'{name}_dense_composed_ms'] = (name, lr, False, 'auto', None, {})
    return out


def _profile(torch, model, params0, batches, steps, variants, n):
    """torch.profiler over ``n`` steps of each of ``variants`` ({key:
    (name, lr, fused, impl, shard, more options)}): device time by kernel
    (device-side events only, so no op is counted twice) and the device's
    idle share of the unprofiled median step time ``steps[key]``.  Where
    the trace holds no device time, says so instead of a number."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for key, (name, lr, fused_flag, impl, shard, opt_kw) in variants.items():
        *_, step, params, state = _train(torch, model, params0, batches[:3],
                                         fused=fused_flag, impl=impl,
                                         lr=lr, name=name, shard=shard,
                                         opt_kw=opt_kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for batch in batches[:n]:
                params, state, _ = step(params, state, batch)
            torch.cuda.synchronize()
        by_kernel = {}
        for evt in prof.key_averages():
            if evt.device_type != DeviceType.CUDA:
                continue
            by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + \
                evt.self_device_time_total / n
        busy_us = sum(by_kernel.values())
        step_ms = steps[key]['median']
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
        out[key[:-len('_cuda_ms')]] = {
            'device_kernels_per_step': sum(
                e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA) / n,
            'device_busy_ms_per_step': busy_us / 1e3 if busy_us
            else 'not measured',
            'device_idle_share': 1.0 - busy_us / 1e3 / step_ms if busy_us
            else 'not measured',
            'top_device_us_per_step': {k[:80]: v for k, v in top},
            'port_kernels_us_per_step': {k[:80]: v for k, v in
                                         by_kernel.items() if 'repro::' in k},
        }
    return out


def _steps_and_profile(torch, model, params0, batches, variants, grads_only,
                       rounds, per_round, key):
    """_step_times of ``variants`` and a profile of their kernel-path steps
    (per_round of each), printed as ``{key}_step_ms`` and
    ``{key}_profile``."""
    steps = _step_times(torch, model, params0, batches, variants,
                        grads_only=grads_only, rounds=rounds,
                        per_round=per_round)
    print(json.dumps({f'{key}_step_ms': steps}))
    cuda = {k: v for k, v in variants.items() if k.endswith('_cuda_ms')}
    print(json.dumps({f'{key}_profile': _profile(
        torch, model, params0, batches, steps, cuda, n=per_round)}))
    return steps


# ---------------------------------------------------------------------------
# 7. the demo transformer LM at full width


def lm_setup(torch):
    """demo_lm('100m') with nothing cut, its weights from a seeded
    generator, and LM_STEPS batches of LMStream(vocab 32768, 16 x 512)."""
    from repro_torch.configs.registry import demo_lm
    from repro_torch.launch import train as cli
    from repro_torch.models import module as M
    from repro_torch.models.registry import build_model
    cfg = demo_lm('100m')
    model = build_model(cfg)
    params0 = M.init_params(model.param_specs(),
                            torch.Generator().manual_seed(0), device='cuda')
    n_params = sum(v.numel() for v in params0.values())
    require(n_params == LM_PARAMS, f'demo-100m has {n_params} parameters')
    # the CLI's own stream (seed 0), kept for phase 11's CLI runs: a
    # vocab-32768 chain takes tens of seconds to build
    t0 = time.perf_counter()
    data = cli.lm_stream(LM_STREAM['vocab'], LM_STREAM['seq_len'],
                         LM_STREAM['batch'], 'cuda')
    require(data.seed == LM_STREAM['seed'], 'the CLI stream is not seed 0')
    t1 = time.perf_counter()
    batches = [data.batch_at(i) for i in range(LM_STEPS)]
    t2 = time.perf_counter()
    # phase 8's corpus: FIT_STEPS batches' sequences of FIT_SEQ + 1 tokens
    seqs = [torch.cat([b['tokens'], b['labels'][:, -1:]], 1).cpu()
            for b in (data.batch_at(i) for i in range(FIT_STEPS))]
    corpus = torch.cat(seqs).reshape(-1).numpy()
    print(f'  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, '
          f'{cfg.n_heads} heads ({cfg.n_kv_heads} KV), d_ff {cfg.d_ff}, vocab '
          f'{cfg.vocab}, remat {cfg.remat}; {n_params} parameters; LMStream '
          f'chain built in {t1 - t0:.1f} s, {LM_STEPS} batches in '
          f'{t2 - t1:.1f} s; bigram CE floor {data.bigram_ce:.4f}, uniform '
          f'{data.uniform_ce:.4f}', flush=True)
    return model, params0, batches, corpus


def _lm_learns(torch, model, params0, params, batch, tag):
    """The loss on the run's first batch, before and after the run; the
    run must have lowered it.  (Each step's loss is on a batch of its own,
    and a few steps from a random start can rise with the batch.)"""
    with torch.no_grad():
        before = model.loss_fn(params0, None, batch, None)[0].item()
        after = model.loss_fn(params, None, batch, None)[0].item()
    require(after < before, f'{tag}: the loss on the first batch did not '
            f'fall ({before} -> {after})')
    return before, after


def _lm_kfac(torch, model, params0, batches, plan, learned):
    """K-FAC with the head's 32768-wide output side sharded (CG, 32 band
    products a step through matvec_cols, every other side dense with its
    12-deep stacked inverses): LM_KFAC_STEPS steps held by _check_path, and
    each step's host-clock ms."""
    from repro_torch.core import factor_sharded as fsh
    from repro_torch.core import kv as kvlib
    _, heads = fsh.split_plan(plan, fsh.FactorShardConfig(**LM_SHARD))
    sharded = {key: pol for key, pol in heads.items() if 'shard' in pol}
    require(sum(p == 'shard' for pol in heads.values() for p in pol) == 1,
            f'sharded sides at threshold 32768: {heads}')
    paths = model.precon_paths()

    def taps_fn(p, b):
        return kvlib.make_full_taps(p, paths, tuple(b['tokens'].shape))
    run = batches[:LM_KFAC_STEPS]
    iters = LM_SHARD['solve_iters']
    tag = 'lm kfac head-shard'
    res = _check_path(torch, model, params0, run, name='kfac',
                      lr=LM_KFAC_LR, fused=False,
                      want={'matvec_cols': iters * len(run)}, learned=learned,
                      tag=tag, shard=LM_SHARD, taps_fn=taps_fn)
    vocab = LM_STREAM['vocab']
    want_calls = {('matvec_cols', (1, vocab, vocab)): iters * len(run)}
    require(res['calls'] == want_calls, f'{tag}: calls {res["calls"]}')
    print(f'  {tag}: sharded {sorted(sharded)}, {iters} matvec_cols a step; '
          f'host-clock ms a step {[round(x, 1) for x in res["step_ms"]]}',
          flush=True)
    info = {k: v for k, v in res.items() if k not in ('launches', 'calls')}
    info['sharded_buckets'] = sorted(sharded)
    return res['launches'], {tag: {'matvec_cols': iters}}, info


def _lm_serving(torch, model, params, batch):
    """prefill_fn over 15 tokens, the cache grown to 16, decode_fn of the
    16th token against prefill_fn over all 16 (rtol = atol = SERVE_TOL,
    the same argmax), then 8 greedy decode steps stay finite."""
    from repro_torch.launch.serve import grow_cache
    n, b, gen = 16, 2, 8
    toks = batch['tokens'][:b, :n].contiguous()
    full, _ = model.prefill_fn(params, {'tokens': toks})
    _, cache = model.prefill_fn(params, {'tokens': toks[:, :n - 1]})
    cache = grow_cache(model, cache, b, n)
    got, cache = model.decode_fn(params, cache, toks[:, n - 1], n - 1)
    err = (got - full).abs()
    require(bool((err <= SERVE_TOL + SERVE_TOL * full.abs()).all()),
            f'lm serving: decode vs prefill err {err.max().item():.3e}')
    require(torch.equal(got.argmax(-1), full.argmax(-1)),
            'lm serving: decode and prefill disagree on the argmax')
    cache = grow_cache(model, cache, b, n + gen)
    tok, out = got.argmax(-1).to(torch.int32), []
    for i in range(gen):
        logits, cache = model.decode_fn(params, cache, tok, n + i)
        require(bool(torch.isfinite(logits).all()),
                f'lm serving: decode step {i} not finite')
        tok = logits.argmax(-1).to(torch.int32)
        out.append(tok.cpu().tolist())
    info = {'decode_vs_prefill_max_abs': err.max().item(),
            'greedy_tokens': out}
    print(f'  serving: decode of token 16 vs prefill over 16: max abs err '
          f'{err.max().item():.2e} (limit {SERVE_TOL} + {SERVE_TOL} rel), '
          f'argmax equal; {gen} greedy decode steps finite: {out}',
          flush=True)
    return info


def lm_phase(torch, rows):
    """Phase 7: the LM's paths, checked; then the LM's times, added to the
    kernel rows of phase 6 (and each row's launches on the LM's paths)."""
    phase('7 lm: demo_lm(100m) at full width, 16 x 512 tokens a step; Eva '
          'and Eva-f composed and fused, K-FAC with the head sharded, '
          'serving')
    from repro_torch.core import bucketing
    torch.cuda.reset_peak_memory_stats()
    model, params0, batches, corpus = lm_setup(torch)
    paths = sorted(model.precon_paths())
    plan = bucketing.build_plan({p: params0[p] for p in paths})
    # q/o, k/v and gate/up pair up, below the stacking size of 3: each
    # weight is one call, its 12-deep layer stack folded into one launch
    require(len(plan.buckets) == 5 and not any(b.stacked
                                               for b in plan.buckets),
            f'lm buckets {[(b.key, b.paths) for b in plan.buckets]}')

    def learned(losses, params, tag):
        return _lm_learns(torch, model, params0, params, batches[0], tag)
    counts, per_step = main_phase(torch, model, params0, batches, LM_PATHS,
                                  learned, 'lm')
    k_counts, k_per_step, kfac = _lm_kfac(torch, model, params0, batches,
                                          plan, learned)
    counts = {k: counts[k] + k_counts[k] for k in counts}
    per_step.update(k_per_step)
    info = {'lm kfac head-shard': kfac,
            'serving': _lm_serving(torch, model, params0, batches[0]),
            'peak_device_gb': torch.cuda.max_memory_allocated() / 1e9}
    print(f'  peak device memory of the LM paths: '
          f'{info["peak_device_gb"]:.2f} GB', flush=True)
    print(json.dumps({'lm_kfac_serving_memory': info}))
    for row in rows:
        row['launches'] += counts[row['name']]
        row['launches_per_step'].update(
            {tag: c[row['name']] for tag, c in per_step.items()
             if row['name'] in c})
    steps = lm_times(torch, rows, model, params0, batches)
    return corpus, steps['eva_fused_cuda_ms']['median']


def _matvec_alone(torch, g, a):
    """matvec on one stacked G alone (the LM's tall mlp/down, 12 x 2048 x
    768) beside its einsum: µs per call, 20 calls replayed from one graph,
    against the byte bound."""
    from repro_torch.kernels import matvec as mv
    lead, d_in, d_out = g.shape
    bound_us = _bound(4 * (g.numel() + a.numel() + lead * d_out + lead),
                      2 * g.numel())[0] * 1e3
    graph_us = _graph_ms(torch, lambda: [mv.matvec_and_norm_stacked(g, a)
                                         for _ in range(20)], 20) * 1e3 / 20
    lib_us = _graph_ms(torch, lambda: [torch.einsum('...io,...i->...o', g, a)
                                       for _ in range(20)], 20) * 1e3 / 20
    return {'shape': 'x'.join(map(str, g.shape)), 'graph_us': graph_us,
            'library_graph_us': lib_us, 'bound_us': bound_us}


def lm_times(torch, rows, model, params0, batches):
    """Each kernel's calls of one LM step, from a CUDA graph and eager,
    beside its plain version, its bound and its one-call library
    equivalent: rows 1-8 one call per weight; row 9 K-FAC's 32 band
    products of the head, all 32 in each timed run.  Then the LM's
    host-clock step times and a profile of each kernel-path step."""
    phase('7 lm times (one step = 8 weights; row 9: one step = 32 band '
          'products at 768 x 32768 x 32768)')
    paths = sorted(model.precon_paths())
    layers = _layer_inputs(torch, [params0[p].shape for p in paths], 300)
    n = sum(g.numel() for g, *_ in layers)
    print(f'  G of one LM step: {n} f32 values, {4 * n / 1e6:.2f} MB',
          flush=True)
    fns, work = _kernel_fns(torch, layers)
    out = {name: {'calls_per_step': len(layers),
                  **_times(torch, *fns[name], work[name], len(layers),
                           LM_TIME_ITERS)}
           for name in fns}
    out['matvec']['tall_g'] = _matvec_alone(
        torch, *layers[paths.index('blocks/mlp/down/w')][:2])
    print(f'  matvec alone: {out["matvec"]["tall_g"]}', flush=True)
    del layers, fns
    # row 9: the head's 768 rows against its symmetric 32768 x 32768 output
    # factor, a step's 32 calls in each run (about 1 s): one warm-up run
    # and one timed run (one repeat: the budget of phase 11)
    d_model, vocab = params0['lm_head/w'].shape
    reps = LM_SHARD['solve_iters']
    gen = torch.Generator(device='cuda').manual_seed(400)
    g = torch.randn((vocab, vocab), generator=gen, device='cuda')
    g = (g + g.T) / 2
    a = torch.randn((d_model, vocab), generator=gen, device='cuda')
    fns, work = _cols_fns(torch, [(g, a)], reps)
    out['matvec_cols'] = {'calls_per_step': reps,
                          **_times(torch, *fns, work, reps, 1, warmup=1,
                                   host_reps=1, repeats=1)}
    del g, a, fns
    for row in rows:
        if row['name'] in out:
            row['lm'] = out[row['name']]
            _print_times(row['name'], out[row['name']])
    return _steps_and_profile(torch, model, params0, batches,
                              _rank_one_variants(LM_PATHS), list(LM_PATHS),
                              rounds=1, per_round=3, key='lm')


# ---------------------------------------------------------------------------
# 8. the rest of the optimizer set, the snapshot policies, Trainer.fit


def _sched_count(state):
    from repro_torch.schedule.runtime import schedule_metrics
    m = schedule_metrics(state)
    return int(m['refreshes']) if m else None


def _opt8(name, lr, fused, opt_kw):
    """``_make_opt`` for phase 8: ``opt_kw`` may carry an ``interval`` and a
    ``policy`` as (registry name, its options)."""
    from repro_torch.schedule.policy import named_policy
    opt_kw = dict(opt_kw)
    interval = opt_kw.pop('interval', 1)
    if 'policy' in opt_kw:
        opt_kw['policy'] = named_policy(opt_kw['policy'][0],
                                        **opt_kw['policy'][1])
    return _make_opt(name, lr, fused, 'auto', interval=interval,
                     opt_kw=opt_kw)


def _run_on(torch, model, params0, batches, device, name, lr, opt_kw,
            fused=False):
    """Losses and parameters after a step on each batch, every tensor on
    ``device`` (the kernels on the card, their plain versions on the
    CPU)."""
    from repro_torch.train.step import init_opt_state, make_train_step
    opt, cap, _ = _opt8(name, lr, fused, opt_kw)
    params = {k: v.to(device) for k, v in params0.items()}
    batches = [{k: v.to(device) for k, v in b.items()} for b in batches]
    state = init_opt_state(model, opt, cap, params, batches[0],
                           device=device)
    step = make_train_step(model, opt, cap, device=device)
    losses = []
    for batch in batches:
        params, state, met = step(params, state, batch)
        losses.append(met['loss'])
    return torch.stack(losses).cpu().tolist(), params, state


def _skip_step_kernels(torch, model, params0, batches, name, lr, opt_kw,
                       skip_at):
    """The profiler's device kernels of step ``skip_at`` (a skip step of
    the policy) and of step 0 (a refresh step): the skip step launches no
    dense inverse."""
    from repro_torch.train.step import init_opt_state, make_train_step
    opt, cap, _ = _opt8(name, lr, False, opt_kw)
    step = make_train_step(model, opt, cap, device='cuda')
    state = init_opt_state(model, opt, cap, params0, batches[0],
                           device='cuda')
    k_refresh, params, state = _step_device_kernels(torch, step, params0,
                                                    state, batches[0])
    for batch in batches[1:skip_at]:
        params, state, _ = step(params, state, batch)
    k_skip, _, state = _step_device_kernels(torch, step, params, state,
                                            batches[skip_at])
    dense_refresh = _dense_refresh_kernels(k_refresh)
    dense_skip = _dense_refresh_kernels(k_skip)
    require(dense_refresh, f'{name} {opt_kw}: no dense inverse kernel in its '
            f'refresh step: {sorted(k_refresh)[:20]}')
    require(not dense_skip, f'{name} {opt_kw}: skip step {skip_at} launched '
            f'{dense_skip}')
    return {'refresh_step_dense_kernels': len(dense_refresh),
            'skip_step': skip_at,
            'skip_step_device_kernels': sum(k_skip.values()),
            'refresh_step_device_kernels': sum(k_refresh.values())}


def rest_phase(torch, model, params0, batches):
    """8a: each optimizer of REST_PATHS for STEPS steps on the full-width
    autoencoder: finite, falling losses; the first REST_CPU_STEPS steps on
    the card within TRAJ_RTOL of the same steps on this machine's CPU; the
    skip steps of the explicit-inverse methods under a counter policy
    launch no dense inverse.  Returns the launch counts and per-step
    launches."""
    phase('8a the rest of the optimizer set on the full-width autoencoder')
    from repro_torch.kernels import launches
    counts = {k: 0 for k in launches.COUNTS}
    per_step, info = {}, {}
    for tag, (name, lr, opt_kw, fused, skip_at) in REST_PATHS.items():
        launches.reset()
        t0 = time.perf_counter()
        losses, params, state = _run_on(torch, model, params0, batches,
                                        'cuda', name, lr, opt_kw, fused)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = launches.snapshot()
        for k, v in got.items():
            counts[k] += v
        per_step[f'ae {tag}'] = {k: v // len(batches)
                                 for k, v in got.items() if v}
        _finite_and_falling(losses, f'ae {tag}')
        refreshes = _sched_count(state)
        del params, state
        n = REST_CPU_STEPS
        cpu, _, _ = _run_on(torch, model, params0, batches[:n], 'cpu', name,
                            lr, opt_kw, fused)
        _compare_trajectories(losses[:n], cpu, f'ae {tag} card vs cpu')
        rel = max(abs(k - p) / abs(p) for k, p in zip(losses[:n], cpu))
        row = {'losses': losses, 'launches': {k: v for k, v in got.items()
                                              if v},
               'refreshes': refreshes, 'seconds': secs,
               'max_rel_loss_diff_to_cpu': rel}
        if skip_at is not None:
            row.update(_skip_step_kernels(torch, model, params0, batches,
                                          name, lr, opt_kw, skip_at))
        info[tag] = row
        print(f'  {tag}: loss {losses[0]:.6f} -> {losses[-1]:.6f}; '
              f'launches {row["launches"]}; refreshes {refreshes}; first '
              f'{n} steps vs cpu max rel {rel:.2e}'
              + ('' if skip_at is None else
                 f'; skip step {skip_at}: {row["skip_step_device_kernels"]} '
                 f'device kernels, no dense inverse (refresh step: '
                 f'{row["refresh_step_dense_kernels"]} inverse kernel '
                 f'names)'), flush=True)
    print(json.dumps({'rest_checks': info}))
    return counts, per_step


def policy_phase(torch, model, params0, batches):
    """8b: Eva composed and fused and Eva-f fused under each policy of
    POLICY_PATHS through the kernels: the launches, the refresh count,
    finite losses, and each step within PARAM_RTOL of the plain step from
    the same state (_compare_steps)."""
    phase('8b snapshot policies through the kernels on the autoencoder')
    from repro_torch.kernels import launches
    from repro_torch.schedule.policy import named_policy
    counts = {k: 0 for k in launches.COUNTS}
    per_step, info = {}, {}
    calls = len(model.precon_paths()) * len(batches)
    for pol_args in POLICY_PATHS:
        for name, fused in (('eva', False), ('eva', True), ('eva_f', True)):
            lr, kw, composed, fused_names = MAIN_PATHS[name]
            opt_kw = dict(kw, policy=named_policy(pol_args[0],
                                                  **pol_args[1]))
            tag = f'ae {name} fused={fused} {opt_kw["policy"].name}'
            launches.reset()
            losses, _, params, state = _train(
                torch, model, params0, batches, fused=fused, impl='auto',
                lr=lr, name=name, opt_kw=opt_kw)
            got = launches.snapshot()
            want = {k: (calls if k in (fused_names if fused else composed)
                        else 0) for k in launches.COUNTS}
            require(got == want, f'{tag}: launches {got} != {want}')
            for k, v in got.items():
                counts[k] += v
            per_step[tag] = {k: v // len(batches) for k, v in got.items()
                             if v}
            # finite: a run whose KVs are stale for 9 steps need not fall
            # in 20 (Eva-f under warmup_then_k(5,10) ends 0.693 -> 0.701)
            require(all(map(math.isfinite, losses)),
                    f'{tag}: non-finite loss {losses}')
            refreshes = _sched_count(state)
            require(1 <= refreshes <= len(batches), f'{tag}: {refreshes}')
            pre = state.inner[0]
            require((pre.cached is None) == (pol_args[0] == 'adaptive'),
                    f'{tag}: the applied tree is kept twice or not at all')
            del params, state
            prel = _compare_steps(torch, model, params0, batches, fused=fused,
                                  lr=lr, name=name, what=tag, opt_kw=opt_kw)
            info[tag] = {'losses': losses, 'refreshes': refreshes,
                         'step_change_vs_plain': prel}
            print(f'  {tag}: refreshes {refreshes} of {len(batches)}; loss '
                  f'{losses[0]:.6f} -> {losses[-1]:.6f}; step change vs '
                  f'plain {prel:.2e} of its norm', flush=True)
    print(json.dumps({'policy_checks': info}))
    return counts, per_step


def _tree_bytes(tree):
    from repro_torch.core.transform import tree_leaves
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def _dir_bytes(path):
    return sum(f.stat().st_size for f in Path(path).rglob('*') if f.is_file())


def _fit_run(torch, model, params0, data_path, out_dir, total):
    """One Trainer.fit of demo-100m with Eva fused through the kernels
    under adaptive(0.05), over MemmapLM behind a Prefetcher.  Returns
    (params, state, history, prefetcher host ms per batch)."""
    from repro_torch.core.registry import make_optimizer
    from repro_torch.data.memmap_loader import MemmapLM
    from repro_torch.data.pipeline import Prefetcher
    from repro_torch.schedule.policy import adaptive
    from repro_torch.train.trainer import Trainer, TrainerConfig
    lr, kw, *_ = LM_PATHS['eva']
    opt, cap = make_optimizer('eva', lr=lr, fused=True,
                              policy=adaptive(FIT_THRESHOLD), **kw)
    cfg = TrainerConfig(total_steps=total, log_every=1, ckpt_every=4,
                        keep_ckpts=2, out_dir=str(out_dir))
    data = Prefetcher(MemmapLM(str(data_path), seq_len=FIT_SEQ,
                               batch=FIT_BATCH, device='cuda'), depth=2)
    try:
        params, state, hist = Trainer(model, opt, cap, cfg,
                                      device='cuda').fit(params0, data)
    finally:
        data.close()
    return params, state, hist, list(data.host_ms)


def _leaves_equal(torch, a, b):
    from repro_torch.train import checkpoint as ckpt
    la, lb = ckpt.leaf_paths(a), ckpt.leaf_paths(b)
    require([p for p, _ in la] == [p for p, _ in lb], 'leaf paths differ')
    worst, unequal = 0.0, []
    for (p, x), (_, y) in zip(la, lb):
        if not torch.equal(x, y):
            unequal.append(p)
            if x.is_floating_point():
                d = (x.double() - y.double()).abs().max().item()
                worst = max(worst, d / max(y.double().abs().max().item(),
                                           1e-30))
            else:
                worst = float('inf')
    return unequal, worst


def fit_phase(torch, corpus, bare_step_ms):
    """8c: Trainer.fit on demo-100m at full width, run A unbroken, run B cut
    at FIT_CUT steps and finished by a fresh Trainer on its out_dir; B's
    parameters and state equal A's bit for bit (deterministic algorithms on;
    should an op lack a deterministic CUDA form, it is named and the resume
    is held to FIT_FALLBACK_RTOL instead).  Every record of A's
    metrics.jsonl validates.  Returns the launch counts of run A and its
    launches per step."""
    phase('8c Trainer.fit: demo_lm(100m), Eva fused under adaptive, '
          'MemmapLM + Prefetcher, checkpoint every 4, resume')
    import shutil
    from repro_torch.configs.registry import demo_lm
    from repro_torch.data.memmap_loader import write_tokens
    from repro_torch.kernels import launches
    from repro_torch.models import module as M
    from repro_torch.models.registry import build_model
    from repro_torch.obs.events import validate_record
    from repro_torch.train import checkpoint as ckpt
    work = ROOT / 'build' / 'smoke_fit'
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    write_tokens(work / 'corpus', corpus)
    model = build_model(demo_lm('100m'))
    params0 = M.init_params(model.param_specs(),
                            torch.Generator().manual_seed(0), device='cuda')
    os.environ.setdefault('CUBLAS_WORKSPACE_CONFIG', ':4096:8')
    torch.use_deterministic_algorithms(True)
    nondeterministic = None
    try:
        launches.reset()
        pa, sa, ha, host_ms = _fit_run(torch, model, params0,
                                       work / 'corpus', work / 'a', FIT_STEPS)
        got = launches.snapshot()
    except RuntimeError as e:
        if 'deterministic' not in str(e):
            raise
        nondeterministic = str(e).splitlines()[0][:300]
        print(f'  an op has no deterministic CUDA form: {nondeterministic}',
              flush=True)
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(work / 'a', ignore_errors=True)
        launches.reset()
        pa, sa, ha, host_ms = _fit_run(torch, model, params0,
                                       work / 'corpus', work / 'a', FIT_STEPS)
        got = launches.snapshot()
    try:
        want = {k: (LM_WEIGHTS * FIT_STEPS if k == 'eva_fused' else 0)
                for k in launches.COUNTS}
        require(got == want, f'fit A: launches {got} != {want}')
        kept = ckpt.available_steps(work / 'a' / 'ckpt')
        require(kept == [8, 12], f'fit A: checkpoints {kept}')
        _, _, hb_cut, _ = _fit_run(torch, model, params0, work / 'corpus',
                                   work / 'b', FIT_CUT)
        require(ckpt.available_steps(work / 'b' / 'ckpt') == [4],
                'fit B: no checkpoint at step 4')
        pb, sb, hb, _ = _fit_run(torch, model, params0, work / 'corpus',
                                 work / 'b', FIT_STEPS)
    finally:
        torch.use_deterministic_algorithms(False)
    require(len(hb) == FIT_STEPS - 4, f'fit B resumed {len(hb)} steps')
    require(all(math.isfinite(x) for x in ha), f'fit A losses {ha}')
    require(ha[:FIT_CUT] == hb_cut, 'fit B before the cut differs from A')
    unequal_p, worst_p = _leaves_equal(torch, pa, pb)
    unequal_s, worst_s = _leaves_equal(torch, sa, sb)
    worst = max(worst_p, worst_s)
    if nondeterministic is None:
        require(not unequal_p and not unequal_s and ha[4:] == hb,
                f'fit: resumed run differs from the unbroken one in '
                f'{(unequal_p + unequal_s)[:8]} (worst {worst:.3e})')
    else:
        require(worst <= FIT_FALLBACK_RTOL, f'fit: resumed run differs by '
                f'{worst:.3e} of a leaf\'s scale')
    recs = [json.loads(line) for line in
            (work / 'a' / 'metrics.jsonl').read_text().splitlines()]
    bad = [(r, validate_record(r)) for r in recs if validate_record(r)]
    require(not bad, f'fit A: invalid records {bad[:3]}')
    steps = [r for r in recs if r['event'] == 'step']
    require(len(steps) == FIT_STEPS, f'fit A: {len(steps)} step records')
    fit_ms = [r['step_time_s'] * 1e3 for r in steps]
    refreshes = steps[-1]['refreshes']
    # a checkpoint's bytes, and a synchronous save and a restore timed
    tree = {'params': pa, 'opt_state': sa}
    n_bytes = _tree_bytes(tree)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.save(work / 'timed', 1, tree, {'next_step': 1})
    t_save = time.perf_counter() - t0
    file_bytes = _dir_bytes(work / 'timed' / 'step_00000001')
    t0 = time.perf_counter()
    back, _ = ckpt.restore(work / 'timed', 1, tree, device='cuda')
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    unequal_r, _ = _leaves_equal(torch, tree, back)
    require(not unequal_r, f'checkpoint round trip differs in {unequal_r[:4]}')
    del back, tree, pb, sb
    info = {
        'deterministic_algorithms': nondeterministic is None,
        'nondeterministic_op': nondeterministic,
        'resume_bit_exact': not unequal_p and not unequal_s,
        'resume_worst_rel': worst,
        'losses_a': ha, 'refreshes': refreshes,
        'fit_step_ms': fit_ms,
        'fit_step_ms_median_after_first': statistics.median(fit_ms[1:]),
        'bare_step_ms_phase7': bare_step_ms,
        'checkpoint_tensor_bytes': n_bytes,
        'checkpoint_file_bytes': file_bytes,
        'save_s': t_save, 'save_gb_per_s': file_bytes / t_save / 1e9,
        'restore_s': t_restore,
        'restore_gb_per_s': file_bytes / t_restore / 1e9,
        'prefetch_host_ms_per_batch': _median_spread(host_ms),
    }
    print(f'  fit A: {FIT_STEPS} steps, loss {ha[0]:.4f} -> {ha[-1]:.4f}, '
          f'{refreshes} refreshes; B cut at {FIT_CUT}, resumed from 4: '
          + ('bit for bit equal' if info['resume_bit_exact'] else
             f'worst rel {worst:.2e}')
          + '; fit step ms median '
          f'{info["fit_step_ms_median_after_first"]:.1f} (phase 7 bare step '
          f'{bare_step_ms:.1f}); checkpoint '
          f'{file_bytes / 1e9:.3f} GB, save {t_save:.2f} s '
          f'({info["save_gb_per_s"]:.2f} GB/s), restore {t_restore:.2f} s '
          f'({info["restore_gb_per_s"]:.2f} GB/s); prefetcher host ms per '
          f'batch {info["prefetch_host_ms_per_batch"]}', flush=True)
    print(json.dumps({'fit_checks': info}))
    shutil.rmtree(work, ignore_errors=True)
    return got, {'lm fit eva fused adaptive': {'eva_fused': LM_WEIGHTS}}


def table5_phase(torch, corpus):
    """8d: the paper's Table 5 on demo-100m: each optimizer's step ms (the
    median of TABLE5_ROUNDS rounds of TABLE5_PER_ROUND steps after
    TABLE5_WARMUP), its state bytes and the peak device memory of its run,
    each beside SGD's."""
    phase('8d Table 5 on demo_lm(100m): step time, state bytes, peak memory')
    from repro_torch.configs.registry import demo_lm
    from repro_torch.models import module as M
    from repro_torch.models.registry import build_model
    from repro_torch.train.step import init_opt_state, make_train_step
    model = build_model(demo_lm('100m'))
    params0 = M.init_params(model.param_specs(),
                            torch.Generator().manual_seed(0), device='cuda')
    seqs = torch.from_numpy(corpus[:TABLE5_BATCHES * FIT_BATCH
                                   * (FIT_SEQ + 1)]).reshape(
        TABLE5_BATCHES, FIT_BATCH, FIT_SEQ + 1).to(torch.int32).cuda()
    batches = [{'tokens': s[:, :-1].contiguous(),
                'labels': s[:, 1:].contiguous()} for s in seqs]
    out = {}
    for name, kw in TABLE5_OPTS.items():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        opt, cap, _ = _opt8(name, TABLE5_LR, False, kw)
        state = init_opt_state(model, opt, cap, params0, batches[0],
                               device='cuda')
        step = make_train_step(model, opt, cap, device='cuda')
        params = params0
        i = 0
        for _ in range(TABLE5_WARMUP):
            params, state, met = step(params, state, batches[i % len(batches)])
            i += 1
        torch.cuda.synchronize()
        rounds = []
        for _ in range(TABLE5_ROUNDS):
            t0 = time.perf_counter()
            for _ in range(TABLE5_PER_ROUND):
                params, state, met = step(params, state,
                                          batches[i % len(batches)])
                i += 1
            torch.cuda.synchronize()
            rounds.append((time.perf_counter() - t0) * 1e3 / TABLE5_PER_ROUND)
        require(math.isfinite(met['loss'].item()), f'table5 {name}: loss')
        out[name] = {'step_ms': statistics.median(rounds),
                     'step_ms_rounds': rounds,
                     'state_bytes': _tree_bytes(state),
                     'peak_device_gb': torch.cuda.max_memory_allocated() / 1e9}
        del params, state, step, opt, met
    sgd = out['sgd']
    n_param_bytes = _tree_bytes(params0)
    for name, row in out.items():
        row['rel_time'] = row['step_ms'] / sgd['step_ms']
        row['rel_state'] = row['state_bytes'] / sgd['state_bytes']
        row['state_over_param_bytes'] = row['state_bytes'] / n_param_bytes
        print(f'  {name}: {row["step_ms"]:.2f} ms a step '
              f'({row["rel_time"]:.3f}x sgd), state '
              f'{row["state_bytes"] / 1e9:.3f} GB ({row["rel_state"]:.3f}x '
              f'sgd, {row["state_over_param_bytes"]:.3f}x the parameters), '
              f'peak {row["peak_device_gb"]:.2f} GB', flush=True)
    print(json.dumps({'table5_lm': out}))


def rest_phases(torch, rows, corpus, bare_step_ms):
    """Phase 8 (8a-8d); the launches of its paths go into the kernel
    rows."""
    from repro_torch.kernels import launches
    model, params0, batches = ae_setup(torch)
    counts, per_step = rest_phase(torch, model, params0, batches)
    p_counts, p_per_step = policy_phase(torch, model, params0, batches)
    del model, params0, batches
    f_counts, f_per_step = fit_phase(torch, corpus, bare_step_ms)
    for c in (p_counts, f_counts):
        counts = {k: counts[k] + c.get(k, 0) for k in launches.COUNTS}
    per_step.update(p_per_step)
    per_step.update(f_per_step)
    for row in rows:
        row['launches'] += counts[row['name']]
        row['launches_per_step'].update(
            {tag: c[row['name']] for tag, c in per_step.items()
             if row['name'] in c})
    table5_phase(torch, corpus)


# ---------------------------------------------------------------------------
# 9. the other model families at published widths


def _on_card(torch, model, seed):
    """The model's weights drawn on the card from a seeded CUDA generator
    (a host draw of billions of values would take minutes)."""
    from repro_torch.models import module as M
    return M.init_params(model.param_specs(),
                         torch.Generator(device='cuda').manual_seed(seed),
                         device='cuda')


def _token_batches(torch, vocab, b, s, n, seed, embeds=None):
    """``n`` batches of random tokens (b, s) and labels; with ``embeds``
    ((frames, d_model, dtype)), random frame embeddings too."""
    gen = torch.Generator(device='cuda').manual_seed(seed)
    out = []
    for _ in range(n):
        batch = {k: torch.randint(0, vocab, (b, s), generator=gen,
                                  device='cuda', dtype=torch.int32)
                 for k in ('tokens', 'labels')}
        if embeds is not None:
            frames, d, dt = embeds
            batch['embeds'] = torch.randn((b, frames, d), generator=gen,
                                          device='cuda').to(dt)
        out.append(batch)
    return out


@contextlib.contextmanager
def _drops(torch):
    """While a model runs, each MoE ``route`` call, in call order (one call
    a MoE layer and forward); yields the list of (assignments, dropped,
    experts holding at least one slot: the others get a = 0 and only the
    s·G part of Eva's rank-one term)."""
    from repro_torch.models import moe
    route, seen = moe.route, []

    def spy(flat_e, *args):
        out = route(flat_e, *args)
        seen.append((flat_e.numel(), int((~out[3]).sum().item()),
                     int((out[1].sum(1) > 0).sum().item())))
        return out
    moe.route = spy
    try:
        yield seen
    finally:
        moe.route = route


def _plan_calls(torch, model, params):
    """Kernel calls of one step: one per stacked bucket of the
    preconditioned weights, one per weight of the other buckets."""
    from repro_torch.core import bucketing
    plan = bucketing.build_plan({p: params[p]
                                 for p in sorted(model.precon_paths())})
    return sum(1 if b.stacked else len(b.paths) for b in plan.buckets)


def _step_profile(torch, fn):
    """Device busy µs and kernels of one call of ``fn`` (profiler, device
    activity only: a step's 20k host ops would take the trace seconds to
    sum)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in ev),
            sum(e.count for e in ev))


def _family_run(torch, model, params0, batches, *, name, lr, opt_kw, fused,
                want, tag, bf16, host):
    """len(batches) - 1 steps of one optimizer through the kernels, each
    held to the plain path from the same state: one forward and backward a
    step, then the plain update (``kernel_impl='torch'``, parked in the
    pinned host buffers ``host`` to leave the card room) and the kernel
    update from the same gradients, stats and state, each leaf's f32 update
    within UPDATE_RTOL of the plain one's (relative norm); the kernel step
    is applied, and the next batch's loss after either update must agree
    (bf16 parameters: within BF16_LOSS_RTOL).  Each step's host-clock ms
    covers the forward, backward, kernel update and apply.  Then one kernel
    step profiled, and one whose kernel inputs are copied to host memory
    and held against the plain versions with phase 3's limits.  The path
    launches exactly ``want`` ({kernel: calls a step}) a step.  Returns
    (launches, what it read)."""
    from repro_torch.kernels import launches
    from repro_torch.train.step import init_opt_state, make_phased_step
    (opt_k, cap, _), (opt_p, _, _) = (
        _make_opt(name, lr, fused, impl, opt_kw=opt_kw)
        for impl in ('auto', 'torch'))
    grad_fn, upd_k, apply_fn = make_phased_step(model, opt_k, cap,
                                                device='cuda')
    upd_p = make_phased_step(model, opt_p, cap, device='cuda')[1]
    state = init_opt_state(model, opt_k, cap, params0, batches[0],
                           device='cuda')
    params, n = params0, len(batches) - 1
    losses, upd_rel, loss_rel, step_ms = [], [], [], []

    def next_loss(p, batch):
        with torch.no_grad():
            return model.loss_fn(p, None, batch, None)[0].item()
    launches.reset()
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads, stats = grad_fn(params, batches[i])
        torch.cuda.synchronize()
        t_grad = time.perf_counter() - t0
        ref, _, _ = upd_p(grads, stats, loss, state, params)
        for path, r in ref.items():
            host.setdefault(path, torch.empty(r.shape, dtype=r.dtype,
                                              pin_memory=True))
            host[path].copy_(r, non_blocking=True)
        torch.cuda.synchronize()
        del ref
        t0 = time.perf_counter()
        upd, state, _ = upd_k(grads, stats, loss, state, params)
        new = apply_fn(params, upd)
        torch.cuda.synchronize()
        step_ms.append((t_grad + time.perf_counter() - t0) * 1e3)
        del grads, stats
        worst, plain_params = 0.0, {}
        for path, u in upd.items():
            r = host[path].to('cuda', non_blocking=True).float()
            rel = torch.linalg.vector_norm(u.float() - r).item() / max(
                torch.linalg.vector_norm(r).item(), 1e-30)
            require(rel <= UPDATE_RTOL, f'{tag}: step {i} update of {path} '
                    f'{rel:.3e} of the plain one\'s norm away from it')
            worst = max(worst, rel)
            p = params[path]
            plain_params[path] = (p.float() + r).to(p.dtype)
        del upd, r
        upd_rel.append(worst)
        params = new
        lk, lp = next_loss(params, batches[i + 1]), \
            next_loss(plain_params, batches[i + 1])
        del plain_params
        losses.append(loss.item())
        require(math.isfinite(losses[-1]) and math.isfinite(lk),
                f'{tag}: step {i} loss {losses[-1]}, next {lk}')
        rel = abs(lk - lp) / abs(lp)
        require(rel <= (BF16_LOSS_RTOL if bf16 else TRAJ_RTOL),
                f'{tag}: after step {i} the loss is {lk!r} (kernels), '
                f'{lp!r} (plain)')
        loss_rel.append(rel)

    def kernel_step():
        nonlocal params, state
        loss, grads, stats = grad_fn(params, batches[0])
        upd, state, _ = upd_k(grads, stats, loss, state, params)
        params = apply_fn(params, upd)
    busy_us, kernels = _step_profile(torch, kernel_step)
    with _recording(torch, host=True) as (seen, _):
        kernel_step()
    got = launches.snapshot()
    del state, params
    want = {k: want.get(k, 0) * (n + 2) for k in launches.COUNTS}
    require(got == want, f'{tag}: launches {got} != {want}')
    kerr, _ = _check_path_inputs(torch, seen, tag)
    del seen
    require(set(kerr) == {k for k, v in want.items() if v},
            f'{tag}: kernels checked {sorted(kerr)}')
    med = statistics.median(step_ms[1:] or step_ms)
    info = {'losses': losses, 'next_loss_rel_diff': loss_rel,
            'update_rel_diff': upd_rel, 'step_ms': step_ms,
            'step_ms_median_after_first': med,
            'device_busy_ms_profiled_step': busy_us / 1e3 if busy_us
            else 'not measured',
            'device_idle_share': 1.0 - busy_us / 1e3 / med if busy_us
            else 'not measured',
            'device_kernels_profiled_step': kernels,
            'err_share_of_limit': kerr}
    print(f'  {tag}: launches {dict((k, v) for k, v in got.items() if v)}; '
          f'losses {[round(x, 5) for x in losses]}; update vs plain '
          f'{max(upd_rel):.2e} of its norm; next-batch loss vs plain '
          f'{max(loss_rel):.2e} rel; step ms {[round(x, 1) for x in step_ms]}'
          f'; profiled step: {kernels} device kernels, busy '
          f'{busy_us / 1e3:.1f} ms, idle {info["device_idle_share"]}; on '
          f'the path\'s inputs, error as a share of its limit '
          f'{ {k: float(f"{v:.2e}") for k, v in kerr.items()} }', flush=True)
    return got, info


def _family_paths(torch, model, params0, batches, paths, what, bf16):
    """Each optimizer of ``paths`` (LM_PATHS' form), composed and fused,
    through _family_run: (launches of all runs, launches a step of each,
    what each read)."""
    from repro_torch.kernels import launches
    calls = _plan_calls(torch, model, params0)
    counts = {k: 0 for k in launches.COUNTS}
    per_step, info, host = {}, {}, {}
    for name, (lr, kw, composed, fused_names, fused_too) in paths.items():
        for fused in (False, True) if fused_too == 'both' else \
                ((fused_too == 'fused'),):
            tag = f'{what} {name} fused={fused}'
            want = {k: calls for k in (fused_names if fused else composed)}
            got, info[tag] = _family_run(
                torch, model, params0, batches, name=name, lr=lr, opt_kw=kw,
                fused=fused, want=want, tag=tag, bf16=bf16, host=host)
            for k, v in got.items():
                counts[k] += v
            per_step[tag] = want
            torch.cuda.empty_cache()
    return counts, per_step, info


def _family_serving(torch, model, full_model, params, toks, prompt, tag,
                    extra=None, grow_kw=None):
    """prefill_fn over ``prompt`` tokens, the cache grown, then decode_fn
    of the SERVE_GEN tokens that follow in ``toks`` one at a time (each
    finite), and ``full_model``'s prefill_fn over all of them (the same
    weights; naive attention where flash's chunks would not divide the
    length).  No MoE assignment may drop.  Returns (last decode logits,
    full prefill logits, both f32, and what it read)."""
    from repro_torch.launch.serve import grow_cache
    extra = extra or {}
    b, total = toks.shape[0], prompt + SERVE_GEN
    with _drops(torch) as drops:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill_fn(params, {'tokens': toks[:, :prompt],
                                                  **extra})
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        if model.cfg.family != 'ssm':
            cache = grow_cache(model, cache, b, total, **(grow_kw or {}))
        t0 = time.perf_counter()
        for i in range(SERVE_GEN):
            logits, cache = model.decode_fn(params, cache,
                                            toks[:, prompt + i], prompt + i)
            require(bool(torch.isfinite(logits).all()),
                    f'{tag}: decode step {i} not finite')
        torch.cuda.synchronize()
        t_decode = (time.perf_counter() - t0) / SERVE_GEN
        full, _ = full_model.prefill_fn(params, {'tokens': toks[:, :total],
                                                 **extra})
    dropped = sum(d for _, d, _ in drops)
    require(dropped == 0, f'{tag}: {dropped} MoE assignments dropped')
    got, want = logits.float(), full.float()
    info = {'prompt': prompt, 'decoded': SERVE_GEN, 'batch': b,
            'compute_dtype': str(model.cfg.compute_dtype),
            'decode_vs_prefill_max_abs': (got - want).abs().max().item(),
            'max_abs_logit': want.abs().max().item(),
            'argmax_equal': torch.equal(got.argmax(-1), want.argmax(-1)),
            'moe_route_calls': len(drops), 'prefill_s': t_prefill,
            'decode_ms_per_token': t_decode * 1e3}
    return got, want, info


def _serving_pair(torch, cfg, params, toks, prompt, tag, naive_full=False,
                  extra=None, grow_kw=None):
    """_family_serving twice on the same bf16 weights.  With f32 compute
    and cache, decode against prefill within SERVE_TOL and the argmax equal
    unless the prefill's own logits tie within it there, as the
    reference's serving test holds its f32 models.  With the published
    bf16 compute, decode's distance to that f32 prefill within
    BF16_DECODE_RATIO times the bf16 prefill's own plus 2^-7 of the
    largest logit; its gap to the bf16 prefill and the argmax are read
    (they grow with depth: rounding at other points, and in bf16 a near
    tie of two experts may route the two runs apart)."""
    from repro_torch.models.registry import build_model
    out, truth = {}, None
    for key, c in (('f32_compute', cfg.replace(compute_dtype='float32',
                                               cache_dtype='float32')),
                   ('bf16', cfg)):
        full_model = build_model(c.replace(attn_impl='naive') if naive_full
                                 else c)
        got, want, info = _family_serving(torch, build_model(c), full_model,
                                          params, toks, prompt, tag, extra,
                                          grow_kw)
        err = (got - want).abs()
        if truth is None:
            truth = want
            lim = SERVE_TOL + SERVE_TOL * want.abs()
            require(bool((err <= lim).all()), f'{tag}: f32 decode vs '
                    f'prefill err {err.max().item():.3e}')
            top = want.max(-1).values
            at = want.gather(-1, got.argmax(-1, keepdim=True))[:, 0]
            require(info['argmax_equal'] or bool(
                (top - at <= SERVE_TOL + SERVE_TOL * top.abs()).all()),
                f'{tag}: f32 decode\'s argmax {got.argmax(-1).tolist()} is '
                f'not the prefill\'s {want.argmax(-1).tolist()} nor tied '
                'with it')
            held = f'limit {SERVE_TOL} + {SERVE_TOL} rel'
        else:
            err_dec = (got - truth).abs().max().item()
            err_pre = (want - truth).abs().max().item()
            lim = BF16_DECODE_RATIO * err_pre + \
                2 ** -7 * truth.abs().max().item()
            info.update(decode_vs_f32_prefill_max_abs=err_dec,
                        prefill_vs_f32_prefill_max_abs=err_pre,
                        decode_vs_f32_limit=lim)
            require(err_dec <= lim, f'{tag}: bf16 decode is {err_dec:.3e} '
                    f'from the f32 prefill, past {lim:.3e} (the bf16 '
                    f'prefill is {err_pre:.3e} from it)')
            held = (f'read; decode {err_dec:.2e} from the f32 prefill, '
                    f'prefill {err_pre:.2e}, limit {lim:.2e}')
        out[key] = info
        print(f'  {tag} serving, {c.compute_dtype} compute: prefill '
              f'{info["batch"]} x {prompt} in {info["prefill_s"]:.2f} s, '
              f'{SERVE_GEN} decode steps at '
              f'{info["decode_ms_per_token"]:.1f} ms each; last decode vs '
              f'prefill over {prompt + SERVE_GEN}: max abs err '
              f'{err.max().item():.2e} (logits up to '
              f'{info["max_abs_logit"]:.2f}; {held}), argmax '
              + ('equal' if info['argmax_equal'] else 'not equal')
              + (f'; {info["moe_route_calls"]} MoE route calls, none '
                 'dropped' if info['moe_route_calls'] else ''), flush=True)
        torch.cuda.empty_cache()
    return out


def _moe_times(torch, model):
    """Each kernel's calls of one qwen3-moe step on random operands of the
    path's shapes and dtype (bf16 G, each weight's lead dims folded into
    one stack, as kernels/ops.py folds them): from a CUDA graph and eager,
    beside its plain version, bound and library call."""
    from repro_torch.models import module as M
    specs = M.flatten_specs(model.param_specs())
    shapes = []
    for p in sorted(model.precon_paths()):
        shape = specs[p].shape
        shapes.append(shape if len(shape) == 2 else
                      (math.prod(shape[:-2]),) + tuple(shape[-2:]))
    layers = _layer_inputs(torch, shapes, 900, dtype=torch.bfloat16)
    fns, work = _kernel_fns(torch, layers)
    out = {name: {'calls_per_step': len(layers),
                  'shapes': ['x'.join(map(str, s)) for s in shapes],
                  **_times(torch, *fns[name], work[name], len(layers),
                           MOE_TIME_ITERS, warmup=1,
                           repeats=MOE_TIME_REPEATS)}
           for name in fns}
    return out


def moe_phase(torch, rows):
    """9a: qwen3-moe-30b-a3b at its published widths, depth 4."""
    phase(f'9a {MOE_ARCH} at published widths, depth {MOE_DEPTH} of 48, '
          f'bf16, flash, remat dots; {MOE_BATCH} x {MOE_SEQ} tokens a step')
    from repro_torch.configs.registry import get_config
    from repro_torch.models.moe import capacity
    from repro_torch.models.registry import build_model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(MOE_ARCH).replace(n_layers=MOE_DEPTH)
    model = build_model(cfg)
    params0 = _on_card(torch, model, 9)
    n_params = sum(v.numel() for v in params0.values())
    require(n_params == MOE_PARAMS, f'{MOE_ARCH} depth {MOE_DEPTH}: '
            f'{n_params} parameters')
    batches = _token_batches(torch, cfg.vocab, MOE_BATCH, MOE_SEQ,
                             FAMILY_STEPS + 1, 90)
    cap = capacity(MOE_BATCH * MOE_SEQ, cfg.top_k, cfg.n_experts,
                   cfg.capacity_factor)
    with _drops(torch) as drops, torch.no_grad():
        for batch in batches[:FAMILY_STEPS]:
            model.loss_fn(params0, None, batch, None)
    per_layer = [drops[i::MOE_DEPTH] for i in range(MOE_DEPTH)]
    dropped = [[d for _, d, _ in l] for l in per_layer]
    used = [[u for _, _, u in l] for l in per_layer]
    print(f'  {n_params} parameters; capacity {cap} slots an expert; per '
          f'layer over the {FAMILY_STEPS} batches, dropped of {drops[0][0]} '
          f'assignments {dropped}, experts of {cfg.n_experts} holding a '
          f'slot (a nonzero rank-one term) {used}', flush=True)
    counts, per_step, info = _family_paths(
        torch, model, params0, batches, FAMILY_PATHS, 'moe', bf16=True)
    # SGD's step, the yardstick
    sgd_ms = []
    _train(torch, model, params0, batches[:FAMILY_STEPS], fused=False,
           impl='auto', lr=0.05, name='sgd', step_ms=sgd_ms)
    info['sgd_step_ms'] = sgd_ms
    info['train_peak_device_gb'] = torch.cuda.max_memory_allocated() / 1e9
    info['dropped_per_layer'] = dropped
    info['experts_with_slots_per_layer'] = used
    info['capacity'] = cap
    print(f'  sgd step ms {[round(x, 1) for x in sgd_ms]}; peak device '
          f'memory of the training runs {info["train_peak_device_gb"]:.2f} '
          f'GB', flush=True)
    torch.cuda.empty_cache()
    serve_cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
    toks = _token_batches(torch, cfg.vocab, 2, MOE_SEQ + SERVE_GEN, 1,
                          91)[0]['tokens']
    info['serving'] = _serving_pair(torch, serve_cfg, params0, toks, MOE_SEQ,
                                    'moe', naive_full=True)
    del params0, batches
    torch.cuda.empty_cache()
    times = _moe_times(torch, model)
    _add_counts(rows, counts, per_step)
    for row in rows:
        if row['name'] in times:
            row['qwen3_moe'] = times[row['name']]
            _print_times(row['name'], times[row['name']])
    info['peak_device_gb'] = torch.cuda.max_memory_allocated() / 1e9
    print(json.dumps({'moe_checks': info}))
    return counts


def _family_case(torch, rows, *, tag, arch, seed, depth=None, n_params=None,
                 reduced=False, train=None, serve=None, frames=None,
                 naive_full=False):
    """One model of phases 9b-9d: ``arch``'s config (reduced, or cut to
    ``depth``), its weights drawn on the card from ``seed``; with ``train``
    = (batch, tokens a sequence, 'both' or 'fused'), Eva's paths through
    _family_paths on batches from seed 10·seed; with ``serve`` = (batch,
    prompt), _serving_pair on tokens from seed 10·seed + 1, at a dropless
    capacity.  ``frames``: an encoder-decoder's frame count, random frame
    embeddings beside each batch's tokens.  Returns what it read."""
    from repro_torch.configs.registry import get_config, get_reduced
    from repro_torch.models.registry import build_model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_reduced(arch) if reduced else get_config(arch)
    if depth:
        cfg = cfg.replace(n_layers=depth)
    model = build_model(cfg)
    params = _on_card(torch, model, seed)
    info = {'parameters': sum(v.numel() for v in params.values()),
            'weight_gb': sum(v.numel() * v.element_size()
                             for v in params.values()) / 1e9}
    if n_params:
        require(info['parameters'] == n_params, f'{tag}: '
                f'{info["parameters"]} parameters')
    embeds = (frames, cfg.d_model, cfg.cdtype) if frames else None
    if train:
        b, seq, fused = train
        batches = _token_batches(torch, cfg.vocab, b, seq, FAMILY_STEPS + 1,
                                 10 * seed, embeds)
        counts, per_step, info['training'] = _family_paths(
            torch, model, params, batches,
            {'eva': FAMILY_PATHS['eva'][:4] + (fused,)}, tag,
            bf16=cfg.param_dtype == 'bfloat16')
        _add_counts(rows, counts, per_step)
        del batches
        info['train_peak_device_gb'] = torch.cuda.max_memory_allocated() / 1e9
    if serve:
        b, prompt = serve
        batch = _token_batches(torch, cfg.vocab, b, prompt + SERVE_GEN, 1,
                               10 * seed + 1, embeds)[0]
        extra = {'embeds': batch['embeds']} if frames else None
        grow_kw = {'enc_len': frames} if frames else None
        if cfg.n_experts:
            cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
        info['serving'] = _serving_pair(torch, cfg, params, batch['tokens'],
                                        prompt, tag, naive_full, extra,
                                        grow_kw)
    info['peak_device_gb'] = torch.cuda.max_memory_allocated() / 1e9
    print(f'  {tag}: {info["parameters"]} parameters, '
          f'{info["weight_gb"]:.2f} GB of weights; peak device memory '
          f'{info["peak_device_gb"]:.2f} GB', flush=True)
    del params
    return info


# 9b-9d: (phase title or None, _family_case's arguments)
FAMILY_CASES = (
    (f'9b mamba2-780m whole (48 layers, d_model 1536, state 128, chunk 256, '
     f'tied vocab 50280, bf16); {MAMBA_BATCH} x {MAMBA_SEQ} tokens a step',
     dict(tag='ssm', arch='mamba2-780m', seed=10,
          train=(MAMBA_BATCH, MAMBA_SEQ, 'both'), serve=(2, MAMBA_SEQ))),
    (f'9c whisper-tiny whole (4 + 4 layers, d_model 384, vocab 51865, bf16); '
     f'{WHISPER_BATCH} x {WHISPER_FRAMES} frames, {WHISPER_FRAMES // 4} '
     'decoder tokens a step',
     dict(tag='encdec', arch='whisper-tiny', seed=11, frames=WHISPER_FRAMES,
          train=(WHISPER_BATCH, WHISPER_FRAMES // 4, 'fused'),
          serve=(2, WHISPER_FRAMES // 4 - SERVE_GEN))),
    (f'9d jamba-v0.1-52b at published widths, depth {JAMBA_DEPTH} (one '
     f'period), bf16, serving 1 x {JAMBA_PROMPT}; Eva at its reduced config',
     dict(tag='hybrid', arch='jamba-v0.1-52b', seed=12, depth=JAMBA_DEPTH,
          n_params=JAMBA_PARAMS, serve=(1, JAMBA_PROMPT), naive_full=True)),
    (None, dict(tag='hybrid reduced', arch='jamba-v0.1-52b', seed=13,
                reduced=True, train=(4, 256, 'both'))),
)


def _add_counts(rows, counts, per_step):
    for row in rows:
        row['launches'] += counts[row['name']]
        row['launches_per_step'].update(
            {tag: c[row['name']] for tag, c in per_step.items()
             if row['name'] in c})


def families_phase(torch, rows):
    """Phase 9; the launches of its paths go into the kernel rows."""
    t0 = time.perf_counter()
    moe_phase(torch, rows)
    took = {'9a': time.perf_counter() - t0}
    for title, kw in FAMILY_CASES:
        if title:
            phase(title)
        t0 = time.perf_counter()
        info = _family_case(torch, rows, **kw)
        print(json.dumps({f'{kw["tag"].replace(" ", "_")}_checks': info}))
        took[kw['tag']] = time.perf_counter() - t0
    print(f'  phase 9 took {sum(took.values()):.1f} s: '
          f'{ {k: round(v, 1) for k, v in took.items()} }', flush=True)


# ---------------------------------------------------------------------------
# 10. the multi-worker layers (torch.distributed)

# 10b's autoencoder paths: tag -> (optimizer, lr of MAIN_PATHS /
# SOLVER_PATHS / REST_PATHS, fused, the sharded-factor config or None, the
# kernels launched: {kernel: launches per step and rank})
P10_WORLD = 4
P10_STEPS = 10
P10_CMP_STEPS = 3       # steps of the gather-against-psum runs
P10_PATHS = {
    'eva': ('eva', 0.15, False, None, {'bilinear': 8, 'rank1_update': 8}),
    'eva fused': ('eva', 0.15, True, None, {'eva_fused': 8}),
    'eva_f fused': ('eva_f', 0.15, True, None, {'eva_f_fused': 8}),
    'kfac shard': ('kfac', 0.15, False, SOLVER_PATHS['kfac'][1],
                   {'matvec_cols': 128}),
    'shampoo shard': ('shampoo', 0.3, False, SOLVER_PATHS['shampoo'][1],
                      {'matvec_cols': 128}),
    'foof': ('foof', 0.1, False, None, {}),
}
# 10a: the paths held bit for bit to make_train_step under a one-rank NCCL
# group
P10_W1_PATHS = ('eva fused', 'eva_f fused', 'kfac shard', 'shampoo shard')
# the gather ≡ psum runs
P10_PSUM_PATHS = ('kfac shard', 'foof', 'shampoo shard')
P10_MLP_STEPS = 3
# 10b holds each W = 4 update within PARAM_RTOL of the W = 1 step on the
# whole batch from the same state (relative to that step's norm), but for
# these paths, whose f32 step one rounding of the data already moves as far:
# on an H100 (scripts/dp_split.py) splitting the batch moved FOOF's step by
# 1.70e-4 and the MLP's K-FAC step by 1.44e-3, one f32 rounding of the
# batch's inputs by 9.0e-5 and 1.44e-3, and the whole-batch f32 step itself
# lies up to 3.8e-5 and 1.44e-3 from the f64 step; in f64 the W = 4 step is
# the whole-batch step within 7e-14 and 2.4e-11.  Fixed caps, about three
# times those readings.
P10_W1_RTOL = {'foof': 5e-4, 'mlp kfac shard': 5e-3}
# the stacked 3 x 1000 x 1000 bucket of phase 5's MLP, K-FAC sharded
P10_MLP = ('kfac', 0.1, False, SOLVER_PATHS['kfac'][1], {})
P10_FIT_STEPS = 8
P10_CHAOS_STEPS, P10_KILLS = 24, (8, 16)
P10_LIVE_STEPS = 16
P10_TIMEOUT = 900.0


def _p10_opt(torch, spec):
    """(optimizer, capture, factor config) of a P10_PATHS entry."""
    from repro_torch.core.factor_sharded import FactorShardConfig
    from repro_torch.core.registry import make_optimizer
    name, lr, fused, shard, _ = spec
    kw = {} if name == 'foof' else {'fused': fused}
    opt, cap = make_optimizer(name, lr=lr, **kw)
    return opt, cap, (FactorShardConfig(**shard) if shard else None)


def _state_snapshot(torch, state):
    from repro_torch.core.transform import tree_leaves_with_path
    return {k: v.clone() for k, v in tree_leaves_with_path(state).items()
            if torch.is_tensor(v)}


def _snapshots_equal(torch, a, b):
    return list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)


def _ms(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


class _TokenData:
    """Seekable random-token batches on the card for demo-100m: batch
    ``step`` drawn from a generator seeded with ``seed + step``."""

    def __init__(self, torch, vocab, batch, seq, seed):
        self.torch, self.vocab = torch, vocab
        self.batch, self.seq, self.seed = batch, seq, seed

    def batch_at(self, step):
        torch = self.torch
        gen = torch.Generator(device='cuda').manual_seed(self.seed + step)
        return {k: torch.randint(0, self.vocab, (self.batch, self.seq),
                                 generator=gen, device='cuda',
                                 dtype=torch.int32)
                for k in ('tokens', 'labels')}


def _fit_pair(torch, work):
    """fit and fit_elastic(world=1) of demo-100m, Eva fused, P10_FIT_STEPS
    steps each from the same weights: (fit's, fit_elastic's) (params,
    state, losses) and launches."""
    from repro_torch.configs.registry import demo_lm
    from repro_torch.core.registry import make_optimizer
    from repro_torch.kernels import launches
    from repro_torch.models.registry import build_model
    from repro_torch.train.trainer import Trainer, TrainerConfig
    model = build_model(demo_lm('100m'))
    params0 = _on_card(torch, model, 20)
    lr, kw, *_ = LM_PATHS['eva']
    data = _TokenData(torch, demo_lm('100m').vocab, FIT_BATCH, FIT_SEQ, 300)
    runs = {}
    for how in ('fit', 'fit_elastic'):
        opt, cap = make_optimizer('eva', lr=lr, fused=True, **kw)
        cfg = TrainerConfig(total_steps=P10_FIT_STEPS, log_every=100,
                            out_dir=str(work / how))
        tr = Trainer(model, opt, cap, cfg, device='cuda')
        launches.reset()
        if how == 'fit':
            p, s, h = tr.fit(params0, data, resume=False)
        else:
            p, s, h = tr.fit_elastic(params0, data, world=1)
            h = [loss for _, loss in h]
        runs[how] = (p, _state_snapshot(torch, s), h, launches.snapshot())
        del p, s
    return runs


def dp_w1_phase(torch):
    """10a: make_dp_step under a one-rank NCCL group against
    make_train_step, bit for bit, on the full-width autoencoder; then
    fit_elastic(world=1) against fit on demo-100m.  Returns (launches of
    the DP runs, per-step launches, info)."""
    phase('10a W = 1 NCCL: make_dp_step against make_train_step on the '
          'autoencoder (Eva fused, Eva-f fused, K-FAC shard, Shampoo shard, '
          f'{P10_STEPS} steps each) and fit_elastic against fit on '
          f'demo-100m ({P10_FIT_STEPS} steps), bit for bit')
    import shutil
    import tempfile
    import torch.distributed as dist
    from repro_torch.kernels import launches
    from repro_torch.launch import workers
    from repro_torch.train.step import (init_opt_state, make_dp_step,
                                        make_train_step)
    os.environ.setdefault('CUBLAS_WORKSPACE_CONFIG', ':4096:8')
    torch.use_deterministic_algorithms(True)
    store = tempfile.mkdtemp(prefix='repro_torch_nccl_')
    workers.init_workers('nccl', 'cuda', rank=0, world=1,
                         init_method=f'file://{store}/store')
    counts = {k: 0 for k in launches.COUNTS}
    per_step, info = {}, {}
    try:
        require(dist.get_backend() == 'nccl', 'not an NCCL group')
        model, params0, batches = ae_setup(torch)
        batches = batches[:P10_STEPS]
        for tag in P10_W1_PATHS:
            runs, ms = {}, {}
            for how in ('train', 'dp'):
                opt, cap, factor = _p10_opt(torch, P10_PATHS[tag])
                state = init_opt_state(model, opt, cap, params0, batches[0],
                                       factor=factor, device='cuda')
                step = (make_dp_step(model, opt, cap, None, factor=factor,
                                     device='cuda') if how == 'dp' else
                        make_train_step(model, opt, cap, factor=factor,
                                        device='cuda'))
                params, losses, times = params0, [], []
                launches.reset()
                for batch in batches:
                    (params, state, met), t = _ms(
                        torch, lambda: step(params, state, batch))
                    losses.append(float(met['loss']))
                    times.append(t)
                got = launches.snapshot()
                runs[how] = (params, _state_snapshot(torch, state), losses,
                             got)
                ms[how] = statistics.median(times[1:])
            (pa, sa, la, _), (pb, sb, lb, got) = runs['train'], runs['dp']
            want = {k: v * P10_STEPS
                    for k, v in P10_PATHS[tag][4].items()}
            require(got == {k: want.get(k, 0) for k in got},
                    f'10a {tag}: DP launches {got} != {want}')
            require(la == lb, f'10a {tag}: losses {la} != {lb}')
            require(all(torch.equal(pa[k], pb[k]) for k in pa),
                    f'10a {tag}: parameters differ')
            require(_snapshots_equal(torch, sa, sb),
                    f'10a {tag}: optimizer state differs')
            _finite_and_falling(la, f'10a {tag}')
            for k in counts:
                counts[k] += got[k]
            per_step[f'p10 W=1 nccl {tag}'] = {
                k: v // P10_STEPS for k, v in got.items() if v}
            info[f'w1 nccl {tag}'] = {
                'train_step_ms': ms['train'], 'dp_step_ms': ms['dp'],
                'dp_overhead_ms': ms['dp'] - ms['train'],
                'loss_first_last': [la[0], la[-1]]}
            print(f'  {tag}: bit for bit over {P10_STEPS} steps; launches '
                  f'{ {k: v for k, v in got.items() if v} }; step ms median '
                  f'make_train_step {ms["train"]:.2f}, make_dp_step '
                  f'{ms["dp"]:.2f} (DP overhead {ms["dp"] - ms["train"]:+.2f})',
                  flush=True)
            del runs
        del model, params0, batches
        work = ROOT / 'build' / 'smoke_fit_elastic'
        shutil.rmtree(work, ignore_errors=True)
        fits = _fit_pair(torch, work)
        (pa, sa, ha, ga), (pb, sb, hb, gb) = fits['fit'], fits['fit_elastic']
        require(ha == hb, f'10a fit {ha} != fit_elastic {hb}')
        require(all(torch.equal(pa[k], pb[k]) for k in pa),
                '10a fit_elastic parameters differ from fit\'s')
        require(_snapshots_equal(torch, sa, sb),
                '10a fit_elastic state differs from fit\'s')
        want = {k: (LM_WEIGHTS * P10_FIT_STEPS if k == 'eva_fused' else 0)
                for k in launches.COUNTS}
        require(gb == want, f'10a fit_elastic launches {gb} != {want}')
        for k in counts:
            counts[k] += gb[k]
        per_step['p10 W=1 nccl lm fit_elastic eva fused'] = {
            'eva_fused': LM_WEIGHTS}
        info['lm_fit_elastic'] = {'losses': hb}
        print(f'  demo-100m fit_elastic(world=1) = fit bit for bit over '
              f'{P10_FIT_STEPS} steps (loss {hb[0]:.4f} -> {hb[-1]:.4f}); '
              f'launches {gb["eva_fused"]} eva_fused', flush=True)
        shutil.rmtree(work, ignore_errors=True)
        del fits, pa, pb, sa, sb
    finally:
        workers.shutdown_workers()
        shutil.rmtree(store, ignore_errors=True)
        torch.use_deterministic_algorithms(False)
    return counts, per_step, info


def _p10_dist(torch, params, ref, new):
    """(‖Δnew − Δref‖ / ‖Δref‖ over the whole update, the largest such
    ratio of one leaf), Δ = the step's change of the parameters."""
    num = den = leaf = 0.0
    for k, p in params.items():
        d1 = ref[k].double() - p.double()
        n1 = torch.linalg.vector_norm(d1).item()
        dn = torch.linalg.vector_norm(new[k].double() - p.double()
                                      - d1).item()
        num, den = num + dn ** 2, den + n1 ** 2
        if n1 > 0:
            leaf = max(leaf, dn / n1)
    return (num / den) ** 0.5 if den > 0 else float('inf'), leaf


def _p10_twin(torch, model, opt, cap, factor, params, state, batch,
              world):
    """The W-worker step's arithmetic on one process: each shard's loss,
    gradients and statistics, their sum in rank order over W, the
    optimizer's second mean of the identical statistics; then the update.
    Returns its new parameters."""
    from repro_torch.core.transform import Extras, apply_updates, tree_map
    from repro_torch.train.step import (_plan_for_stats,
                                        compute_grads_and_stats)
    n = next(iter(batch.values())).shape[0] // world
    parts = [compute_grads_and_stats(model, params, {
        k: v[r * n:(r + 1) * n] for k, v in batch.items()}, cap)
        for r in range(world)]

    def mean(trees):
        acc = trees[0]
        for t in trees[1:]:
            acc = tree_map(lambda a, b: a + b, acc, t)
        return tree_map(lambda a: a / world, acc)

    loss, grads = mean([p[0] for p in parts]), mean([p[1] for p in parts])
    stats = None if parts[0][2] is None else \
        mean([mean([p[2] for p in parts])] * world)
    upd, _ = opt.update(grads, state, params=params, extras=Extras(
        stats=stats, loss=loss, plan=_plan_for_stats(grads, stats),
        factor=factor))
    return apply_updates(params, upd)


def _p10_agree(torch, params, ref, twin, new, what, cap):
    """The W = 4 step's change held to two W = 1 steps from the same state.
    (a) Its arithmetic twin (the same four shard means on one process):
    within PARAM_RTOL of its norm over the whole update, which proves the
    exchanges.  (b) The step on the whole batch: within ``cap`` (PARAM_RTOL
    but for the paths of P10_W1_RTOL).  Returns (W = 4 against the
    whole-batch step, its largest one-leaf ratio, W = 4 against the twin,
    the twin against the whole-batch step)."""
    rel_twin, _ = _p10_dist(torch, params, twin, new)
    require(rel_twin <= PARAM_RTOL, f'{what}: the update is {rel_twin:.3e}'
            f' of its one-process twin\'s norm away from it, beyond '
            f'{PARAM_RTOL}')
    split, _ = _p10_dist(torch, params, ref, twin)
    rel, leaf = _p10_dist(torch, params, ref, new)
    require(rel <= cap, f'{what}: the update is {rel:.3e} of the W = 1 '
            f'step\'s norm away from it, beyond {cap:.1e} (its one-process '
            f'twin lies {split:.3e} from that step)')
    return rel, leaf, rel_twin, split


def _p10_run(torch, rank, model, params0, batches, tag, *, sched=None,
             comm=None, agree=True, snap_at=None, record=False, spec=None):
    """One P10_PATHS tag (or ``spec``) through make_dp_step over every
    rank; on rank 0 each step also taken at W = 1 on the whole batch from
    the same state (its launches and kernel calls not counted) and held by
    _p10_agree.  Returns the run's record."""
    from repro_torch.comm import metrics
    from repro_torch.kernels import launches
    from repro_torch.train.step import (init_opt_state, make_dp_step,
                                        make_train_step)
    opt, cap, factor = _p10_opt(torch, spec or P10_PATHS[tag])
    kw = dict(sched=sched, factor=factor, device='cuda')
    state = init_opt_state(model, opt, cap, params0, batches[0], comm=comm,
                           **kw)
    step = make_dp_step(model, opt, cap, None, comm=comm, **kw)
    ref_step = make_train_step(model, opt, cap, comm=comm, **kw)
    params, losses, snap = params0, [], None
    worst = leaf = twin_rel = split = 0.0
    metrics.reset()
    with _recording(torch) as (seen, calls):
        launches.reset()
        for i, batch in enumerate(batches):
            if agree and rank == 0:
                mine = (launches.snapshot(), dict(seen), dict(calls))
                ref, _, _ = ref_step(params, state, batch)
                twin = _p10_twin(torch, model, opt, cap, factor, params,
                                 state, batch, P10_WORLD)
                launches.COUNTS.update(mine[0])
                seen.clear()
                seen.update(mine[1])
                calls.clear()
                calls.update(mine[2])
            new, state, met = step(params, state, batch)
            if agree and rank == 0:
                rel, one, to_twin, twin_off = _p10_agree(
                    torch, params, ref, twin, new, f'10b {tag} step {i}',
                    P10_W1_RTOL.get(tag, PARAM_RTOL))
                worst, leaf = max(worst, rel), max(leaf, one)
                twin_rel, split = max(twin_rel, to_twin), max(split,
                                                              twin_off)
                del ref, twin
            params = new
            losses.append(float(met['loss']))
            if snap_at == i + 1:
                snap = ({k: v.clone() for k, v in params.items()},
                        _state_snapshot(torch, state))
        got = launches.snapshot()
    lag = {k: int(v) for k, v in met.items() if k.startswith('pipeline')}
    kerr = {}
    if record and rank == 0:
        kerr, _ = _check_path_inputs(torch, seen, f'10b {tag}')
    return {'losses': losses, 'launches': got, 'worst': worst,
            'worst_leaf': leaf, 'twin': twin_rel, 'split': split,
            'snap': snap,
            'params': params,
            'state': state, 'lag': lag,
            'calls': {f'{k}{list(s)}': c for (k, s), c in calls.items()},
            'kerr': kerr, 'sites': metrics.snapshot()}


def _p10_first_step_zero_stats(torch, model, params0, batch, tag):
    """The W = 1 step that sees zero statistics (the cold pipeline's first
    step of the Eva family): its new parameters."""
    from repro_torch.core.transform import Extras, apply_updates, tree_map
    from repro_torch.train.step import (_plan_for_stats,
                                        compute_grads_and_stats,
                                        init_opt_state)
    opt, cap, factor = _p10_opt(torch, P10_PATHS[tag])
    state = init_opt_state(model, opt, cap, params0, batch, factor=factor,
                           device='cuda')
    loss, grads, stats = compute_grads_and_stats(model, params0, batch, cap)
    zero = tree_map(torch.zeros_like, stats)
    upd, _ = opt.update(grads, state, params=params0, extras=Extras(
        stats=zero, loss=loss, plan=_plan_for_stats(grads, zero),
        factor=factor))
    return apply_updates(params0, upd)


def _p10_dense_paths(torch, model, params0, tag):
    """The weights of the dense-plan buckets (their sides below the shard
    threshold)."""
    from repro_torch.core import bucketing
    from repro_torch.core import factor_sharded as fsh
    _, _, factor = _p10_opt(torch, P10_PATHS[tag])
    plan = bucketing.build_plan({p: params0[p]
                                 for p in sorted(model.precon_paths())})
    return list(fsh.split_plan(plan, factor)[0].paths)


def _p10_elastic(torch, rank, root):
    """10c: chaos and live resizes of Eva and K-FAC on the autoencoder."""
    import signal
    from repro_torch.core.registry import make_optimizer
    from repro_torch.data.synthetic import AEStream
    from repro_torch.models import module as M
    from repro_torch.models.simple import ae_loss_fn, autoencoder
    from repro_torch.train.trainer import Trainer, TrainerConfig

    class Chaos:
        def __init__(self, kill_at):
            self.inner, self.kill_at = AEStream(batch=1000, device='cuda'), \
                kill_at

        def batch_at(self, step):
            if step == self.kill_at:
                os.kill(os.getpid(), signal.SIGTERM)
            return self.inner.batch_at(step)

    def trainer(name, out, steps):
        model = autoencoder()
        model.loss_fn = ae_loss_fn(model)
        opt, cap = make_optimizer(name, lr=0.15)
        cfg = TrainerConfig(total_steps=steps, log_every=4,
                            ckpt_every=10 ** 6, out_dir=str(out))
        params = M.init_params(model.param_specs(),
                               torch.Generator().manual_seed(0),
                               device='cuda')
        return Trainer(model, opt, cap, cfg, device='cuda'), params

    out = {}
    for name in ('eva', 'kfac'):
        t0 = time.perf_counter()
        tr, p = trainer(name, f'{root}/{name}/base', P10_CHAOS_STEPS)
        base = tr.fit_elastic(p, Chaos(None), world=P10_WORLD)[2]
        chaos = []
        for w, kill in ((P10_WORLD, P10_KILLS[0]), (2, P10_KILLS[1]),
                        (P10_WORLD, None)):
            tr, p = trainer(name, f'{root}/{name}/chaos', P10_CHAOS_STEPS)
            chaos.append(tr.fit_elastic(p, Chaos(kill), world=w)[2])
        tr, p = trainer(name, f'{root}/{name}/live', P10_LIVE_STEPS)
        live = tr.fit_elastic(p, Chaos(None), world=P10_WORLD,
                              world_fn=lambda s: 2 if 6 <= s < 11 else 4)[2]
        out[name] = {'base': base, 'chaos': chaos, 'live': live,
                     'seconds': time.perf_counter() - t0}
        del tr, p
    return out


def _p10_rank(rank, world, root):
    """One rank of 10b and 10c (four ranks over gloo on the one card)."""
    os.environ.setdefault('CUBLAS_WORKSPACE_CONFIG', ':4096:8')
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    from repro_torch.comm.exchange import ExchangeConfig
    from repro_torch.schedule import ownership
    from repro_torch.schedule.runtime import RefreshRuntime
    t0 = time.perf_counter()
    res = {'world_and_rank_outside': ownership.world_and_rank()}
    model, params0, batches = ae_setup(torch)
    batches = batches[:P10_STEPS]
    runs = {}
    for tag in P10_PATHS:
        runs[tag] = _p10_run(torch, rank, model, params0, batches, tag,
                             snap_at=P10_CMP_STEPS,
                             record=(tag == 'kfac shard'))
    # gather ≡ psum: the same steps with the zero-padded sum
    psum = {}
    for tag in P10_PSUM_PATHS:
        r = _p10_run(torch, rank, model, params0, batches[:P10_CMP_STEPS],
                     tag, comm=ExchangeConfig(exchange='psum'), agree=False)
        p_g, s_g = runs[tag]['snap']
        psum[tag] = {
            'params_equal': all(torch.equal(r['params'][k], p_g[k])
                                for k in p_g),
            'state_equal': _snapshots_equal(
                torch, _state_snapshot(torch, r['state']), s_g),
            'sites': r['sites'], 'launches': r['launches']}
    # 'onestep': Eva fused and K-FAC shard.  The first step applies the
    # cold buffers: Eva's zero statistics (held to the W = 1 step that sees
    # zeros), K-FAC's zero cached inverses (its dense-plan weights stay
    # put; the sharded head solves against the live factors)
    onestep = {}
    for tag in ('eva fused', 'kfac shard'):
        r = _p10_run(torch, rank, model, params0, batches[:1], tag,
                     sched=RefreshRuntime(pipeline='onestep'), agree=False)
        zero = None
        if rank == 0 and tag == 'eva fused':
            ref = _p10_first_step_zero_stats(torch, model, params0,
                                             batches[0], tag)
            zero, _ = _p10_dist(torch, params0, ref, r['params'])
            require(zero <= PARAM_RTOL, f'10b onestep {tag}: the first '
                    f'step is {zero:.3e} from the zero-statistics step')
        elif rank == 0:
            dense = _p10_dense_paths(torch, model, params0, tag)
            require(dense, f'10b onestep {tag}: no dense-plan weight')
            zero = max((r['params'][k] - params0[k]).abs().max().item()
                       for k in dense)
        r2 = _p10_run(torch, rank, model, params0, batches, tag,
                      sched=RefreshRuntime(pipeline='onestep'), agree=False)
        onestep[tag] = {'first_step': zero, 'losses': r2['losses'],
                        'lag': r2['lag'], 'launches': r2['launches']}
    # the MLP's stacked 3 x 1000 x 1000 bucket, K-FAC with its sides sharded
    mlp = _p10_mlp(torch, rank)
    # the int8-compressed DP step (Eva composed)
    comp = _p10_int8(torch, model, params0, batches)
    for r in runs.values():
        for k in ('params', 'state', 'snap'):
            r.pop(k)
    res.update(runs=runs, psum=psum, onestep=onestep, mlp=mlp, int8=comp)
    del model, params0, batches
    res['elastic'] = _p10_elastic(torch, rank, root)
    res['seconds'] = time.perf_counter() - t0
    return res


def _p10_mlp(torch, rank):
    from repro_torch.data.synthetic import ClassStream
    from repro_torch.models import module as M
    from repro_torch.models.simple import MLP, classifier_loss_fn
    model = MLP([784, 1000, 1000, 1000, 1000, 10])
    model.loss_fn = classifier_loss_fn(model)
    params0 = M.init_params(model.param_specs(),
                            torch.Generator().manual_seed(1), device='cuda')
    data = ClassStream(batch=512, dim=784, classes=10, device='cuda')
    batches = [data.batch_at(i) for i in range(P10_MLP_STEPS)]
    r = _p10_run(torch, rank, model, params0, batches, 'mlp kfac shard',
                 record=True, spec=P10_MLP)
    for k in ('params', 'state', 'snap'):
        r.pop(k)
    return r


def _p10_int8(torch, model, params0, batches):
    from repro_torch.comm import metrics
    from repro_torch.core.registry import make_optimizer
    from repro_torch.kernels import launches
    from repro_torch.train.compression import make_dp_train_step
    from repro_torch.train.step import init_opt_state
    opt, cap = make_optimizer('eva', lr=0.15)
    state = init_opt_state(model, opt, cap, params0, batches[0],
                           device='cuda')
    step, init_err = make_dp_train_step(model, opt, cap, None, device='cuda')
    params, err, losses, sats = params0, init_err(params0), [], []
    metrics.reset()
    launches.reset()
    for batch in batches:
        params, state, err, met = step(params, state, err, batch)
        losses.append(float(met['loss']))
        sats.append(float(met['comm_saturation']))
    return {'losses': losses, 'saturation': sats,
            'launches': launches.snapshot(), 'sites': metrics.snapshot()}


def _p10_sum(results, get):
    """Sum a launch dict over the ranks."""
    out = collections.Counter()
    for res in results:
        out.update(get(res))
    return dict(out)


def _p10_check(torch, results, root):
    """Hold 10b's and 10c's results; returns (launches summed over the
    ranks, per-step launches, info)."""
    from repro_torch.obs.events import validate_record
    per_step, info = {}, {'ranks_seconds': [r['seconds'] for r in results]}
    counts = collections.Counter()
    r0 = results[0]
    for rank, res in enumerate(results):
        require(res['world_and_rank_outside'] == (1, None),
                f'rank {rank}: world_and_rank outside a scope')
    phase(f'10b W = {P10_WORLD}: {P10_STEPS} steps each over gloo, every '
          'update held to the W = 1 step on the whole batch')
    for tag, r in r0['runs'].items():
        want = {k: v * P10_STEPS for k, v in P10_PATHS[tag][4].items()}
        for rank, res in enumerate(results):
            got = res['runs'][tag]['launches']
            require(got == {k: want.get(k, 0) for k in got},
                    f'10b {tag} rank {rank}: launches {got} != {want}')
            require(res['runs'][tag]['losses'] == r['losses'],
                    f'10b {tag}: rank {rank} losses differ from rank 0')
        total = _p10_sum(results, lambda res: res['runs'][tag]['launches'])
        counts.update(total)
        per_step[f'p10 W=4 {tag} (summed over ranks)'] = {
            k: v // P10_STEPS for k, v in total.items() if v}
        _finite_and_falling(r['losses'], f'10b {tag}')
        if tag == 'kfac shard':
            bands = {k for k in r['calls'] if k.startswith('matvec_cols')}
            require(bands == {'matvec_cols[1, 250, 1000]'},
                    f'10b kfac shard: band products {bands}')
        info[tag] = {'losses': r['losses'], 'worst_vs_w1': r['worst'],
                     'w1_cap': P10_W1_RTOL.get(tag, PARAM_RTOL),
                     'worst_leaf_vs_w1': r['worst_leaf'],
                     'worst_vs_twin': r['twin'], 'twin_vs_w1': r['split'],
                     'launches_summed': total}
        print(f'  {tag}: loss {r["losses"][0]:.5f} -> {r["losses"][-1]:.5f}; '
              f'each update within {r["worst"]:.2e} of the W = 1 step\'s '
              f'norm (cap {P10_W1_RTOL.get(tag, PARAM_RTOL):.0e}; one leaf at most {r["worst_leaf"]:.2e} of its own), '
              f'within {r["twin"]:.2e} of its one-process twin\'s (the '
              f'twin {r["split"]:.2e} from the W = 1 step); launches over '
              f'4 ranks '
              f'{ {k: v for k, v in total.items() if v} }'
              + (f'; band calls {r["calls"]}; matvec_cols on the path\'s '
                 f'band inputs {r["kerr"]["matvec_cols"]:.2e} of its limit'
                 if r['kerr'] else ''), flush=True)
    for tag, p in r0['psum'].items():
        for rank, res in enumerate(results):
            q = res['psum'][tag]
            require(q['params_equal'] and q['state_equal'],
                    f'10b {tag} rank {rank}: gather != psum after '
                    f'{P10_CMP_STEPS} steps')
        counts.update(_p10_sum(results, lambda res: res['psum'][tag][
            'launches']))
        print(f'  {tag}: exchange gather = psum, atol 0, parameters and '
              f'state after {P10_CMP_STEPS} steps on every rank', flush=True)
    for tag, o in r0['onestep'].items():
        if tag == 'eva fused':
            require(o['first_step'] <= PARAM_RTOL,
                    f'10b onestep {tag}: first step {o["first_step"]:.2e} '
                    'from the zero-statistics step')
        else:
            require(o['first_step'] == 0.0, f'10b onestep {tag}: the cold '
                    f'caches moved the dense-plan weights by '
                    f'{o["first_step"]}')
        require(o['lag'].get('pipeline_lag/stats') == 1,
                f'10b onestep {tag}: lag {o["lag"]}')
        _finite_and_falling(o['losses'], f'10b onestep {tag}')
        total = _p10_sum(results, lambda res: res['onestep'][tag][
            'launches'])
        counts.update(total)
        per_step[f'p10 W=4 onestep {tag} (summed over ranks)'] = {
            k: v // P10_STEPS for k, v in total.items() if v}
        info[f'onestep {tag}'] = o
        print(f'  onestep {tag}: first step from zero statistics '
              f'({o["first_step"]:.2e}); loss {o["losses"][0]:.5f} -> '
              f'{o["losses"][-1]:.5f}; lag {o["lag"]}', flush=True)
    m = r0['mlp']
    bands = {k: v for k, v in m['calls'].items()
             if k.startswith('matvec_cols')}
    iters = SHARD['solve_iters']
    require(bands == {'matvec_cols[3, 250, 1000]': 2 * iters * P10_MLP_STEPS,
                      'matvec_cols[1, 250, 1000]': 2 * iters * P10_MLP_STEPS},
            f'10b MLP kfac shard: band calls {bands}')
    mtotal = _p10_sum(results, lambda res: res['mlp']['launches'])
    counts.update(mtotal)
    per_step['p10 W=4 MLP kfac shard (summed over ranks)'] = {
        k: v // P10_MLP_STEPS for k, v in mtotal.items() if v}
    require(all(map(math.isfinite, m['losses'])),
            f'10b MLP kfac shard: losses {m["losses"]}')
    info['mlp kfac shard'] = {
        'losses': m['losses'], 'worst_vs_w1': m['worst'],
        'w1_cap': P10_W1_RTOL['mlp kfac shard'],
        'worst_vs_twin': m['twin'], 'twin_vs_w1': m['split'],
        'band_calls_per_rank': bands}
    print(f'  MLP 784-1000-1000-1000-1000-10 K-FAC shard: band calls per '
          f'rank {bands}; each update within {m["worst"]:.2e} of the W = 1 '
          f'step\'s norm (cap {P10_W1_RTOL["mlp kfac shard"]:.0e}), within {m["twin"]:.2e} of its one-process twin\'s '
          f'(the twin {m["split"]:.2e} from the W = 1 step); matvec_cols on '
          f'the stacked bands {m["kerr"]["matvec_cols"]:.2e} of its limit',
          flush=True)
    c = r0['int8']
    require(c['saturation'] == [0.0] * P10_STEPS,
            f'10b int8: comm_saturation {c["saturation"]}')
    _finite_and_falling(c['losses'], '10b int8')
    ctotal = _p10_sum(results, lambda res: res['int8']['launches'])
    counts.update(ctotal)
    per_step['p10 W=4 int8 eva (summed over ranks)'] = {
        k: v // P10_STEPS for k, v in ctotal.items() if v}
    sites = {
        'grads/dp f32': r0['runs']['eva']['sites']['grads/dp'],
        'stats/dp eva': r0['runs']['eva']['sites']['stats/dp'],
        'stats/dp kfac': r0['runs']['kfac shard']['sites']['stats/dp'],
        'refresh/kfac gather': r0['runs']['kfac shard']['sites'][
            'refresh/kfac'],
        'refresh/kfac psum': r0['psum']['kfac shard']['sites'][
            'refresh/kfac'],
        'refresh/foof gather': r0['runs']['foof']['sites']['refresh/foof'],
        'refresh/foof psum': r0['psum']['foof']['sites']['refresh/foof'],
        'factor/kfac': r0['runs']['kfac shard']['sites']['factor/kfac'],
        'grads/dp int8': c['sites']['grads/dp'],
    }
    sites = {k: {f: v[f] for f in ('bytes_per_call', 'codec', 'mode')}
             for k, v in sites.items()}
    info['sites'] = sites
    print('  bytes a call per site: ' + '; '.join(
        f'{k} {v["bytes_per_call"]} ({v["mode"]})' for k, v in
        sites.items()), flush=True)
    print(f'  int8 DP step: comm_saturation 0 over {P10_STEPS} steps, loss '
          f'{c["losses"][0]:.5f} -> {c["losses"][-1]:.5f}', flush=True)
    phase(f'10c elastic: W = 4, SIGTERM at {P10_KILLS[0]}, restore at W = 2,'
          f' SIGTERM at {P10_KILLS[1]}, restore at W = 4, '
          f'{P10_CHAOS_STEPS} steps; a live world_fn 4 -> 2 -> 4')
    for name, e in r0['elastic'].items():
        base = e['base']
        stitched = [x for h in e['chaos'] for x in h]
        require([s for s, _ in stitched] == list(range(P10_CHAOS_STEPS)),
                 f'10c {name}: steps {[s for s, _ in stitched]}')
        rel = max(abs(a - b) / abs(b) for (_, a), (_, b)
                  in zip(stitched, base))
        require(rel <= TRAJ_RTOL, f'10c {name}: stitched run {rel:.3e} '
                f'from the uninterrupted one')
        live = e['live']
        lrel = max(abs(a - b) / abs(b) for (_, a), (_, b)
                   in zip(live, base[:P10_LIVE_STEPS]))
        require([s for s, _ in live] == list(range(P10_LIVE_STEPS)),
                 f'10c {name} live: steps {[s for s, _ in live]}')
        require(lrel <= TRAJ_RTOL, f'10c {name} live resize: {lrel:.3e} '
                'from the uninterrupted run')
        recs = [json.loads(line) for line in (
            Path(root) / name / 'chaos' / 'metrics.jsonl').read_text(
        ).splitlines()]
        bad = [r for r in recs if validate_record(r)]
        require(not bad, f'10c {name}: invalid records {bad[:2]}')
        resizes = [(r['world_from'], r['world_to'], r['source'])
                   for r in recs if r['event'] == 'reshard']
        require(resizes == [(4, 2, 'checkpoint'), (2, 4, 'checkpoint')],
                f'10c {name}: reshard records {resizes}')
        lrecs = [json.loads(line) for line in (
            Path(root) / name / 'live' / 'metrics.jsonl').read_text(
        ).splitlines()]
        lres = [(r['world_from'], r['world_to'], r['source'])
                for r in lrecs if r['event'] == 'reshard']
        require(lres == [(4, 2, 'live'), (2, 4, 'live')],
                f'10c {name} live: reshard records {lres}')
        info[f'elastic {name}'] = {'stitched_max_rel': rel,
                                   'live_max_rel': lrel,
                                   'seconds': e['seconds']}
        print(f'  {name}: stitched 4 -> 2 -> 4 run, every step once, within '
              f'{rel:.3e} relative of the uninterrupted run (limit '
              f'{TRAJ_RTOL}); live 4 -> 2 -> 4 within {lrel:.3e}; records '
              f'{resizes}; {e["seconds"]:.1f} s', flush=True)
    return dict(counts), per_step, info


def multi_worker_phase(torch, rows):
    """Phase 10: 10a in this process, 10b and 10c in four spawned ranks;
    the launches of its paths go into the kernel rows."""
    import shutil
    from repro_torch.launch import workers
    t0 = time.perf_counter()
    counts, per_step, info = dp_w1_phase(torch)
    torch.cuda.empty_cache()
    root = ROOT / 'build' / 'smoke_elastic'
    shutil.rmtree(root, ignore_errors=True)
    print(f'transport: gloo, {P10_WORLD} ranks on 1 card', flush=True)
    t1 = time.perf_counter()
    results = workers.spawn(_p10_rank, P10_WORLD, args=(str(root),),
                            backend='gloo', device='cuda',
                            timeout=P10_TIMEOUT)
    spawn_s = time.perf_counter() - t1
    c2, p2, i2 = _p10_check(torch, results, root)
    shutil.rmtree(root, ignore_errors=True)
    for k, v in c2.items():
        counts[k] = counts.get(k, 0) + v
    per_step.update(p2)
    _add_counts(rows, {k: counts.get(k, 0) for k in
                       (row['name'] for row in rows)}, per_step)
    require(counts.get('matvec_cols', 0) > 0,
            'phase 10 launched no matvec_cols')
    info.update(i2)
    info['seconds'] = {'10a': t1 - t0, '10b_10c_spawn': spawn_s,
                       'total': time.perf_counter() - t0}
    print(json.dumps({'multi_worker_checks': info}))
    print(f'  phase 10 took {info["seconds"]["total"]:.1f} s (10a '
          f'{t1 - t0:.1f} s, the four ranks {spawn_s:.1f} s)', flush=True)


# ---------------------------------------------------------------------------
# 11. the CLI and the examples on the card


def _cli_run(torch, flags, out_dir, trace):
    """One in-process run of the CLI: (its step records' losses and ms,
    the metrics path, the wrapper launch counts, the port's device kernels
    in its trace or None).  Every record must validate."""
    from repro_torch.kernels import launches
    from repro_torch.launch import train as cli
    from repro_torch.obs.events import validate_record
    launches.reset()
    argv = CLI_BASE + flags + ['--out-dir', str(out_dir)]
    if trace:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            history = cli.main(argv)
            torch.cuda.synchronize()
        device = sum(e.count for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA and 'repro::' in e.key)
    else:
        history = cli.main(argv)
        device = None
    counts = launches.snapshot()
    path, = Path(out_dir).glob('*/metrics.jsonl')     # <arch>-<opt>/
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    bad = [r for r in recs if validate_record(r)]
    require(not bad, f'{argv}: invalid records {bad[:2]}')
    steps = [r for r in recs if r['event'] == 'step']
    losses = [r['loss'] for r in steps]
    require(losses == history, f'{argv}: step records {losses} against the '
            f'returned history {history}')
    torch.cuda.empty_cache()
    return losses, [r['step_time_s'] * 1e3 for r in steps], path, counts, \
        device


def _cli_paths(torch, work):
    """11a: each CLI run through the kernels beside its --kernel-impl torch
    twin.  Returns the launch counts, the per-step counts and the info."""
    from repro_torch.kernels import launches
    from repro_torch.train import checkpoint as ckpt
    counts = {k: 0 for k in launches.COUNTS}
    per_step, info, profiled = {}, {}, None
    for tag, (flags, want_step, traced) in CLI_RUNS.items():
        n_steps = int(flags[flags.index('--steps') + 1])
        t0 = time.perf_counter()
        kl, kms, kpath, got, device = _cli_run(torch, flags, work / tag /
                                               'kernel', trace=traced)
        t1 = time.perf_counter()
        pl, pms, ppath, twin, _ = _cli_run(
            torch, flags + ['--kernel-impl', 'torch'], work / tag / 'plain',
            trace=False)
        t2 = time.perf_counter()
        want = {k: want_step.get(k, 0) * n_steps for k in launches.COUNTS}
        require(got == want, f'{tag}: launches {got} != {want}')
        require(not any(twin.values()), f'{tag}: the twin launched {twin}')
        want_dev = sum(DEVICE_LAUNCHES[k][0] * v for k, v in want.items())
        require(not traced or want_dev * (1 - CLI_TRACE_SHORT) <= device
                <= want_dev, f'{tag}: {device} port kernels in the trace, '
                f'want {want_dev}')
        require(len(kl) == len(pl) == n_steps and all(
            math.isfinite(x) for x in kl + pl), f'{tag}: losses {kl} {pl}')
        rel = max(abs(a - b) / abs(b) for a, b in zip(kl, pl))
        require(rel <= TRAJ_RTOL, f'{tag}: kernel losses {kl} against the '
                f'plain twin {pl}: {rel:.3e} > {TRAJ_RTOL}')
        if '--ckpt-every' in flags:
            for path in (kpath, ppath):
                kept = ckpt.available_steps(path.parent / 'ckpt')
                require(kept == [2, 4], f'{tag}: checkpoints {kept}')
        if '--profile' in flags:
            profiled = kpath
        for k, v in got.items():
            counts[k] += v
        per_step[f'lm {tag}'] = dict(want_step)
        info[tag] = {'losses_kernel': kl, 'losses_plain': pl,
                     'max_rel_loss_diff': rel, 'step_ms_kernel': kms,
                     'kernel_run_traced': traced,
                     'step_ms_plain': pms, 'launches': got,
                     'port_device_kernels_traced': device,
                     'port_device_kernels_want': want_dev,
                     'seconds_kernel': t1 - t0, 'seconds_plain': t2 - t1}
        print(f'  {tag}: {n_steps} steps, loss {kl[0]:.4f} -> {kl[-1]:.4f}, '
              f'within {rel:.2e} of the plain twin; launches {got}, '
              + (f'{device} of {want_dev:.0f} port kernels in the trace; '
                 if traced else 'not traced; ')
              + f'step ms kernel {[round(x, 1) for x in kms]}, plain '
              f'{[round(x, 1) for x in pms]}; {t1 - t0:.1f} s + '
              f'{t2 - t1:.1f} s', flush=True)
    return counts, per_step, info, profiled


def _cli_processes(work, profiled):
    """11b and 11c, as processes started together on the card: the report
    on the profiled run's records (``--validate``, then the breakdown), the
    CLI on demo_lm('small') and each example.  Each must exit 0; every
    process still running when one fails or times out is killed.  Returns
    each one's seconds and output."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS='2')
    report = 'scripts/obs_report_torch.py'
    jobs = {'report validate': [report, '--validate', str(profiled)],
            'report breakdown': [report, str(profiled)],
            **CLI_SUBPROCESSES}
    procs = {}
    t0 = time.perf_counter()
    seconds, out = {}, {}
    try:
        for tag, argv in jobs.items():
            log = open(work / f'{tag.replace(" ", "_")}.log', 'w')
            procs[tag] = (subprocess.Popen(
                [sys.executable, *argv], cwd=ROOT, env=env, stdout=log,
                stderr=subprocess.STDOUT), log)
        for tag, (proc, log) in procs.items():
            left = CLI_SUB_TIMEOUT - (time.perf_counter() - t0)
            try:
                rc = proc.wait(timeout=max(left, 1))
            except subprocess.TimeoutExpired:
                fail(f'{tag} still running after {CLI_SUB_TIMEOUT} s')
            seconds[tag] = time.perf_counter() - t0
            log.close()
            out[tag] = Path(log.name).read_text()
            require(rc == 0, f'{tag}: exit code {rc}: {out[tag][-2000:]}')
    finally:
        for proc, log in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    require('records OK' in out['report validate'], out['report validate'])
    for piece in ('mean step time', 'precondition', 'profile @ step 3'):
        require(piece in out['report breakdown'],
                f'the breakdown lacks {piece!r}')
    print('\n'.join('  | ' + line for line in
                    out['report breakdown'].strip().splitlines()[:16]))
    for tag in jobs:
        last = [line for line in out[tag].splitlines() if line.strip()][-1:]
        print(f'  {tag}: exit 0 after {seconds[tag]:.1f} s; '
              f'{last[0][:120] if last else ""}', flush=True)
    return seconds


def cli_phase(torch, rows):
    """Phase 11: the training CLI and the examples on the card; the
    launches of 11a go into the kernel rows."""
    import shutil
    from repro_torch.launch import train as cli
    phase('11 the CLI and the examples on the card: repro_torch.launch.'
          'train on demo_lm(100m) at 16 x 512, the report, the examples')
    t0 = time.perf_counter()
    work = ROOT / 'build' / 'smoke_cli'
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        counts, per_step, info, profiled = _cli_paths(torch, work)
        # the host cost of one of the CLI's batches, beside its step: the
        # Prefetcher's thread makes each while the card runs a step
        stream = cli.lm_stream(LM_STREAM['vocab'], LM_STREAM['seq_len'],
                               LM_STREAM['batch'], 'cuda')
        host_ms = []
        for step in range(2):
            tb = time.perf_counter()
            stream.batch_at(step)
            host_ms.append((time.perf_counter() - tb) * 1e3)
        info['lmstream_batch_host_ms'] = host_ms
        print(f'  LMStream.batch_at at 16 x 512, vocab 32768: host ms '
              f'{[round(x, 1) for x in host_ms]}', flush=True)
    finally:
        cli.lm_stream.cache_clear()
    t1 = time.perf_counter()
    info['process_seconds'] = _cli_processes(work, profiled)
    t2 = time.perf_counter()
    _add_counts(rows, counts, per_step)
    info['seconds'] = {'11a': t1 - t0, '11b_11c': t2 - t1, 'total': t2 - t0}
    print(json.dumps({'cli_checks': info}))
    print(f'  phase 11 took {t2 - t0:.1f} s (11a {t1 - t0:.1f} s, 11b and '
          f'11c together {t2 - t1:.1f} s)', flush=True)
    shutil.rmtree(work, ignore_errors=True)


def main() -> None:
    if not (SRC / 'repro_torch' / 'kernels' / 'csrc').is_dir():
        fail(f'no src/repro_torch beside {Path(__file__).name}: run it from '
             'the root of a checkout of the repository')
    sys.path.insert(0, str(SRC))
    import torch
    smi = device_phase(torch)
    t0 = time.perf_counter()
    build_phase()
    err = kernels_phase(torch)
    model, params0, batches = ae_setup(torch)
    phase('4 main path: Eva, Eva-f and Eva-s on the full-width autoencoder')
    counts, per_step = main_phase(torch, model, params0, batches, MAIN_PATHS,
                                  _falls, 'ae')
    s_counts, s_per_step = solver_phase(torch, model, params0, batches)
    counts = {k: counts[k] + s_counts[k] for k in counts}
    per_step.update(s_per_step)
    stacked_phase(torch)
    rows = times_phase(torch, err, counts, per_step, model, params0, batches)
    del model, params0, batches
    corpus, bare_step_ms = lm_phase(torch, rows)
    rest_phases(torch, rows, corpus, bare_step_ms)
    families_phase(torch, rows)
    multi_worker_phase(torch, rows)
    cli_phase(torch, rows)
    print(f'total {time.perf_counter() - t0:.1f} s after device check')
    print(json.dumps({'kernels': rows}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
