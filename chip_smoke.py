#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (categoricalnf_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py [--seed 0]

1. Prints the card's name and power limit and builds every CUDA kernel
   (one nvcc per source, started together), printing ptxas's registers
   and spills of each; counts the tensor-core (HMMA) instructions of each
   kernel function in the SASS and checks that the bf16 forward, the bf16
   backward and the fp32 (3xTF32) forward all have some.
2. Holds each kernel against its plain PyTorch version on the card, at the
   shapes the serving and training paths give it (a 1024-sample chunk; the
   fp32 net and a second mixture forward at eval_bpd's 1024 sets x 4
   chains; the backward kernels at a training step's 16,384 rows and
   M = 65,536, the fp32 backward and the FMA forward of a differentiable
   fp32 call at 4,096 and 16,384 rows; the mixture forward and its
   backward also at K = 3 and K = 16 with M = 91; K = 32 in 8.), twice,
   with a synchronize after each launch; times both with CUDA events
   around runs of back-to-back launches.  The fp32 forward is also held to
   fp32's accuracy (F32_FWD_REL) beside a control that a single TF32 pass
   reads above it.  The mixture inverse is held by its residual in y
   (``inverse_failures``: per element within max(2 e_p, tau) of the plain
   version's residual e_p and an fp32 floor tau) at the sampling path's
   sizes, at --seed and --seed + 1: a 1024-set chunk (M = 65,536) at K = 8
   and K = 3, a /sample of 4 sets (M = 256), K = 16 at M = 91, and the
   tails (y = +-60 and +-90, log-scales at the clip), beside the plain
   version cut short, which the rule must refuse; it is timed at M = 65,536
   and M = 256.  The mixture lines carry the kernels' registers and
   spills.  #3 bf16, #4 bf16 and #3 fp32 at sets of 33, 48, 64, 100 and
   128 (``check_big_set_kernels``: in bf16 whole-set tiles, and 2-CTA
   clusters where a set does not fit one block; #3 fp32 over clusters of
   2 blocks up to 64 rows and 4 above) against plain within the
   flagship's limits at --seed and --seed + 1, masked at 64, and the fp32
   train step's pair (#3 fp32 with grad, #4 fp32; a set over a cluster of
   2 blocks up to 64 rows, of 4 above) against autograd of plain within
   1e-4 and 2e-4 as torch.allclose, masked at 64 beside the call without
   the mask above 10 x; each of the five 4 times on the same inputs
   bitwise; each timed at the set-64 and set-128 runs' 1024 sets; their
   outputs on fixed inputs hash to the digests of the trees before
   (``SMALL_SET_DIGESTS`` at sets of 16 and 24; ``PAIR_AND_BIG_SET_DIGESTS``:
   the fp32 pair at 16 and 24, the other three at 64 and 128).
3. Serves the flagship set-shuffling flow (runs/set16/config.json as it
   is, seeded random weights, data init on one batch) over HTTP:
   /health, /sample, /sample_metrics; then the fp32 importance-sampled
   bits/var of one batch.  Checks the answers, checks that every serving
   kernel launched during this phase, and checks the served model against
   the plain path on the CPU on a small input.
4. Trains the flagship (runs/set16/config.json: bf16, batch 1024) for 200
   steps through the port's Trainer (evals at 100 and 200): finite losses,
   the best bpd 0.2 bits/var below the untrained one and above the
   optimum, no integrity alarm, every training kernel launched; prints
   set_shuffling_train_samples_per_s over steps 101-200; then traces 10
   more train steps with torch.profiler (the device's busy time a step by
   kernel, its idle share); serves the run.
4b. runs/set16 at the CLI's --set_size 64 (``big_set_phase``): 100 steps
   through the Trainer with the checks of 4. (its fp32 IS eval untrained,
   at 50 and 100; the best above log2(64!)/64 = 4.6249), 10 steps
   traced, served (/sample, /sample_metrics, eval_bpd) and held against
   its CPU copy; then at --set_size 128 three train steps with finite
   losses and one eval batch, #4 bf16 over 2-CTA clusters and #3 fp32
   over clusters of 4.
5. One fp32 train step of the flagship (64 sets), at --seed and at
   --seed + 1: the kernels on the card, the plain path on the card and a
   CPU fp32 copy, each held per tensor against the same step in float64 on
   the CPU (rules (a)-(c) of ``train_step_failures``), beside a control
   (the kernels' gradients rounded once to bf16) that must read above the
   limit where it is at its floor.  Only the default --seed 0 (the steps
   of seeds 0 and 1) is known to pass: at seed 2 the control reads inside
   its limit on some tensor, the port's kernels as they are included, so
   --seed 1 or above may refuse a sound program (ROADMAP.md, Queue C).
   Then trains in fp32 through that pair (#3 fp32 with grad and #4 fp32):
   runs/set16/config.json with compute_dtype float32 (the CLI's switch)
   for FP32_SET_STEPS (60) steps, its fp32 IS eval untrained and at the
   end, with the checks of 4. and each of the pair launched 8 times a
   step, 10 more steps traced; and runs/molecules/config.json's
   architecture (hidden 96, 4 node and 4 edge layers, K = 8, batch 64)
   with compute_dtype float32 and dataset synthetic for FP32_MOL_STEPS
   (20) steps with the checks of 4. but the optimum, the pair launched
   with the node flow's key mask, 10 more steps traced; the same for
   runs/molecules_v4/config.json (hidden 192, 4 node and 6 edge layers,
   batch 128; evals untrained and at the end), #4 launched with the
   residual copies and the MLP pair in its global workspace; and
   runs/moses/config.json (hidden 256, K = 16, batch 192) in fp32 for
   FP32_MOSES_CALLS (2) calls of its 4 steps a call, no eval: every loss
   finite, #4 with qkv in its workspace too.
5b. runs/set16 in fp32 at the CLI's --set_size 64 (``fp32_big_set_phase``):
   FP32_BIG_SET_STEPS (30) steps through the Trainer with the checks of 4.
   (its fp32 IS eval untrained and at the end, above log2(64!)/64), the
   pair over clusters 8 times a step, 10 steps traced; then at --set_size
   128 three train steps with finite losses and one eval batch above
   log2(128!)/128 = 5.5950.
6. The graph-coloring family (runs/coloring/config.json as it is: bf16,
   batch 256, graphs of 10-20 nodes padded to 20, a ScannedBlocks stack of
   3 two-parity blocks of RGCN couplings).  First, with the kernel checks
   of 2., #2 and #2' at its M = 256 x 20 x 2 = 10,240 and #1 there and at a
   /sample of 4 graphs (M = 160), at --seed and --seed + 1, held and timed
   as above.  Then 200 steps through the port's Trainer (evals at 100 and
   200 with its 8 chains, the final sample metrics at 1024 graphs): the
   checks of 4. but the optimum, every eval bpd above 0, #2 and #2'
   launched, #1 in the final sampling; prints
   graph_coloring_train_samples_per_s, the peak memory and the validity
   columns, and traces 10 more steps.  Serves the run: /health, /sample of
   4 graphs (edges inside their graph, colors in range, "valid" as
   recomputed), /sample_metrics at 1024, a bad request; #1 and #2
   launched.  Last, the served model with random coupling output layers
   against its CPU copy, as in 3., and #1 held by the residual rule on
   every inverse call of that model's sample of a batch of graphs, at
   --seed and --seed + 1.
7. The dequantized set flows.  First, with the kernel checks of 2., at
   --seed and --seed + 1: #1 at the encoders' shapes (M = 16,384 and
   65,536, K = 4) by the residual rule, and its backward #1' (the
   loop-rule kernel: the reference's gradient, reverse mode through the
   inverse's loop) there, each gradient elementwise against autograd
   through the plain loop on the card (at least 90% of the elements
   within 1e-3 of it plus 1e-4 of its largest magnitude), beside the
   implicit rule (the exact derivative) as a control that fails it; #2 at the
   linear-flows decoder's M = 1,048,576; #3 and #4 in bf16 at the vardeq
   main flow's in 1, out 26; each timed.  Then runs/sum_vardeq
   (SetSummationTask, vardeq) and runs/shuffle_linear (linear flows), each
   as it is, 200 steps with the checks of 4. and #1' launched; prints
   set_summation_train_samples_per_s and shuffle_linear_train_samples_per_s;
   serves each run (/sample, /sample_metrics with sum_validity or
   permutation_validity), holds #1 on every inverse call of a sample of
   the served model with random coupling output layers and that model
   against its CPU copy.  Then runs/shuffle_decoder_mlp (a learned MLP
   decoder) as it is, at its steps_per_call of 8, trained and served the
   same way.  Then one fp32 train step of runs/sum_vardeq (64 sets, #1' in
   the encoder), the loop rule on both devices: the tensors outside the
   encoder per tensor against the same step in float64 on the CPU by rule
   (a) of 5., the encoder's against the CPU fp32 step within max(1e-3, 2
   e_plain), e_plain the plain path's on the card, beside the CPU step
   with the implicit rule as a control that must read over that limit.
8. Language modeling.  First, with the kernel checks of 2., #1, #2 and
   #2' at K = 32 at the LM path's M = 131,072 (a train step's density
   pass), 512 (a sample batch of 128) and 16 (a /sample of 4): #1 by the
   residual rule at --seed and --seed + 1 (with peaked mixtures and tails
   at K = 32), #2 and #2' against their plain versions; each timed, with
   the wide groups' registers and spills.  Then runs/lm_v6/config.json as
   it is (full width and depth: 4 blocks of two autoregressive layers,
   2-layer LSTMs of hidden 512 in bf16, K = 32, the HMM prior of 32
   states, batch 128 of 256 characters) for LM_STEPS steps, its IS
   bits/char on LM_EVAL_BATCHES (4) eval batches of 8 chains before and
   after, the final
   sample metrics and the test: the losses finite and falling, every bpd
   finite and above the analytic optimum, no alarm, #1, #2 and #2'
   launched; prints language_modeling_train_samples_per_s with the peak
   memory and the card's idle share from 2 steps traced with the host's
   activity (on crops of 32 characters: the same operations for each
   position); times the LSTMs and the HMM prior alone; holds #1 on every
   inverse call of sample_metrics at 128 samples at --seed and --seed + 1;
   serves the run (/health, /sample of 4 strings, a bad request) and holds
   the served model, its heads random, against its CPU copy.  Then the
   same config with net transformer (2-block causal transformers of
   hidden 512, 4 heads, a KV cache of 256) for LM_TRANSFORMER_STEPS
   steps with the same checks, 10 steps traced, and the KV-cache rollout
   of a trained net held against its batched pass in bf16 and fp32
   (``check_kv_rollout``); sampled, held and served as the LSTMs.
9. Molecules (GraphCNF).  First, with the kernel checks of 2., the key
   mask in #3 bf16, #4 bf16 and #3 fp32 at the node flow's shapes (128
   graphs of 24 nodes, in 6, out 156, hidden 192; fp32 at 4 chains, and
   at moses's hidden 256, K = 16; #3 and #4 bf16 at moses's 192 graphs,
   out 300, #4 with its residual copies in global memory), at --seed and
   --seed + 1, masks of a synthetic batch with a set of one valid key and
   one of none: each within its tolerance of plain, the same call without
   the mask above 10 x that tolerance, a mask of ones bitwise the call
   without one; #4 at hidden 192 with the copies in global memory bitwise
   the shared layout's; each timed.  The fp32 train step's pair with the
   key mask at runs/molecules' hidden 96 and at 128 (in 6, out 156, 64 and
   128 graphs of 24 nodes), at --seed and --seed + 1: #3's output within
   1e-4 and each gradient of #4 within 2e-4 (allclose's) of plain_forward
   and autograd through it with the mask, the pair without the mask above
   10 x each, a mask of ones bitwise no mask; the same at molecules_v4's
   hidden 192 on 128 graphs and at moses's 256 on 192 graphs (out 300),
   where #4 keeps regions of its tile in a global workspace (its launches
   counted); timed at hidden 96 on 64 graphs and at the two wide shapes;
   #4 with every region in the workspace forced at hidden 96 and 128
   bitwise the shared layout's.  Then runs/molecules_v4/config.json as
   it is but for its dataset (the in-memory synthetic molecules; hidden
   192, 4 node and 6 edge layers, K = 8, bf16, batch 128) for MOL_STEPS
   (10) steps with the checks of 4.,
   every molecule kernel launched with the mask, the final sample metrics
   at 1,024 and sampled_molecules.json; prints
   molecule_generation_train_samples_per_s, the peak memory, the validity
   columns and a 10-step trace.  Serves the run (/health, /sample of 4
   with atoms, bonds, SMILES and "valid" checked, /sample_metrics, a bad
   request), holds the served model with random coupling output layers
   against its CPU copy (bpd within 1e-3; a sample stage by stage, each on
   the CPU's earlier stages) and #1 on every inverse call of its sample at
   --seed and --seed + 1.  Then runs/moses/config.json at
   full width (hidden 256, K = 16, 12 bond layers, node_cond_atoms,
   bond_cond_degree, batch 192; synthetic molecules) the same way for
   MOSES_STEPS (20) steps, #4 bf16 launched with the copies in global
   memory.
10. The parallel layer (``parallel_phase``): a process group of one rank
   over NCCL from a FileStore, its 1 x 1 ``create_mesh()``; runs/set16 as
   it is for PARALLEL_STEPS (10) steps through the Trainer on that mesh
   and without one from the same seed: every logged row (the losses, the
   gradient norms, the evals) and every parameter at the end bitwise
   equal, #3 bf16, #4 bf16, #2 and #2' launched under the all-reduces;
   then the sharded IS eval on the mesh bitwise ``eval_step`` on one eval
   batch x 4 chains, #3 fp32 and #2 launched; ms a step with and without
   the mesh printed, not bounded.
11. Prints each phase's seconds, one JSON line of kernel numbers (with
   the coloring's, the dequantized flows', the LM's and the molecules'
   shapes, and every path's launches), then, as the last line, {"ok":
   true, "device": {...}}.

Exits non-zero, printing no result, without a CUDA card, outside a checkout
of the repo, or when any check fails.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import http.client
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3, FLOP/s.
HBM_BYTES_PER_S = 3.35e12
# "tf32": the tensor cores' dense TF32 rate, which the fp32 forward's three
# TF32 products a multiply-add run at; "float32": the FMA units.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 494.7e12}

# Slice shapes: one sampling chunk of the flagship; eval_bpd runs its IS
# chains as a batch of EVAL_CHAINS x B sets.
B, S, D, K, H, HEADS = 1024, 16, 4, 8, 96, 4
OUT = D * (2 + 3 * K)
EVAL_CHAINS = 4
# The graph-coloring path's [graphs, nodes, D] (runs/coloring/config.json:
# batch 256, graphs padded to 20 nodes, encoding dim 2), whose mixtures
# have K = 8 as the flagship's
COLORING_SHAPE = (256, 20, 2)

# Float operations per mixture component, as the kernels do them (a
# transcendental counts as one): the parameter set-up (log-softmax, clip,
# exp of the scale) and one evaluation of the three logsumexps.
MIX_SETUP_OPS = 10
MIX_EVAL_OPS = 24
# and the backward's pull-back of the three logsumexps to the component's
# logit, mean and log-scale (exps of the three weights, the sigmoid pair)
MIX_BWD_OPS = 30
# The loop-rule backward of the inverse (#1'): its evaluations of the
# components' terms an element (42 bisections, 3 Newton steps forward and 3
# again in reverse) and the reverse steps, each one pull-back of the three
# logsumexps
LOOP_EVALS, LOOP_NEWTON = 42 + 3 + 3, 3
# The inverse's linear domain: the weights pi and pi / s and log2(e) / s
# once, then per iteration z log2(e), exp2, 1 + e, its reciprocal, the
# sigmoid pair's two products and three fused multiply-adds (two each)
MIX_INV_SETUP_OPS = 3
MIX_INV_ITER_OPS = 13


class CheckFailed(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


_CYCLES_PER_MS: list = []


def spin(ms: float) -> None:
    """Keeps the card busy for about ``ms``, so that the calls queued
    meanwhile then run back to back, with no host time between them."""
    import torch
    if not _CYCLES_PER_MS:
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(20_000_000)
        end.record()
        end.synchronize()
        _CYCLES_PER_MS.append(20_000_000 / start.elapsed_time(end))
    torch.cuda._sleep(int(ms * _CYCLES_PER_MS[0]))


def cuda_ms(fn, n: int) -> tuple[float, float]:
    """(device ms, host ms) per call of ``fn``.  Device: ``n`` calls queued
    behind a spin run back to back between one pair of CUDA events; their
    time over ``n``, median of three such runs.  Host: the wall time the
    caller spends queuing one call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        spin(1.5 * host_ms * n + 1.0)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / n)
    return statistics.median(runs), host_ms


def twice(fn):
    """Run ``fn`` twice, synchronizing after each launch; the kernels are
    deterministic, so both results must be identical."""
    import torch
    outs = []
    for _ in range(2):
        r = fn()
        torch.cuda.synchronize()
        outs.append(r if isinstance(r, tuple) else (r,))
    for a, b in zip(*outs):
        check(torch.equal(a, b), "kernel result differs between two runs")
    return outs[0] if len(outs[0]) > 1 else outs[0][0]


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def close(a, b, tol: float) -> bool:
    import torch
    return bool(torch.allclose(a.float(), b.float(), rtol=tol, atol=tol))


def mixture_inputs(gen, shape, k, device):
    import torch
    def n(*s):
        return torch.randn(*s, generator=gen, device=device)
    return (n(*shape) * 2.0, n(*shape, k), n(*shape, k) * 2.0,
            n(*shape, k) * 0.5 - 0.5)


def timed(kernel, plain, n_kernel: int, n_plain: int) -> dict:
    ms, host_ms = cuda_ms(kernel, n_kernel)
    plain_ms, _ = cuda_ms(plain, n_plain)
    return dict(ms=ms, host_ms=host_ms, plain_ms=plain_ms)


def mixture_forward_report(x, pi, mu, ls, n_plain: int, what: str) -> dict:
    """#2 on these inputs, twice, against its plain version within 1e-4;
    its report entry: error, times (``n_plain`` plain calls a run), bytes
    and operations."""
    from categoricalnf_tpu_torch.ops import numerics as nm
    from categoricalnf_tpu_torch.ops.cuda import mixture as cm
    y, ldj = twice(lambda: cm.mixture_forward_cuda(x, pi, mu, ls))
    y_p, ldj_p = nm.mixture_logit_cdf_and_ldj(x, pi, mu, ls)
    check(close(y, y_p, 1e-4) and close(ldj, ldj_p, 1e-4),
          f"{what} off: y {max_err(y, y_p)}, ldj {max_err(ldj, ldj_p)}")
    m, k = x.numel(), pi.shape[-1]
    return dict(
        max_abs_err=max(max_err(y, y_p), max_err(ldj, ldj_p)), m=m,
        **timed(lambda: cm.mixture_forward_cuda(x, pi, mu, ls),
                lambda: nm.mixture_logit_cdf_and_ldj(x, pi, mu, ls), 50,
                n_plain),
        bytes=m * (4 + 12 * k + 8),
        ops=m * k * (MIX_SETUP_OPS + MIX_EVAL_OPS), dtype="float32")


def mixture_inverse_report(y, pi, mu, ls, n_plain: int) -> dict:
    """#1's report entry on these inputs: its largest distance in x from
    the plain version (which the residual rule, not this, holds), times,
    bytes, and the operations of the rtsafe iterations these inputs took
    (each element stops at its own; ``iterations_mean`` an element)."""
    from categoricalnf_tpu_torch.ops import numerics as nm
    from categoricalnf_tpu_torch.ops.cuda import mixture as cm
    x, iters = cm.mixture_inverse_iterations(y, pi, mu, ls)
    x_p = nm.mixture_inverse_logit_cdf(y, pi, mu, ls)
    m, k = y.numel(), pi.shape[-1]
    n_iters = int(iters.sum())
    return dict(
        max_abs_err=max_err(x, x_p), m=m, iterations_mean=n_iters / m,
        **timed(lambda: cm.mixture_inverse_cuda(y, pi, mu, ls),
                lambda: nm.mixture_inverse_logit_cdf(y, pi, mu, ls), 50,
                n_plain),
        bytes=m * (4 + 12 * k + 4),
        ops=k * (m * (MIX_SETUP_OPS + MIX_INV_SETUP_OPS)
                 + n_iters * MIX_INV_ITER_OPS),
        dtype="float32")


def check_mixture(device, gen, report):
    import torch
    from categoricalnf_tpu_torch.ops import numerics as nm
    from categoricalnf_tpu_torch.ops.cuda import mixture as cm

    x, pi, mu, ls = mixture_inputs(gen, (B, S, D), K, device)

    # #2 forward
    report["mixture_forward"] = mixture_forward_report(x, pi, mu, ls, 20,
                                                       "mixture_forward")
    y_p, _ = nm.mixture_logit_cdf_and_ldj(x, pi, mu, ls)

    # #2 at the shape eval_bpd gives it: its 1024 sets x 4 chains
    report["mixture_forward_eval"] = mixture_forward_report(
        *mixture_inputs(gen, (EVAL_CHAINS * B, S, D), K, device), 10,
        "mixture_forward (eval shape)")

    # #1 inverse at the flagship's chunk (M = 65,536): back to x, and held
    # by its residual in y against the plain 42 + 3 version (where y is flat
    # in x, x itself may not lie within 1e-4 of the plain version's)
    xi = twice(lambda: cm.mixture_inverse_cuda(y_p, pi, mu, ls))
    xi_p = nm.mixture_inverse_logit_cdf(y_p, pi, mu, ls)
    failed = inverse_failures(xi, xi_p, y_p, pi, mu, ls, "mixture_inverse")
    check(not failed, "; ".join(failed))
    check(close(xi, x, 1e-3), f"mixture_inverse round trip: "
          f"{max_err(xi, x)}")

    # the Newton two-cycle case of the reference's tests
    pi2 = torch.tensor([0.6, 1.614, 0.921, 1.032, 0.278, -1.363, 2.304,
                        0.68], device=device).expand(256, 8)
    mu2 = torch.tensor([-1.708, 5.648, 0.566, -2.809, -0.082, 1.026, -2.156,
                        0.744], device=device).expand(256, 8)
    ls2 = torch.tensor([-0.095, -1.146, -0.103, 0.93, -0.74, -0.958, -0.81,
                        -0.332], device=device).expand(256, 8)
    y2 = torch.full((256,), -1.2907967567443848, device=device)
    x2 = twice(lambda: cm.mixture_inverse_cuda(y2, pi2, mu2, ls2))
    check(close(x2, torch.full_like(x2, -2.456364393234253), 1e-4),
          f"two-cycle case did not converge: {max_err(x2, -2.456364393234253 + 0 * x2)}")

    # odd sizes: K=3, M=91; and K=16 (the groups of K > 8) at M=91, drawn
    # from a generator of its own so that the later checks' inputs stay
    for k, g in ((3, gen), (16, torch.Generator(device).manual_seed(16))):
        x3, pi3, mu3, ls3 = mixture_inputs(g, (7, 13), k, device)
        y3, ldj3 = nm.mixture_logit_cdf_and_ldj(x3, pi3, mu3, ls3)
        if k == 3:
            xi3 = twice(lambda: cm.mixture_inverse_cuda(y3, pi3, mu3, ls3))
            check(close(xi3, x3, 1e-3),
                  f"K=3, M=91 round trip: {max_err(xi3, x3)}")
        yk3, ldjk3 = twice(lambda: cm.mixture_forward_cuda(x3, pi3, mu3,
                                                           ls3))
        check(close(yk3, y3, 1e-4) and close(ldjk3, ldj3, 1e-4),
              f"K={k}, M=91 forward off: y {max_err(yk3, y3)}, "
              f"ldj {max_err(ldjk3, ldj3)}")

    report["mixture_inverse"] = mixture_inverse_report(y_p, pi, mu, ls, 5)


def inverse_held(cases, seeds, device) -> dict:
    """#1 on each case of ``cases(seed, device)`` at each seed, by the
    residual rule (``inverse_failures``), beside the plain version cut short
    (12 bisections, no Newton step), which the rule must refuse; each kernel
    call runs twice with identical results.  Returns the worst ratio of
    residual to limit by seed and case."""
    from categoricalnf_tpu_torch.ops import numerics as nm
    from categoricalnf_tpu_torch.ops.cuda import mixture as cm
    worst = {}
    for seed in seeds:
        for name, (y, pi, mu, ls) in cases(seed, device).items():
            what = f"mixture_inverse at {name}, seed {seed}"
            x = twice(lambda: cm.mixture_inverse_cuda(y, pi, mu, ls))
            x_p = nm.mixture_inverse_logit_cdf(y, pi, mu, ls)
            failed = inverse_failures(x, x_p, y, pi, mu, ls, what)
            check(not failed, "; ".join(failed))
            cut = nm.mixture_inverse_logit_cdf(y, pi, mu, ls, num_bisect=12,
                                               num_newton=0)
            check(inverse_failures(cut, x_p, y, pi, mu, ls, what),
                  f"{what}: the plain version cut short passes the residual "
                  "rule, which so cannot tell")
            worst[f"{seed}/{name}"] = inverse_reading(x, x_p, y, pi, mu,
                                                      ls)[1]
    return worst


def check_inverse(device, seeds, report):
    """#1 at the sampling path's sizes (``inverse_cases``) at each seed
    (``inverse_held``).  Prints the worst ratio of residual to limit of each
    case, and times #1 at a /sample of 4 sets (M = 256)."""
    from categoricalnf_tpu_torch.ops.cuda import mixture as cm
    worst = inverse_held(inverse_cases, seeds, device)
    print("mixture_inverse: worst residual / max(2 e_p, tau) by case: "
          + json.dumps(worst), flush=True)
    y, pi, mu, ls = inverse_cases(seeds[0], device)["sample4"]
    report["mixture_inverse"].update(
        ms_m256=cuda_ms(lambda: cm.mixture_inverse_cuda(y, pi, mu, ls),
                        50)[0],
        residual_ratio=max(worst.values()),
        design="linear domain, log domain for |y| > 64; each element "
        "stops once done, up to 48 iterations; the best iterate")


def check_coloring_kernels(device, seeds, report):
    """#2, #2' and #1 at the shapes the graph-coloring path gives them
    (``COLORING_SHAPE``: a train step's batch and a sampling chunk, M =
    10,240; #1 also at a /sample of 4 graphs, M = 160), from generators of
    their own: #2 and #2' against their plain versions as ``check_mixture``
    and ``check_mixture_bwd`` hold them, #1 by the residual rule at each
    seed (``coloring_inverse_cases``); each timed.  Prints #1's worst
    ratio of residual to limit."""
    import torch
    g = torch.Generator(device).manual_seed(seeds[0] + 20)
    report["mixture_forward_coloring"] = mixture_forward_report(
        *mixture_inputs(g, COLORING_SHAPE, K, device), 20,
        "mixture_forward (coloring shape)")
    report["mixture_forward_bwd_coloring"] = mixture_bwd_report(
        mixture_bwd_case(device, g, COLORING_SHAPE, K))
    worst = inverse_held(coloring_inverse_cases, seeds, device)
    print("mixture_inverse at the coloring's shapes: worst residual / "
          "max(2 e_p, tau) by case: " + json.dumps(worst), flush=True)
    cases = coloring_inverse_cases(seeds[0], device)
    for name, case in (("mixture_inverse_coloring", "chunk"),
                       ("mixture_inverse_coloring_m160", "sample4")):
        report[name] = mixture_inverse_report(*cases[case], 5)


# The shapes of the dequantized set flows (runs/sum_vardeq,
# runs/shuffle_linear): the encoders' inverses under grad, the vardeq
# encoder's [1024 sets, 16, dim 1] (M = 16,384) and the linear-flows
# encoder's [16,384 rows, 1, dim 4] (M = 65,536), with vardeq_mixtures
# K = 4; the linear-flows decoder's one forward of 16 categories x 16,384
# rows (M = 1,048,576); the vardeq main flow's coupling net, in 1, out 26
ENCODER_SHAPES = {"vardeq": (B, S, 1), "linear_flows": (B * S, 1, D)}
ENCODER_K = 4
DECODER_SHAPE = (S * B * S, 1, D)
VARDEQ_OUT = 2 + 3 * K
# #1' (the reference's rule: reverse mode through the inverse's loop) held
# per gradient elementwise against autograd through the plain loop on the
# card: within INV_LOOP_REL of the reference plus INV_LOOP_FLOOR of its
# largest magnitude on at least INV_LOOP_SHARE of the elements (the rule
# of tests/test_torch_encodings.py's test_plain_inverse_autograd_matches_
# reference: a one-ulp difference of a bisection's midpoint sends the rest
# of an element's loop another way); the implicit rule (the exact
# derivative, mixture_inverse_bwd_cuda) is the control that must fail it
# on some gradient
INV_LOOP_REL, INV_LOOP_FLOOR, INV_LOOP_SHARE = 1e-3, 1e-4, 0.9
# the other widths #1' is built for (no path trains through the inverse at
# them yet), held by the same rule at the vardeq encoder's M = 16,384
INV_LOOP_WIDE_KS = (8, 16, 32)


def encoder_inverse_cases(seed: int, device) -> dict:
    """#1's cases at the encoders' shapes (``ENCODER_SHAPES``), drawn as
    ``inverse_cases`` draws them, pi and ls strided as the coupling passes
    them."""
    import torch
    gen = torch.Generator(device).manual_seed(seed)
    return {name: inverse_case(gen, shape, ENCODER_K, device, True)
            for name, shape in ENCODER_SHAPES.items()}


def inverse_exact_vjp(y, pi, mu, ls, gx, h: float = 1e-6) -> list:
    """The inverse's gradients (y, pi, mu, ls) for the cotangent ``gx`` by
    central differences of the plain inverse in float64 (100 bisections, 6
    Newton steps), one parameter column at a time for all elements at once
    (the elements are independent)."""
    import torch
    from categoricalnf_tpu_torch.ops import numerics as nm
    d = [t.detach().double() for t in (y, pi, mu, ls)]
    g = gx.double()

    def diff(i, col=None):
        step = torch.zeros_like(d[i])
        if col is None:
            step += h
        else:
            step[..., col] = h
        roots = [nm.mixture_inverse_logit_cdf(
            *[a + sign * step if j == i else a for j, a in enumerate(d)],
            num_bisect=100, num_newton=6) for sign in (1, -1)]
        return g * (roots[0] - roots[1]) / (2 * h)

    return [diff(0)] + [torch.stack([diff(i, c) for c in range(
        pi.shape[-1])], dim=-1) for i in (1, 2, 3)]


def near_share(a, ref) -> float:
    """The share of elements of ``a`` within INV_LOOP_REL of ``ref`` plus
    INV_LOOP_FLOOR of ``ref``'s largest magnitude (float64)."""
    a, ref = a.detach().double(), ref.detach().double()
    tol = INV_LOOP_REL * ref.abs() + INV_LOOP_FLOOR * ref.abs().max()
    return float(((a - ref).abs() <= tol).double().mean())


def inverse_bwd_readings(y, pi, mu, ls, gx, what: str) -> dict:
    """#1' (autograd through ``mixture_inverse_cuda``, the parameters as
    slices of one leaf as the coupling passes them: the loop-rule kernel)
    held per gradient against autograd through the plain loop on the card
    (``near_share`` at least INV_LOOP_SHARE), beside its plain version
    (``numerics.mixture_inverse_loop_vjp`` on the card, by the same rule)
    and the control, the implicit rule at the kernel's root, which must
    read below INV_LOOP_SHARE on some gradient.  Returns the shares."""
    import torch
    from categoricalnf_tpu_torch.ops import numerics as nm
    from categoricalnf_tpu_torch.ops.cuda import mixture as cm
    k = pi.shape[-1]
    raw = torch.zeros(*pi.shape[:-1], 2 + 3 * k, device=y.device)
    raw[..., 2:2 + k], raw[..., 2 + 2 * k:] = pi, ls
    leaves = [y.clone().requires_grad_(True), raw.requires_grad_(True),
              mu.clone().requires_grad_(True)]
    before = cm.LAUNCHES["mixture_inverse_loop_bwd"]
    x = cm.mixture_inverse_cuda(leaves[0], raw[..., 2:2 + k], leaves[2],
                                raw[..., 2 + 2 * k:])
    gy, graw, gmu = torch.autograd.grad(x, leaves, gx)
    check(cm.LAUNCHES["mixture_inverse_loop_bwd"] == before + 1,
          f"{what}: the inverse's backward did not launch the loop-rule "
          "kernel")
    got = [gy, graw[..., 2:2 + k], gmu, graw[..., 2 + 2 * k:]]
    check(not graw[..., :2].any() and not graw[..., 2 + k:2 + 2 * k].any(),
          f"{what}: #1' wrote outside its parameters' slices")
    args = [t.clone().requires_grad_(True) for t in (y, pi, mu, ls)]
    spec = torch.autograd.grad(nm.mixture_inverse_logit_cdf(*args), args,
                               gx)
    mirror = nm.mixture_inverse_loop_vjp(y, pi, mu, ls, gx)
    implicit = cm.mixture_inverse_bwd_cuda(x.detach(), pi, mu, ls, gx)
    names = ("gy", "gpi", "gmu", "gls")
    out = {"kernel": {n: near_share(a, r) for n, a, r in
                      zip(names, got, spec)},
           "plain_mirror": {n: near_share(a, r) for n, a, r in
                            zip(names, mirror, spec)},
           "implicit_control": {n: near_share(a, r) for n, a, r in
                                zip(names, implicit, spec)}}
    for key in ("kernel", "plain_mirror"):
        check(min(out[key].values()) >= INV_LOOP_SHARE,
              f"{what}: {key} off autograd of the plain loop: {out[key]}")
    check(min(out["implicit_control"].values()) < INV_LOOP_SHARE,
          f"{what}: the implicit-rule control meets the rule, which so "
          f"cannot tell the two: {out['implicit_control']}")
    return out


def check_set_modeling_kernels(device, seeds, report):
    """The kernels at the dequantized set flows' shapes, from generators of
    their own: #1 at the encoders' shapes by the residual rule
    (``inverse_held``) and #1' (the loop-rule kernel) there by
    ``inverse_bwd_readings``, at each seed, and there at the vardeq
    encoder's M with K = 8, 16 and 32; #2 at the linear-flows
    decoder's M = 1,048,576, K = 4; #3 and #4 in bf16 at the vardeq main
    flow's in 1, out 26.  Each timed; prints the readings against their
    limits."""
    import torch
    from categoricalnf_tpu_torch.ops import numerics as nm
    from categoricalnf_tpu_torch.ops.cuda import mixture as cm
    worst = inverse_held(encoder_inverse_cases, seeds, device)
    print("mixture_inverse at the encoders' shapes: worst residual / "
          "max(2 e_p, tau) by case: " + json.dumps(worst), flush=True)
    readings = {}
    for seed in seeds:
        g = torch.Generator(device).manual_seed(seed + 40)
        for name, (y, pi, mu, ls) in encoder_inverse_cases(seed,
                                                           device).items():
            gx = torch.randn(y.shape, generator=g, device=device)
            readings[f"{seed}/{name}"] = inverse_bwd_readings(
                y, pi, mu, ls, gx, f"#1' at {name}, seed {seed}")
        gen = torch.Generator(device).manual_seed(seed + 44)
        for k in INV_LOOP_WIDE_KS:
            y, pi, mu, ls = inverse_case(gen, (B, S), k, device, True)
            gx = torch.randn(y.shape, generator=g, device=device)
            readings[f"{seed}/K{k}"] = inverse_bwd_readings(
                y, pi, mu, ls, gx, f"#1' at K = {k}, seed {seed}")
    print(f"mixture_inverse_loop_bwd (#1'): share of each gradient's "
          f"elements within {INV_LOOP_REL} of autograd through the plain "
          f"loop plus {INV_LOOP_FLOOR} of its largest magnitude (limit: at "
          f"least {INV_LOOP_SHARE}; the implicit-rule control below it on "
          f"some gradient): " + json.dumps(readings), flush=True)
    cases = encoder_inverse_cases(seeds[0], device)
    g = torch.Generator(device).manual_seed(seeds[0] + 41)
    for name, suffix in (("linear_flows", ""), ("vardeq", "_vardeq")):
        y, pi, mu, ls = cases[name]
        report[f"mixture_inverse_encoder_{name}"] = mixture_inverse_report(
            y, pi, mu, ls, 5)
        gx = torch.randn(y.shape, generator=g, device=device)
        got = cm.mixture_inverse_loop_bwd_cuda(y, pi, mu, ls, gx)
        plain = nm.mixture_inverse_loop_vjp(y, pi, mu, ls, gx)
        m, k = y.numel(), ENCODER_K
        report[f"mixture_inverse_loop_bwd{suffix}"] = dict(
            max_abs_err=max(max_err(a, p) for a, p in zip(got, plain)),
            m=m, worst_share=min(
                min(r["kernel"].values()) for key, r in readings.items()
                if key.endswith(name)),
            **timed(lambda: cm.mixture_inverse_loop_bwd_cuda(y, pi, mu, ls,
                                                             gx),
                    lambda: nm.mixture_inverse_loop_vjp(y, pi, mu, ls, gx),
                    50, 5),
            # read y, gx and the parameters; write gy and their gradients
            bytes=m * (12 + 24 * k),
            # the loop: 42 bisections (log F and log S), 3 Newton steps
            # forward and 3 back (with log f), each over the K components
            ops=m * k * (MIX_SETUP_OPS + LOOP_EVALS * MIX_EVAL_OPS
                         + LOOP_NEWTON * MIX_BWD_OPS),
            dtype="float32")
    report["mixture_forward_decoder"] = mixture_forward_report(
        *mixture_inputs(torch.Generator(device).manual_seed(seeds[0] + 42),
                        DECODER_SHAPE, ENCODER_K, device), 5,
        "mixture_forward (the linear-flows decoder's shape)")
    g = torch.Generator(device).manual_seed(seeds[0] + 43)
    x = torch.randn(B, S, 1, generator=g, device=device)
    report["fused_set_transformer_bf16_vardeq"] = fused_fwd_report(
        flagship_net("bfloat16", device, 1, VARDEQ_OUT), x)
    gy = torch.randn(B, S, VARDEQ_OUT, generator=g,
                     device=device).to(torch.bfloat16)
    report["fused_set_transformer_bwd_bf16_vardeq"] = fused_bwd_report(
        flagship_net("bfloat16", device, 1, VARDEQ_OUT), x, gy,
        "fused_set_transformer_bwd_bf16 (in 1, out 26)")


# Sets above 32 rows (runs/set16 at --set_size 33..128): #3 bf16, #4 bf16
# and #3 fp32 at the flagship's width against plain at these set sizes, at
# BIG_SET_ROWS rows (the bf16 pair over 2-CTA clusters above 64, #3 fp32
# over clusters of 2 and of 4 above 64); masked at 64; each timed at the
# set-64 and set-128 runs'
# 1024 sets.  At sets of 16 and 24 the kernels
# take the unrolled attention, unchanged: their outputs on fixed inputs
# hash to the digests of the tree before the chunked attention
# (BITWISE_DIGESTS, read by tools/set_digests.py on an H100).
BIG_SETS = (33, 48, 64, 100, 128)
BIG_SET_ROWS = 16_384
BIG_SET_TIMED = (64, 128)


# sha256 digests of the kernels' outputs on fixed inputs (``set_digests``)
# from the trees before a change to their instances, read by
# tools/set_digests.py on an NVIDIA H100 80GB HBM3 at 700.00 W.  At sets of
# 16 and 24 #3 bf16, #4 bf16 and #3 fp32, from commit b72488a (the tree
# before sets above 32): those sets take the instances without the chunked
# attention, whose code is that tree's, so the bits must not move.
SMALL_SET_DIGESTS = {
    "fwd_bfloat16_set16": "a656c64d803df850",
    "bwd_bfloat16_set16": "fc57c015a9bb8180",
    "fwd_float32_set16": "d45fe7615678c666",
    "fwd_bfloat16_set24": "e1e38ac7a9ab120c",
    "bwd_bfloat16_set24": "92cd3a0fbc7be279",
    "fwd_float32_set24": "a9cb4e9133ed29b4"}
# From commit d493a85 (the tree before the fp32 pair's instances for sets
# above 32): the fp32 train step's pair (#3 fp32 with grad, #4 fp32's dx and
# 12 weight gradients) at sets of 16 and 24, whose code that change moved
# into a header and templated, and the BIG instances of #3 bf16 and #3 fp32
# (without grad) at sets of 64 and 128, whose row addressing over a cluster
# it generalised.  From commit b6a0554 (the tree before #4's attention at
# sets above 32 moved to warp tiles): #3 fp32 with grad's BIG instance at
# 64 and 128, which that change left as it was.  From the commit after
# b6a0554 that made that change (tools/set_digests.py on its tree): #4
# bf16's and #4 fp32's BIG instances at 64 and 128, whose sums it
# reordered (QK^T and PV on mma.sync in bf16, register tiles in fp32).
# From the tree of the change after cb41803 that moved #3's BIG attention
# to the same warp tiles (tools/set_digests.py on its tree): #3 bf16's and
# #3 fp32 with grad's BIG instances at 64, 128 and 128 masked, whose sums
# it reordered (#3 fp32 with grad's now #4's recompute; #3 bf16's above
# 64 rows with its row sums over two halves of the keys).  From the tree of
# the change after b685635 that moved the 3xTF32 eval twin's BIG attention
# to warp tiles (tools/set_digests.py on its tree): #3 fp32's BIG instance
# at 64, 128 and 128 masked, whose QK^T and P.V it moved to 3xTF32 on the
# tensor cores.
PAIR_AND_BIG_SET_DIGESTS = {
    "train_fwd_float32_set16": "36b0c115040615d3",
    "bwd_float32_set16": "6d411fa7a17525b8",
    "train_fwd_float32_set24": "6832036f752837f5",
    "bwd_float32_set24": "e582ecbe0c870e00",
    "fwd_bfloat16_set64": "c1795036cdbfbbaf",
    "bwd_bfloat16_set64": "6a46ce2228fc8d94",
    "fwd_float32_set64": "be4f8ff10c23b419",
    "train_fwd_float32_set64": "3a48f73632cf0c1c",
    "bwd_float32_set64": "06e0bbc6bf125f27",
    "fwd_bfloat16_set128": "c47ed46a3e01ce60",
    "bwd_bfloat16_set128": "2763b1292b9398bf",
    "fwd_float32_set128": "fc4b7b0b4dcd0d61",
    "train_fwd_float32_set128": "d32f0bae8c88cbb2",
    "bwd_float32_set128": "53d248d3aa257314",
    "fwd_bfloat16_set128_masked": "ae8c30a788764a8c",
    "bwd_bfloat16_set128_masked": "76beff9943c6849d",
    "fwd_float32_set128_masked": "82385ac1d1c3c928",
    "train_fwd_float32_set128_masked": "ca2a55306085870f",
    "bwd_float32_set128_masked": "b8c74ac9f4e2fa23"}


# From commit 5d23eee (the tree before #4 bf16's GLOBAL_H instance moved
# its weight gradients out of the tile loop into wgrad_tiles_bf16, in the
# same sum order): #4 bf16's dx and 12 gradients at runs/moses' node flow.
MOSES_DIGESTS = {"bwd_bfloat16_moses": "f6a8f5f4cbc4417d"}


def set_digests(device) -> dict:
    """sha256 of the bytes of each kernel's outputs on the flagship's nets
    (in 4, out 104) on inputs from fixed seeds, by kernel and set size: #3
    bf16's output, #4 bf16's dx and 12 weight gradients, #3 fp32's output
    and the fp32 pair's (#3 fp32 with grad, #4 fp32) at 64 sets of 16 and,
    with a key mask (``set_mask``), 64 sets of 24; all five at 64 sets of
    64 and of 128, and with a key mask at 128; #4 bf16 at runs/moses' node
    flow (hidden 256, out 300, 192 graphs of 24 nodes, under
    ``molecule_key_mask``: the ``GLOBAL_H`` instance)."""
    import hashlib

    import torch
    from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft

    def digest(ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.detach().cpu().contiguous().view(torch.uint8)
                     .numpy().tobytes())
        return h.hexdigest()[:16]

    out = {}
    for s, mask in ((16, None), (24, set_mask(64, 24, 5, device)),
                    (64, None), (128, None),
                    (128, set_mask(64, 128, 6, device))):
        g = torch.Generator(device).manual_seed(100 + s)
        x = torch.randn(64, s, D, generator=g, device=device)
        gy = torch.randn(64, s, OUT, generator=g,
                         device=device).to(torch.bfloat16)
        gf = torch.randn(64, s, OUT, generator=g, device=device)
        tag = f"set{s}" + ("_masked" if mask is not None and s > 24 else "")
        with torch.no_grad():
            for cd in ("bfloat16", "float32"):
                tdt = getattr(torch, cd)
                ws = ft.flatten_params(flagship_net(cd, device))
                packed = ft.PackedWeights(ws, tdt)
                out[f"fwd_{cd}_{tag}"] = digest([ft.fused_set_transformer(
                    packed, x, num_heads=HEADS, mask=mask)])
                if cd == "bfloat16":
                    dx, dws = ft.fused_set_transformer_bwd(
                        packed, x, gy, num_heads=HEADS, mask=mask)
                    out[f"bwd_{cd}_{tag}"] = digest([dx, *dws])
                else:
                    out[f"train_fwd_{cd}_{tag}"] = digest([
                        ft.FusedSetTransformer.apply(x, packed, HEADS, mask,
                                                     *ws)])
                    dx, dws = ft.fused_set_transformer_bwd(
                        packed, x, gf, num_heads=HEADS, mask=mask)
                    out[f"bwd_{cd}_{tag}"] = digest([dx, *dws])
    # #4 bf16 at runs/moses' node flow, masked: its GLOBAL_H instance
    g = torch.Generator(device).manual_seed(124)
    x = torch.randn(MOSES_BATCH, MOL_NODES, MOL_NODE_DIM, generator=g,
                    device=device)
    gy = torch.randn(MOSES_BATCH, MOL_NODES, MOSES_OUT, generator=g,
                     device=device).to(torch.bfloat16)
    packed = molecule_net("bfloat16", device, 7, MOSES_HIDDEN,
                          MOSES_OUT)._packed_weights(torch.bfloat16)
    with torch.no_grad():
        dx, dws = ft.fused_set_transformer_bwd(
            packed, x, gy, num_heads=HEADS,
            mask=molecule_key_mask(7, device, MOSES_BATCH))
    out["bwd_bfloat16_moses"] = digest([dx, *dws])
    return out


# calls of each kernel on the same inputs that must give the same bits, at
# every size of BIG_SETS, with and without the key mask
BIG_SET_REPEATS = 4


def big_set_repeats(device, seed: int) -> dict:
    """#3 bf16, #4 bf16 (dx and the 12 weight gradients), #3 fp32 and the
    fp32 train step's pair (#3 fp32 with grad, #4 fp32) at each size of
    BIG_SETS, unmasked and masked (``set_mask``), called BIG_SET_REPEATS
    times on the same inputs: whether every call gave the first one's bits.
    A race between a block's warps or a cluster's blocks, or a read of
    memory no one wrote, shows here as a difference.  The sets number
    BIG_SET_ROWS // s, so the backwards' persistent grids walk several
    sets a block at every size."""
    import torch
    g = torch.Generator(device).manual_seed(seed + 62)
    gp = torch.Generator(device).manual_seed(seed + 65)
    nets = {cd: flagship_net(cd, device) for cd in ("bfloat16", "float32")}
    packed = {cd: net._packed_weights(getattr(torch, cd))
              for cd, net in nets.items()}
    from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft
    ws = ft.flatten_params(nets["float32"])
    out = {}
    for s in BIG_SETS:
        sets = BIG_SET_ROWS // s
        x = torch.randn(sets, s, D, generator=g, device=device)
        gy = torch.randn(sets, s, OUT, generator=g,
                         device=device).to(torch.bfloat16)
        gf = torch.randn(sets, s, OUT, generator=gp, device=device)
        for masked in (False, True):
            mask = set_mask(sets, s, seed, device) if masked else None
            calls = {
                "fwd_bf16": lambda: [ft.fused_set_transformer(
                    packed["bfloat16"], x, num_heads=HEADS, mask=mask)],
                "bwd_bf16": lambda: (lambda r: [r[0], *r[1]])(
                    ft.fused_set_transformer_bwd(
                        packed["bfloat16"], x, gy, num_heads=HEADS,
                        mask=mask)),
                "fwd_f32": lambda: [ft.fused_set_transformer(
                    packed["float32"], x, num_heads=HEADS, mask=mask)],
                "train_fwd_f32": lambda: [ft.FusedSetTransformer.apply(
                    x, packed["float32"], HEADS, mask, *ws)],
                "bwd_f32": lambda: (lambda r: [r[0], *r[1]])(
                    ft.fused_set_transformer_bwd(
                        packed["float32"], x, gf, num_heads=HEADS,
                        mask=mask))}
            with torch.no_grad():
                for name, call in calls.items():
                    first = call()
                    same = all(
                        all(torch.equal(a, b) for a, b in zip(first, call()))
                        for _ in range(BIG_SET_REPEATS - 1))
                    out[f"set{s}{'_masked' if masked else ''}/{name}"] = same
    return out


def set_mask(sets: int, s: int, seed: int, device):
    """A key mask [sets, s]: set i's first n_i keys valid, n_i drawn from
    1..s, set 0 with one valid key and set 1 with none."""
    import torch
    g = torch.Generator().manual_seed(seed)
    n = torch.randint(1, s + 1, (sets, 1), generator=g)
    n[0], n[1] = 1, 0
    return (torch.arange(s)[None] < n).float().to(device)


def check_big_set_kernels(device, seeds, report):
    """#3 bf16, #4 bf16 and #3 fp32 at sets of BIG_SETS rows (whole-set
    tiles, and clusters where a set does not fit one block) against
    plain, at each seed, within the flagship's limits
    (``fused_fwd_report``, ``fused_bwd_report``), and the fp32 train step's
    pair (a cluster of 2 blocks up to 64 rows, of 4 above) against autograd
    of plain within F32_TRAIN_FWD_TOL and F32_BWD_TOL and against float64
    by ``f32_pair_failures`` (``f32_pair_readings``; at the timed 1,024
    sets by the latter alone, ``f32_pair_set_reports``); the key mask at 64 (``masked_fwd_readings``,
    ``masked_bwd_readings``, ``masked_f32_pair_readings``); each timed at
    the set-64 and set-128 runs' 1024 sets, into ``report``."""
    import torch
    from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft
    readings: dict = {}
    for seed in seeds:
        g = torch.Generator(device).manual_seed(seed + 60)
        gp = torch.Generator(device).manual_seed(seed + 63)
        for s in BIG_SETS:
            sets = BIG_SET_ROWS // s
            x = torch.randn(sets, s, D, generator=g, device=device)
            gy = torch.randn(sets, s, OUT, generator=g,
                             device=device).to(torch.bfloat16)
            r = {"fwd_bf16": fused_fwd_report(
                     flagship_net("bfloat16", device), x, time_it=False),
                 "bwd_bf16": fused_bwd_report(
                     flagship_net("bfloat16", device), x, gy,
                     f"#4 bf16 at sets of {s}", time_it=False),
                 "fwd_f32": fused_fwd_report(
                     flagship_net("float32", device), x, time_it=False)}
            readings[f"{seed}/set{s}"] = {
                k: {key: v[key] for key in ("rel_err", "tile", "smem")}
                for k, v in r.items()}
            pair = f32_pair_readings(
                flagship_net("float32", device), x,
                torch.randn(sets, s, OUT, generator=gp, device=device))
            check(pair["fwd_err"] <= F32_TRAIN_FWD_TOL
                  and pair["bwd_err"] <= F32_BWD_TOL,
                  f"the fp32 pair at {sets} sets of {s}: #3 and #4 off "
                  f"autograd of plain by {pair['fwd_err']}, "
                  f"{pair['bwd_err']}")
            readings[f"{seed}/set{s}"]["pair_f32"] = pair
        s = 64
        mask = set_mask(BIG_SET_ROWS // s, s, seed, device)
        x = torch.randn(BIG_SET_ROWS // s, s, D, generator=g, device=device)
        gy = torch.randn(BIG_SET_ROWS // s, s, OUT, generator=g,
                         device=device).to(torch.bfloat16)
        bf = flagship_net("bfloat16", device)
        readings[f"{seed}/set64_masked"] = {
            "fwd_bf16": masked_fwd_readings(bf, x, mask, BF16_FWD_REL),
            "bwd_bf16": masked_bwd_readings(bf, x, mask, gy),
            "fwd_f32": masked_fwd_readings(flagship_net("float32", device),
                                           x, mask, F32_FWD_REL),
            "pair_f32": masked_f32_pair_readings(
                flagship_net("float32", device), x, mask,
                torch.randn(x.shape[0], s, OUT, generator=gp,
                            device=device))}
    print("fused kernels at sets above 32 (limits: bf16 #3 "
          f"{BF16_FWD_REL}, #4 0.03, fp32 #3 {F32_FWD_REL}; the fp32 pair "
          f"{F32_TRAIN_FWD_TOL} and {F32_BWD_TOL} as torch.allclose and "
          "within max(those, 2 x plain fp32's distance) of float64, the "
          f"masked pair's control above {MASK_CONTROL} x): "
          + json.dumps(readings), flush=True)
    repeats = big_set_repeats(device, seeds[0])
    print(f"fused kernels at sets above 32, {BIG_SET_REPEATS} calls on the "
          "same inputs bitwise equal: " + json.dumps(repeats), flush=True)
    check(all(repeats.values()), "a fused kernel at a set above 32 gave "
          f"other bits on the same inputs: {repeats}")
    digests = set_digests(device)
    pinned = {**SMALL_SET_DIGESTS, **PAIR_AND_BIG_SET_DIGESTS,
              **MOSES_DIGESTS}
    print("fused kernels against the trees before (SMALL_SET_DIGESTS, "
          "PAIR_AND_BIG_SET_DIGESTS, MOSES_DIGESTS): " + json.dumps(
              {k: v == pinned.get(k) for k, v in digests.items()}),
          flush=True)
    check(digests == pinned, "a kernel's bits moved off the tree before: "
          f"{digests}")
    g = torch.Generator(device).manual_seed(seeds[0] + 61)
    for s in BIG_SET_TIMED:
        x = torch.randn(B, s, D, generator=g, device=device)
        gy = torch.randn(B, s, OUT, generator=g,
                         device=device).to(torch.bfloat16)
        x4 = torch.randn(EVAL_CHAINS * B, s, D, generator=g, device=device)
        report[f"fused_set_transformer_bf16_set{s}"] = fused_fwd_report(
            flagship_net("bfloat16", device), x)
        report[f"fused_set_transformer_bwd_bf16_set{s}"] = fused_bwd_report(
            flagship_net("bfloat16", device), x, gy,
            f"#4 bf16 at 1024 sets of {s}")
        report[f"fused_set_transformer_f32_set{s}"] = fused_fwd_report(
            flagship_net("float32", device), x4)
        for name in ("bf16", "bwd_bf16", "f32"):
            r = report[f"fused_set_transformer_{name}_set{s}"]
            dt = torch.float32 if name == "f32" else torch.bfloat16
            r["cluster"] = (ft.bwd_layout(
                dt, s, D, H, 2 * H, OUT, HEADS, 2)[3] if name == "bwd_bf16"
                else ft.fwd_shape(dt, s, D, H, 2 * H, HEADS)[2])
        report.update(f32_pair_set_reports(device, seeds[0], s))
    for name in FP32_BIG_PAIR:
        report[name] = report[f"{name}_set{BIG_SET_TIMED[0]}"]
    return readings


def f32_pair_readings(net, x, g) -> dict:
    """The fp32 train step's pair (a differentiable call: #3 through
    ``FusedSetTransformer``, #4 in its backward), twice and bitwise, against
    ``plain_forward`` and autograd through it on x with the cotangent g,
    in fp32 (read: ``fwd_err``, ``bwd_err`` by ``allclose_err``) and in
    float64 (held: ``f32_pair_failures``), the launches at a set above 32
    counted among those over clusters."""
    import copy

    import torch
    from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft

    def run(model, plain, xx):
        xr = xx.clone().requires_grad_(True)
        y = model.plain_forward(xr) if plain else model(xr)
        return (y.detach(), *torch.autograd.grad(
            y, [xr] + list(model.parameters()), g.to(xx.dtype)))

    n = (ft.CLUSTER_TRAIN_FWD_LAUNCHES["float32"],
         ft.CLUSTER_BWD_LAUNCHES["float32"])
    got = twice(lambda: run(net, False, x))
    big = x.shape[1] > ft.MAX_SET
    check((ft.CLUSTER_TRAIN_FWD_LAUNCHES["float32"],
           ft.CLUSTER_BWD_LAUNCHES["float32"])
          == (n[0] + 2 * big, n[1] + 2 * big),
          f"the fp32 pair at sets of {x.shape[1]} did not launch over "
          "clusters")
    want = run(net, True, x)
    # (the copy leaves out the net's cached kernel weights, whose ctypes
    # pointers do not copy)
    net64 = copy.deepcopy(net, {id(net._packed): None}).double()
    net64.compute_dtype = "float64"
    ref = run(net64, True, x.double())
    del net64
    what = f"the fp32 pair at {tuple(x.shape)}"
    check(bool(torch.isfinite(got[0]).all()), f"{what}: not finite")
    names = ["y", "dx"] + [k for k, _ in net.named_parameters()]
    failed, fp64 = f32_pair_failures(names, got, want, ref)
    check(not failed, f"{what}: " + "; ".join(failed))
    rels = [rel_err(a, w) for a, w in zip(got, want)]
    return dict(fwd_err=allclose_err(got[0], want[0]),
                bwd_err=max(allclose_err(a, w)
                            for a, w in zip(got[1:], want[1:])),
                fp64=fp64, fwd_rel_err=rels[0], rel_err=max(rels[1:]),
                max_abs_err=max(max_err(a, w) for a, w in zip(got, want)),
                cluster=ft.fma_fwd_shape(x.shape[1], x.shape[2],
                                         net.hidden_dim,
                                         2 * net.hidden_dim)[2])


# The fp32 pair at sets above 32 against the same call in float64 on the
# card (``plain_forward`` and autograd through it), per tensor (the output,
# dx and the 12 parameters' gradients) by ``allclose_err``, in the form of
# the train step's rule (b): the kernels within max(floor, 2 e_plain),
# e_plain plain fp32's own distance from float64, the floor
# F32_TRAIN_FWD_TOL for the output and F32_BWD_TOL for a gradient.  Both
# fp32 results drift from float64 as the weight gradients sum over more
# rows (past 2e-4 at 1,024 sets of 64 or 128, on an H100 80GB HBM3 at
# 700 W), so a fixed limit against plain fp32 reads fp32's own noise
# there.  The control, the kernels' values rounded once to bf16, must fail
# the limit on the output and on some gradient.


def f32_pair_failures(names, got, plain, ref) -> tuple:
    """The rule above on the kernels' ``got``, plain fp32's ``plain`` and
    float64's ``ref`` (output first, then the gradients, named ``names``):
    (a message for each failure, the readings)."""
    import torch
    failed, lims, kern, ctrl = [], [], [], []
    for i, (name, a, p, r) in enumerate(zip(names, got, plain, ref)):
        r = r.float()
        lim = max(F32_TRAIN_FWD_TOL if i == 0 else F32_BWD_TOL,
                  2 * allclose_err(p, r))
        e = allclose_err(a, r)
        c = allclose_err(a.to(torch.bfloat16), r)
        if not e <= lim:
            failed.append(f"{name} {e} from float64, over {lim}")
        lims.append(lim)
        kern.append(e)
        ctrl.append(c > lim)
    if not (ctrl[0] and any(ctrl[1:])):
        failed.append("the bf16-rounded control is inside the limit on "
                      + ("the output" if not ctrl[0] else "every gradient"))
    worst = max(range(len(kern)), key=lambda i: kern[i] / lims[i])
    return failed, dict(
        fwd=kern[0], fwd_limit=lims[0], bwd=max(kern[1:]),
        worst=names[worst], worst_share=kern[worst] / lims[worst],
        bwd_limit_max=max(lims[1:]), control_over=sum(ctrl))


# the fp32 train step's pair at sets above 32: its instances over clusters
FP32_BIG_PAIR = ("fused_set_transformer_train_f32_big",
                 "fused_set_transformer_bwd_f32_big")


def f32_pair_set_reports(device, seed: int, s: int) -> dict:
    """#3 fp32 with grad and #4 fp32 on the flagship's net at 1,024 sets of
    ``s`` (runs/set16's batch at --set_size s): against autograd of plain
    in float64 (``f32_pair_readings``, ``f32_pair_failures``; the fp32
    plain path's distance is read), timed, with the bounds' bytes and
    operations, the tiles, clusters, shared memory, and #4's grid and the
    clusters the card holds at once."""
    import torch
    from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft
    g = torch.Generator(device).manual_seed(seed + 64)
    x = torch.randn(B, s, D, generator=g, device=device)
    gy = torch.randn(B, s, OUT, generator=g, device=device)
    net = flagship_net("float32", device)
    r = f32_pair_readings(net, x, gy)
    ws = ft.flatten_params(net)
    packed = net._packed_weights(torch.float32)
    params = list(net.parameters())
    rows = B * s
    with torch.no_grad():
        t_fwd = timed(lambda: ft.FusedSetTransformer.apply(
            x, packed, HEADS, None, *ws), lambda: net.plain_forward(x), 10, 5)
    xr = x.clone().requires_grad_(True)
    y_p = net.plain_forward(xr)
    t_bwd = timed(lambda: ft.fused_set_transformer_bwd(
        packed, x, gy, num_heads=HEADS),
        lambda: torch.autograd.grad(y_p, [xr] + params, gy,
                                    retain_graph=True), 5, 3)
    n_w = sum(w.numel() for w in ws[0::2])
    n_b = sum(b.numel() for b in ws[1::2])
    macs = rows * net_macs_per_row(D, H, HEADS, 2, 2 * H, OUT, s)
    tile, smem, cluster = ft.fma_fwd_shape(s, D, H, 2 * H)
    fwd = dict(max_abs_err=r["max_abs_err"], rel_err=r["fwd_rel_err"],
               allclose_err=r["fwd_err"], fp64=r["fp64"], rows=rows, **t_fwd, dtype="float32", tile=tile, smem=smem,
               cluster=cluster, blocks_per_sm=min(
                   ft.FMA_FWD_BLOCKS, ft.smem_blocks_per_sm(smem)),
               grid=cluster * B,
               bytes=rows * (D + OUT) * 4 + (n_w + n_b) * 4, ops=2 * macs)
    clusters = ft.fma_max_clusters(device, s, D, H, HEADS, 2, 2 * H, OUT)
    tile, smem, _, grid = ft.bwd_launch(
        torch.float32, s, D, H, 2 * H, OUT, HEADS, 2, rows,
        torch.cuda.get_device_properties(device).multi_processor_count,
        max_clusters=clusters)
    bwd = dict(max_abs_err=r["max_abs_err"], rel_err=r["rel_err"],
               allclose_err=r["bwd_err"], fp64=r["fp64"], rows=rows, **t_bwd, dtype="float32", tile=tile, smem=smem,
               cluster=cluster, grid=grid, max_active_clusters=clusters,
               blocks_per_sm=ft.smem_blocks_per_sm(smem),
               scratch_mb=grid * (n_w + n_b) * 4 / 2**20,
               # x, g, dx; the weights and their fp32 gradients
               bytes=rows * (2 * D + OUT) * 4 + 2 * (n_w + n_b) * 4,
               ops=3 * 2 * macs)
    return {f"{FP32_BIG_PAIR[0]}_set{s}": fwd,
            f"{FP32_BIG_PAIR[1]}_set{s}": bwd}


def net_macs_per_row(in_dim, hidden, heads, layers, mlp, out_dim, s):
    hd = hidden // heads
    attn = heads * s * hd * 2  # QK^T and A.V for one query row
    block = hidden * 3 * hidden + attn + hidden * hidden + 2 * hidden * mlp
    return in_dim * hidden + layers * block + hidden * out_dim


def flagship_net(cd: str, device, in_dim: int = D, out: int = OUT):
    """A coupling net of the flagship (SetTransformer, hidden 96, 4 heads,
    2 blocks, in 4, out 104; the dequantized flows' main net has in 1, out
    26) in compute dtype ``cd`` on ``device``, from seeds 0 and 1, its
    output layer randomized: a zero one would make the output its bias."""
    import torch
    from categoricalnf_tpu_torch.networks import SetTransformer
    net = SetTransformer(in_dim, out, hidden_dim=H, num_heads=HEADS,
                         compute_dtype=cd,
                         generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        net.out.w.copy_(torch.randn(net.out.w.shape,
                                    generator=torch.Generator()
                                    .manual_seed(1)) * 0.1)
    return net.to(device)


def check_fused(device, gen, report):
    """#3 in bf16 at a sampling chunk's 16,384 rows, and in fp32 at the
    65,536 rows of eval_bpd (1024 sets x 4 chains), the only caller of the
    fp32 variant."""
    import torch

    for cd, sets, name in (("float32", EVAL_CHAINS * B,
                            "fused_set_transformer_f32"),
                           ("bfloat16", B, "fused_set_transformer_bf16")):
        x = torch.randn(sets, S, D, generator=gen, device=device)
        report[name] = fused_fwd_report(flagship_net(cd, device), x)


def fused_fwd_report(net, x, time_it: bool = True) -> dict:
    """#3 on ``x`` through ``net``'s packed weights, twice, against
    ``plain_forward``: fp32 within 1e-4 and fp32's accuracy
    (``check_f32_accuracy``), bf16 within BF16_FWD_REL of its norm and 5%
    on 98% of the elements; its report entry (error, times unless not
    ``time_it``, bytes, operations, the bf16 tile)."""
    import torch
    from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft
    sets, s, in_dim = x.shape
    out, cd = net.out.w.shape[1], net.compute_dtype
    rows = sets * s
    tdt = getattr(torch, cd)
    with torch.no_grad():
        ws = ft.flatten_params(net)
        packed = ft.PackedWeights(ws, tdt)
        y = twice(lambda: ft.fused_set_transformer(packed, x,
                                                   num_heads=HEADS))
        y_p = net.plain_forward(x)
        check(y.shape == (sets, s, out) and y.dtype == tdt,
              f"{cd}: output {tuple(y.shape)} {y.dtype}")
        extra = {}
        if cd == "float32":
            check(close(y, y_p, 1e-4),
                  f"fused fp32 off the unfused path: {max_err(y, y_p)}")
            extra = check_f32_accuracy(net, x, y, y_p)
        else:
            err = (y.float() - y_p.float()).abs()
            bad = float((err > 0.05 * y_p.float().abs().clamp_min(1.0))
                        .float().mean())
            check(bad < 0.02, f"fused bf16 at in {in_dim}, out {out}: "
                  f"{bad:.4f} of elements off by more than 5%")
            rel = rel_err(y, y_p)
            check(rel <= BF16_FWD_REL, f"fused bf16 at in {in_dim}, out "
                  f"{out}: relative error {rel} above {BF16_FWD_REL}")
            # the tile, as the kernel picks it, and the blocks an SM
            tile, smem, _ = ft.fwd_shape(tdt, s, in_dim, H, 2 * H, HEADS)
            extra = dict(rel_err=rel, tile=tile, smem=smem,
                         blocks_per_sm=ft.fwd_blocks_per_sm(smem))
        t = timed(lambda: ft.fused_set_transformer(packed, x,
                                                   num_heads=HEADS),
                  lambda: net.plain_forward(x), 20, 5) if time_it else {}
    elt = 2 if cd == "bfloat16" else 4
    n_w = sum(w.numel() for w in ws[0::2])
    n_b = sum(b.numel() for b in ws[1::2])
    macs = rows * net_macs_per_row(in_dim, H, HEADS, 2, 2 * H, out, s)
    if cd == "float32":
        # or three TF32 products a multiply-add on the tensor cores
        extra["tc_ops"] = 3 * 2 * macs
    return dict(max_abs_err=max_err(y, y_p), rows=rows, **t, **extra,
                bytes=rows * (in_dim + out) * elt + n_w * elt + n_b * 4,
                ops=2 * macs, dtype=cd)


# Relative norm error allowed between the fp32 forward (3xTF32) and
# plain_forward in fp32 (TF32 off): fp32's accuracy.  A single TF32 pass
# reads about 3e-4, which the script reads and holds above it in every run.
F32_FWD_REL = 1e-5


def check_f32_accuracy(net, x, y, y_p) -> dict:
    """#3 fp32 against plain_forward at F32_FWD_REL, with TF32 off as
    resolve_device sets it; the control, plain_forward with TF32 on, must
    read above the limit."""
    import torch
    from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    rel = rel_err(y, y_p)
    check(rel <= F32_FWD_REL, f"fused fp32: relative error {rel} above "
          f"{F32_FWD_REL}")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        y_tf32 = net.plain_forward(x)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    control = rel_err(y_tf32, y_p)
    check(control > F32_FWD_REL, f"plain_forward in TF32 reads {control}, "
          f"inside the limit {F32_FWD_REL}: the limit cannot tell it")
    tile, smem, _ = ft.fwd_shape(torch.float32, x.shape[1], x.shape[2], H,
                                 2 * H, HEADS)
    return dict(rel_err=rel, tf32_control_rel_err=control, tile=tile,
                smem=smem,
                blocks_per_sm=ft.f32_fwd_blocks_per_sm(x.shape[1], smem))


def rel_err(a, b) -> float:
    return float((a.float() - b.float()).norm()
                 / b.float().norm().clamp_min(1e-30))


def check_train_fwd(device, gen, report):
    """#3 in fp32 as a differentiable call runs it (the FMA forward that the
    fp32 backward recomputes), at 4,096 rows and, from a generator of its
    own (so that the other checks' inputs stay as they were), at a flagship
    batch's 16,384 rows, against plain_forward."""
    import torch
    from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft

    net = flagship_net("float32", device)
    with torch.no_grad():
        ws = ft.flatten_params(net)
        packed = ft.PackedWeights(ws, torch.float32)
    big = torch.Generator(device).manual_seed(gen.initial_seed() + 18)
    for sets, name, g in ((B // 4, "fused_set_transformer_train_f32", gen),
                          (B, "fused_set_transformer_train_f32_16384", big)):
        rows = sets * S
        x = torch.randn(sets, S, D, generator=g, device=device)
        with torch.no_grad():

            def run():
                return ft.FusedSetTransformer.apply(x, packed, HEADS, None, *ws)

            y = twice(run)
            y_p = net.plain_forward(x)
            check(y.shape == (sets, S, OUT) and close(y, y_p, 1e-4),
                  f"fp32 train forward off the unfused path: "
                  f"{max_err(y, y_p)}")
            t = timed(run, lambda: net.plain_forward(x), 20, 5)
        n_w = sum(w.numel() for w in ws[0::2])
        n_b = sum(b.numel() for b in ws[1::2])
        macs = rows * net_macs_per_row(D, H, HEADS, 2, 2 * H, OUT, S)
        tile, smem, _ = ft.fma_fwd_shape(S, D, H, 2 * H)
        report[name] = dict(
            max_abs_err=max_err(y, y_p), rel_err=rel_err(y, y_p), rows=rows,
            **t, bytes=rows * (D + OUT) * 4 + (n_w + n_b) * 4, ops=2 * macs,
            dtype="float32", tile=tile, smem=smem, blocks_per_sm=min(
                ft.FMA_FWD_BLOCKS, ft.smem_blocks_per_sm(smem)))


def mixture_bwd_case(device, g, shape, k):
    """#2' on inputs drawn from ``g`` (log-scales on both sides of the
    clip) against ``torch.func.vjp`` of the numerics, its plain version.
    Returns (inputs, the kernel's cotangents, the plain ones, the vjp)."""
    import torch
    from categoricalnf_tpu_torch.ops import numerics as nm
    from categoricalnf_tpu_torch.ops.cuda import mixture as cm
    x, pi, mu, ls = mixture_inputs(g, shape, k, device)
    ls = ls * 6.0
    gy = torch.randn(shape, generator=g, device=device)
    gl = torch.randn(shape, generator=g, device=device)
    got = twice(lambda: cm.mixture_forward_bwd_cuda(x, pi, mu, ls, gy, gl))
    _, vjp = torch.func.vjp(nm.mixture_logit_cdf_and_ldj, x, pi, mu, ls)
    want = vjp((gy, gl))
    for name, a, w in zip(("gx", "gpi", "gmu", "gls"), got, want):
        check(close(a, w, 1e-4), f"mixture_forward_bwd {name} off the "
              f"plain version at K={k}, M={x.numel()}: {max_err(a, w)}")
    return (x, pi, mu, ls, gy, gl), got, want, vjp


def mixture_bwd_report(case) -> dict:
    """#2''s report entry from ``mixture_bwd_case``'s result: error, times
    (kernel and plain), bytes and operations."""
    from categoricalnf_tpu_torch.ops.cuda import mixture as cm
    args, got, want, vjp = case
    x, k = args[0], args[1].shape[-1]
    m = x.numel()
    return dict(
        max_abs_err=max(max_err(a, w) for a, w in zip(got, want)), m=m,
        **timed(lambda: cm.mixture_forward_bwd_cuda(*args),
                lambda: vjp(tuple(args[4:])), 50, 20),
        bytes=m * ((4 + 12 * k + 8) + (4 + 12 * k)),
        ops=m * k * (MIX_SETUP_OPS + MIX_EVAL_OPS + MIX_BWD_OPS),
        dtype="float32")


def check_mixture_bwd(device, gen, report):
    """#2's backward at the training step's M = 1024 x 16 x 4, and at K = 16
    and K = 3 with M = 91, against ``torch.func.vjp`` of the numerics (its
    plain version), log-scales on both sides of the clip."""
    import torch

    # the odd sizes from a generator of their own, so that the later
    # checks' inputs stay
    odd = torch.Generator(device).manual_seed(17)
    for k in (16, 3):
        mixture_bwd_case(device, odd, (7, 13), k)
    report["mixture_forward_bwd"] = mixture_bwd_report(
        mixture_bwd_case(device, gen, (B, S, D), K))


def check_fused_bwd(device, gen, report):
    """#4 in bf16 at the training step's 16,384 rows and in fp32 at 4,096
    rows and, from a generator of its own (so that the other checks' inputs
    stay as they were), at a flagship batch's 16,384 rows, against autograd
    through plain_forward (its plain version): the whole backward of the
    net, through ``FusedSetTransformer`` and the stacks of
    ``flatten_params``, against the parameters' gradients."""
    import torch

    big = torch.Generator(device).manual_seed(gen.initial_seed() + 19)
    for cd, sets, name, draw in (
            ("bfloat16", B, "fused_set_transformer_bwd_bf16", gen),
            ("float32", B // 4, "fused_set_transformer_bwd_f32", gen),
            ("float32", B, "fused_set_transformer_bwd_f32_16384", big)):
        tdt = getattr(torch, cd)
        net = flagship_net(cd, device)
        x = torch.randn(sets, S, D, generator=draw, device=device)
        g = torch.randn(sets, S, OUT, generator=draw, device=device).to(tdt)
        report[name] = fused_bwd_report(net, x, g, name)


def fused_bwd_report(net, x, g, name: str, time_it: bool = True) -> dict:
    """#4 for the cotangent ``g`` of ``net`` at ``x``, through
    ``FusedSetTransformer`` and the stacks of ``flatten_params``, twice,
    against autograd through ``plain_forward`` (fp32 within 2e-4, bf16
    within 0.03 of each gradient's norm); its report entry (times unless
    not ``time_it``)."""
    import torch
    from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft
    sets, s, in_dim = x.shape
    out, cd = net.out.w.shape[1], net.compute_dtype
    rows = sets * s
    tdt = getattr(torch, cd)
    params = list(net.parameters())
    packed = net._packed_weights(tdt)

    def kernel():
        return ft.fused_set_transformer_bwd(packed, x, g, num_heads=HEADS)

    def grads(plain):
        xr = x.clone().requires_grad_(True)
        y = net.plain_forward(xr) if plain else net(xr)
        return torch.autograd.grad(y, [xr] + params, g)

    got = twice(lambda: grads(False))
    want = grads(True)
    errs = [rel_err(a, w) for a, w in zip(got, want)]
    for a, w in zip(got, want):
        if cd == "float32":
            check(close(a, w, 2e-4), f"{name} off autograd of the "
                  f"plain path: {max_err(a, w)}")
    if cd == "bfloat16":
        check(max(errs) <= 0.03, f"{name}: relative error {max(errs)}")
    # the kernel alone, and the plain path's backward alone
    t = {}
    if time_it:
        xr = x.clone().requires_grad_(True)
        y_p = net.plain_forward(xr)
        t = timed(kernel, lambda: torch.autograd.grad(
            y_p, [xr] + params, g, retain_graph=True), 10, 5)
    elt = 2 if cd == "bfloat16" else 4
    ws = ft.flatten_params(net)
    n_w = sum(w.numel() for w in ws[0::2])
    n_b = sum(b.numel() for b in ws[1::2])
    macs = rows * net_macs_per_row(in_dim, H, HEADS, 2, 2 * H, out, s)
    tile, smem, _, grid = ft.bwd_launch(
        tdt, s, in_dim, H, 2 * H, out, HEADS, 2, rows,
        torch.cuda.get_device_properties(x.device).multi_processor_count)
    # the weight-gradient scratch: each block's slice is written once a
    # tile and read back for every tile after its first, and each slice
    # is read once by reduce_wgrad, so as many bytes are read as written
    slice_bytes = (n_w + n_b) * 4
    return dict(
        max_abs_err=max(max_err(a, w) for a, w in zip(got, want)),
        rel_err=max(errs), rows=rows, **t,
        bytes=(rows * (2 * in_dim + out) * elt + n_w * elt + n_b * 4
               + (n_w + n_b) * 4),
        ops=3 * 2 * macs, dtype=cd,
        scratch_mb=grid * slice_bytes / 2**20,
        scratch_written_mb=-(-rows // tile) * slice_bytes / 2**20,
        tile=tile, smem=smem, grid=grid,
        blocks_per_sm=ft.smem_blocks_per_sm(smem))


def http_json(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        t0 = time.perf_counter()
        conn.request(method, path,
                     body=None if body is None else json.dumps(body))
        r = conn.getresponse()
        payload = json.loads(r.read())
        return r.status, payload, time.perf_counter() - t0
    finally:
        conn.close()


def randomize_coupling_nets(model, seed: int, scale: float = 0.05):
    """Seeded N(0, scale^2) weights for the output layer of every coupling
    net of ``model`` (an encoder's MLP nets too, those inside a
    ``ScannedBlocks`` and the autoregressive layers' LSTMs), in module
    order: zero-initialised output layers make every coupling the
    identity, random ones make the kernels' results matter."""
    import torch
    from categoricalnf_tpu_torch.flows import (AutoregressiveMixtureCDF,
                                               MixtureCDFCoupling)
    from categoricalnf_tpu_torch.networks import MLP
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (MixtureCDFCoupling, AutoregressiveMixtureCDF)):
                w = (m.net[-1] if isinstance(m.net, MLP) else m.net.out).w
                w.copy_(torch.randn(w.shape, generator=g).to(w.device)
                        * scale)


def serve_flagship(seed: int, timings: dict, device: str = "cuda"):
    """Drive the serving path; returns the launch counts of this phase."""
    from http.server import ThreadingHTTPServer

    import numpy as np
    import torch
    from categoricalnf_tpu_torch import inference
    from categoricalnf_tpu_torch.serve import RunServer, make_handler
    from categoricalnf_tpu_torch.training.checkpoint import CheckpointManager
    from categoricalnf_tpu_torch.utils.config import load_config, save_config

    cfg = load_config(os.path.join(REPO, "runs", "set16"))
    # the saved config as it is: on the card the coupling nets run kernel
    # #3 whatever the reference's ``fused`` flag says
    args = {**cfg["args"], "seed": seed}
    task = inference.build_task(cfg["task"], args, device=device)
    randomize_coupling_nets(task.model, seed + 1)
    batch = next(task.train_batches(np.random.default_rng(seed)))
    task.data_init(batch, generator=torch.Generator(device).manual_seed(seed))

    with tempfile.TemporaryDirectory() as run_dir:
        save_config(run_dir, {"task": cfg["task"], "args": args})
        CheckpointManager(run_dir).save(0, task.model)

        reset_launches()
        t0 = time.perf_counter()
        server = RunServer(run_dir, device=device)
        timings["load_run_s"] = time.perf_counter() - t0
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        try:
            port = httpd.server_port
            st, health, _ = http_json(port, "GET", "/health")
            check(st == 200 and health["status"] == "ok"
                  and health["task"] == "set_shuffling", f"/health {health}")
            st, out, dt = http_json(port, "POST", "/sample",
                                    {"num_samples": 4})
            check(st == 200, f"/sample answered {st}: {out}")
            x = np.asarray(out["samples"])
            check(x.shape == (4, S) and x.dtype.kind == "i"
                  and x.min() >= 0 and x.max() < S, f"samples {x}")
            timings["sample_4_first_s"] = dt  # includes lazy CUDA set-up
            st, out, dt = http_json(port, "POST", "/sample",
                                    {"num_samples": 4})
            check(st == 200 and len(out["samples"]) == 4, f"/sample {st}")
            timings["sample_4_s"] = dt
            st, met, dt = http_json(port, "POST", "/sample_metrics",
                                    {"num_samples": 2048})
            check(st == 200 and met["metric_num_samples"] == 2048.0,
                  f"/sample_metrics answered {st}: {met}")
            check(0.0 <= met["permutation_validity"] <= 1.0, f"{met}")
            timings["sample_metrics_2048_s"] = dt
            timings["samples_per_s"] = 2048 / dt
            timings["permutation_validity"] = met["permutation_validity"]
            st, out, _ = http_json(port, "POST", "/sample",
                                   {"num_samples": 0})
            check(st == 400 and "error" in out, "bad request not refused")

            eval_batch = task.eval_batches()[0]
            t0 = time.perf_counter()
            bpd = server.handle.eval_bpd(eval_batch, seed=seed,
                                         num_samples=4)
            timings["eval_bpd_1024x4_s"] = time.perf_counter() - t0
        finally:
            httpd.shutdown()
            httpd.server_close()
            th.join(timeout=60)
        launches = read_launches()
        optimum = task.analytic_optimum_bpd()
        mean_bpd = float(np.mean(bpd))
        timings["eval_bpd_mean"] = mean_bpd
        check(bpd.shape == (B,) and np.isfinite(bpd).all(),
              "eval_bpd not finite")
        check(mean_bpd > optimum,
              f"bpd {mean_bpd} below the optimum {optimum}")
        for name in SERVING_KERNELS:
            check(launches[name] > 0,
                  f"kernel {name} was not launched while serving")
        check_against_cpu(server.handle.task, seed)
    return launches


def check_against_cpu(task, seed: int):
    """The served model (kernels on the card) against a CPU copy of it
    (plain path) on a batch of 64 from the task's generator with shared
    noise, in the fp32 twin: the IS bits/var of 4 chains within 1e-3, and
    a sample (with the batch's condition and mask): z within 1e-3 on 99% of
    the elements and the decoded categories equal on 99% of the live
    positions."""
    import numpy as np
    import torch
    from categoricalnf_tpu_torch.inference import build_task
    from categoricalnf_tpu_torch.ops.numerics import uniform_noise

    args = {f.name: getattr(task, f.name) for f in dataclasses.fields(task)
            if f.name not in ("name", "device")}
    cpu = build_task(task.name, args, device="cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in
                               task.model.state_dict().items()})
    batch = cpu._gen(np.random.default_rng(seed + 7), 64)
    if not isinstance(batch, dict):
        batch = {"x": batch}
    shape = np.shape(batch["x"]) + (cpu.model.encoding.dim,)
    g = torch.Generator().manual_seed(seed + 7)
    noise = uniform_noise((4,) + shape, generator=g)
    with torch.no_grad():
        bpd_cpu = cpu.eval_step(batch, 4, noise=noise)
        bpd_gpu = task.eval_step(batch, 4,
                                 noise=noise.to(task.device)).cpu()
        check(torch.allclose(bpd_gpu, bpd_cpu, rtol=1e-3, atol=1e-3),
              f"eval_bpd card vs CPU: {max_err(bpd_gpu, bpd_cpu)}")
        # The card inverts each coupling by rtsafe (24 steps), the CPU by
        # 42 bisections + 3 Newton steps; they agree to ~1e-5 a layer, and
        # many random layers can stretch that where a mixture is steep.  So
        # hold the bulk of z and the decoded categories, not the worst one.
        u = uniform_noise(shape, generator=g)
        z_cpu, z_gpu = (
            t.eval_model.flow.sample(shape, cond=t._tensor(batch.get("cond")),
                                     mask=t._tensor(batch.get("mask")),
                                     noise=u.to(t.device)).cpu()
            for t in (cpu, task))
        z_near = float(((z_gpu - z_cpu).abs()
                        <= 1e-3 + 1e-3 * z_cpu.abs()).float().mean())
        equal = cpu.model.encoding.decode(z_cpu) == task.model.encoding \
            .decode(z_gpu.to(task.device)).cpu()
        live = torch.as_tensor(batch.get("mask", np.ones(shape[:2]))) > 0
        same = float(equal[live].float().mean())
        check(z_near >= 0.99 and same >= 0.99,
              f"sampled z card vs CPU: {z_near:.4f} of z within 1e-3, "
              f"{same:.4f} of categories equal")
    print(f"{task.name}: card vs CPU (fp32, 64 batch elements): bpd max err "
          f"{max_err(bpd_gpu, bpd_cpu):.3g}; z within 1e-3: {z_near:.4f}, "
          f"max err {max_err(z_gpu, z_cpu):.3g}; categories equal: "
          f"{same:.4f}", flush=True)


def reset_launches():
    from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft
    from categoricalnf_tpu_torch.ops.cuda import mixture as cm
    for counts in (cm.LAUNCHES, ft.LAUNCHES, ft.BWD_LAUNCHES,
                   ft.TRAIN_FWD_LAUNCHES, ft.MASKED_LAUNCHES,
                   ft.MASKED_TRAIN_FWD_LAUNCHES, ft.MASKED_BWD_LAUNCHES,
                   ft.GLOBAL_H_BWD_LAUNCHES, ft.CLUSTER_TRAIN_FWD_LAUNCHES,
                   ft.CLUSTER_BWD_LAUNCHES, ft.GLOBAL_H_WGRAD_LAUNCHES):
        for k in counts:
            counts[k] = 0


def read_launches() -> dict:
    from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft
    from categoricalnf_tpu_torch.ops.cuda import mixture as cm
    short = {"bfloat16": "bf16", "float32": "f32"}
    return {**cm.LAUNCHES,
            **{f"fused_set_transformer_{short[k]}": v
               for k, v in ft.LAUNCHES.items()},
            **{f"fused_set_transformer_bwd_{short[k]}": v
               for k, v in ft.BWD_LAUNCHES.items()},
            "fused_set_transformer_train_f32":
                ft.TRAIN_FWD_LAUNCHES["float32"],
            "fused_set_transformer_train_f32_masked":
                ft.MASKED_TRAIN_FWD_LAUNCHES["float32"],
            **{f"fused_set_transformer_{short[k]}_masked": v
               for k, v in ft.MASKED_LAUNCHES.items()},
            **{f"fused_set_transformer_bwd_{short[k]}_masked": v
               for k, v in ft.MASKED_BWD_LAUNCHES.items()},
            **{f"fused_set_transformer_bwd_{short[k]}_global_h": v
               for k, v in ft.GLOBAL_H_BWD_LAUNCHES.items()},
            FP32_BIG_PAIR[0]: ft.CLUSTER_TRAIN_FWD_LAUNCHES["float32"],
            FP32_BIG_PAIR[1]: ft.CLUSTER_BWD_LAUNCHES["float32"],
            "wgrad_tiles_bf16": ft.GLOBAL_H_WGRAD_LAUNCHES["bfloat16"]}


TRAIN_STEPS, TRAIN_EVAL_EVERY, TRAIN_LOG_EVERY = 200, 100, 20
# train steps traced after the measured run: untraced warm-up (5 until the
# fp32 runs at sets of 64 and 128 came: the model and the allocator are
# warm from its training by then), then traced
PROFILE_WARMUP, PROFILE_STEPS = 2, 10


def profile_steps(task, optimizer, seed: int, *, warmup: int = PROFILE_WARMUP,
                  steps: int = PROFILE_STEPS, host: bool = False,
                  crop=None) -> dict:
    """Traces the card's kernels (torch.profiler, CUDA activity; with
    ``host`` the CPU's too) over ``steps`` train steps of the trained model
    after ``warmup`` untraced ones, on batches cut to their first ``crop``
    positions where it is given: the Trainer's step (batch to the card,
    loss, backward, clip and update, a fresh optimizer), run after the
    measured training so that the profiler cannot slow the steps the
    metric reads.  Gives the wall ms a step (a synchronize at both ends),
    the device's busy ms a step (the kernels' and copies' durations summed:
    one stream, so they do not overlap), its idle share, and the busy time
    by kernel group and by the largest kernels; with ``host``, the kernel
    launches a step and the host's largest operators by their own time (the
    profiler's overhead on the host is in the wall time then)."""
    import numpy as np
    import torch
    from categoricalnf_tpu_torch.data.prefetch import to_device
    from categoricalnf_tpu_torch.training.state import TrainState

    state = TrainState.create(task.model, optimizer)
    batches = task.train_batches(np.random.default_rng(seed + 11))
    activities = [torch.profiler.ProfilerActivity.CUDA]
    if host:
        activities.append(torch.profiler.ProfilerActivity.CPU)
    prof = torch.profiler.profile(activities=activities)
    for i in range(warmup + steps):
        if i == warmup:
            torch.cuda.synchronize()
            prof.__enter__()
            t0 = time.perf_counter()
        batch = next(batches)
        if crop:
            batch = {k: v[:, :crop] for k, v in batch.items()}
        loss = task.loss(to_device(batch, task.device), 1.0)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.apply_gradients()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    prof.__exit__(None, None, None)
    kernels: dict = {}
    host_ops: dict = {}
    launches = 0
    for evt in prof.key_averages():
        if str(evt.device_type).endswith("CUDA"):
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = evt.self_cuda_time_total
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us / 1e3
        elif host:
            host_ops[evt.key] = (evt.count, evt.self_cpu_time_total / 1e3)
            if evt.key in ("cudaLaunchKernel", "cuLaunchKernel",
                           "cudaLaunchKernelExC"):
                launches += evt.count
    if not kernels:
        return {"measured": False, "error": "no device time in the trace"}
    groups: dict = {}
    for name, ms in kernels.items():
        group = next((g for g in ("fused_set_transformer_bwd",
                                  "fused_set_transformer_fwd", "reduce_wgrad",
                                  "wgrad_tiles", "mixture_forward_bwd",
                                  "mixture_forward", "mixture_inverse")
                      if g in name), "plain torch")
        groups[group] = groups.get(group, 0.0) + ms / steps
    busy = sum(kernels.values()) / steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    out = {"measured": True, "steps": steps,
           "wall_ms_per_step": wall, "device_busy_ms_per_step": busy,
           "device_idle_share": 1.0 - busy / wall,
           "groups_ms_per_step": dict(sorted(groups.items())),
           "groups_share_of_busy": {g: ms / busy
                                    for g, ms in sorted(groups.items())},
           "top_kernels_ms_per_step": [[k[:80], ms / steps]
                                       for k, ms in top]}
    if host:
        top_host = sorted(host_ops.items(), key=lambda kv: -kv[1][1])[:12]
        out.update(
            kernel_launches_per_step=launches / steps,
            host_self_ms_per_step=sum(ms for _, ms in host_ops.values())
            / steps,
            top_host_ops_per_step=[[k[:60], n / steps, ms / steps]
                                   for k, (n, ms) in top_host])
    return out


def train_config(a: dict, seed: int, eval_samples: int):
    """The Trainer's config of a chip_smoke training phase from a run's
    saved args ``a``: TRAIN_STEPS steps, evals every TRAIN_EVAL_EVERY with
    ``eval_samples`` chains (the final eval and the test too), the run's
    steps a call, rate, clip and beta warm-up."""
    from categoricalnf_tpu_torch.training.engine import TrainConfig
    from categoricalnf_tpu_torch.training.schedules import ScheduleSpec
    from categoricalnf_tpu_torch.training.state import OptimizerConfig
    return TrainConfig(
        num_steps=TRAIN_STEPS, eval_every=TRAIN_EVAL_EVERY,
        eval_samples=eval_samples, final_eval_samples=eval_samples,
        log_every=TRAIN_LOG_EVERY, seed=seed,
        steps_per_call=a.get("steps_per_call") or 1,
        optimizer=OptimizerConfig(learning_rate=a["lr"],
                                  grad_clip_norm=a["grad_clip"]),
        beta_schedule=ScheduleSpec(kind="sigmoid", start=0.5,
                                   end=a["beta_end"],
                                   center=a["beta_warmup"], rate=0.002))


def rate_windows(rows, after: int) -> tuple:
    """(steps, seconds, "first-last" step) of the Trainer's rate windows
    that start at or after step ``after``, from a run's metrics rows: a
    window runs from the last log or eval to its log (a call of several
    steps logs once), and its seconds are its steps over its
    ``steps_per_s``."""
    steps = secs = 0.0
    start, first = 0, None
    for r in rows:
        if r["prefix"] not in ("train", "val"):
            continue
        if r["prefix"] == "train" and start >= after:
            steps += r["step"] - start
            secs += (r["step"] - start) / r["steps_per_s"]
            first = start + 1 if first is None else first
            last = r["step"]
        start = r["step"]
    check(steps > 0, f"no rate window after step {after}")
    return steps, secs, f"{first}-{last}"


def train_checked(task, task_name: str, args: dict, tcfg, out_dir: str,
                  timings: dict, kernels, rate_after=None) -> dict:
    """Train ``task`` through the port's Trainer into ``out_dir`` (its
    config.json written from ``task_name`` and ``args``) and check the run:
    it starts from the untrained model (the seed's parameters,
    data-initialised on the first training batch), every logged loss is
    finite, no eval raises the integrity alarm, every eval bpd is above 0,
    the best is at least 0.2 bits/var below the untrained one, and each of
    ``kernels`` was launched.  Records in ``timings`` the wall time, the
    peak device memory, the bpds and samples/s over the steps after the
    first eval of ``tcfg`` (101-200 at TRAIN_STEPS; the Trainer's windows,
    which count training steps only), or after step ``rate_after`` where
    it is given.  Returns the
    final metrics with the launches of the run under "launches"."""
    import numpy as np
    import torch
    from categoricalnf_tpu_torch.training.engine import Trainer
    from categoricalnf_tpu_torch.utils.config import save_config

    tcfg = dataclasses.replace(tcfg, out_dir=out_dir)
    save_config(out_dir, {"task": task_name, "args": args})
    trainer = Trainer(task, tcfg)
    trainer.init_model(next(task.train_batches(
        np.random.default_rng(tcfg.seed))))
    bpd0 = trainer.evaluate(tcfg.eval_samples, 0)["bpd"]
    start = {k: v.clone() for k, v in task.model.state_dict().items()}
    started_from = []
    init_model = trainer.init_model

    def spy(batch):
        init_model(batch)
        started_from.append({k: v.clone() for k, v in
                             task.model.state_dict().items()})

    trainer.init_model = spy
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    final = trainer.train(resume=False)
    torch.cuda.synchronize()
    timings[f"train_{tcfg.num_steps}_steps_s"] = time.perf_counter() - t0
    launches = read_launches()
    check(len(started_from) == 1 and all(
        torch.equal(started_from[0][k], v) for k, v in start.items()),
        "the trainer started from another model than the untrained one")
    timings["train_peak_mem_gib"] = (torch.cuda.max_memory_allocated()
                                     / 2**30)
    rows = [json.loads(line) for line in
            open(os.path.join(out_dir, "metrics.jsonl"))]
    train = [r for r in rows if r["prefix"] == "train"]
    vals = [r for r in rows if r["prefix"] == "val"]
    check(len(train) == tcfg.num_steps // tcfg.log_every
          and all(np.isfinite(r["loss"]) for r in train),
          f"training loss not finite at every logged step: {train}")
    check(all(r["integrity_alarm"] == 0 for r in vals),
          f"integrity alarm: {vals}")
    check(all(r["bpd"] > 0 for r in vals), f"eval bpd not above 0: {vals}")
    best = final["best_bpd"]
    timings.update(untrained_bpd=bpd0, best_bpd=best,
                   val_bpd=[r["bpd"] for r in vals],
                   test_bpd=final["test_bpd"])
    check(best < bpd0 - 0.2, f"training did not lower the bpd by 0.2: "
          f"{bpd0} -> {best}")
    steps, secs, timings["rate_steps"] = rate_windows(
        rows, tcfg.eval_every if rate_after is None else rate_after)
    timings["train_ms_per_step"] = secs * 1e3 / steps
    timings["train_samples_per_s"] = steps * task.batch_size / secs
    for name in kernels:
        check(launches[name] > 0, f"kernel {name} was not launched "
              "while training")
    return {**final, "launches": launches}


def train_calls(task, tcfg, calls: int, timings: dict, kernels) -> dict:
    """``calls`` calls of ``tcfg.steps_per_call`` train steps of ``task``
    through the Trainer's step (its data init on the first batch, its
    batches grouped as ``Trainer.train`` groups them, its beta and noise a
    step), with no eval: every loss finite and each of ``kernels``
    launched.  Records the losses, the wall seconds, ms a step and
    samples/s over the calls after the first, and the peak device memory.
    Returns the launches of the steps."""
    import numpy as np
    import torch
    from categoricalnf_tpu_torch.data.prefetch import to_device
    from categoricalnf_tpu_torch.training.engine import Trainer, grouped
    from categoricalnf_tpu_torch.training.state import TrainState

    trainer = Trainer(task, tcfg)
    batches = grouped(task.train_batches(np.random.default_rng(tcfg.seed)),
                      tcfg.steps_per_call)
    trainer.init_model(next(batches)[0])
    state = trainer.state = TrainState.create(task.model, tcfg.optimizer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, ends = [], []
    t0 = time.perf_counter()
    for _ in range(calls):
        for batch in next(batches):
            loss, _, _ = trainer._step(state, to_device(batch, task.device))
            losses.append(float(loss.detach()))
        ends.append(time.perf_counter())
    launches = read_launches()
    check(all(np.isfinite(v) for v in losses),
          f"training loss not finite: {losses}")
    for name in kernels:
        check(launches[name] > 0, f"kernel {name} was not launched "
              "while training")
    steps = (calls - 1) * tcfg.steps_per_call
    secs = ends[-1] - ends[0]
    timings.update(
        losses=losses, wall_s=ends[-1] - t0,
        train_peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        rate_steps=f"{tcfg.steps_per_call + 1}-{len(losses)}",
        train_ms_per_step=secs * 1e3 / steps,
        train_samples_per_s=steps * task.batch_size / secs)
    return launches


def train_flagship(seed: int, timings: dict, card: str,
                   device: str = "cuda") -> dict:
    """Train the flagship (runs/set16/config.json: bf16, 8 layers, hidden
    96, batch 1024) for 200 steps through the port's Trainer, then serve the
    run.  Returns the launch counts of the training run."""
    import torch
    from categoricalnf_tpu_torch import inference
    from categoricalnf_tpu_torch.networks import SetTransformer
    from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft
    from categoricalnf_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(REPO, "runs", "set16"))
    a = cfg["args"]
    args = {**a, "seed": seed, "eval_batches_count": 1}
    task = inference.build_task(cfg["task"], args, device=device)
    tcfg = train_config(a, seed, 4)
    with tempfile.TemporaryDirectory() as out_dir:
        final = train_checked(task, cfg["task"], args, tcfg, out_dir,
                              timings, ("mixture_forward",
                                        "mixture_forward_bwd",
                                        "fused_set_transformer_bf16",
                                        "fused_set_transformer_bwd_bf16"))
        optimum = task.analytic_optimum_bpd()
        check(final["best_bpd"] > optimum,
              f"best bpd {final['best_bpd']} below the optimum {optimum}")
        timings["permutation_validity"] = final["permutation_validity"]

        timings["step_profile"] = profile_steps(task, tcfg.optimizer, seed)
        # the host cost of recasting the weights after an optimizer step
        nets = [m for m in task.model.modules()
                if isinstance(m, SetTransformer)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for net in nets:
            ft.PackedWeights(ft.flatten_params(net), torch.bfloat16)
        torch.cuda.synchronize()
        timings["repack_ms_per_step"] = (time.perf_counter() - t0) * 1e3

        # serve the run that was just written
        from http.server import ThreadingHTTPServer

        from categoricalnf_tpu_torch.serve import RunServer, make_handler
        server = RunServer(out_dir, device=device)
        check(server.handle.step in (TRAIN_EVAL_EVERY, TRAIN_STEPS),
              f"served step {server.handle.step}")
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        try:
            st, met, dt = http_json(httpd.server_port, "POST",
                                    "/sample_metrics", {"num_samples": 1024})
        finally:
            httpd.shutdown()
            httpd.server_close()
            th.join(timeout=60)
        check(st == 200 and met["metric_num_samples"] == 1024.0,
              f"/sample_metrics of the trained run answered {st}: {met}")
        timings["trained_sample_metrics_1024_s"] = dt
        timings["trained_permutation_validity"] = met["permutation_validity"]
    print(json.dumps({"metric": "set_shuffling_train_samples_per_s",
                      "value": timings["train_samples_per_s"],
                      "unit": "samples/s", "steps": timings["rate_steps"],
                      "batch_size": task.batch_size, "device": card}),
          flush=True)
    return final["launches"]


# runs/set16 at the CLI's --set_size 64 (bf16's whole-set tiles) and 128
# (#4 bf16 over 2-CTA clusters, #3 fp32 over clusters of 4), bf16, batch
# 1024: at 64 the Trainer for
# BIG_SET_STEPS steps (evals at the middle and the end), served; at 128
# BIG_SET_128_CALLS calls of one step and one eval batch
BIG_SET_STEPS, BIG_SET_EVAL_EVERY = 100, 50
BIG_SET_128_CALLS = 3
BIG_SET_KERNELS = ("mixture_forward", "mixture_forward_bwd",
                   "fused_set_transformer_bf16",
                   "fused_set_transformer_bwd_bf16",
                   "fused_set_transformer_f32")


def big_set_task(seed: int, set_size: int, device: str = "cuda",
                 compute_dtype: str | None = None):
    """runs/set16/config.json as it is but for ``--set_size`` (and one eval
    batch; ``--compute_dtype`` where given): (task name, args, task)."""
    from categoricalnf_tpu_torch import inference
    from categoricalnf_tpu_torch.utils.config import load_config
    cfg = load_config(os.path.join(REPO, "runs", "set16"))
    args = {**cfg["args"], "seed": seed, "set_size": set_size,
            "eval_batches_count": 1,
            **({"compute_dtype": compute_dtype} if compute_dtype else {})}
    return cfg["task"], args, inference.build_task(cfg["task"], args,
                                                   device=device)


def big_set_phase(seed: int, timings: dict, card: str,
                  device: str = "cuda") -> dict:
    """runs/set16 at --set_size 64: trained through the Trainer for
    BIG_SET_STEPS steps (the checks of ``train_checked``: its fp32 IS eval
    untrained, at the middle and at the end, the best 0.2 bits/var below
    the untrained and above the optimum log2(64!)/64), 10 more steps traced
    (``profile_steps``), then served: /sample, /sample_metrics, eval_bpd,
    and held against its CPU copy (``check_against_cpu``).  Then --set_size
    128: BIG_SET_128_CALLS calls of one train step (``train_calls``: every
    loss finite) and the fp32 IS eval of one batch (finite, above the
    optimum), #3 bf16, #4 bf16 and #3 fp32 launched, the latter two over
    clusters.  Returns the launches by path."""
    import numpy as np
    import torch
    from http.server import ThreadingHTTPServer

    from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft
    from categoricalnf_tpu_torch.serve import RunServer, make_handler

    launches = {}
    name, args, task = big_set_task(seed, 64, device)
    a = {**args, "steps_per_call": 1}
    tcfg = dataclasses.replace(train_config(a, seed, 4),
                               num_steps=BIG_SET_STEPS,
                               eval_every=BIG_SET_EVAL_EVERY)
    t64: dict = {}
    with tempfile.TemporaryDirectory() as out_dir:
        final = train_checked(task, name, args, tcfg, out_dir, t64,
                              BIG_SET_KERNELS)
        launches["set64_training"] = final["launches"]
        optimum = task.analytic_optimum_bpd()
        t64["optimum_bpd"] = optimum
        check(all(b > optimum for b in t64["val_bpd"] + [t64["best_bpd"]]),
              f"set 64: an eval bpd below the optimum {optimum}: {t64}")
        t64["permutation_validity"] = final["permutation_validity"]
        t64["step_profile"] = profile_steps(task, tcfg.optimizer, seed)

        reset_launches()
        server = RunServer(out_dir, device=device)
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        try:
            port = httpd.server_port
            st, out, _ = http_json(port, "POST", "/sample",
                                   {"num_samples": 4})
            x = np.asarray(out.get("samples", []))
            check(st == 200 and x.shape == (4, 64) and x.min() >= 0
                  and x.max() < 64, f"set 64 /sample answered {st}: {out}")
            st, met, dt = http_json(port, "POST", "/sample_metrics",
                                    {"num_samples": 1024})
            check(st == 200 and met["metric_num_samples"] == 1024.0,
                  f"set 64 /sample_metrics answered {st}: {met}")
            t64["sample_metrics_1024_s"] = dt
            t64["served_permutation_validity"] = met["permutation_validity"]
            t0 = time.perf_counter()
            bpd = server.handle.eval_bpd(task.eval_batches()[0], seed=seed,
                                         num_samples=4)
            t64["eval_bpd_1024x4_s"] = time.perf_counter() - t0
        finally:
            httpd.shutdown()
            httpd.server_close()
            th.join(timeout=60)
        launches["set64_serving"] = read_launches()
        check(np.isfinite(bpd).all() and float(np.mean(bpd)) > optimum,
              f"set 64 eval_bpd {np.mean(bpd)}")
        t64["served_eval_bpd_mean"] = float(np.mean(bpd))
        for k in SERVING_KERNELS:
            check(launches["set64_serving"][k] > 0,
                  f"{k} was not launched serving the set-64 run")
        check_against_cpu(server.handle.task, seed)
    timings["set64"] = t64

    name, args, task = big_set_task(seed, 128, device)
    a = {**args, "steps_per_call": 1}
    tcfg = train_config(a, seed, 4)
    t128: dict = {}
    step = train_calls(task, tcfg, BIG_SET_128_CALLS, t128,
                       BIG_SET_KERNELS[:4])
    reset_launches()
    with torch.no_grad():
        bpd = task.eval_step(task.eval_batches()[0], 4).cpu()
    torch.cuda.synchronize()
    evals = read_launches()
    check(bool(torch.isfinite(bpd).all())
          and float(bpd.mean()) > task.analytic_optimum_bpd(),
          f"set 128 eval bpd {bpd.mean()}")
    check(evals["fused_set_transformer_f32"] > 0,
          "#3 fp32 was not launched by the set-128 eval")
    t128.update(eval_bpd_mean=float(bpd.mean()),
                optimum_bpd=task.analytic_optimum_bpd(),
                clusters={"fwd_bf16": ft.fwd_shape(
                              torch.bfloat16, 128, D, H, 2 * H)[2],
                          "bwd_bf16": ft.bwd_layout(
                              torch.bfloat16, 128, D, H, 2 * H, OUT, HEADS,
                              2)[3],
                          "fwd_f32": ft.fwd_shape(torch.float32, 128, D,
                                                  H, 2 * H, HEADS)[2]})
    launches["set128_training"] = {k: step[k] + evals[k] for k in step}
    timings["set128"] = t128
    print(json.dumps({"metric": "set_shuffling_64_train_samples_per_s",
                      "value": t64["train_samples_per_s"],
                      "unit": "samples/s", "steps": t64["rate_steps"],
                      "batch_size": task.batch_size, "device": card}),
          flush=True)
    return launches


# runs/set16 in fp32 at --set_size 64 and 128, through the fp32 train
# step's pair over clusters of 2 and 4 blocks: at 64 the Trainer for
# FP32_BIG_SET_STEPS steps (evals untrained and at the end), 10 more traced;
# at 128 BIG_SET_128_CALLS calls of one step and one eval batch
FP32_BIG_SET_STEPS, FP32_BIG_SET_LOG_EVERY = 30, 10
FP32_BIG_SET_KERNELS = ("mixture_forward", "mixture_forward_bwd",
                        "fused_set_transformer_f32") + FP32_BIG_PAIR


def fp32_big_set_phase(seed: int, timings: dict, card: str,
                       device: str = "cuda") -> dict:
    """runs/set16 with compute_dtype float32 at --set_size 64: trained
    through the Trainer for FP32_BIG_SET_STEPS steps (``train_checked``:
    its fp32 IS eval, one batch of 1024 and 4 chains, untrained and at the
    end; the best 0.2 bits/var below the untrained, every bpd above the
    optimum log2(64!)/64, no alarm), each step launching both kernels of
    the pair over clusters once a coupling, and no other instance of the
    pair (none at sets up to 32); 10 more steps traced
    (``profile_steps``).  Then --set_size 128:
    BIG_SET_128_CALLS calls of one train step (``train_calls``: every loss
    finite, the pair over clusters of 4) and the fp32 IS eval of one batch
    (finite, above log2(128!)/128).  Returns the launches by path."""
    import torch
    from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft

    launches = {}
    name, args, task = big_set_task(seed, 64, device, "float32")
    check(task.compute_dtype == "float32" and task.batch_size == B,
          "runs/set16 in fp32 at set 64 is not the model this phase is "
          "written for")
    a = {**args, "steps_per_call": 1}
    tcfg = dataclasses.replace(train_config(a, seed, 4),
                               num_steps=FP32_BIG_SET_STEPS,
                               eval_every=FP32_BIG_SET_STEPS,
                               log_every=FP32_BIG_SET_LOG_EVERY)
    t64: dict = {"cut": {"compute_dtype": "float32", "set_size": 64}}
    with tempfile.TemporaryDirectory() as out_dir:
        final = train_checked(task, name, args, tcfg, out_dir, t64,
                              FP32_BIG_SET_KERNELS, rate_after=2
                              * FP32_BIG_SET_LOG_EVERY)
        optimum = task.analytic_optimum_bpd()
        t64["optimum_bpd"] = optimum
        check(all(b > optimum for b in t64["val_bpd"]
                  + [t64["best_bpd"], t64["untrained_bpd"]]),
              f"fp32 set 64: an eval bpd below the optimum {optimum}: {t64}")
        n = final["launches"]
        for kernel, small in zip(FP32_BIG_PAIR, FP32_PAIR):
            check(n[kernel] == 8 * FP32_BIG_SET_STEPS and n[small] == 0,
                  f"fp32 set 64: {kernel} launched {n[kernel]} times in "
                  f"{FP32_BIG_SET_STEPS} steps, not 8 a step ({small}: "
                  f"{n[small]}, not 0)")
        t64["step_profile"] = profile_steps(task, tcfg.optimizer, seed)
    launches["set64_fp32_training"] = final["launches"]
    timings["set64"] = t64

    name, args, task = big_set_task(seed, 128, device, "float32")
    tcfg = train_config({**args, "steps_per_call": 1}, seed, 4)
    t128: dict = {"cut": {"compute_dtype": "float32", "set_size": 128}}
    step = train_calls(task, tcfg, BIG_SET_128_CALLS, t128,
                       ("mixture_forward", "mixture_forward_bwd")
                       + FP32_BIG_PAIR)
    reset_launches()
    with torch.no_grad():
        bpd = task.eval_step(task.eval_batches()[0], 4).cpu()
    torch.cuda.synchronize()
    evals = read_launches()
    check(bool(torch.isfinite(bpd).all())
          and float(bpd.mean()) > task.analytic_optimum_bpd(),
          f"fp32 set 128 eval bpd {bpd.mean()}")
    t128.update(eval_bpd_mean=float(bpd.mean()),
                optimum_bpd=task.analytic_optimum_bpd(),
                clusters={"train_fwd_f32": ft.fma_fwd_shape(
                    128, D, H, 2 * H)[2], "bwd_f32": ft.bwd_layout(
                        torch.float32, 128, D, H, 2 * H, OUT, HEADS, 2)[3]})
    launches["set128_fp32_training"] = {k: step[k] + evals[k] for k in step}
    timings["set128"] = t128
    for size, t in ((64, t64), (128, t128)):
        print(json.dumps({"metric": "fp32_train_samples_per_s",
                          "run": f"set16_set{size}",
                          "value": t["train_samples_per_s"],
                          "unit": "samples/s", "steps": t["rate_steps"],
                          "batch_size": task.batch_size,
                          "ms_per_step": t["train_ms_per_step"],
                          "peak_mem_gib": t["train_peak_mem_gib"],
                          "device_idle_share": t.get("step_profile", {}).get(
                              "device_idle_share"),
                          "device": card}), flush=True)
    return launches


# fp32 training through the FMA pair: runs/set16's, runs/molecules' and
# runs/molecules_v4's steps; runs/moses's, 2 calls of its 4 steps a call
# (FP32_MOL_STEPS: 30 until the fp32 runs at sets of 64 and 128 came)
FP32_SET_STEPS, FP32_MOL_STEPS = 60, 20
FP32_MOSES_CALLS = 2
FP32_PAIR = ("fused_set_transformer_train_f32",
             "fused_set_transformer_bwd_f32")
FP32_MOL_KERNELS = ("mixture_forward", "mixture_forward_bwd",
                    "mixture_inverse", "fused_set_transformer_f32",
                    "fused_set_transformer_f32_masked") + FP32_PAIR + tuple(
                        f"{name}_masked" for name in FP32_PAIR)
# the wide nets' #4 keeps regions of its tile in global memory; what their
# train steps alone launch (no eval, no sample)
FP32_WIDE_KERNELS = FP32_MOL_KERNELS + (
    "fused_set_transformer_bwd_f32_global_h",)
FP32_WIDE_STEP_KERNELS = ("mixture_forward", "mixture_forward_bwd",
                          "fused_set_transformer_bwd_f32_global_h"
                          ) + FP32_PAIR + tuple(f"{name}_masked"
                                                for name in FP32_PAIR)


def fp32_training_phase(seed: int, timings: dict, card: str,
                        device: str = "cuda") -> dict:
    """Train in fp32 on the card, through the fp32 train step's pair (#3
    fp32 with grad, #4 fp32).  runs/set16/config.json with compute_dtype
    float32 (the CLI's --compute_dtype switch; the config otherwise as it
    is: 8 couplings, hidden 96, batch 1024) for FP32_SET_STEPS steps, its
    fp32 IS eval (one batch of 1024, 4 chains) untrained and at the end,
    with ``train_checked``'s checks, the best above the optimum and each of
    the pair launched 8 times a step (once a coupling); then
    runs/molecules/config.json's architecture (hidden 96, 4 node and 4
    edge layers, K = 8, batch 64) with compute_dtype float32 and dataset
    synthetic (its .npz is not in the repo) for FP32_MOL_STEPS steps (evals
    of its 8 batches of 4 chains untrained and at the end), with
    ``train_checked``'s checks and the pair launched with the node flow's
    key mask; runs/molecules_v4/config.json (hidden 192, 4 node and 6 edge
    layers, K = 8, batch 128) the same way for FP32_MOL_STEPS steps, evals
    untrained and at the end, #4 launched with regions of its tile in its
    global workspace.  Each of these traces 10 more steps.  Then
    runs/moses/config.json (hidden 256, K = 16, batch 192) in fp32 for
    FP32_MOSES_CALLS calls of its 4 steps a call, no eval
    (``train_calls``: the losses finite, #4 in its global layout), and
    traces one call more after a warm-up step.  Returns the launches of
    the four trainings."""
    from categoricalnf_tpu_torch import inference
    from categoricalnf_tpu_torch.utils.config import load_config

    launches = {}
    cfg = load_config(os.path.join(REPO, "runs", "set16"))
    a = cfg["args"]
    args = {**a, "compute_dtype": "float32", "seed": seed,
            "eval_batches_count": 1}
    task = inference.build_task(cfg["task"], args, device=device)
    check(task.compute_dtype == "float32" and task.batch_size == 1024,
          "runs/set16 in fp32 is not the model this phase is written for")
    tcfg = dataclasses.replace(train_config(a, seed, 4),
                               num_steps=FP32_SET_STEPS,
                               eval_every=FP32_SET_STEPS)
    set_timings: dict = {"cut": {"compute_dtype": "float32"}}
    with tempfile.TemporaryDirectory() as out_dir:
        final = train_checked(task, cfg["task"], args, tcfg, out_dir,
                              set_timings, ("mixture_forward",
                                            "mixture_forward_bwd",
                                            "fused_set_transformer_f32")
                              + FP32_PAIR, rate_after=TRAIN_LOG_EVERY)
        optimum = task.analytic_optimum_bpd()
        check(final["best_bpd"] > optimum,
              f"fp32 best bpd {final['best_bpd']} below the optimum {optimum}")
        for name in FP32_PAIR:
            check(final["launches"][name] == 8 * FP32_SET_STEPS,
                  f"fp32 training launched {name} "
                  f"{final['launches'][name]} times in {FP32_SET_STEPS} "
                  "steps, not 8 a step")
        set_timings["step_profile"] = profile_steps(task, tcfg.optimizer,
                                                    seed)
    launches["set16_fp32_training"] = final["launches"]
    timings["set16"] = set_timings

    cfg = load_config(os.path.join(REPO, "runs", "molecules"))
    a = cfg["args"]
    m_args = {**a, "compute_dtype": "float32", "dataset": "synthetic",
              "seed": seed}
    mol = inference.build_task(cfg["task"], m_args, device=device)
    check((mol.hidden_dim, mol.num_layers_node, mol.num_layers_edge,
           mol.num_mixtures, mol.batch_size, mol.compute_dtype)
          == (96, 4, 4, 8, 64, "float32"),
          "runs/molecules in fp32 is not the model this phase is written for")
    tcfg = dataclasses.replace(train_config(a, seed, a["eval_samples"]),
                               num_steps=FP32_MOL_STEPS,
                               eval_every=FP32_MOL_STEPS, log_every=10)
    mol_timings: dict = {"cut": {"dataset": "synthetic",
                                 "compute_dtype": "float32"}}
    with tempfile.TemporaryDirectory() as out_dir:
        final = train_checked(mol, cfg["task"], m_args, tcfg, out_dir,
                              mol_timings, FP32_MOL_KERNELS,
                              rate_after=tcfg.log_every)
        mol_timings["step_profile"] = profile_steps(mol, tcfg.optimizer,
                                                    seed)
    launches["molecules_fp32_training"] = final["launches"]
    timings["molecules"] = mol_timings

    # runs/molecules_v4 in fp32 (hidden 192: #4's copies and MLP pair in
    # its global workspace), evals untrained and at the end
    t0 = time.perf_counter()
    cfg = load_config(os.path.join(REPO, "runs", "molecules_v4"))
    a = cfg["args"]
    v4_args = {**a, "compute_dtype": "float32", "dataset": "synthetic",
               "seed": seed}
    v4 = inference.build_task(cfg["task"], v4_args, device=device)
    check((v4.hidden_dim, v4.num_layers_node, v4.num_layers_edge,
           v4.num_mixtures, v4.batch_size, v4.compute_dtype)
          == (MOL_HIDDEN, 4, 6, K, MOL_BATCH, "float32"),
          "runs/molecules_v4 in fp32 is not the model this phase is written "
          "for")
    tcfg = dataclasses.replace(train_config(a, seed, a["eval_samples"]),
                               num_steps=FP32_MOL_STEPS,
                               eval_every=FP32_MOL_STEPS, log_every=10)
    v4_timings: dict = {"cut": {"dataset": "synthetic",
                                "compute_dtype": "float32"}}
    with tempfile.TemporaryDirectory() as out_dir:
        final = train_checked(v4, cfg["task"], v4_args, tcfg, out_dir,
                              v4_timings, FP32_WIDE_KERNELS,
                              rate_after=tcfg.log_every)
        v4_timings["step_profile"] = profile_steps(v4, tcfg.optimizer, seed)
    launches["molecules_v4_fp32_training"] = final["launches"]
    v4_timings["phase_s"] = time.perf_counter() - t0
    timings["molecules_v4"] = v4_timings

    # runs/moses in fp32 (hidden 256: qkv in the workspace too): two calls
    # of its steps_per_call steps, no eval
    t0 = time.perf_counter()
    cfg = load_config(os.path.join(REPO, "runs", "moses"))
    a = cfg["args"]
    moses_args = {**a, "compute_dtype": "float32", "dataset": "synthetic",
                  "seed": seed}
    moses = inference.build_task(cfg["task"], moses_args, device=device)
    check((moses.hidden_dim, moses.num_mixtures, moses.batch_size,
           moses.compute_dtype) == (MOSES_HIDDEN, MOSES_K, MOSES_BATCH,
                                    "float32"),
          "runs/moses in fp32 is not the model this phase is written for")
    tcfg = train_config(a, seed, a["eval_samples"])
    moses_timings: dict = {"cut": {"dataset": "synthetic",
                                   "compute_dtype": "float32",
                                   "eval": "none"}}
    launches["moses_fp32_training"] = train_calls(
        moses, tcfg, FP32_MOSES_CALLS, moses_timings, FP32_WIDE_STEP_KERNELS)
    moses_timings["step_profile"] = profile_steps(
        moses, tcfg.optimizer, seed, warmup=1, steps=tcfg.steps_per_call)
    moses_timings["phase_s"] = time.perf_counter() - t0
    timings["moses"] = moses_timings
    for run, t, b in (("set16", set_timings, task.batch_size),
                      ("molecules", mol_timings, mol.batch_size),
                      ("molecules_v4", v4_timings, v4.batch_size),
                      ("moses", moses_timings, moses.batch_size)):
        print(json.dumps({"metric": "fp32_train_samples_per_s", "run": run,
                          "value": t["train_samples_per_s"],
                          "unit": "samples/s", "steps": t["rate_steps"],
                          "batch_size": b,
                          "ms_per_step": t["train_ms_per_step"],
                          "peak_mem_gib": t["train_peak_mem_gib"],
                          "device_idle_share": t["step_profile"].get(
                              "device_idle_share"),
                          "device": card}), flush=True)
    return launches


COLORING_VALIDITY = ("coloring_validity", "coloring_validity_ci95",
                     "coloring_validity_corrected",
                     "coloring_validity_corrected_ci95")


def coloring_phase(seed: int, timings: dict, card: str,
                   device: str = "cuda") -> dict:
    """Train runs/coloring/config.json as it is (bf16, 6 layers scanned as
    3 two-parity blocks, RGCN hidden 96, batch 256, graphs of 10-20 nodes;
    only the seed set) for 200 steps through the port's Trainer (evals at
    100 and 200 with its 8 chains, the final sample metrics at the task's
    1024 graphs), trace 10 more steps, then serve the run over HTTP and
    hold the served model, its coupling nets' output layers randomized,
    against its CPU copy, and #1 on every inverse call of its sample of a
    batch of graphs at the seed and the next by the residual rule.  Returns
    the launch counts of the training run and of the serving."""
    from http.server import ThreadingHTTPServer

    import numpy as np
    import torch
    from categoricalnf_tpu_torch import inference
    from categoricalnf_tpu_torch.serve import RunServer, make_handler
    from categoricalnf_tpu_torch.tasks.graph_coloring import \
        coloring_validity
    from categoricalnf_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(REPO, "runs", "coloring"))
    a = cfg["args"]
    args = {**a, "seed": seed}
    task = inference.build_task(cfg["task"], args, device=device)
    tcfg = train_config(a, seed, a["eval_samples"])
    launches = {}
    with tempfile.TemporaryDirectory() as out_dir:
        final = train_checked(task, cfg["task"], args, tcfg, out_dir,
                              timings, ("mixture_forward",
                                        "mixture_forward_bwd",
                                        "mixture_inverse"))
        launches["coloring_training"] = final["launches"]
        timings.update({k: final[k] for k in COLORING_VALIDITY})
        timings["step_profile"] = profile_steps(task, tcfg.optimizer, seed)

        reset_launches()
        server = RunServer(out_dir, device=device)
        check(server.handle.step in (TRAIN_EVAL_EVERY, TRAIN_STEPS),
              f"served step {server.handle.step}")
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        try:
            port = httpd.server_port
            st, health, _ = http_json(port, "GET", "/health")
            check(st == 200 and health["task"] == "graph_coloring",
                  f"/health {health}")
            st, out, dt = http_json(port, "POST", "/sample",
                                    {"num_samples": 4})
            check(st == 200 and len(out["samples"]) == 4,
                  f"/sample answered {st}: {out}")
            timings["sample_4_s"] = dt
            for s in out["samples"]:
                n = len(s["colors"])
                adj = np.zeros((1, n, n), np.float32)
                for i, j in s["edges"]:
                    check(0 <= i < j < n, f"edge {i}-{j} outside its graph "
                          f"of {n} nodes")
                    adj[0, i, j] = adj[0, j, i] = 1.0
                check(a["min_nodes"] <= n <= a["max_nodes"]
                      and all(0 <= c < a["num_colors"] for c in s["colors"]),
                      f"colors {s['colors']}")
                check(s["valid"] == bool(coloring_validity(
                    adj, np.asarray([s["colors"]]), np.ones((1, n)))[0]),
                      f"'valid' disagrees with the payload: {s}")
            st, met, dt = http_json(port, "POST", "/sample_metrics",
                                    {"num_samples": 1024})
            check(st == 200 and met["metric_num_samples"] == 1024.0,
                  f"/sample_metrics answered {st}: {met}")
            check(met["coloring_validity_corrected"]
                  >= met["coloring_validity"], f"{met}")
            timings["sample_metrics_1024_s"] = dt
            timings["served"] = {k: met[k] for k in COLORING_VALIDITY}
            st, out, _ = http_json(port, "POST", "/sample",
                                   {"num_samples": 0})
            check(st == 400 and "error" in out, "bad request not refused")
        finally:
            httpd.shutdown()
            httpd.server_close()
            th.join(timeout=60)
        launches["coloring_serving"] = read_launches()
        for name in ("mixture_inverse", "mixture_forward"):
            check(launches["coloring_serving"][name] > 0,
                  f"kernel {name} was not launched while serving coloring")
        served = server.handle.task
        randomize_coupling_nets(served.model, seed + 1)
        check_against_cpu(served, seed)
        # #1 on every inverse call of that model's sample of a batch of
        # graphs, at the seed and the next
        ratios = held_samples(lambda s: served.sample_graphs(
            served._gen(np.random.default_rng(s), served.batch_size), 1.0,
            torch.Generator(device).manual_seed(s)), seed, "coloring sample")
        timings["held_inverse_calls"] = len(ratios)
        timings["held_inverse_worst_ratio"] = max(ratios)
    print(json.dumps({"metric": "graph_coloring_train_samples_per_s",
                      "value": timings["train_samples_per_s"],
                      "unit": "samples/s", "steps": timings["rate_steps"],
                      "batch_size": task.batch_size, "device": card}),
          flush=True)
    return launches


# the kernels every dequantized set flow's training launches (#1 and #1' in
# its encoder)
SET_MODELING_KERNELS = ("mixture_forward", "mixture_forward_bwd",
                        "mixture_inverse", "mixture_inverse_loop_bwd",
                        "fused_set_transformer_bf16",
                        "fused_set_transformer_bwd_bf16")
SAMPLING_KERNELS = ("mixture_inverse", "mixture_forward",
                    "fused_set_transformer_bf16")


def held_samples(sample, seed: int, what: str) -> list:
    """``sample(s)`` (a sample of a served model drawn at seed ``s``) at
    ``seed`` and ``seed + 1``, with #1 held by the residual rule on every
    inverse call (``inverse_calls_held``); returns each call's worst
    ratio of residual to limit."""
    import torch
    ratios = []
    for s in (seed, seed + 1):
        with inverse_calls_held(f"{what}, seed {s}") as r, torch.no_grad():
            sample(s)
        ratios += r
    return ratios


def serve_set_run(run_dir: str, task_name: str, num_categories: int,
                  validity: str, timings: dict, device: str) -> tuple:
    """Serve the run in ``run_dir`` over HTTP: /health, /sample of 4 sets
    (ints in 0..num_categories - 1), /sample_metrics of 1024 (``validity``
    in [0, 1]) unless ``validity`` is None, a bad request.  Returns the
    server and the launches of the serving, each sampling kernel
    launched."""
    from http.server import ThreadingHTTPServer

    import numpy as np
    from categoricalnf_tpu_torch.serve import RunServer, make_handler
    reset_launches()
    server = RunServer(run_dir, device=device)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        port = httpd.server_port
        st, health, _ = http_json(port, "GET", "/health")
        check(st == 200 and health["task"] == task_name, f"/health {health}")
        st, out, dt = http_json(port, "POST", "/sample", {"num_samples": 4})
        check(st == 200, f"/sample answered {st}: {out}")
        x = np.asarray(out["samples"])
        check(x.shape == (4, S) and x.dtype.kind == "i" and x.min() >= 0
              and x.max() < num_categories, f"samples {x}")
        timings["sample_4_s"] = dt
        if validity is not None:
            st, met, dt = http_json(port, "POST", "/sample_metrics",
                                    {"num_samples": 1024})
            check(st == 200 and met["metric_num_samples"] == 1024.0
                  and 0.0 <= met[validity] <= 1.0,
                  f"/sample_metrics answered {st}: {met}")
            timings["sample_metrics_1024_s"] = dt
            timings[f"served_{validity}"] = met[validity]
        st, out, _ = http_json(port, "POST", "/sample", {"num_samples": 0})
        check(st == 400 and "error" in out, "bad request not refused")
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=60)
    launches = read_launches()
    for name in SAMPLING_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched while "
              f"serving {task_name}")
    return server, launches


def train_set_run(run: str, path: str, validity: str, seed: int,
                  timings: dict, card: str, device: str,
                  kernels=SET_MODELING_KERNELS) -> dict:
    """Train runs/<run>/config.json as it is (only the seed set; one eval
    batch of 1024 with EVAL_CHAINS chains; its steps_per_call) for
    TRAIN_STEPS steps through the port's Trainer with ``train_checked``'s
    checks, the best bpd above the analytic optimum and every kernel of
    ``kernels`` launched; trace 10 more steps; serve the run; hold #1 on
    every inverse call of a sample of the served model with random coupling
    output layers, and that model against its CPU copy.  Prints
    ``<path>_train_samples_per_s`` and returns the launches of the training
    and of the serving."""
    import torch
    from categoricalnf_tpu_torch import inference
    from categoricalnf_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(REPO, "runs", run))
    a = cfg["args"]
    args = {**a, "seed": seed, "eval_batches_count": 1}
    task = inference.build_task(cfg["task"], args, device=device)
    tcfg = train_config(a, seed, EVAL_CHAINS)
    launches = {}
    with tempfile.TemporaryDirectory() as out_dir:
        final = train_checked(task, cfg["task"], args, tcfg, out_dir,
                              timings, kernels)
        launches[f"{path}_training"] = final["launches"]
        timings["steps_per_call"] = tcfg.steps_per_call
        optimum = task.analytic_optimum_bpd()
        timings["optimum_bpd"] = optimum
        check(final["best_bpd"] > optimum,
              f"{run}: best bpd {final['best_bpd']} below the optimum "
              f"{optimum}")
        timings[validity] = final[validity]
        timings["step_profile"] = profile_steps(task, tcfg.optimizer, seed)
        categories = getattr(task, "num_categories", task.set_size)
        server, launches[f"{path}_serving"] = serve_set_run(
            out_dir, cfg["task"], categories, validity, timings, device)
        check(server.handle.step in (TRAIN_EVAL_EVERY, TRAIN_STEPS),
              f"served step {server.handle.step}")
        served = server.handle.task
        timings["learned_decoder"] = getattr(served.model.encoding,
                                             "decoder", None) is not None
        randomize_coupling_nets(served.model, seed + 1)
        timings["held_inverse_worst_ratio"] = max(held_samples(
            lambda s: served.model.sample(B, served.set_size, generator=torch
                                          .Generator(device).manual_seed(s)),
            seed, f"{run} sample"))
        check_against_cpu(served, seed)
    print(json.dumps({"metric": f"{path}_train_samples_per_s",
                      "value": timings["train_samples_per_s"],
                      "unit": "samples/s", "steps": timings["rate_steps"],
                      "batch_size": task.batch_size, "device": card}),
          flush=True)
    return launches


def set_modeling_phase(seed: int, timings: dict, card: str,
                       device: str = "cuda") -> dict:
    """The dequantized set flows: train and serve runs/sum_vardeq
    (SetSummationTask, the vardeq encoding) and runs/shuffle_linear (the
    linear-flows encoding) with ``train_set_run``; then
    runs/shuffle_decoder_mlp (the mixture encoding with a learned MLP
    decoder) as it is, with its steps_per_call of 8, trained and served the
    same way.  Returns the launches of each path."""
    launches = {}
    for run, path, validity, kernels in (
            ("sum_vardeq", "set_summation", "sum_validity",
             SET_MODELING_KERNELS),
            ("shuffle_linear", "shuffle_linear", "permutation_validity",
             SET_MODELING_KERNELS),
            ("shuffle_decoder_mlp", "decoder_mlp", "permutation_validity",
             SAMPLING_KERNELS + ("mixture_forward_bwd",
                                 "fused_set_transformer_bwd_bf16"))):
        timings[run] = {}
        launches.update(train_set_run(run, path, validity, seed,
                                      timings[run], card, device, kernels))
    t = timings["shuffle_decoder_mlp"]
    check(t["steps_per_call"] == 8 and t["learned_decoder"],
          "runs/shuffle_decoder_mlp did not train its learned decoder at 8 "
          "steps a call")
    return launches


# The parallel layer: runs/set16's steps through the Trainer on a mesh of
# one rank and without one, and the sharded IS eval on that mesh.
PARALLEL_STEPS, PARALLEL_LOG_EVERY = 10, 5
PARALLEL_TRAINING_KERNELS = ("mixture_forward", "mixture_forward_bwd",
                             "fused_set_transformer_bf16",
                             "fused_set_transformer_bwd_bf16")
PARALLEL_EVAL_KERNELS = ("mixture_forward", "fused_set_transformer_f32")


def parallel_phase(seed: int, timings: dict, card: str,
                   device: str = "cuda") -> dict:
    """The data-parallel path on a world of one rank: a process group over
    NCCL, in-process from a FileStore in a temporary directory, and its
    ``create_mesh()`` (1 x 1).  runs/set16/config.json as it is (bf16,
    batch 1024, 8 couplings, hidden 96) for PARALLEL_STEPS steps through
    the Trainer with that mesh and without one, from the same seed (its
    eval at the end on one batch of 1024, 4 chains; the final sample
    metrics and the test): every logged row but its clock, and every
    parameter at the end, bitwise equal, the all-reduces running all the
    same, and #3 bf16, #4 bf16, #2 and #2' launched under them.  Then the
    sharded IS eval (``parallel.make_task_sharded_iw_eval``) on that mesh
    against ``eval_step`` on one eval batch x 4 chains from one generator
    seed: bitwise, #3 fp32 and #2 launched.  Records ms a step of steps
    6-10 with and without the mesh (not bounded).  Destroys the process
    group.  Returns the launches of the mesh's training and its eval."""
    import torch
    import torch.distributed as dist
    from categoricalnf_tpu_torch import inference
    from categoricalnf_tpu_torch.parallel import (create_mesh,
                                                  make_task_sharded_iw_eval)
    from categoricalnf_tpu_torch.training.engine import Trainer
    from categoricalnf_tpu_torch.utils.config import load_config

    t_phase = time.perf_counter()
    cfg = load_config(os.path.join(REPO, "runs", "set16"))
    a = cfg["args"]
    args = {**a, "seed": seed, "eval_batches_count": 1}
    tcfg = dataclasses.replace(
        train_config(a, seed, EVAL_CHAINS), num_steps=PARALLEL_STEPS,
        eval_every=PARALLEL_STEPS, log_every=PARALLEL_LOG_EVERY)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1,
            device_id=torch.device("cuda", torch.cuda.current_device()))
        try:
            mesh = create_mesh()
            check(mesh.shape == {"data": 1, "sample": 1},
                  f"the mesh of one rank is {mesh.shape}")
            runs = {}
            for arm in ("mesh", "none"):
                task = inference.build_task(cfg["task"], args, device=device)
                check((task.batch_size, task.num_layers, task.hidden_dim,
                       task.compute_dtype) == (1024, 8, 96, "bfloat16"),
                      "runs/set16 is not the model this phase is written "
                      "for")
                out = os.path.join(tmp, arm)
                trainer = Trainer(task, dataclasses.replace(tcfg,
                                                            out_dir=out),
                                  mesh=mesh if arm == "mesh" else None)
                torch.cuda.synchronize()
                reset_launches()
                trainer.train(resume=False)
                torch.cuda.synchronize()
                if arm == "mesh":
                    launches["parallel_training"] = read_launches()
                rows = [json.loads(line) for line in
                        open(os.path.join(out, "metrics.jsonl"))]
                runs[arm] = {"task": task, "rows": rows}
                window = [r for r in rows if r["prefix"] == "train"][-1]
                timings[f"ms_per_step_{arm}"] = 1e3 / window["steps_per_s"]
            clockless = {arm: [{k: v for k, v in r.items()
                                if k not in ("time", "steps_per_s")}
                               for r in runs[arm]["rows"]] for arm in runs}
            check(clockless["mesh"] == clockless["none"],
                  "the Trainer on a mesh of one rank logged other numbers "
                  f"than without one: {clockless}")
            losses = [r["loss"] for r in clockless["mesh"]
                      if r["prefix"] == "train"]
            check(len(losses) == PARALLEL_STEPS // PARALLEL_LOG_EVERY
                  and all(math.isfinite(v) for v in losses),
                  f"the mesh's logged losses: {losses}")
            state = {arm: runs[arm]["task"].model.state_dict()
                     for arm in runs}
            differ = [k for k, v in state["none"].items()
                      if not torch.equal(state["mesh"][k], v)]
            check(not differ, "parameters after the mesh's steps differ "
                  f"from those without it: {differ[:5]}")
            for name in PARALLEL_TRAINING_KERNELS:
                check(launches["parallel_training"][name] > 0,
                      f"kernel {name} was not launched on the mesh")
            timings.update(logged_rows=len(clockless["mesh"]),
                           losses=losses,
                           final_bpd=[r["bpd"] for r in clockless["mesh"]
                                      if r["prefix"] == "val"])

            task = runs["mesh"]["task"]
            batch = task.eval_batches()[0]
            sharded = make_task_sharded_iw_eval(task, mesh)

            def gen():
                return torch.Generator(device).manual_seed(seed + 5)
            torch.cuda.synchronize()
            reset_launches()
            got = sharded(batch, EVAL_CHAINS, generator=gen())
            torch.cuda.synchronize()
            launches["parallel_eval"] = read_launches()
            want = task.eval_step(batch, EVAL_CHAINS, generator=gen())
            check(got.shape == want.shape == (task.batch_size,)
                  and torch.equal(got, want),
                  "the sharded eval on a 1 x 1 mesh is not eval_step: max "
                  f"abs err {max_err(got, want)}")
            check(bool(torch.isfinite(got).all()),
                  "the sharded eval's bpd is not finite")
            for name in PARALLEL_EVAL_KERNELS:
                check(launches["parallel_eval"][name] > 0,
                      f"kernel {name} was not launched by the sharded eval")
            timings.update(
                sharded_eval_bpd=float(got.mean()),
                sharded_eval_chains=sharded.effective_num_samples(
                    EVAL_CHAINS))
        finally:
            dist.destroy_process_group()
    timings["phase_s"] = time.perf_counter() - t_phase
    print(f"parallel: {timings['ms_per_step_mesh']!r} ms a step on a mesh "
          f"of one rank, {timings['ms_per_step_none']!r} without "
          f"(steps {PARALLEL_STEPS - PARALLEL_LOG_EVERY + 1}-"
          f"{PARALLEL_STEPS}; {card})", flush=True)
    return launches


# The language-modeling path (runs/lm_v6/config.json): batches of 128
# sequences of 256 characters, encoding dim 4, K = 32 components.  #2 and
# #2' run on a train step's density pass (M = 128 x 256 x 4 = 131,072); #1
# and #2 on every sampled position, M = 128 x 4 = 512 for a batch of 128
# samples and 16 for a /sample of 4.
LM_K = 32
LM_SHAPES = {"density": (128, 256, 4), "m512": (128, 4), "m16": (4, 4)}
# the LM phase's train steps, chosen from the step time measured on the
# card so that the phase fits the script's time (PERF.md, section 4: 40
# until the transformer's phase and runs/moses's training came, 20 until
# the fp32 runs of molecules_v4 and moses came), and its log cadence: the
# rate is read over the second half
LM_STEPS, LM_LOG_EVERY = 8, 4
# the eval batches of both LM phases (runs/lm_v6's 8 until the fp32 runs at
# sets of 64 and 128 came; their evals took most of the transformer phase)
LM_EVAL_BATCHES = 4
# the characters of the crops the LM phase traces a step on (profile_steps)
LM_PROFILE_CROP = 32
# what runs/lm_v6/config.json builds, which the phase checks it trains
LM_MODEL = {"num_mixtures": LM_K, "hidden_dim": 512, "lstm_layers": 2,
            "num_layers": 4, "prior": "hmm", "prior_states": 32,
            "seq_len": 256, "batch_size": 128, "encoding_dim": 4,
            "compute_dtype": "bfloat16"}


def lm_inverse_cases(seed: int, device) -> dict:
    """#1's cases at K = 32, drawn as ``inverse_cases`` draws them: the LM
    path's shapes (``LM_SHAPES``, pi and ls strided as the autoregressive
    layer passes them), y the plain forward of x there; and M = 4,096 of
    peaked mixtures and of tails at the clip, as in ``inverse_cases``."""
    import torch
    from categoricalnf_tpu_torch.ops import numerics as nm
    gen = torch.Generator(device).manual_seed(seed)
    cases = {name: inverse_case(gen, shape, LM_K, device, True)
             for name, shape in LM_SHAPES.items()}
    _, pi, mu, ls = mixture_inputs(gen, (4096,), LM_K, device)
    y = torch.randn(4096, generator=gen, device=device) * 10.0
    cases["peaked"] = (y, pi * 50.0, mu * 30.0, ls * 60.0)
    _, pi, mu, ls = mixture_inputs(gen, (4096,), LM_K, device)
    y = torch.tensor([60.0, -60.0, 90.0, -90.0], device=device).repeat(1024)
    cases["tails"] = (y, pi, mu, nm.LOG_SCALE_MIN - 0.5 - ls.abs())
    return cases


def check_lm_kernels(device, seeds, report):
    """#1, #2 and #2' at K = 32 (the wide groups of csrc/mixture.cu) at the
    LM path's M = 131,072, 512 and 16: #1 by the residual rule at each seed
    (``lm_inverse_cases``), #2 (pi and ls strided) and #2' against their
    plain versions within 1e-4; each timed."""
    import torch
    worst = inverse_held(lm_inverse_cases, seeds, device)
    print("mixture_inverse at K = 32 (the LM path): worst residual / "
          "max(2 e_p, tau) by case: " + json.dumps(worst), flush=True)
    cases = lm_inverse_cases(seeds[0], device)
    g = torch.Generator(device).manual_seed(seeds[0] + 50)
    for name, shape in LM_SHAPES.items():
        report[f"mixture_inverse_lm_{name}"] = dict(
            mixture_inverse_report(*cases[name], 5),
            residual_ratio=max(v for k, v in worst.items()
                               if k.endswith(f"/{name}")))
        x, pi, mu, ls = mixture_inputs(g, shape, LM_K, device)
        pi, ls = coupling_slices(pi, ls)
        report[f"mixture_forward_lm_{name}"] = mixture_forward_report(
            x, pi, mu, ls, 10, f"mixture_forward at K = 32, {name}")
        report[f"mixture_forward_bwd_lm_{name}"] = mixture_bwd_report(
            mixture_bwd_case(device, g, shape, LM_K))


def wide_lanes() -> dict:
    """Lanes an element of the three kernels at 16 < K <= 32, as
    csrc/mixture.cu builds them (kWideFwdLanes, kWideBwdLanes,
    kWideInvLanes)."""
    with open(os.path.join(REPO, SOURCES["mixture_forward"][0])) as f:
        hit = re.search(r"constexpr int kWideFwdLanes = (\d+), "
                        r"kWideBwdLanes = (\d+), kWideInvLanes = (\d+);",
                        f.read())
    check(hit is not None, "no wide lanes in csrc/mixture.cu")
    return dict(zip(("mixture_forward", "mixture_forward_bwd",
                     "mixture_inverse"), map(int, hit.groups())))


def lm_mixture_resources(log: str) -> dict:
    """``mixture_resources`` of the three kernels' K = 32 instances (full
    wide groups), by report name of the LM shapes."""
    res = kernel_resources(log)
    out = {}
    for name, g in wide_lanes().items():
        entry = mixture_entry(res, f"{name}_kernel", g, LM_K // g)
        out.update({f"{name}_lm_{shape}": entry for shape in LM_SHAPES})
    return out


def lm_step_breakdown(task, seed: int) -> dict:
    """Where an LM train step's time goes, each part run on the card at the
    step's shapes and timed on the host clock between synchronizes, the
    least of 2 runs, in one window: the loss of a training batch and its
    backward (the step but the update); the causal LSTMs of the 8
    autoregressive layers alone (forward with the channel coupling's extra
    features, then backward); the HMM prior's log-density alone (forward
    and backward)."""
    import numpy as np
    import torch
    from categoricalnf_tpu_torch.data.prefetch import to_device
    from categoricalnf_tpu_torch.flows import AutoregressiveMixtureCDF
    g = torch.Generator(task.device).manual_seed(seed + 60)
    shape = (task.batch_size, task.seq_len, task.model.encoding.dim)
    layers = [m for m in task.model.modules()
              if isinstance(m, AutoregressiveMixtureCDF)]
    z = torch.randn(shape, generator=g, device=task.device)
    batch = to_device(next(task.train_batches(
        np.random.default_rng(seed + 61))), task.device)

    def step():
        task.loss(batch, 1.0, generator=g).backward()

    def lstms():
        for layer in layers:
            extra = None if layer.parity is None else z
            layer.net(z, extra=extra).float().sum().backward()

    def hmm():
        task.model.flow.prior.log_prob(z).sum().backward()

    out = {"ar_layers": len(layers)}
    for name, fn in (("loss_and_backward_ms", step),
                     ("lstm_fwd_bwd_ms", lstms), ("hmm_fwd_bwd_ms", hmm)):
        runs = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        out[name] = min(runs)
    out["lstm_share"] = out["lstm_fwd_bwd_ms"] / out["loss_and_backward_ms"]
    out["hmm_share"] = out["hmm_fwd_bwd_ms"] / out["loss_and_backward_ms"]
    task.model.zero_grad(set_to_none=True)
    return out


def check_lm_against_cpu(task, seed: int, n: int = 8, length: int = 32):
    """The served LM (kernels on the card) against a CPU copy of it (plain
    path), in the fp32 twin, on ``n`` validation crops of ``length``
    characters with shared noise: the IS bits/char of 4 chains within
    1e-3, and a sample (the HMM prior's chain and emission uniforms
    shared): z within 1e-3 on 99% of the elements and the decoded
    characters equal on 99%."""
    import numpy as np
    import torch
    from categoricalnf_tpu_torch.inference import build_task
    from categoricalnf_tpu_torch.ops.numerics import uniform_noise

    args = {f.name: getattr(task, f.name) for f in dataclasses.fields(task)
            if f.name not in ("name", "device")}
    cpu = build_task(task.name, args, device="cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in
                               task.model.state_dict().items()})
    stream = cpu.corpus.splits["valid"]
    x = np.asarray(stream[:n * length]).reshape(n, length)
    shape = (n, length, cpu.model.encoding.dim)
    g = torch.Generator().manual_seed(seed + 7)
    noise = uniform_noise((4,) + shape, generator=g)
    u = uniform_noise(cpu.model.flow.prior.noise_shape(shape), generator=g)
    with torch.no_grad():
        bpd_cpu = cpu.eval_step({"x": x}, 4, noise=noise)
        bpd_gpu = task.eval_step({"x": x}, 4,
                                 noise=noise.to(task.device)).cpu()
        z_cpu, z_gpu = (t.eval_model.flow.sample(shape, noise=u.to(t.device))
                        .cpu() for t in (cpu, task))
    check(torch.allclose(bpd_gpu, bpd_cpu, rtol=1e-3, atol=1e-3),
          f"LM eval_bpd card vs CPU: {max_err(bpd_gpu, bpd_cpu)}")
    z_near = float(((z_gpu - z_cpu).abs()
                    <= 1e-3 + 1e-3 * z_cpu.abs()).float().mean())
    same = float((cpu.model.encoding.decode(z_cpu) == task.model.encoding
                  .decode(z_gpu.to(task.device)).cpu()).float().mean())
    check(z_near >= 0.99 and same >= 0.99,
          f"LM sampled z card vs CPU: {z_near:.4f} of z within 1e-3, "
          f"{same:.4f} of characters equal")
    print(f"{task.name}: card vs CPU (fp32, {n} crops of {length}): bpd max "
          f"err {max_err(bpd_gpu, bpd_cpu):.3g}; z within 1e-3: "
          f"{z_near:.4f}, max err {max_err(z_gpu, z_cpu):.3g}; characters "
          f"equal: {same:.4f}", flush=True)


LM_KERNELS = ("mixture_forward", "mixture_forward_bwd", "mixture_inverse")
# the transformer backbone's train steps on runs/lm_v6 (net transformer; 20
# until the fp32 runs of molecules_v4 and moses came), and the sequences of
# its KV-cache rollout check
LM_TRANSFORMER_STEPS, KV_ROLLOUT_BATCH = 8, 16
# the rollout against the batched pass: fp32 within 2e-4 (the reference's
# own test of its cache, tests/test_language.py); bf16 by the relative error
# of the norm within BF16_FWD_REL, the limit of #3 bf16 against its plain
# version, for the same reason: the two round to bf16 after sums taken in
# another order
KV_ROLLOUT_F32_TOL = 2e-4


def check_kv_rollout(task, seed: int) -> dict:
    """The trained transformer of the first autoregressive layer, rolled
    through its KV cache one position at a time (``step``) over
    KV_ROLLOUT_BATCH random sequences of seq_len positions with the
    coupling's extra features, against its batched ``forward`` on the
    card, in bf16 (the trained net) and in fp32 (a copy of it):
    KV_ROLLOUT_F32_TOL and BF16_FWD_REL."""
    import copy

    import torch
    from categoricalnf_tpu_torch.flows import AutoregressiveMixtureCDF
    from categoricalnf_tpu_torch.networks import CausalTransformer
    layer = next(m for m in task.model.modules()
                 if isinstance(m, AutoregressiveMixtureCDF))
    check(isinstance(layer.net, CausalTransformer),
          "the LM's autoregressive layer has no causal transformer")
    g = torch.Generator(task.device).manual_seed(seed + 62)
    shape = (KV_ROLLOUT_BATCH, task.seq_len, task.model.encoding.dim)
    z = torch.randn(shape, generator=g, device=task.device)
    m = layer._chan_mask(z)
    extra = z * m
    out = {}
    for cd in ("bfloat16", "float32"):
        net = layer.net
        if cd != net.compute_dtype:
            net = copy.deepcopy(net)
            net.compute_dtype = cd
        with torch.no_grad():
            full = net(z, shift=True, extra=extra).float()
            carry = net.init_carry(z.shape[0], z.device)
            prev = torch.zeros_like(z[:, 0])
            steps = []
            for t in range(z.shape[1]):
                carry, o = net.step(carry, prev, extra_t=extra[:, t])
                steps.append(o.float())
                prev = z[:, t]
            rolled = torch.stack(steps, dim=1)
        torch.cuda.synchronize()
        r = {"max_abs_err": max_err(rolled, full), "rel_err":
             rel_err(rolled, full), "out_max_abs": float(full.abs().max())}
        ok = (close(rolled, full, KV_ROLLOUT_F32_TOL) if cd == "float32"
              else r["rel_err"] <= BF16_FWD_REL)
        check(bool(torch.isfinite(rolled).all()) and ok,
              f"KV-cache rollout against the batched pass ({cd}): {r}")
        out[cd] = r
    return out


def lm_phase(seed: int, timings: dict, card: str, device: str = "cuda",
             net: str = "lstm", num_steps: int = LM_STEPS) -> dict:
    """Train runs/lm_v6/config.json as it is (only the seed set: the
    synthetic Markov corpus, 4 blocks of two autoregressive layers with
    2-layer LSTMs of hidden 512 in bf16, K = 32, the HMM prior of 32
    states, batch 128 of 256 characters), or with ``net`` transformer its
    2-block causal transformers (4 heads, KV cache of 256), for
    ``num_steps`` steps through the
    port's Trainer, with LM_EVAL_BATCHES eval batches of 8 chains before
    training and at the end, the final sample metrics and the test: every
    logged loss finite and the last below the first, every bpd finite and above
    the analytic optimum, no alarm, #2, #2' and #1 launched.  Then, for the
    LSTMs, traces 2
    steps on crops of LM_PROFILE_CROP characters with the host's activity
    and times the LSTMs and the HMM prior alone at the full shapes; for
    the transformers, traces 10 whole steps (the card's kernels) and holds
    the KV-cache rollout against the batched pass (``check_kv_rollout``).
    Runs sample_metrics at 128 samples with #1 held by the residual rule on
    every inverse call at the seed and the next.  Serves
    the run: /health, /sample of 4 (strings of the vocabulary), a bad
    request; last, the served model with random heads against its CPU
    copy.  Returns the launch counts of the training and of the
    serving."""
    from http.server import ThreadingHTTPServer

    import numpy as np
    import torch
    from categoricalnf_tpu_torch import inference
    from categoricalnf_tpu_torch.serve import RunServer, make_handler
    from categoricalnf_tpu_torch.training.engine import TrainConfig, Trainer
    from categoricalnf_tpu_torch.training.schedules import ScheduleSpec
    from categoricalnf_tpu_torch.training.state import OptimizerConfig
    from categoricalnf_tpu_torch.utils.config import load_config, save_config

    cfg = load_config(os.path.join(REPO, "runs", "lm_v6"))
    a = cfg["args"]
    args = {**a, "seed": seed, "net": net,
            "eval_batches_count": LM_EVAL_BATCHES}
    key = "lm" if net == "lstm" else f"lm_{net}"
    t0 = time.perf_counter()
    task = inference.build_task(cfg["task"], args, device=device)
    timings["build_task_s"] = time.perf_counter() - t0
    check({k: getattr(task, k) for k in LM_MODEL} == LM_MODEL
          and task.net == net,
          f"runs/lm_v6 is not the model this phase is written for: "
          f"{LM_MODEL}, net {net}")
    tcfg = TrainConfig(
        num_steps=num_steps, eval_every=num_steps,
        eval_samples=a["eval_samples"], final_eval_samples=a["eval_samples"],
        log_every=LM_LOG_EVERY, seed=seed,
        steps_per_call=a.get("steps_per_call") or 1,
        optimizer=OptimizerConfig(learning_rate=a["lr"],
                                  grad_clip_norm=a["grad_clip"]),
        beta_schedule=ScheduleSpec(kind="sigmoid", start=0.5,
                                   end=a["beta_end"],
                                   center=a["beta_warmup"], rate=0.002))
    optimum = task.analytic_optimum_bpd()
    launches = {}
    with tempfile.TemporaryDirectory() as out_dir:
        tcfg = dataclasses.replace(tcfg, out_dir=out_dir)
        save_config(out_dir, {"task": cfg["task"], "args": args})
        trainer = Trainer(task, tcfg)
        trainer.init_model(next(task.train_batches(
            np.random.default_rng(seed))))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bpd0 = trainer.evaluate(tcfg.eval_samples, 0)["bpd"]
        torch.cuda.synchronize()
        timings["eval_s"] = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        final = trainer.train(resume=False)
        torch.cuda.synchronize()
        timings[f"train_{num_steps}_steps_s"] = time.perf_counter() - t0
        launches[f"{key}_training"] = read_launches()
        timings["train_peak_mem_gib"] = (torch.cuda.max_memory_allocated()
                                         / 2**30)
        rows = [json.loads(line) for line in
                open(os.path.join(out_dir, "metrics.jsonl"))]
        losses = [r["loss"] for r in rows if r["prefix"] == "train"]
        vals = [r["bpd"] for r in rows if r["prefix"] == "val"]
        check(len(losses) == num_steps // LM_LOG_EVERY
              and all(np.isfinite(losses)), f"LM losses {losses}")
        check(losses[-1] < losses[0], f"LM loss did not fall: {losses}")
        bpds = [bpd0, *vals, final["best_bpd"], final["test_bpd"]]
        check(all(np.isfinite(b) and b > optimum for b in bpds),
              f"LM bpds {bpds} not finite above the optimum {optimum}")
        check(all(r["integrity_alarm"] == 0 for r in rows
                  if r["prefix"] == "val"), "LM integrity alarm")
        for name in LM_KERNELS:
            check(launches[f"{key}_training"][name] > 0,
                  f"kernel {name} was not launched while training the LM")
        check(os.path.exists(os.path.join(out_dir, "samples.txt")),
              "the LM run wrote no samples.txt")
        steps, secs, timings["rate_steps"] = rate_windows(rows,
                                                          num_steps // 2)
        timings.update(
            optimum_bpd=optimum, untrained_bpd=bpd0, val_bpd=vals,
            best_bpd=final["best_bpd"], test_bpd=final["test_bpd"],
            losses=losses, train_ms_per_step=secs * 1e3 / steps,
            train_samples_per_s=steps * task.batch_size / secs,
            final_sample_metrics={k: final[k] for k in
                                  ("unigram_tv", "bigram_kl_bits")})
        if net == "lstm":
            # the host's activity makes a trace of a whole LSTM step too
            # large to read back in the script's time: the trace takes crops
            # of LM_PROFILE_CROP characters, whose steps run the same
            # operations for each position
            timings["step_profile"] = profile_steps(
                task, tcfg.optimizer, seed, warmup=1, steps=2, host=True,
                crop=LM_PROFILE_CROP)
            timings["step_breakdown"] = lm_step_breakdown(task, seed)
        else:
            timings["step_profile"] = profile_steps(task, tcfg.optimizer,
                                                    seed)
            timings["kv_rollout"] = check_kv_rollout(task, seed)

        # #1 on every inverse call of sample_metrics at 128 samples
        sampled = {}

        def metrics(s):
            sampled[s] = task.sample_metrics(
                generator=torch.Generator(device).manual_seed(s),
                num_samples=128)

        t0 = time.perf_counter()
        ratios = held_samples(metrics, seed, "LM sample")
        timings["held_sample_metrics_128_s"] = time.perf_counter() - t0
        timings["held_inverse_calls"] = len(ratios)
        timings["held_inverse_worst_ratio"] = max(ratios)
        timings["sample_metrics_128"] = sampled[seed]

        reset_launches()
        server = RunServer(out_dir, device=device)
        check(server.handle.step == num_steps,
              f"served step {server.handle.step}")
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        try:
            port = httpd.server_port
            st, health, _ = http_json(port, "GET", "/health")
            check(st == 200 and health["task"] == cfg["task"],
                  f"/health {health}")
            st, out, dt = http_json(port, "POST", "/sample",
                                    {"num_samples": 4})
            check(st == 200 and len(out["samples"]) == 4
                  and all(len(t) == task.seq_len
                          and set(t) <= set(task.corpus.vocab)
                          for t in out["samples"]),
                  f"/sample answered {st}: {out}")
            timings["sample_4_s"] = dt
            timings["sample_4_text"] = out["samples"][0][:64]
            st, out, _ = http_json(port, "POST", "/sample",
                                   {"num_samples": 0})
            check(st == 400 and "error" in out, "bad request not refused")
        finally:
            httpd.shutdown()
            httpd.server_close()
            th.join(timeout=60)
        launches[f"{key}_serving"] = read_launches()
        for name in ("mixture_inverse", "mixture_forward"):
            check(launches[f"{key}_serving"][name] > 0,
                  f"kernel {name} was not launched while serving the LM")
        served = server.handle.task
        randomize_coupling_nets(served.model, seed + 1)
        check_lm_against_cpu(served, seed)
    print(json.dumps({"metric": "language_modeling_train_samples_per_s",
                      "net": net,
                      "value": timings["train_samples_per_s"],
                      "unit": "samples/s",
                      "steps": timings["rate_steps"],
                      "ms_per_step": timings["train_ms_per_step"],
                      "batch_size": task.batch_size,
                      "peak_mem_gib": timings["train_peak_mem_gib"],
                      "device_idle_share": timings["step_profile"].get(
                          "device_idle_share"),
                      "device": card}), flush=True)
    return launches


# GraphCNF's node flow (runs/molecules_v4: graphs padded to 24 nodes, node
# latents of dim 6, K = 8, batch 128, hidden 192; runs/moses: hidden 256,
# K = 16): the SetTransformer's sets are the graphs' nodes, under the key
# mask of their node mask
MOL_NODES, MOL_NODE_DIM, MOL_BATCH, MOL_HIDDEN = 24, 6, 128, 192
MOSES_BATCH, MOSES_HIDDEN, MOSES_K = 192, 256, 16
# molecules_v4's and runs/moses's training steps, evals at half and at the
# end, one log at the end: a v4 step takes 0.3-0.6 s on the card's host
# (PERF.md), and v4 was cut from 120 steps to 60 when moses began to train,
# both to 20 when their fp32 runs came, and v4 to 10 when the fp32 runs at
# sets of 64 and 128 came, to keep the script inside its time (moses at 8
# steps, two calls of its 4, read its served model 1.59e-3 bits/var off its
# CPU copy, over the 1e-3 that check_molecules_against_cpu allows: ROADMAP
# Queue C)
MOL_STEPS, MOSES_STEPS = 10, 20
MOL_OUT = MOL_NODE_DIM * (2 + 3 * K)
MOSES_OUT = MOL_NODE_DIM * (2 + 3 * MOSES_K)
# #4 bf16's tolerance (``fused_bwd_report``): the largest relative error of
# a gradient's norm
BF16_BWD_REL = 0.03
# a masked kernel's control: the same call without the mask must read this
# many times the tolerance away from the masked plain version
MASK_CONTROL = 10.0


def molecule_net(cd: str, device, seed: int, hidden: int = MOL_HIDDEN,
                 out: int = MOL_OUT):
    """A node-flow coupling net of GraphCNF (SetTransformer, 4 heads, 2
    blocks, in 6) in compute dtype ``cd``, from ``seed``, its output layer
    N(0, 0.1^2)."""
    import torch
    from categoricalnf_tpu_torch.networks import SetTransformer
    net = SetTransformer(MOL_NODE_DIM, out, hidden_dim=hidden,
                         num_heads=HEADS, compute_dtype=cd,
                         generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        net.out.w.copy_(torch.randn(net.out.w.shape,
                                    generator=torch.Generator()
                                    .manual_seed(seed + 1)) * 0.1)
    return net.to(device)


def molecule_key_mask(seed: int, device, batch: int = MOL_BATCH):
    """The node mask [batch, 24] of a synthetic molecule batch (8-24 atoms,
    the dataset's generator at ``seed``), with set 0 cut to one valid key
    and set 1 to none."""
    import torch
    from categoricalnf_tpu_torch.tasks.molecules import load_molecule_dataset
    m = load_molecule_dataset("synthetic", None, MOL_NODES, batch,
                              seed)["node_mask"].copy()
    m[0] = 0.0
    m[0, 0] = 1.0
    m[1] = 0.0
    return torch.as_tensor(m, device=device)


def masked_fwd_readings(net, x, mask, tol: float) -> dict:
    """#3 with the key mask against ``plain_forward`` with it: the kernel's
    relative error of the norm within ``tol``; the control, the kernel
    without the mask, above MASK_CONTROL x tol; a mask of ones bitwise the
    call without one."""
    import torch
    from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft
    packed = net._packed_weights(getattr(torch, net.compute_dtype))
    with torch.no_grad():
        y = twice(lambda: ft.fused_set_transformer(packed, x, num_heads=HEADS,
                                                   mask=mask))
        y_p = net.plain_forward(x, mask=mask)
        y_u = ft.fused_set_transformer(packed, x, num_heads=HEADS)
        y_1 = ft.fused_set_transformer(packed, x, num_heads=HEADS,
                                       mask=torch.ones_like(mask))
    rel, control = rel_err(y, y_p), rel_err(y_u, y_p)
    what = f"masked #3 {net.compute_dtype} at {tuple(x.shape)}"
    check(bool(torch.isfinite(y.float()).all()), f"{what}: not finite")
    check(rel <= tol, f"{what}: relative error {rel} above {tol}")
    check(control > MASK_CONTROL * tol, f"{what}: the call without the mask "
          f"reads {control}, inside {MASK_CONTROL} x {tol}")
    check(torch.equal(y_1, y_u), f"{what}: a mask of ones is not bitwise "
          "the call without a mask")
    return dict(rel_err=rel, control_rel_err=control,
                max_abs_err=max_err(y, y_p))


def masked_bwd_readings(net, x, mask, g) -> dict:
    """#4 bf16 with the key mask (through ``FusedSetTransformer`` and the
    stacks of ``flatten_params``) against autograd through
    ``plain_forward`` with it: each gradient within BF16_BWD_REL of its
    norm; the control, the kernels without the mask, above MASK_CONTROL x
    that on some gradient; a mask of ones bitwise the call without one."""
    import torch
    from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft
    params = list(net.parameters())

    def grads(plain, m):
        xr = x.clone().requires_grad_(True)
        y = net.plain_forward(xr, mask=m) if plain else net(xr, mask=m)
        return torch.autograd.grad(y, [xr] + params, g)

    got = twice(lambda: grads(False, mask))
    want = grads(True, mask)
    errs = [rel_err(a, w) for a, w in zip(got, want)]
    control = max(rel_err(a, w) for a, w in zip(grads(False, None), want))
    what = f"masked #4 bf16 at {tuple(x.shape)}"
    check(max(errs) <= BF16_BWD_REL, f"{what}: relative error {max(errs)} "
          f"above {BF16_BWD_REL}")
    check(control > MASK_CONTROL * BF16_BWD_REL, f"{what}: the kernels "
          f"without the mask read {control}, inside {MASK_CONTROL} x "
          f"{BF16_BWD_REL}")
    packed = net._packed_weights(torch.bfloat16)
    with torch.no_grad():
        one = ft.fused_set_transformer_bwd(packed, x, g, num_heads=HEADS,
                                           mask=torch.ones_like(mask))
        none = ft.fused_set_transformer_bwd(packed, x, g, num_heads=HEADS)
    check(all(torch.equal(a, b) for a, b in
              zip((one[0], *one[1]), (none[0], *none[1]))),
          f"{what}: a mask of ones is not bitwise the call without a mask")
    return dict(rel_err=max(errs), control_rel_err=control,
                max_abs_err=max(max_err(a, w) for a, w in zip(got, want)))


def check_molecule_kernels(device, seeds, report):
    """#3 bf16, #4 bf16 and #3 fp32 with the key mask at the node flow's
    shapes (runs/molecules_v4: 128 graphs of 24 nodes, in 6, out 156,
    hidden 192; the fp32 forward at the eval twin's 4 chains x 128 graphs),
    at each seed, masks from a synthetic batch with one set of a single
    valid key and one of none (``molecule_key_mask``): #3 bf16 within
    BF16_FWD_REL, #4 bf16 within BF16_BWD_REL, #3 fp32 within 1e-4 and
    F32_FWD_REL of plain, each beside its control (``masked_fwd_readings``,
    ``masked_bwd_readings``); #3 fp32 also at moses's hidden 256, K = 16,
    and #3 bf16 there on its served batch of 192 graphs (out 300: a tile
    and shared-memory layout of its own).  Then each timed at the first
    seed."""
    import torch
    from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft
    readings: dict = {}
    for seed in seeds:
        g = torch.Generator(device).manual_seed(seed + 50)
        mask = molecule_key_mask(seed, device)
        x = torch.randn(MOL_BATCH, MOL_NODES, MOL_NODE_DIM, generator=g,
                        device=device)
        gy = torch.randn(MOL_BATCH, MOL_NODES, MOL_OUT, generator=g,
                         device=device).to(torch.bfloat16)
        bf = molecule_net("bfloat16", device, seed)
        readings[f"{seed}/fwd_bf16"] = masked_fwd_readings(bf, x, mask,
                                                           BF16_FWD_REL)
        readings[f"{seed}/bwd_bf16"] = masked_bwd_readings(bf, x, mask, gy)
        x4 = torch.randn(EVAL_CHAINS * MOL_BATCH, MOL_NODES, MOL_NODE_DIM,
                         generator=g, device=device)
        mask4 = mask.repeat(EVAL_CHAINS, 1)
        for hidden, k in ((MOL_HIDDEN, K), (MOSES_HIDDEN, MOSES_K)):
            f32 = molecule_net("float32", device, seed, hidden,
                               MOL_NODE_DIM * (2 + 3 * k))
            r = masked_fwd_readings(f32, x4, mask4, F32_FWD_REL)
            with torch.no_grad():
                y = f32(x4, mask=mask4)
                check(close(y, f32.plain_forward(x4, mask=mask4), 1e-4),
                      f"masked #3 fp32 at hidden {hidden}: off plain by "
                      f"more than 1e-4")
            readings[f"{seed}/fwd_f32_h{hidden}"] = r
        mask = molecule_key_mask(seed, device, MOSES_BATCH)
        x = torch.randn(MOSES_BATCH, MOL_NODES, MOL_NODE_DIM, generator=g,
                        device=device)
        bf = molecule_net("bfloat16", device, seed, MOSES_HIDDEN, MOSES_OUT)
        readings[f"{seed}/fwd_bf16_h{MOSES_HIDDEN}"] = masked_fwd_readings(
            bf, x, mask, BF16_FWD_REL)
        gy = torch.randn(MOSES_BATCH, MOL_NODES, MOSES_OUT, generator=g,
                         device=device).to(torch.bfloat16)
        readings[f"{seed}/bwd_bf16_h{MOSES_HIDDEN}"] = masked_bwd_readings(
            bf, x, mask, gy)
    print("masked fused kernels at the node flow's shapes (limits: bf16 "
          f"#3 {BF16_FWD_REL}, #4 {BF16_BWD_REL}, fp32 #3 {F32_FWD_REL}; "
          f"controls above {MASK_CONTROL} x): " + json.dumps(readings),
          flush=True)
    layout = global_h_bitwise(device, seeds[0])
    print("#4 bf16 at hidden 192 with the residual copies in global memory "
          "against shared memory: " + json.dumps(layout), flush=True)

    seed = seeds[0]
    g = torch.Generator(device).manual_seed(seed + 51)
    mask = molecule_key_mask(seed, device)
    x = torch.randn(MOL_BATCH, MOL_NODES, MOL_NODE_DIM, generator=g,
                    device=device)
    gy = torch.randn(MOL_BATCH, MOL_NODES, MOL_OUT, generator=g,
                     device=device).to(torch.bfloat16)
    x4 = torch.randn(EVAL_CHAINS * MOL_BATCH, MOL_NODES, MOL_NODE_DIM,
                     generator=g, device=device)
    mask4 = mask.repeat(EVAL_CHAINS, 1)
    macs_row = net_macs_per_row(MOL_NODE_DIM, MOL_HIDDEN, HEADS, 2,
                                2 * MOL_HIDDEN, MOL_OUT, MOL_NODES)
    for cd, xs, ms, name in (
            ("bfloat16", x, mask, "fused_set_transformer_bf16_molecules"),
            ("float32", x4, mask4, "fused_set_transformer_f32_molecules")):
        net = molecule_net(cd, device, seed)
        tdt = getattr(torch, cd)
        packed = net._packed_weights(tdt)
        with torch.no_grad():
            t = timed(lambda: ft.fused_set_transformer(
                packed, xs, num_heads=HEADS, mask=ms),
                lambda: net.plain_forward(xs, mask=ms), 20, 5)
        rows = xs.shape[0] * MOL_NODES
        elt = 2 if cd == "bfloat16" else 4
        ws = ft.flatten_params(net)
        n_w = sum(w.numel() for w in ws[0::2])
        n_b = sum(b.numel() for b in ws[1::2])
        r = readings[f"{seed}/fwd_{'bf16' if elt == 2 else 'f32_h192'}"]
        report[name] = dict(
            r, rows=rows, **t, dtype=cd,
            # x and y, the weights, and one byte a key of the mask
            bytes=rows * ((MOL_NODE_DIM + MOL_OUT) * elt + 1) + n_w * elt
            + n_b * 4, ops=2 * rows * macs_row,
            **({"tc_ops": 3 * 2 * rows * macs_row} if elt == 4 else {}))
    net = molecule_net("bfloat16", device, seed)
    packed = net._packed_weights(torch.bfloat16)
    params = list(net.parameters())
    xr = x.clone().requires_grad_(True)
    y_p = net.plain_forward(xr, mask=mask)
    t = timed(lambda: ft.fused_set_transformer_bwd(packed, x, gy,
                                                   num_heads=HEADS,
                                                   mask=mask),
              lambda: torch.autograd.grad(y_p, [xr] + params, gy,
                                          retain_graph=True), 10, 5)
    ws = ft.flatten_params(net)
    n_w = sum(w.numel() for w in ws[0::2])
    n_b = sum(b.numel() for b in ws[1::2])
    rows = MOL_BATCH * MOL_NODES
    report["fused_set_transformer_bwd_bf16_molecules"] = dict(
        readings[f"{seed}/bwd_bf16"], rows=rows, **t, dtype="bfloat16",
        # x, g, dx and the mask; the weights and their fp32 gradients
        bytes=rows * ((2 * MOL_NODE_DIM + MOL_OUT) * 2 + 1) + n_w * 2
        + n_b * 4 + (n_w + n_b) * 4, ops=3 * 2 * rows * macs_row)
    report.update(moses_fused_reports(device, seed, readings))
    report["fused_set_transformer_bwd_bf16_global_h"][
        "layout_bitwise_at_192"] = layout["bitwise"]


# The fp32 train step's pair against its plain version (``check_train_fwd``,
# ``fused_bwd_report``): #3's output and each gradient of #4 within these
# tolerances, as torch.allclose with rtol = atol = the tolerance
F32_TRAIN_FWD_TOL, F32_BWD_TOL = 1e-4, 2e-4
# the node flow's widths at which the pair runs (runs/molecules, and
# molecules_long/_v2 at 128), and its batches of graphs
FP32_NODE_HIDDEN = (96, 128)
FP32_NODE_BATCHES = (64, 128)
# the widths whose #4 keeps regions of its tile in a global workspace, at
# their configs' batches and outputs: molecules_v3/_v4 (hidden 192, K = 8,
# 128 graphs) and moses (hidden 256, K = 16, 192 graphs), by report name
FP32_WIDE_NODE_CASES = {"molecules_v4": (MOL_HIDDEN, MOL_BATCH, MOL_OUT),
                        "moses": (MOSES_HIDDEN, MOSES_BATCH, MOSES_OUT)}


def allclose_err(a, b) -> float:
    """max |a - b| / (1 + |b|): at most tol exactly where
    torch.allclose(a, b, rtol=tol, atol=tol) holds."""
    a, b = a.float(), b.float()
    return float(((a - b).abs() / (1.0 + b.abs())).max())


def masked_f32_pair_readings(net, x, mask, g) -> dict:
    """The fp32 train step's pair with the key mask (a differentiable call:
    #3 through ``FusedSetTransformer``, #4 in its backward) against
    ``plain_forward`` with it and autograd through that: the output within
    F32_TRAIN_FWD_TOL and each gradient within F32_BWD_TOL
    (``allclose_err``); the control, the pair without the mask, above
    MASK_CONTROL x those on the output and on some gradient; a mask of ones
    bitwise the call without one, output and gradients; the masked
    launches counted."""
    import torch
    from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft
    params = list(net.parameters())

    def run(plain, m):
        xr = x.clone().requires_grad_(True)
        y = net.plain_forward(xr, mask=m) if plain else net(xr, mask=m)
        return (y.detach(), *torch.autograd.grad(y, [xr] + params, g))

    n_fwd = ft.MASKED_TRAIN_FWD_LAUNCHES["float32"]
    n_bwd = ft.MASKED_BWD_LAUNCHES["float32"]
    got = twice(lambda: run(False, mask))
    check(ft.MASKED_TRAIN_FWD_LAUNCHES["float32"] == n_fwd + 2
          and ft.MASKED_BWD_LAUNCHES["float32"] == n_bwd + 2,
          "the masked fp32 call did not launch the masked pair")
    want = run(True, mask)
    none = run(False, None)
    ones = run(False, torch.ones_like(mask))
    fwd, bwd = allclose_err(got[0], want[0]), max(
        allclose_err(a, w) for a, w in zip(got[1:], want[1:]))
    c_fwd, c_bwd = allclose_err(none[0], want[0]), max(
        allclose_err(a, w) for a, w in zip(none[1:], want[1:]))
    what = f"the masked fp32 pair at {tuple(x.shape)}, hidden {net.hidden_dim}"
    check(bool(torch.isfinite(got[0]).all()), f"{what}: not finite")
    check(fwd <= F32_TRAIN_FWD_TOL, f"{what}: #3 off plain by {fwd}")
    check(bwd <= F32_BWD_TOL, f"{what}: #4 off autograd of plain by {bwd}")
    check(c_fwd > MASK_CONTROL * F32_TRAIN_FWD_TOL
          and c_bwd > MASK_CONTROL * F32_BWD_TOL,
          f"{what}: the pair without the mask reads {c_fwd}, {c_bwd}, inside "
          f"{MASK_CONTROL} x the tolerances")
    check(all(torch.equal(a, b) for a, b in zip(ones, none)),
          f"{what}: a mask of ones is not bitwise the call without a mask")
    rels = [rel_err(a, w) for a, w in zip(got, want)]
    return dict(fwd_err=fwd, bwd_err=bwd, control_fwd_err=c_fwd,
                control_bwd_err=c_bwd, rel_err=max(rels[1:]),
                fwd_rel_err=rels[0],
                control_rel_err=max(rel_err(a, w)
                                    for a, w in zip(none, want)),
                max_abs_err=max(max_err(a, w) for a, w in zip(got, want)))


def check_masked_f32_pair(device, seeds, report):
    """The fp32 train step's pair with the key mask at the node flow's
    shapes (in 6, sets of 24; hidden 96 and 128 on 64 and 128 graphs, out
    156; hidden 192 on 128 graphs, out 156, and 256 on 192 graphs, out
    300, where #4 keeps regions of its tile in global memory, its launches
    counted), at each seed, masks from a synthetic batch with one set of a
    single valid key and one of none (``masked_f32_pair_readings``); then
    #3 and #4 timed at runs/molecules' shape (hidden 96, 64 graphs: 1,536
    rows) and at the two wide ones, with their tiles, shared memory, grid
    and workspace; and #4 with the workspace layout forced at hidden 96
    and 128 bitwise the shared layout's (``fma_workspace_bitwise``)."""
    import torch
    from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft
    cases = [(hidden, batch, MOL_OUT) for hidden in FP32_NODE_HIDDEN
             for batch in FP32_NODE_BATCHES]
    cases += list(FP32_WIDE_NODE_CASES.values())
    readings: dict = {}
    for seed in seeds:
        g = torch.Generator(device).manual_seed(seed + 53)
        for hidden, batch, out in cases:
            net = molecule_net("float32", device, seed, hidden, out)
            mask = molecule_key_mask(seed, device, batch)
            x = torch.randn(batch, MOL_NODES, MOL_NODE_DIM, generator=g,
                            device=device)
            gy = torch.randn(batch, MOL_NODES, out, generator=g,
                             device=device)
            n_global = ft.GLOBAL_H_BWD_LAUNCHES["float32"]
            readings[f"{seed}/h{hidden}/rows{batch * MOL_NODES}"] = (
                masked_f32_pair_readings(net, x, mask, gy))
            n_global = ft.GLOBAL_H_BWD_LAUNCHES["float32"] - n_global
            check((n_global > 0) == (hidden >= MOL_HIDDEN),
                  f"the masked fp32 pair at hidden {hidden}: #4's global "
                  f"layout launched {n_global} times")
    print(f"the masked fp32 pair at the node flow's shapes (limits: #3 "
          f"{F32_TRAIN_FWD_TOL}, #4 {F32_BWD_TOL}; controls above "
          f"{MASK_CONTROL} x): " + json.dumps(readings), flush=True)

    seed = seeds[0]
    timed_cases = {"molecules": (FP32_NODE_HIDDEN[0], FP32_NODE_BATCHES[0],
                                 MOL_OUT), **FP32_WIDE_NODE_CASES}
    for run, (hidden, batch, out) in timed_cases.items():
        fwd_name = f"fused_set_transformer_train_f32_{run}"
        bwd_name = ("fused_set_transformer_bwd_f32_molecules"
                    if run == "molecules" else
                    "fused_set_transformer_bwd_f32_global_h" + (
                        "" if run == "molecules_v4" else f"_{run}"))
        report.update(masked_f32_pair_reports(
            device, seed, hidden, batch, out,
            readings[f"{seed}/h{hidden}/rows{batch * MOL_NODES}"],
            fwd_name, bwd_name))
    layout = fma_workspace_bitwise(device, seed)
    print("the fp32 #4 with its workspace layout forced, against the shared "
          "layout: " + json.dumps(layout), flush=True)
    report["fused_set_transformer_bwd_f32_global_h"][
        "layout_bitwise_at_96_128"] = all(v["bitwise"]
                                          for v in layout.values())


def masked_f32_pair_reports(device, seed: int, hidden: int, batch: int,
                            out: int, r: dict, fwd_name: str,
                            bwd_name: str) -> dict:
    """#3 fp32 with grad and #4 fp32, masked, timed at the node flow's
    shape (hidden, batch graphs of 24 nodes, in 6, out) against plain and
    autograd of plain, with ``r``, their readings at ``seed``, the bounds'
    bytes and operations, the tiles, shared memory, grid, the regions of
    #4's tile in global memory and its workspace."""
    import torch
    from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft
    g = torch.Generator(device).manual_seed(seed + 54)
    mask = molecule_key_mask(seed, device, batch)
    x = torch.randn(batch, MOL_NODES, MOL_NODE_DIM, generator=g,
                    device=device)
    gy = torch.randn(batch, MOL_NODES, out, generator=g, device=device)
    net = molecule_net("float32", device, seed, hidden, out)
    ws = ft.flatten_params(net)
    packed = net._packed_weights(torch.float32)
    params = list(net.parameters())
    rows = batch * MOL_NODES
    with torch.no_grad():
        t_fwd = timed(lambda: ft.FusedSetTransformer.apply(
            x, packed, HEADS, mask, *ws),
            lambda: net.plain_forward(x, mask=mask), 20, 5)
    xr = x.clone().requires_grad_(True)
    y_p = net.plain_forward(xr, mask=mask)
    t_bwd = timed(lambda: ft.fused_set_transformer_bwd(
        packed, x, gy, num_heads=HEADS, mask=mask),
        lambda: torch.autograd.grad(y_p, [xr] + params, gy,
                                    retain_graph=True), 10, 5)
    n_w = sum(w.numel() for w in ws[0::2])
    n_b = sum(b.numel() for b in ws[1::2])
    macs = rows * net_macs_per_row(MOL_NODE_DIM, hidden, HEADS, 2,
                                   2 * hidden, out, MOL_NODES)
    tile, smem, _ = ft.fma_fwd_shape(MOL_NODES, MOL_NODE_DIM, hidden,
                                     2 * hidden)
    fwd = dict(
        max_abs_err=r["max_abs_err"], rel_err=r["fwd_rel_err"],
        control_rel_err=r["control_rel_err"], rows=rows, **t_fwd,
        dtype="float32", tile=tile, smem=smem, blocks_per_sm=min(
            ft.FMA_FWD_BLOCKS, ft.smem_blocks_per_sm(smem)),
        # x and y, the weights, and one byte a key of the mask
        bytes=rows * ((MOL_NODE_DIM + out) * 4 + 1) + (n_w + n_b) * 4,
        ops=2 * macs)
    tile, smem, regions, grid = ft.bwd_launch(
        torch.float32, MOL_NODES, MOL_NODE_DIM, hidden, 2 * hidden, out,
        HEADS, 2, rows, torch.cuda.get_device_properties(
            device).multi_processor_count)
    bwd = dict(
        max_abs_err=r["max_abs_err"], rel_err=r["rel_err"],
        control_rel_err=r["control_rel_err"], rows=rows, **t_bwd,
        dtype="float32", tile=tile, smem=smem, grid=grid,
        blocks_per_sm=ft.smem_blocks_per_sm(smem), regions=list(regions),
        scratch_mb=grid * (n_w + n_b) * 4 / 2**20,
        workspace_mb=ft.fma_workspace_elems(regions, tile, hidden,
                                            2 * hidden, 2, grid) * 4 / 2**20,
        # x, g, dx and the mask; the weights and their fp32 gradients
        bytes=rows * ((2 * MOL_NODE_DIM + out) * 4 + 1)
        + 2 * (n_w + n_b) * 4, ops=3 * 2 * macs)
    return {fwd_name: fwd, bwd_name: bwd}


def fma_workspace_bitwise(device, seed: int) -> dict:
    """#4 fp32 at the node flow's hidden 96 and 128 (64 and 128 graphs of
    24 nodes, in 6, out 156, masked), whose tiles fit in shared memory,
    with every region of ``ft.FMA_WS_REGIONS`` in the global workspace
    instead (the wrapper's private ``_global_h``): dx and the 12 weight
    gradients bitwise the shared layout's at the same tile and grid, so
    only the storage moved."""
    import torch
    from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft
    out = {}
    g = torch.Generator(device).manual_seed(seed + 55)
    for hidden, batch in zip(FP32_NODE_HIDDEN, FP32_NODE_BATCHES):
        x = torch.randn(batch, MOL_NODES, MOL_NODE_DIM, generator=g,
                        device=device)
        gy = torch.randn(batch, MOL_NODES, MOL_OUT, generator=g,
                         device=device)
        mask = molecule_key_mask(seed, device, batch)
        packed = molecule_net("float32", device, seed,
                              hidden)._packed_weights(torch.float32)
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        shape = (torch.float32, MOL_NODES, MOL_NODE_DIM, hidden, 2 * hidden,
                 MOL_OUT, HEADS, 2, batch * MOL_NODES, sms)
        shared, forced = ft.bwd_launch(*shape), ft.bwd_launch(*shape, True)
        check(not shared[2] and forced[2] == ft.FMA_WS_REGIONS
              and (forced[0], forced[3]) == (shared[0], shared[3]),
              f"#4 fp32 layouts at hidden {hidden}: {shared}, {forced}")
        n_global = ft.GLOBAL_H_BWD_LAUNCHES["float32"]
        with torch.no_grad():
            a = ft.fused_set_transformer_bwd(packed, x, gy, num_heads=HEADS,
                                             mask=mask)
            c = ft.fused_set_transformer_bwd(packed, x, gy, num_heads=HEADS,
                                             mask=mask, _global_h=True)
        check(ft.GLOBAL_H_BWD_LAUNCHES["float32"] == n_global + 1,
              f"#4 fp32 at hidden {hidden}: the forced layout was not the "
              "global one")
        same = [torch.equal(u, v) for u, v in zip((a[0], *a[1]),
                                                   (c[0], *c[1]))]
        check(all(same), f"#4 fp32 at hidden {hidden}: the workspace "
              f"layout's gradients differ from the shared layout's ({same})")
        out[f"h{hidden}"] = {"tile": shared[0], "grid": shared[3],
                             "smem_shared": shared[1],
                             "smem_global": forced[1], "bitwise": all(same)}
    return out


def global_h_bitwise(device, seed: int) -> dict:
    """#4 bf16 at molecules_v4's node-flow shape (hidden 192, a tile that
    fits with the residual copies in shared memory), masked, with the
    copies in the global workspace instead (the wrapper's private
    ``_global_h``): dx and the 12 weight gradients bitwise the shared
    layout's at the same tile and grid, so only the storage moved."""
    import torch
    from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft
    g = torch.Generator(device).manual_seed(seed + 52)
    x = torch.randn(MOL_BATCH, MOL_NODES, MOL_NODE_DIM, generator=g,
                    device=device)
    gy = torch.randn(MOL_BATCH, MOL_NODES, MOL_OUT, generator=g,
                     device=device).to(torch.bfloat16)
    mask = molecule_key_mask(seed, device)
    packed = molecule_net("bfloat16", device, seed)._packed_weights(
        torch.bfloat16)
    shape = (torch.bfloat16, MOL_NODES, MOL_NODE_DIM, MOL_HIDDEN,
             2 * MOL_HIDDEN, MOL_OUT, HEADS, 2)
    shared, forced = ft.bwd_layout(*shape), ft.bwd_layout(*shape, True)
    check(not shared[2] and forced[2] and forced[0] == shared[0],
          f"#4 bf16 layouts at hidden 192: {shared}, {forced}")
    with torch.no_grad():
        a = ft.fused_set_transformer_bwd(packed, x, gy, num_heads=HEADS,
                                         mask=mask)
        c = ft.fused_set_transformer_bwd(packed, x, gy, num_heads=HEADS,
                                         mask=mask, _global_h=True)
    same = [torch.equal(u, v) for u, v in zip((a[0], *a[1]), (c[0], *c[1]))]
    check(all(same), f"#4 bf16 at hidden 192: the global layout's gradients "
          f"differ from the shared layout's ({same})")
    return {"tile": shared[0], "smem_shared": shared[1],
            "smem_global": forced[1], "bitwise": all(same)}


def moses_fused_reports(device, seed: int, readings: dict) -> dict:
    """Masked #3 bf16 and #4 bf16 at runs/moses's node flow (hidden 256,
    out 300, 192 graphs of 24 nodes; #4 in its global layout), timed, with
    their readings at ``seed``, bounds' bytes and operations, and #4's
    tile, grid, operand images and residual workspace; wgrad_tiles_bf16
    at that call's shape (``wgrad_report``)."""
    import torch
    from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft
    g = torch.Generator(device).manual_seed(seed + 53)
    mask = molecule_key_mask(seed, device, MOSES_BATCH)
    x = torch.randn(MOSES_BATCH, MOL_NODES, MOL_NODE_DIM, generator=g,
                    device=device)
    gy = torch.randn(MOSES_BATCH, MOL_NODES, MOSES_OUT, generator=g,
                     device=device).to(torch.bfloat16)
    net = molecule_net("bfloat16", device, seed, MOSES_HIDDEN, MOSES_OUT)
    packed = net._packed_weights(torch.bfloat16)
    rows = MOSES_BATCH * MOL_NODES
    macs_row = net_macs_per_row(MOL_NODE_DIM, MOSES_HIDDEN, HEADS, 2,
                                2 * MOSES_HIDDEN, MOSES_OUT, MOL_NODES)
    ws = ft.flatten_params(net)
    n_w = sum(w.numel() for w in ws[0::2])
    n_b = sum(b.numel() for b in ws[1::2])
    with torch.no_grad():
        t = timed(lambda: ft.fused_set_transformer(
            packed, x, num_heads=HEADS, mask=mask),
            lambda: net.plain_forward(x, mask=mask), 20, 5)
    out = {"fused_set_transformer_bf16_moses": dict(
        readings[f"{seed}/fwd_bf16_h{MOSES_HIDDEN}"], rows=rows, **t,
        dtype="bfloat16",
        bytes=rows * ((MOL_NODE_DIM + MOSES_OUT) * 2 + 1) + n_w * 2
        + n_b * 4, ops=2 * rows * macs_row)}
    params = list(net.parameters())
    xr = x.clone().requires_grad_(True)
    y_p = net.plain_forward(xr, mask=mask)
    t = timed(lambda: ft.fused_set_transformer_bwd(packed, x, gy,
                                                   num_heads=HEADS,
                                                   mask=mask),
              lambda: torch.autograd.grad(y_p, [xr] + params, gy,
                                          retain_graph=True), 10, 5)
    tile, smem, in_global, _ = ft.bwd_layout(
        torch.bfloat16, MOL_NODES, MOL_NODE_DIM, MOSES_HIDDEN,
        2 * MOSES_HIDDEN, MOSES_OUT, HEADS, 2)
    check(in_global, "#4 bf16 at hidden 256 did not take the global layout")
    grid = ft.bwd_grid(rows, tile, smem, torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    shape = ft.WgradShape(rows, MOL_NODES, MOL_NODE_DIM, MOSES_HIDDEN, 2,
                          2 * MOSES_HIDDEN, MOSES_OUT)
    images_mb = ft.wgrad_workspace_elems(shape, tile) * 2 / 2**20
    out["fused_set_transformer_bwd_bf16_global_h"] = dict(
        readings[f"{seed}/bwd_bf16_h{MOSES_HIDDEN}"], rows=rows, **t,
        dtype="bfloat16",
        bytes=rows * ((2 * MOL_NODE_DIM + MOSES_OUT) * 2 + 1) + n_w * 2
        + n_b * 4 + (n_w + n_b) * 4, ops=3 * 2 * rows * macs_row,
        tile=tile, smem=smem, grid=grid,
        blocks_per_sm=ft.smem_blocks_per_sm(smem), images_mb=images_mb,
        workspace_mb=(ft.h_workspace_elems(tile, MOSES_HIDDEN, 2, grid)
                      + ft.stash_workspace_elems(tile, MOSES_HIDDEN, 2,
                                                 2 * MOSES_HIDDEN, grid))
        * 2 / 2**20)
    out["wgrad_tiles_bf16"] = wgrad_readings(device, seed, MOSES_BATCH, grid,
                                             report=True)
    return out


def wgrad_readings(device, seed: int, batch: int = MOSES_BATCH,
                   grid: int | None = None, report: bool = False) -> dict:
    """wgrad_tiles_bf16 at runs/moses' node flow (``batch`` graphs of 24
    nodes, hidden 256, out 300; #4 bf16's tile and, unless given, its grid)
    on random operand images of that call's shape, twice, against
    ``wgrad_tiles_plain`` on them: the matrices within one bf16 rounding
    (2^-7 of the plain value, plus 1e-5 of the largest: the two sum in
    fp32 in other orders, then round), the biases (fp32) within 1e-5 of the
    largest.  With ``report``, timed, and the bytes and operations of its
    bound: its report entry."""
    import torch
    from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft
    rows = batch * MOL_NODES
    net = (torch.bfloat16, MOL_NODES, MOL_NODE_DIM, MOSES_HIDDEN,
           2 * MOSES_HIDDEN, MOSES_OUT, HEADS, 2)
    tile = ft.bwd_layout(*net)[0]
    if grid is None:
        grid = ft.bwd_launch(*net, rows, torch.cuda.get_device_properties(
            device).multi_processor_count)[3]
    shape = ft.WgradShape(rows, MOL_NODES, MOL_NODE_DIM, MOSES_HIDDEN, 2,
                          2 * MOSES_HIDDEN, MOSES_OUT)
    g = torch.Generator(device).manual_seed(seed + 54)
    images = torch.randn(ft.wgrad_workspace_elems(shape, tile), generator=g,
                         device=device).to(torch.bfloat16)
    with torch.no_grad():
        dw = twice(lambda: ft.wgrad_tiles_bf16(images, shape, tile, grid))
        want = ft.wgrad_tiles_plain(images, shape, tile, grid)
    sizes = [math.prod(s) for s in shape.weight_shapes()]
    err, ref = (dw - want).abs().split(sizes), want.split(sizes)
    mats, ref_m = torch.cat(err[0::2]), torch.cat(ref[0::2]).abs()
    bias, ref_b = torch.cat(err[1::2]), torch.cat(ref[1::2]).abs()
    out = dict(
        max_abs_err=float(torch.cat(err).max()), grid=grid, rows=rows,
        matrices_within=bool((mats <= 2.0**-7 * ref_m + 1e-5 * ref_m.max())
                             .all()),
        biases_within=bool((bias <= 1e-5 * ref_b.max()).all()),
        bitwise_share=float((dw == want).float().mean()))
    check(out["matrices_within"] and out["biases_within"],
          f"wgrad_tiles_bf16 at {batch} graphs, grid {grid}: off its plain "
          f"version ({out})")
    if report:
        products = ft.wgrad_products(shape)
        n_ops = sum(kd * n for _, _, kd, n in products)
        widths = sum(kd + n for _, _, kd, n in products)
        out.update(
            timed(lambda: ft.wgrad_tiles_bf16(images, shape, tile, grid),
                  lambda: ft.wgrad_tiles_plain(images, shape, tile, grid),
                  20, 3),
            dtype="bfloat16", images_mb=images.numel() * 2 / 2**20,
            # the valid rows of X and G at their own widths read once (pad
            # rows and columns add nothing) and dw written; their products
            bytes=rows * widths * 2 + sum(sizes) * 4, ops=2 * rows * n_ops)
    return out


def molecule_graph_noise(task, n: int, chains: int, seed: int):
    """Uniforms of the three stages' encoders for ``chains`` chains of
    ``n`` graphs, and of their priors for a sample of ``n``."""
    import torch
    from categoricalnf_tpu_torch.ops.numerics import uniform_noise
    m = task.model
    g = torch.Generator().manual_seed(seed)
    shapes = [(n, m.max_nodes, m.node_dim), (n, m.num_edges, m.exist_dim),
              (n, m.num_edges, m.bond_dim)]
    enc = tuple(uniform_noise((chains,) + s, generator=g) for s in shapes)
    prior = tuple(uniform_noise(s, generator=g) for s in shapes)
    return enc, prior


def decode_fixed(enc, z, tol: float = 1e-3):
    """Where the Bayes decode of the mixture encoding ``enc`` at ``z``
    [..., D] stays whatever each latent moves by up to tol (1 + |z|): the
    gap between the two best log joints is above what such a move can
    change it by (a logistic's log density has a slope of at most 1/s) and
    above fp32's rounding of them."""
    import torch
    joint = enc._log_joint_all(z)
    top, idx = joint.topk(2, dim=-1)
    inv_s = torch.exp(-enc._ls(enc.log_scales))                 # [C, D]
    move = tol * (1 + z.abs())
    bound = (move * (inv_s[idx[..., 0]] + inv_s[idx[..., 1]])).sum(-1)
    rounding = 1e-5 * (1 + top.abs().sum(-1))
    return top[..., 0] - top[..., 1] > bound + rounding


def check_molecules_against_cpu(task, seed: int, n: int = 16) -> dict:
    """The served GraphCNF (kernels on the card) against a CPU copy of it
    (plain path), in the fp32 twin, on ``n`` graphs of the task's data with
    shared noise: the IS bits/var of 4 chains within 1e-3; then a sample
    from shared prior uniforms held stage by stage, each stage of the card
    run on the CPU's earlier stages (``GraphCNF.sample_stages`` with
    ``given``): its latents within 1e-3 (absolute and relative) on 99% of
    its live positions (nodes, node pairs, existing bonds), and its
    categories equal on 99% of those whose decode that tolerance cannot
    flip (``decode_fixed``: a deep flow with random weights sends some
    latents so far out that 1e-3 of them moves every category's log joint
    across the others).  The
    whole sample's agreement is recorded, not held: one decision that
    flips between the two changes the conditions of every later stage of
    its graph."""
    import numpy as np
    import torch
    from categoricalnf_tpu_torch.inference import build_task

    args = {f.name: getattr(task, f.name) for f in dataclasses.fields(task)
            if f.name not in ("name", "device")}
    cpu = build_task(task.name, args, device="cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in
                               task.model.state_dict().items()})
    batch = cpu._slice(np.random.default_rng(seed + 7).integers(
        0, len(cpu.data["atoms"]), n))
    enc, prior = molecule_graph_noise(cpu, n, 4, seed + 7)
    mask = torch.as_tensor(batch["node_mask"])
    dev = task.device
    with torch.no_grad():
        bpd_cpu = cpu.eval_step(batch, 4, noise=enc)
        bpd_gpu = task.eval_step(batch, 4, noise=tuple(
            u.to(dev) for u in enc)).cpu()
        gap = max_err(bpd_gpu, bpd_cpu)
        check(gap <= 1e-3, f"{task.name}: eval_bpd card vs CPU {gap}")
        want = cpu.eval_model.sample_stages(mask, noise=prior)
        got = {k: v.cpu() for k, v in task.eval_model.sample_stages(
            mask.to(dev), noise=tuple(u.to(dev) for u in prior),
            given={k: v.to(dev) for k, v in want.items()}).items()}
        a_c, e_c = cpu.eval_model.sample(mask, noise=prior)
        a_g, e_g = (t.cpu() for t in task.eval_model.sample(
            mask.to(dev), noise=tuple(u.to(dev) for u in prior)))
    e_mask = cpu.model.edge_mask(mask) > 0
    live = {"v": mask > 0, "e1": e_mask, "e2": e_mask & (want["exist"] > 0)}
    r = {"bpd_max_err": gap}
    for stage, z, cat, enc in (
            ("v", "z_v", "atoms", cpu.model.enc_node),
            ("e1", "z_e1", "exist", cpu.model.enc_exist),
            ("e2", "z_e2", "bond", cpu.model.enc_bond)):
        near = ((got[z] - want[z]).abs() <= 1e-3 + 1e-3 * want[z].abs())
        r[f"{z}_within_1e3"] = float(near[live[stage]].float().mean())
        with torch.no_grad():
            sure = live[stage] & decode_fixed(enc, want[z])
        r[f"{cat}_determined"] = float(sure.sum() / live[stage].sum())
        # None where no decode is determined: nothing to hold there
        r[f"{cat}_equal"] = (float((got[cat] == want[cat])[sure]
                                   .float().mean()) if sure.any() else None)
        check(r[f"{z}_within_1e3"] >= 0.99
              and (r[f"{cat}_equal"] is None or r[f"{cat}_equal"] >= 0.99),
              f"{task.name}: stage {z} card vs CPU: {r}")
    r["sample_atoms_equal"] = float((a_g == a_c)[mask > 0].float().mean())
    r["sample_edges_equal"] = float((e_g == e_c)[e_mask].float().mean())
    print(f"{task.name}: card vs CPU (fp32, {n} graphs): " + json.dumps(r),
          flush=True)
    return r


MOLECULE_KERNELS = ("mixture_forward", "mixture_forward_bwd",
                    "mixture_inverse", "fused_set_transformer_bf16",
                    "fused_set_transformer_bwd_bf16",
                    "fused_set_transformer_f32")
# the launches of the masked kernels, counted apart (``read_launches``)
MASKED_KERNELS = ("fused_set_transformer_bf16_masked",
                  "fused_set_transformer_bwd_bf16_masked",
                  "fused_set_transformer_f32_masked")
MOLECULE_QUALITY = ("validity", "validity_ci95", "uniqueness", "novelty",
                    "validity_strict", "validity_corrected",
                    "uniqueness_corrected", "novelty_corrected")


def serve_molecules(run_dir: str, timings: dict, device: str,
                    metric_samples: int) -> tuple:
    """Serve the molecule run in ``run_dir`` over HTTP: /health, /sample of
    4 (atoms of the vocabulary, bonds of orders 1-3 inside each molecule,
    "valid" as recomputed), /sample_metrics of ``metric_samples``, a bad
    request.  Returns the server and the launches of the serving."""
    from http.server import ThreadingHTTPServer

    import numpy as np
    from categoricalnf_tpu_torch.serve import RunServer, make_handler
    from categoricalnf_tpu_torch.tasks import chem
    reset_launches()
    server = RunServer(run_dir, device=device)
    task = server.handle.task
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(server))
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        port = httpd.server_port
        st, health, _ = http_json(port, "GET", "/health")
        check(st == 200 and health["task"] == task.name, f"/health {health}")
        st, out, dt = http_json(port, "POST", "/sample", {"num_samples": 4})
        check(st == 200 and len(out["samples"]) == 4,
              f"/sample answered {st}: {out}")
        timings["sample_4_s"] = dt
        for mol in out["samples"]:
            k = len(mol["atoms"])
            check(set(mol) == {"atoms", "bonds", "smiles", "valid"}
                  and 1 <= k <= task.max_nodes
                  and set(mol["atoms"]) <= set(chem.ATOM_TYPES)
                  and all(0 <= i < j < k and 1 <= o <= 3
                          for i, j, o in mol["bonds"]), f"molecule {mol}")
            ids = np.asarray([[chem.ATOM_TYPES.index(s)
                               for s in mol["atoms"]]])
            adj = np.zeros((k, k), np.int64)
            for i, j, o in mol["bonds"]:
                adj[i, j] = adj[j, i] = o
            check(mol["valid"] == bool(chem.molecule_validity(
                ids, chem.dense_to_edges(adj)[None], np.ones((1, k)),
                check_connected=False)[0]), f"'valid' disagrees: {mol}")
        timings["sample_4_smiles"] = [m["smiles"] for m in out["samples"]]
        st, met, dt = http_json(port, "POST", "/sample_metrics",
                                {"num_samples": metric_samples})
        check(st == 200 and met["metric_num_samples"] == metric_samples
              and 0.0 <= met["validity"] <= 1.0,
              f"/sample_metrics answered {st}: {met}")
        timings[f"sample_metrics_{metric_samples}_s"] = dt
        timings["served"] = {k: met[k] for k in MOLECULE_QUALITY}
        st, out, _ = http_json(port, "POST", "/sample", {"num_samples": 0})
        check(st == 400 and "error" in out, "bad request not refused")
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=60)
    launches = read_launches()
    for name in ("mixture_inverse", "mixture_forward",
                 "fused_set_transformer_bf16",
                 "fused_set_transformer_bf16_masked"):
        check(launches[name] > 0, f"kernel {name} was not launched while "
              f"serving {task.name}")
    return server, launches


def molecule_phase(seed: int, timings: dict, card: str,
                   device: str = "cuda") -> dict:
    """GraphCNF.  Train runs/molecules_v4/config.json as it is but for its
    dataset, the in-memory synthetic molecules (hidden 192, 4 node and 6
    edge layers, K = 8, bf16, batch 128, graphs padded to 24 nodes) for
    MOL_STEPS steps through the port's Trainer (its 8 eval batches of 4
    chains before, at half and at the end; the final sample metrics at
    1,024 molecules and sampled_molecules.json), with ``train_checked``'s
    checks
    and every molecule kernel launched, the masked ones included; trace 10
    more steps.  Serve the run (``serve_molecules``), then hold the served
    model, its coupling nets' output layers random, against its CPU copy
    and #1 on every inverse call of its sample of a batch at the seed and
    the next.  Then the same for runs/moses/config.json at full width
    (hidden 256, K = 16, 6 node, 8 edge and 12 bond layers,
    node_cond_atoms and bond_cond_degree, batch 192, 4 steps a call;
    synthetic molecules), MOSES_STEPS steps, its #4 bf16 launched with the
    residual copies in global memory.  Returns the launches of the
    trainings and of the serving."""
    import numpy as np
    import torch
    from categoricalnf_tpu_torch import inference
    from categoricalnf_tpu_torch.utils.config import load_config

    cfg = load_config(os.path.join(REPO, "runs", "molecules_v4"))
    a = cfg["args"]
    # the one cut: the named dataset's .npz is not in the repo
    args = {**a, "dataset": "synthetic", "seed": seed}
    t0 = time.perf_counter()
    task = inference.build_task(cfg["task"], args, device=device)
    timings["build_task_s"] = time.perf_counter() - t0
    tcfg = dataclasses.replace(train_config(a, seed, a["eval_samples"]),
                               num_steps=MOL_STEPS, eval_every=MOL_STEPS // 2,
                               log_every=MOL_STEPS)
    launches = {}
    with tempfile.TemporaryDirectory() as out_dir:
        final = train_checked(task, cfg["task"], args, tcfg, out_dir,
                              timings, MOLECULE_KERNELS + MASKED_KERNELS)
        launches["molecule_training"] = final["launches"]
        check(os.path.exists(os.path.join(out_dir, "sampled_molecules.json")),
              "the molecule run wrote no sampled_molecules.json")
        timings["final_sample_metrics"] = {k: final[k]
                                           for k in MOLECULE_QUALITY}
        timings["step_profile"] = profile_steps(task, tcfg.optimizer, seed)

        served_timings: dict = {}
        server, launches["molecule_serving"] = serve_molecules(
            out_dir, served_timings, device, 1024)
        timings["serving"] = served_timings
        served = server.handle.task
        randomize_coupling_nets(served.model, seed + 1)
        timings["against_cpu"] = check_molecules_against_cpu(served, seed)
        ratios = held_samples(lambda s: served.sample_many(
            served.batch_size, generator=torch.Generator(device)
            .manual_seed(s)), seed, "molecule sample")
        timings["held_inverse_calls"] = len(ratios)
        timings["held_inverse_worst_ratio"] = max(ratios)

    # runs/moses at full width (its #4 bf16 in the global layout), trained,
    # served, held
    cfg = load_config(os.path.join(REPO, "runs", "moses"))
    a = cfg["args"]
    m_args = {**a, "dataset": "synthetic", "seed": seed}
    moses = inference.build_task(cfg["task"], m_args, device=device)
    check((moses.hidden_dim, moses.num_mixtures, moses.num_layers_bond,
           moses.node_cond_atoms, moses.bond_cond_degree, moses.batch_size)
          == (256, 16, 12, True, True, MOSES_BATCH),
          "runs/moses is not the model this phase is written for")
    tcfg = dataclasses.replace(train_config(a, seed, a["eval_samples"]),
                               num_steps=MOSES_STEPS,
                               eval_every=MOSES_STEPS // 2,
                               log_every=MOSES_STEPS)
    moses_timings: dict = {"cut": {"dataset": "synthetic"}}
    with tempfile.TemporaryDirectory() as out_dir:
        final = train_checked(moses, cfg["task"], m_args, tcfg, out_dir,
                              moses_timings,
                              MOLECULE_KERNELS + MASKED_KERNELS
                              + ("fused_set_transformer_bwd_bf16_global_h",
                                 "wgrad_tiles_bf16"))
        launches["moses_training"] = final["launches"]
        moses_timings["final_sample_metrics"] = {k: final[k]
                                                 for k in MOLECULE_QUALITY}
        moses_timings["step_profile"] = profile_steps(moses, tcfg.optimizer,
                                                      seed)
        served_timings: dict = {}
        server, launches["moses_serving"] = serve_molecules(
            out_dir, served_timings, device, 1024)
        moses_timings["serving"] = served_timings
        served = server.handle.task
        randomize_coupling_nets(served.model, seed + 2)
        moses_timings["against_cpu"] = check_molecules_against_cpu(served,
                                                                   seed)
        ratios = held_samples(lambda s: served.sample_many(
            served.batch_size, generator=torch.Generator(device)
            .manual_seed(s)), seed, "moses sample")
        moses_timings["held_inverse_calls"] = len(ratios)
        moses_timings["held_inverse_worst_ratio"] = max(ratios)
    timings["moses"] = moses_timings
    for run, t, b in (("molecules_v4", timings, task.batch_size),
                      ("moses", moses_timings, moses.batch_size)):
        print(json.dumps({"metric": "molecule_generation_train_samples_per_s",
                          "run": run, "value": t["train_samples_per_s"],
                          "unit": "samples/s", "steps": t["rate_steps"],
                          "batch_size": b,
                          "ms_per_step": t["train_ms_per_step"],
                          "peak_mem_gib": t["train_peak_mem_gib"],
                          "device_idle_share": t["step_profile"].get(
                              "device_idle_share"),
                          "device": card}), flush=True)
    return launches


@contextlib.contextmanager
def plain_path_on_card():
    """Sends the card's nets, mixture forwards and inverses through their
    plain versions, as a CPU tensor goes, so that a whole train step
    through the kernels can be held against the same step through the
    plain path on the same card."""
    from categoricalnf_tpu_torch.networks import SetTransformer
    from categoricalnf_tpu_torch.ops import dispatch
    from categoricalnf_tpu_torch.ops import numerics as nm
    fwd, mix = SetTransformer.forward, dispatch.mixture_forward
    inv = dispatch.mixture_inverse
    SetTransformer.forward = SetTransformer.plain_forward
    dispatch.mixture_forward = nm.mixture_logit_cdf_and_ldj
    dispatch.mixture_inverse = nm.mixture_inverse_logit_cdf
    try:
        yield
    finally:
        SetTransformer.forward, dispatch.mixture_forward = fwd, mix
        dispatch.mixture_inverse = inv


# The fp32 train step's gradients are held per tensor against the same step
# in float64 on the CPU (the port's plain path with every tensor float64:
# ``fp64_reference``), by relative norm error.  (a) The kernels and the plain
# path on the card: within max(FP64_REL, 2 e_cpu), e_cpu the CPU fp32 step's
# own error, so that where fp32 arithmetic itself cannot resolve a gradient
# (a data-initialised ActNorm bias, the mixture offsets: up to 2e-3 for the
# CPU fp32 step on an H100's host) the card may be as far as twice it.
# (b) The kernels: within max(KERNELS_VS_PLAIN_CARD, 2 e_plain) of the fp64
# step.  (c) The control, the kernels' gradients rounded once to bf16, reads
# above (b)'s limit on every tensor where that limit is its floor.
FP64_REL = 1e-3
# (b)'s floor: between the kernels' reading against the plain path on the
# card (1.9e-4 at worst on an H100 80GB HBM3 at 700 W) and the least that
# their gradients rounded once to bf16 read (4.0e-4 there).
KERNELS_VS_PLAIN_CARD = 3e-4


def train_step_failures(readings: dict) -> list:
    """Rules (a)-(c) on the readings ``{tensor: (e_cpu, e_plain, e_kern,
    control)}``, each a relative norm error against the fp64 step: the CPU
    fp32 step, the plain path on the card, the kernels, and the kernels'
    gradients rounded to bf16.  Returns a message for each rule that a
    tensor fails."""
    failed = []
    for name, (e_cpu, e_plain, e_kern, control) in readings.items():
        lim_a = max(FP64_REL, 2 * e_cpu)
        lim_b = max(KERNELS_VS_PLAIN_CARD, 2 * e_plain)
        for what, err in (("kernels", e_kern), ("plain path", e_plain)):
            if not err <= lim_a:
                failed.append(f"(a) {name}: {what} {err} from the fp64 step, "
                              f"over {lim_a}")
        if not e_kern <= lim_b:
            failed.append(f"(b) {name}: kernels {e_kern} from the fp64 step, "
                          f"over {lim_b}")
        if lim_b == KERNELS_VS_PLAIN_CARD and not control > lim_b:
            failed.append(f"(c) {name}: the bf16-rounded control reads "
                          f"{control}, inside {lim_b}: the limit cannot "
                          "tell it")
    return failed


# The inverse (#1) is held by its residual in y, e = |logit F(x) - y|, in
# float64 (the numerics on float64 inputs): where y is flat in x, two x
# that fp32 cannot tell apart in y may lie far apart.  Per element, the
# kernel's e_k stays within max(2 e_p, tau): e_p the plain fp32 version's
# residual, and tau an fp32 floor that no draw can lower: the error with
# which fp32 evaluates y at the root x* (8 ulps of |log F| + |log(1 - F)|,
# which at the root are softplus(-y) + softplus(y)) plus the move in y of
# half an fp32 ulp of x*, exp(ldj(x*)) ulp(x*) / 2.  x* is the plain
# inverse run in float64.
INV_EVAL_ULPS = 8


def inverse_residual(x, y, pi, mu, ls):
    """|logit F(x) - y| per element, in float64."""
    from categoricalnf_tpu_torch.ops import numerics as nm
    d = [t.detach().double() for t in (x, y, pi, mu, ls)]
    return (nm.mixture_logit_cdf_and_ldj(d[0], *d[2:])[0] - d[1]).abs()


def inverse_floor(y, pi, mu, ls):
    """tau per element (float64), from the root x* found in float64."""
    import torch
    import torch.nn.functional as tf
    from categoricalnf_tpu_torch.ops import numerics as nm
    yd, pd, md, ld = (t.detach().double() for t in (y, pi, mu, ls))
    x_star = nm.mixture_inverse_logit_cdf(yd, pd, md, ld)
    _, ldj = nm.mixture_logit_cdf_and_ldj(x_star, pd, md, ld)
    a = x_star.float().abs()
    ulp = (torch.nextafter(a, torch.full_like(a, float("inf"))) - a).double()
    return (INV_EVAL_ULPS * 2.0 ** -24 * (tf.softplus(yd) + tf.softplus(-yd))
            + ldj.exp() * ulp / 2)


def inverse_reading(x, x_plain, y, pi, mu, ls) -> tuple[int, float]:
    """(elements whose residual is over max(2 e_p, tau), the largest ratio
    of residual to that limit); a residual that is not finite is over."""
    import torch
    e_k = inverse_residual(x, y, pi, mu, ls)
    limit = torch.maximum(2 * inverse_residual(x_plain, y, pi, mu, ls),
                          inverse_floor(y, pi, mu, ls))
    ratio = (e_k / limit).nan_to_num(float("inf"))
    return int((ratio > 1).sum()), float(ratio.max())


def inverse_failures(x, x_plain, y, pi, mu, ls, what: str) -> list:
    """The residual rule on the inverse's ``x``, the plain fp32 version's
    ``x_plain`` beside it: a message if any element is over the limit."""
    over, worst = inverse_reading(x, x_plain, y, pi, mu, ls)
    if not over:
        return []
    return [f"{what}: {over} of {x.numel()} elements over max(2 e_p, tau), "
            f"the worst at {worst!r} times it"]


# elements of the held inverse calls checked at once (``inverse_calls_held``)
HELD_CHUNK = 1 << 18


@contextlib.contextmanager
def inverse_calls_held(what: str):
    """Holds #1 by the residual rule on every call of the couplings' and
    the autoregressive layers' inverse (``dispatch.mixture_inverse`` on a
    CUDA tensor) inside the block, beside the plain version on the same
    inputs: each call's inputs and result are kept, and when the block ends
    the plain version and the rule run on them, calls concatenated into
    batches of up to HELD_CHUNK elements (the rule is elementwise).  Yields
    the list of each call's worst ratio of residual to limit, filled then;
    fails if an element of any call is over or no call was made."""
    import torch
    from categoricalnf_tpu_torch.ops import dispatch
    from categoricalnf_tpu_torch.ops import numerics as nm
    inverse = dispatch.mixture_inverse
    calls, ratios = [], []

    def held(y, pi, mu, ls):
        x = inverse(y, pi, mu, ls)
        if y.is_cuda:
            k = pi.shape[-1]
            calls.append((y.reshape(-1), pi.reshape(-1, k), mu.reshape(-1, k),
                          ls.reshape(-1, k), x.reshape(-1)))
        return x

    dispatch.mixture_inverse = held
    try:
        yield ratios
    finally:
        dispatch.mixture_inverse = inverse
    check(calls, f"{what}: no inverse call on the card")
    failures = []
    start = 0
    while start < len(calls):
        stop, size = start, 0
        while stop < len(calls) and (stop == start or size
                                     + calls[stop][0].numel() <= HELD_CHUNK):
            size += calls[stop][0].numel()
            stop += 1
        y, pi, mu, ls, x = (torch.cat(t) for t in zip(*calls[start:stop]))
        x_p = nm.mixture_inverse_logit_cdf(y, pi, mu, ls)
        e_k = inverse_residual(x, y, pi, mu, ls)
        limit = torch.maximum(2 * inverse_residual(x_p, y, pi, mu, ls),
                              inverse_floor(y, pi, mu, ls))
        ratio = (e_k / limit).nan_to_num(float("inf"))
        for n, r in enumerate(ratio.split([c[0].numel()
                                           for c in calls[start:stop]]),
                              start):
            ratios.append(float(r.max()))
            over = int((r > 1).sum())
            if over:
                failures.append(
                    f"{what}, inverse call {n}: {over} of {r.numel()} "
                    f"elements over max(2 e_p, tau), the worst at "
                    f"{ratios[-1]!r} times it")
        start = stop
    check(not failures, "; ".join(failures))


def coupling_slices(pi, ls):
    """pi and ls as the coupling passes them: slices [2:2+K] and [2+2K:] of
    one [..., 2 + 3K] tensor (the means, offset, are a tensor of their
    own)."""
    import torch
    k = pi.shape[-1]
    raw = torch.zeros(*pi.shape[:-1], 2 + 3 * k, device=pi.device)
    raw[..., 2:2 + k] = pi
    raw[..., 2 + 2 * k:] = ls
    return raw[..., 2:2 + k], raw[..., 2 + 2 * k:]


def inverse_case(gen, shape, k, device, strided: bool):
    """(y, pi, mu, ls) of #1 with y the plain forward of a drawn x; pi and
    ls ``strided`` as the coupling passes them."""
    from categoricalnf_tpu_torch.ops import numerics as nm
    x, pi, mu, ls = mixture_inputs(gen, shape, k, device)
    y, _ = nm.mixture_logit_cdf_and_ldj(x, pi, mu, ls)
    if strided:
        pi, ls = coupling_slices(pi, ls)
    return y, pi, mu, ls


def inverse_cases(seed: int, device) -> dict:
    """The inverse's cases at the sampling path's sizes, ``name: (y, pi,
    mu, ls)`` from a generator seeded ``seed``: the flagship's chunk of
    1024 sets (M = 65,536, K = 8, pi and ls strided as the coupling passes
    them) and the same at K = 3; a /sample of 4 sets (M = 256); K = 16 at
    M = 91; y the plain forward of x there.  And the tails: y = +-60 (the
    linear domain's sums near 2^-87) and +-90 (past kLinearMaxY: the log
    domain) with every log-scale at the clip, M = 4,096; and wide brackets:
    y = +-30 and +-90 with the log-scales spread over the clip's range
    (times 6, as the backward's check draws them), M = 4,096, where a
    narrow component far from the root meets |z| near 1e7; and peaked
    mixtures: logits times 50 (one component holds nearly all the weight),
    means times 30, log-scales times 60 (most past the clip), y ~ N(0,
    10^2), M = 4,096, as a coupling net with random output weights gives
    them: wide brackets around a narrow root, which the inverse before the
    best iterate and the bracket's slack missed; and far roots: |y| from
    1e5 to 5e7, logits, means and log-scales times 1e6, M = 4,096, as
    GraphCNF's bond stage gives them at its masked positions (the layers'
    affine grows what the density never weighs), where the inverse with
    the convergence floor at 2^-20 (1 + |y|) stopped at twice tau."""
    import torch
    from categoricalnf_tpu_torch.ops import numerics as nm
    gen = torch.Generator(device).manual_seed(seed)
    cases = {name: inverse_case(gen, shape, k, device,
                                name in ("flagship", "sample4"))
             for name, shape, k in (("flagship", (B, S, D), K),
                                    ("k3", (B, S, D), 3),
                                    ("sample4", (4, S, D), K),
                                    ("k16", (7, 13), 16))}
    _, pi, mu, ls = mixture_inputs(gen, (4096,), K, device)
    y = torch.tensor([60.0, -60.0, 90.0, -90.0], device=device).repeat(1024)
    cases["tails"] = (y, pi, mu, nm.LOG_SCALE_MIN - 0.5 - ls.abs())
    _, pi, mu, ls = mixture_inputs(gen, (4096,), K, device)
    y = torch.tensor([30.0, -30.0, 90.0, -90.0], device=device).repeat(1024)
    cases["wide"] = (y, pi, mu, ls * 6.0)
    _, pi, mu, ls = mixture_inputs(gen, (4096,), K, device)
    y = torch.randn(4096, generator=gen, device=device) * 10.0
    cases["peaked"] = (y, pi * 50.0, mu * 30.0, ls * 60.0)
    _, pi, mu, ls = mixture_inputs(gen, (4096,), K, device)
    mag = 10.0 ** (5.0 + 2.7 * torch.rand(4096, generator=gen,
                                          device=device))
    y = mag * torch.tensor([1.0, -1.0], device=device).repeat(2048)
    cases["far"] = (y, pi * 1e6, mu * 1e6, ls * 1e6)
    return cases


def coloring_inverse_cases(seed: int, device) -> dict:
    """#1's cases on the graph-coloring path, drawn as ``inverse_cases``
    draws them: a sampling chunk of 256 graphs (M = 10,240) and a /sample
    of 4 (M = 160)."""
    import torch
    gen = torch.Generator(device).manual_seed(seed)
    return {"chunk": inverse_case(gen, COLORING_SHAPE, K, device, True),
            "sample4": inverse_case(gen, (4,) + COLORING_SHAPE[1:], K,
                                    device, True)}


def fp64_reference(task_args: dict, state: dict):
    """The port's plain path on the CPU in float64 throughout: the set task
    of ``task_args`` in compute dtype float64, its model cast to float64
    and loaded with ``state`` (an fp32 model's)."""
    from categoricalnf_tpu_torch.inference import build_task
    ref = build_task("set_shuffling", {**task_args,
                                       "compute_dtype": "float64"},
                     device="cpu")
    ref.model.double()
    ref.model.load_state_dict(state)
    return ref


def step_grads(task, x, noise, beta: float = 0.7) -> dict:
    """The gradients of one train step's loss on batch ``x`` with the
    encoder's uniforms ``noise`` (moved to the task's device), by
    parameter name."""
    task.model.zero_grad(set_to_none=True)
    task.loss({"x": x}, beta, noise=noise.to(task.device)).backward()
    return {k: p.grad for k, p in task.model.named_parameters()}


def train_step_readings(seed: int):
    """One fp32 train step of the flagship at full width (64 sets, shared
    noise, beta 0.7) three ways, the kernels on the card, the plain path on
    the card and the plain path on the CPU, against the same step in
    float64 (``fp64_reference``).  Returns (readings, unchecked, launches):
    per tensor with a gradient in the fp64 step, (e_cpu, e_plain, e_kern,
    control) as ``train_step_failures`` takes them; the readings the check
    held before (the kernels and the plain path on the card against the CPU
    fp32 step, the kernels against the plain path on the card), by reading
    and tensor; and the launches of the kernels' step.  Checks that every
    such tensor gets a non-zero gradient from the kernels."""
    import numpy as np
    import torch
    from categoricalnf_tpu_torch.inference import build_task
    from categoricalnf_tpu_torch.ops.numerics import uniform_noise
    from categoricalnf_tpu_torch.utils.config import load_config

    a = load_config(os.path.join(REPO, "runs", "set16"))["args"]
    args = {**a, "seed": seed, "compute_dtype": "float32"}
    cpu = build_task("set_shuffling", args, device="cpu")
    gpu = build_task("set_shuffling", args, device="cuda")
    # the 64 sets this check's rules (a)-(c) were read on: numpy's argsort
    # of uniforms, the port's draw before its set tasks took the reference's
    # native generator; on the reference's sets at --seed + 1, rule (b)
    # refuses the unchanged kernels as it refuses all arithmetic but the
    # plain path's (ROADMAP C3, C4)
    x = np.argsort(np.random.default_rng(seed + 3).random((64, S)), axis=1)
    cpu.data_init({"x": x}, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        g = torch.Generator().manual_seed(seed + 4)
        for name, p in cpu.model.named_parameters():
            if name.endswith("net.out.w"):  # zero output layers: identity
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    gpu.model.load_state_dict(cpu.model.state_dict())
    ref = fp64_reference(args, cpu.model.state_dict())
    noise = uniform_noise((64, S, D), generator=torch.Generator()
                          .manual_seed(seed + 5))
    exact = step_grads(ref, x, noise.double())
    cpu32 = step_grads(cpu, x, noise)

    reset_launches()
    kern = step_grads(gpu, x, noise)
    torch.cuda.synchronize()
    launches = read_launches()
    with plain_path_on_card():
        plain = step_grads(gpu, x, noise)
    readings, old = {}, {"kernels_vs_cpu": {}, "plain_card_vs_cpu": {},
                         "kernels_vs_plain_card": {}}
    for name, want in exact.items():
        if want is None or not want.abs().max() > 0:
            continue
        gk, gp = kern[name], plain[name]
        check(gk is not None and bool(gk.abs().max() > 0),
              f"{name} has a gradient in the fp64 step and none from the "
              "kernels")
        gk, gp, gc = gk.cpu(), gp.cpu(), cpu32[name]
        readings[name] = (rel_err(gc.double(), want),
                          rel_err(gp.double(), want),
                          rel_err(gk.double(), want),
                          rel_err(gk.bfloat16().double(), want))
        old["kernels_vs_cpu"][name] = rel_err(gk, gc)
        old["plain_card_vs_cpu"][name] = rel_err(gp, gc)
        old["kernels_vs_plain_card"][name] = rel_err(gk, gp)
    nets = sum(1 for k in kern if k.endswith("net.out.w"))
    check(len(readings) > 20 * nets,
          f"only {len(readings)} parameters got a gradient")
    return readings, old, launches


def check_train_step_against_cpu(seed: int, report: dict) -> dict:
    """The fp32 train step's gradients (``train_step_readings``) held per
    tensor against the fp64 step by rules (a)-(c) of
    ``train_step_failures``; prints the readings into ``report``, the
    tensors whose limits are above their floors, and, unchecked, the
    readings the check held before.  Returns the launches of the kernels'
    step."""
    readings, old, launches = train_step_readings(seed)

    def worst(i):
        name = max(readings, key=lambda k: readings[k][i])
        return readings[name][i], name

    # tensors whose limit is above its floor, by rule
    raised_a = sorted(k for k, r in readings.items() if 2 * r[0] > FP64_REL)
    raised_b = sorted(k for k, r in readings.items()
                      if 2 * r[1] > KERNELS_VS_PLAIN_CARD)
    control = [r[3] for r in readings.values()]
    report.update(seed=seed, n_gradients=len(readings))
    for i, key in enumerate(("cpu_f32_vs_fp64", "plain_card_vs_fp64",
                             "kernels_vs_fp64")):
        report[key], report[f"{key}_worst"] = worst(i)
        report[f"{key}_median"] = statistics.median(
            r[i] for r in readings.values())
    report.update(
        limit_a_raised=raised_a, limit_b_raised=raised_b,
        bf16_rounded_vs_fp64_min=min(control),
        bf16_rounded_vs_fp64_median=statistics.median(control),
        unchecked={k: max(v.values()) for k, v in old.items()},
        unchecked_worst={k: max(v, key=v.get) for k, v in old.items()})
    print(f"train step (fp32, 64 sets, seed {seed}) against the fp64 "
          "step: " + json.dumps(report), flush=True)
    print(f"  {len(raised_a)} tensor(s) take a limit (a) above {FP64_REL}: "
          f"{raised_a}; {len(raised_b)} a limit (b) above "
          f"{KERNELS_VS_PLAIN_CARD}: {raised_b}", flush=True)
    failed = train_step_failures(readings)
    check(not failed, "fp32 train step against the fp64 step: "
          + "; ".join(failed))
    return launches


@contextlib.contextmanager
def implicit_inverse_on_cpu():
    """Differentiates the inverse of a CPU tensor by the implicit rule
    (``numerics.ImplicitInverse``, the exact derivative, on no path of the
    port) instead of through the loop: the control of the vardeq step's
    check; a CUDA tensor still goes to ``MixtureInverse``."""
    from categoricalnf_tpu_torch.ops import dispatch
    from categoricalnf_tpu_torch.ops import numerics as nm
    card = dispatch.mixture_inverse

    def inverse(y, *params):
        return card(y, *params) if y.is_cuda else \
            nm.ImplicitInverse.apply(y, *params)

    dispatch.mixture_inverse = inverse
    try:
        yield
    finally:
        dispatch.mixture_inverse = card


@contextlib.contextmanager
def numpy_set_batches():
    """The set tasks' numpy draws in place of their native generator (its
    fallback, as where the library cannot be built)."""
    from categoricalnf_tpu_torch.data import corpus
    saved = corpus._lib, corpus._tried
    corpus._lib, corpus._tried = None, True
    try:
        yield
    finally:
        corpus._lib, corpus._tried = saved


def check_vardeq_step_against_cpu(seed: int, report: dict) -> dict:
    """One fp32 train step of runs/sum_vardeq at full width (64 sets,
    shared noise, beta 0.7, random output layers in every coupling net and
    conditional affine) on the card, the kernels with #1' (the reference's
    rule, the loop-rule kernel) for the encoder's inverse, against the same
    step on the CPU through the inverse's loop.  A tensor outside the
    encoder, whose gradient does not pass through the inverse, is held to
    the step in float64 (the encoder's dense layers stay fp32, as the task
    builds them) within max(FP64_REL, 2 e_cpu), e_cpu the CPU fp32 step's
    own error, as rule (a) of the flagship's step.  An encoder tensor
    follows each element's bisections, which one ulp sends another way, so
    float64 (whose loop ends unclipped, near the implicit rule) cannot
    judge it: it is held to the CPU fp32 step, the kernels within
    max(FP64_REL, 2 e_plain) of it, e_plain the plain path's on the card
    (the same loop in PyTorch, ``plain_path_on_card``), as rule (b): the
    coarse check of the step from end to end.  The close check of #1' is
    elementwise: each encoder tensor of the kernels' step within
    INV_LOOP_REL plus INV_LOOP_FLOOR of its largest magnitude of the plain
    path's on the card on at least INV_LOOP_SHARE of its elements
    (``near_share``).  The control, the CPU fp32 step with the implicit
    rule (``implicit_inverse_on_cpu``), must read over rule (b)'s limit on
    some encoder tensor.  Returns the launches of the card's step."""
    import numpy as np
    import torch
    from categoricalnf_tpu_torch.flows.cond_affine import ConditionalAffine
    from categoricalnf_tpu_torch.inference import build_task
    from categoricalnf_tpu_torch.ops.numerics import uniform_noise
    from categoricalnf_tpu_torch.utils.config import load_config

    a = load_config(os.path.join(REPO, "runs", "sum_vardeq"))["args"]
    args = {**a, "seed": seed, "compute_dtype": "float32"}
    cpu = build_task("set_summation", args, device="cpu")
    gpu = build_task("set_summation", args, device="cuda")
    ref = build_task("set_summation", {**args, "compute_dtype": "float64"},
                     device="cpu")
    # the 64 sequences this check's rule was read on: the numpy draw, which
    # the native generator replaces in training
    with numpy_set_batches():
        x = cpu._gen(np.random.default_rng(seed + 3), 64)
    cpu.data_init({"x": x}, generator=torch.Generator().manual_seed(seed))
    randomize_coupling_nets(cpu.model, seed + 4)
    g = torch.Generator().manual_seed(seed + 6)
    with torch.no_grad():
        for m in cpu.model.modules():
            if isinstance(m, ConditionalAffine):
                m.fc2.w.copy_(torch.randn(m.fc2.w.shape, generator=g) * 0.05)
    gpu.model.load_state_dict(cpu.model.state_dict())
    ref.model.double()
    ref.model.load_state_dict(cpu.model.state_dict())
    noise = uniform_noise((64, S, 1), generator=torch.Generator()
                          .manual_seed(seed + 5))
    exact = step_grads(ref, x, noise.double())
    cpu32 = step_grads(cpu, x, noise)
    with implicit_inverse_on_cpu():
        implicit = step_grads(cpu, x, noise)
    reset_launches()
    kern = step_grads(gpu, x, noise)
    torch.cuda.synchronize()
    launches = read_launches()
    with plain_path_on_card():
        plain = step_grads(gpu, x, noise)
    for name in ("mixture_inverse", "mixture_inverse_loop_bwd",
                 "fused_set_transformer_train_f32",
                 "fused_set_transformer_bwd_f32"):
        check(launches[name] > 0, f"the vardeq step did not launch {name}")
    check(launches["mixture_inverse_bwd"] == 0,
          "the vardeq step launched the implicit rule")
    outside, encoder, failed, control_over = {}, {}, [], []
    for name, want in exact.items():
        if want is None or not want.abs().max() > 0:
            continue
        gk = kern[name]
        check(gk is not None and bool(gk.abs().max() > 0),
              f"{name} has a gradient in the fp64 step and none on the card")
        gk, gp, gc = gk.cpu().double(), plain[name].cpu().double(), \
            cpu32[name].double()
        if name.startswith("encoding."):
            e_plain, e_kern = rel_err(gp, gc), rel_err(gk, gc)
            e_impl = rel_err(implicit[name].double(), gc)
            encoder[name] = (e_plain, e_kern, e_impl,
                             rel_err(gc, want.double()), near_share(gk, gp))
            limit = max(FP64_REL, 2 * e_plain)
            if not e_kern <= limit:
                failed.append(f"{name}: card {e_kern} from the CPU step, "
                              f"over {limit}")
            if e_impl > limit:
                control_over.append(name)
            continue
        e_cpu = rel_err(gc, want)
        e_kern = rel_err(gk, want)
        outside[name] = (e_cpu, e_kern)
        limit = max(FP64_REL, 2 * e_cpu)
        if not e_kern <= limit:
            failed.append(f"{name}: card {e_kern} from the fp64 step, over "
                          f"{limit}")
    check(len(encoder) > 10 and len(outside) > 10,
          f"only {len(encoder)} encoder and {len(outside)} other parameters "
          "got a gradient")

    def worst(d, i):
        name = max(d, key=lambda k: d[k][i])
        return d[name][i], name

    report.update(seed=seed, n_gradients=len(outside) + len(encoder))
    for i, key in enumerate(("cpu_f32_vs_fp64", "card_vs_fp64")):
        report[key], report[f"{key}_worst"] = worst(outside, i)
    for i, key in enumerate(("encoder_plain_card_vs_cpu",
                             "encoder_card_vs_cpu",
                             "encoder_implicit_control_vs_cpu",
                             "encoder_cpu_f32_vs_fp64")):
        report[key], report[f"{key}_worst"] = worst(encoder, i)
    report["encoder_implicit_control_min"] = min(
        v[2] for v in encoder.values())
    # the close check of #1' in the step: each encoder tensor elementwise
    # against the plain path on the same card (both take the plain loop's
    # branches), by inverse_bwd_readings' rule
    shares = {k: v[4] for k, v in encoder.items()}
    report["encoder_card_vs_plain_card_share_min"] = min(shares.values())
    report["encoder_card_vs_plain_card_share_worst"] = min(shares,
                                                           key=shares.get)
    report["control_over_limit"] = len(control_over)
    print(f"vardeq train step (fp32, 64 sets, seed {seed}), the loop rule "
          "on both devices: " + json.dumps(report), flush=True)
    check(not failed, "vardeq train step against the CPU: "
          + "; ".join(failed))
    check(min(shares.values()) >= INV_LOOP_SHARE, "vardeq train step: an "
          "encoder tensor off the plain path on the card by the elementwise "
          f"rule: {shares}")
    check(control_over, "the implicit-rule control reads within the limit "
          "on every encoder tensor: the check cannot tell the two rules")
    return launches


def tensor_core_instructions(source: str) -> dict:
    """HMMA instructions in the SASS of ``csrc/<source>.cu``'s library, by
    the function (``cuobjdump -sass``'s ``Function :`` sections) that holds
    them."""
    from categoricalnf_tpu_torch.ops.cuda import build
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    out = subprocess.run(
        [os.path.join(cuda_home, "bin", "cuobjdump"), "-sass",
         build.library_path(source)], capture_output=True, text=True,
        timeout=300, check=True).stdout
    counts: dict = {}
    function = None
    for line in out.splitlines():
        if "Function :" in line:
            function = line.split("Function :", 1)[1].strip()
            counts.setdefault(function, 0)
        elif "HMMA" in line and function is not None:
            counts[function] += 1
    return counts


def kernel_resources(log: str) -> dict:
    """Registers and spilled bytes (stores and loads) of each entry function
    of an nvcc build log (``-Xptxas -v``), by mangled name; the spills are
    the entry's and those of the functions it calls that are not inlined
    (the FMA backward's ``wgrad_tile``), listed in its section."""
    out: dict = {}
    function = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            function = line.split("'")[1]
            out[function] = {"spill_bytes": 0}
        elif function and "spill stores" in line:
            _, stores, loads = re.findall(r"(\d+) bytes", line)
            out[function]["spill_bytes"] += int(stores) + int(loads)
        elif function and "registers" in line:
            out[function]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    return out


def warps_by_registers(registers: int, threads: int) -> int:
    """Warps an SM can hold with ``registers`` a thread in blocks of
    ``threads`` (65,536 registers an SM, allocated 256 a warp at a time; at
    most 2,048 threads and 32 blocks an SM): the occupancy the registers
    allow, not a measured one."""
    per_warp = -(-registers * 32 // 256) * 256
    blocks = min(65536 // (per_warp * threads // 32), 2048 // threads, 32)
    return blocks * threads // 32


# Lanes an element of the mixture forward, its backward and the inverse at
# K <= 8, and threads a block, as csrc/mixture.cu launches them (kFwdLanes,
# kBwdLanes, kInvLanes, kThreads); with K = 8 a lane holds 8 / lanes
# components
MIX_FWD_LANES, MIX_BWD_LANES, MIX_INV_LANES, MIX_THREADS = 2, 4, 1, 256


def mixture_entry(res: dict, kernel: str, g: int, c: int) -> dict:
    """ptxas's registers and spills of ``kernel``'s instance of ``g`` lanes
    of ``c`` components, built for full groups, from ``kernel_resources``,
    and the warps an SM they allow."""
    tag = f"{kernel}ILi{g}ELi{c}ELb1E"
    hits = [v for f, v in res.items() if tag in f]
    check(len(hits) == 1, f"no ptxas line for {tag} in mixture.cu's log")
    return dict(hits[0], lanes=g, components_per_lane=c,
                warps_per_sm_by_registers=warps_by_registers(
                    hits[0]["registers"], MIX_THREADS))


def fused_bwd_resources(log: str) -> dict:
    """ptxas's registers and spills of #4 bf16's three instances (the
    residual copies in shared memory, in global memory, and the one for
    sets above 32: ``fused_set_transformer_bwd<GLOBAL_H, BIG>``) and of the
    global one's ``wgrad_tiles`` by the report entries that launch them."""
    res = kernel_resources(log)
    out = {}
    for tag, names in (("11wgrad_tiles", ("wgrad_tiles_bf16",)),
                       ("fused_set_transformer_bwdILb0ELb0E",
                        ("fused_set_transformer_bwd_bf16",
                         "fused_set_transformer_bwd_bf16_molecules")),
                       ("fused_set_transformer_bwdILb1ELb0E",
                        ("fused_set_transformer_bwd_bf16_global_h",)),
                       ("fused_set_transformer_bwdILb0ELb1E",
                        tuple(f"fused_set_transformer_bwd_bf16_set{s}"
                              for s in BIG_SET_TIMED))):
        hits = [v for f, v in res.items() if tag in f]
        check(len(hits) == 1, f"no ptxas line for {tag} in "
              "fused_transformer_bf16.cu's log")
        out.update({name: hits[0] for name in names})
    return out


def big_set_resources(logs: dict) -> dict:
    """ptxas's registers and spills of the forwards' instances for sets
    above 32 (``fused_set_transformer_fwd<true>``, bf16;
    ``fused_set_transformer_fwd_tf32x3<true>``, fp32) by the report
    entries that launch them."""
    out = {}
    for source, tag, name in (
            ("fused_transformer_bf16", "fused_set_transformer_fwdILb1E",
             "fused_set_transformer_bf16"),
            ("fused_transformer_tf32x3",
             "fused_set_transformer_fwd_tf32x3ILb1E",
             "fused_set_transformer_f32")):
        hits = [v for f, v in kernel_resources(logs[source]).items()
                if tag in f]
        check(len(hits) == 1, f"no ptxas line for {tag} in {source}.cu's "
              "log")
        out.update({f"{name}_set{s}": hits[0] for s in BIG_SET_TIMED})
    return out


def fma_pair_resources(log: str) -> dict:
    """ptxas's registers and spills of the fp32 train step's pair (the
    logs of csrc/fused_transformer.cu, the forward and the backward with
    its tile all in shared memory, and of csrc/fused_transformer_f32_ws.cu,
    the backward with regions in the global workspace) by the report
    entries that launch them, and the blocks an SM its launch bounds and
    registers allow."""
    res = kernel_resources(log)
    out = {}
    for tag, names in (("fused_set_transformer_fwdILb0E",
                        ("fused_set_transformer_train_f32",)),
                       ("fused_set_transformer_bwdILb0ELb0E",
                        ("fused_set_transformer_bwd_f32",)),
                       ("fused_set_transformer_bwdILb1ELb0E",
                        ("fused_set_transformer_bwd_f32_global_h",
                         "fused_set_transformer_bwd_f32_global_h_moses"))):
        hits = [v for f, v in res.items() if tag in f]
        check(len(hits) == 1, f"no ptxas line for {tag} in the fp32 "
              "pair's logs")
        out.update({name: dict(hits[0], warps_per_sm_by_registers=
                               warps_by_registers(hits[0]["registers"], 256))
                    for name in names})
    return out


def fma_big_resources(log: str) -> dict:
    """ptxas's registers and spills of the fp32 pair's instances for sets
    above 32 (csrc/fused_transformer_f32_big.cu: ``fused_set_transformer_
    fwd<true>`` and ``fused_set_transformer_bwd<false, true>``, with their
    ``__noinline__`` callees' spills) by the report entries that launch
    them."""
    res = kernel_resources(log)
    out = {}
    for tag, name in (("fused_set_transformer_fwdILb1E", FP32_BIG_PAIR[0]),
                      ("fused_set_transformer_bwdILb0ELb1E",
                       FP32_BIG_PAIR[1])):
        hits = [v for f, v in res.items() if tag in f]
        check(len(hits) == 1, f"no ptxas line for {tag} in "
              "fused_transformer_f32_big.cu's log")
        out.update({f"{name}{suffix}": hits[0]
                    for suffix in ("", *(f"_set{s}" for s in BIG_SET_TIMED))})
    return out


def mixture_resources(log: str) -> dict:
    """ptxas's registers and spills of the three mixture kernels as the
    flagship's K = 8 launches them, and the warps an SM they allow."""
    res = kernel_resources(log)
    out = {name: mixture_entry(res, f"{name}_kernel", g, K // g)
           for name, g in (("mixture_forward", MIX_FWD_LANES),
                           ("mixture_forward_bwd", MIX_BWD_LANES),
                           ("mixture_inverse", MIX_INV_LANES))}
    out["mixture_forward_eval"] = out["mixture_forward"]
    # #1' at the encoders' K = 4, one thread an element
    hits = [v for f, v in res.items()
            if "mixture_inverse_loop_bwd_kernelILi4E" in f]
    check(len(hits) == 1, "no ptxas line for mixture_inverse_loop_bwd")
    out["mixture_inverse_loop_bwd"] = dict(
        hits[0], warps_per_sm_by_registers=warps_by_registers(
            hits[0]["registers"], MIX_THREADS))
    return out


# Relative norm error allowed between the bf16 forward and plain_forward
# (the kernel and the plain path round after sums in another order); it
# read 0.00116 here on an H100 80GB HBM3 at 700 W
BF16_FWD_REL = 0.01

SOURCE_NAMES = ["mixture", "fused_transformer", "fused_transformer_f32_ws",
                "fused_transformer_bf16", "fused_transformer_tf32x3",
                "fused_transformer_f32_big"]
SOURCES = {
    "mixture_inverse": ("categoricalnf_tpu_torch/csrc/mixture.cu",
                        "categoricalnf_tpu/ops/pallas/mixture.py:137"),
    "mixture_forward": ("categoricalnf_tpu_torch/csrc/mixture.cu",
                        "categoricalnf_tpu/ops/pallas/mixture.py:196"),
    "fused_set_transformer_bf16": (
        "categoricalnf_tpu_torch/csrc/fused_transformer_bf16.cu",
        "categoricalnf_tpu/ops/pallas/fused_transformer.py:286"),
    "fused_set_transformer_f32": (
        "categoricalnf_tpu_torch/csrc/fused_transformer_tf32x3.cu",
        "categoricalnf_tpu/ops/pallas/fused_transformer.py:286"),
    # no Pallas counterpart: the reference differentiates the plain math of
    # mixture_forward_pallas's reference with XLA
    "mixture_forward_bwd": ("categoricalnf_tpu_torch/csrc/mixture.cu",
                            "categoricalnf_tpu/ops/pallas/mixture.py:196"),
    "fused_set_transformer_bwd_bf16": (
        "categoricalnf_tpu_torch/csrc/fused_transformer_bf16.cu",
        "categoricalnf_tpu/ops/pallas/fused_transformer.py:303"),
    # #4 bf16 with the residual copies in global memory: the instance that
    # the nets of hidden 256 launch (runs/moses, molecules_v5-v7)
    "fused_set_transformer_bwd_bf16_global_h": (
        "categoricalnf_tpu_torch/csrc/fused_transformer_bf16.cu",
        "categoricalnf_tpu/ops/pallas/fused_transformer.py:303"),
    "fused_set_transformer_bwd_f32": (
        "categoricalnf_tpu_torch/csrc/fused_transformer.cu",
        "categoricalnf_tpu/ops/pallas/fused_transformer.py:303"),
    # the GLOBAL_H instance's weight gradients, from its operand images: the
    # sum that _bwd_kernel keeps in its resident output blocks
    "wgrad_tiles_bf16": (
        "categoricalnf_tpu_torch/csrc/fused_transformer_bf16.cu",
        "categoricalnf_tpu/ops/pallas/fused_transformer.py:303"),
    # #4 fp32 with regions of its tile in a global workspace: the instance
    # that the nets of hidden 192 and 256 launch in fp32 (molecules_v3-v7,
    # moses)
    "fused_set_transformer_bwd_f32_global_h": (
        "categoricalnf_tpu_torch/csrc/fused_transformer.cu",
        "categoricalnf_tpu/ops/pallas/fused_transformer.py:303"),
    # #3 in fp32 with grad: the FMA forward that the fp32 backward recomputes
    "fused_set_transformer_train_f32": (
        "categoricalnf_tpu_torch/csrc/fused_transformer.cu",
        "categoricalnf_tpu/ops/pallas/fused_transformer.py:286"),
    # the fp32 train step's pair at sets of 33-128, a set over a cluster
    "fused_set_transformer_train_f32_big": (
        "categoricalnf_tpu_torch/csrc/fused_transformer_f32_big.cu",
        "categoricalnf_tpu/ops/pallas/fused_transformer.py:286"),
    "fused_set_transformer_bwd_f32_big": (
        "categoricalnf_tpu_torch/csrc/fused_transformer_f32_big.cu",
        "categoricalnf_tpu/ops/pallas/fused_transformer.py:303"),
    # #1' has no Pallas counterpart either: it takes the place of XLA's
    # reverse mode through the reference's inverse loop, the same rule
    "mixture_inverse_loop_bwd": ("categoricalnf_tpu_torch/csrc/mixture.cu",
                                 "categoricalnf_tpu/ops/numerics.py:158"),
}
# what a mixture kernel's line adds: its lanes, registers and spills; the
# inverse's also its ms at a /sample of 4 sets, its domain and residual
MIX_KEYS = ("ms_m256", "design", "lanes", "components_per_lane",
            "registers", "spill_bytes", "warps_per_sm_by_registers",
            "residual_ratio", "iterations_mean")
# the entries of the coloring path's shapes (``check_coloring_kernels``)
# that a kernel's line carries, and their keys
COLORING_REPORTS = {
    "mixture_forward": ["mixture_forward_coloring"],
    "mixture_forward_bwd": ["mixture_forward_bwd_coloring"],
    "mixture_inverse": ["mixture_inverse_coloring",
                        "mixture_inverse_coloring_m160"]}
COLORING_KEYS = ("m", "ms", "plain_ms", "bound_ms", "bound_by",
                 "max_abs_err")
# the entries of the dequantized set flows' shapes
# (``check_set_modeling_kernels``) that a kernel's line carries
SET_MODELING_REPORTS = {
    "mixture_forward": ["mixture_forward_decoder"],
    "mixture_inverse": ["mixture_inverse_encoder_vardeq",
                        "mixture_inverse_encoder_linear_flows"],
    "mixture_inverse_loop_bwd": ["mixture_inverse_loop_bwd_vardeq"],
    "fused_set_transformer_bf16": ["fused_set_transformer_bf16_vardeq"],
    "fused_set_transformer_bwd_bf16": [
        "fused_set_transformer_bwd_bf16_vardeq"]}
SET_MODELING_KEYS = ("ms", "host_ms", "plain_ms", "bound_ms", "bound_by",
                     "max_abs_err")
# the entries of the set-64 and set-128 runs' shapes
# (``check_big_set_kernels``) that a kernel's line carries, and their keys
BIG_SET_REPORTS = {
    name: [f"{name}_set{s}" for s in BIG_SET_TIMED]
    for name in ("fused_set_transformer_bf16",
                 "fused_set_transformer_bwd_bf16",
                 "fused_set_transformer_f32") + FP32_BIG_PAIR}
BIG_SET_KEYS = ("rows", "cluster", "tile", "smem", "grid", "ms", "host_ms",
                "plain_ms", "bound_ms", "bound_by", "max_abs_err", "rel_err",
                "registers", "spill_bytes", "max_active_clusters",
                "allclose_err", "fp64")
# the entries of the LM path's shapes at K = 32 (``check_lm_kernels``)
# that a kernel's line carries, and their keys
LM_REPORTS = {name: [f"{name}_lm_{shape}" for shape in
                     ("density", "m512", "m16")]
              for name in ("mixture_forward", "mixture_forward_bwd",
                           "mixture_inverse")}
LM_REPORT_KEYS = ("m", "ms", "host_ms", "plain_ms", "bound_ms", "bound_by",
                  "max_abs_err", "lanes", "components_per_lane",
                  "registers", "spill_bytes", "warps_per_sm_by_registers",
                  "residual_ratio", "iterations_mean")
# the masked kernels' entries at the node flow's shapes
# (``check_molecule_kernels``) that a kernel's line carries, and their keys
MOLECULE_REPORTS = {
    name: [f"{name}_molecules"] for name in (
        "fused_set_transformer_bf16", "fused_set_transformer_bwd_bf16",
        "fused_set_transformer_f32")}
MOLECULE_REPORTS["fused_set_transformer_bf16"].append(
    "fused_set_transformer_bf16_moses")
# the fp32 train step's pair with the key mask at runs/molecules' shape and
# at the wide ones, molecules_v4's and moses's (``check_masked_f32_pair``)
MOLECULE_REPORTS.update({
    "fused_set_transformer_train_f32": [
        f"fused_set_transformer_train_f32_{run}"
        for run in ("molecules", *FP32_WIDE_NODE_CASES)],
    "fused_set_transformer_bwd_f32": [
        "fused_set_transformer_bwd_f32_molecules",
        "fused_set_transformer_bwd_f32_global_h",
        "fused_set_transformer_bwd_f32_global_h_moses"]})
# what a fused kernel's line adds: ptxas's registers and spills, its tile
# and shared memory, the backward's grid, scratch and residual workspace,
# the readings of its masked check
FUSED_KEYS = ("registers", "spill_bytes", "tile", "smem", "grid",
              "blocks_per_sm", "warps_per_sm_by_registers", "scratch_mb",
              "images_mb", "workspace_mb", "regions", "rel_err",
              "control_rel_err", "matrices_within", "biases_within",
              "layout_bitwise_at_192", "layout_bitwise_at_96_128")
MOLECULE_REPORT_KEYS = ("ms", "host_ms", "plain_ms", "bound_ms", "bound_by",
                        "max_abs_err", "rel_err", "control_rel_err")
SERVING_KERNELS = ("mixture_inverse", "mixture_forward",
                   "fused_set_transformer_bf16", "fused_set_transformer_f32")
# the path whose launches each kernel's line reports
PATH_OF = {**{k: "serving" for k in SERVING_KERNELS},
           "mixture_forward_bwd": "training",
           "fused_set_transformer_bwd_bf16": "training",
           "fused_set_transformer_bwd_bf16_global_h": "moses_training",
           "wgrad_tiles_bf16": "moses_training",
           "fused_set_transformer_bwd_f32": "set16_fp32_training",
           "fused_set_transformer_train_f32": "set16_fp32_training",
           "fused_set_transformer_bwd_f32_global_h":
               "molecules_v4_fp32_training",
           **{k: "set64_fp32_training" for k in FP32_BIG_PAIR},
           "mixture_inverse_loop_bwd": "set_summation_training"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and inputs; the fp32 train "
                    "step's check runs at this seed and the next, and only "
                    "the default 0 is known to pass it (ROADMAP.md, "
                    "Queue C)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "categoricalnf_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repo",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from categoricalnf_tpu_torch.ops.cuda import build
    from categoricalnf_tpu_torch.utils.device import resolve_device

    t_start = time.perf_counter()
    # the seconds of each phase, from the end of the one before
    phase_s: dict = {}
    t_lap = [t_start]

    def lap(phase: str) -> None:
        now = time.perf_counter()
        phase_s[phase] = now - t_lap[0]
        t_lap[0] = now

    card = card_line()
    print(card, flush=True)  # name, power limit: as nvidia-smi gives them
    t0 = time.perf_counter()
    logs = build.build_all(SOURCE_NAMES)
    print(f"built kernels in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill",
                                       "error")):
                print(f"  {name}: {line.strip()}", flush=True)
    hmma = tensor_core_instructions("fused_transformer_bf16")
    for function, n in hmma.items():
        print(f"  fused_transformer_bf16: {n} HMMA in {function}", flush=True)
    for kernel in ("fused_set_transformer_fwd", "fused_set_transformer_bwd"):
        n = sum(v for k, v in hmma.items() if kernel in k)
        print(f"{kernel}_bf16: {n} HMMA instructions in the SASS of "
              "fused_transformer_bf16.cu", flush=True)
        check(n > 0, f"{kernel} (bf16) has no tensor-core instruction")
    hmma = tensor_core_instructions("fused_transformer_tf32x3")
    for function, n in hmma.items():
        print(f"  fused_transformer_tf32x3: {n} HMMA in {function}",
              flush=True)
    n = sum(v for k, v in hmma.items() if "fused_set_transformer_fwd" in k)
    print(f"fused_set_transformer_fwd_f32: {n} HMMA instructions in the SASS "
          "of fused_transformer_tf32x3.cu", flush=True)
    check(n > 0, "the fp32 forward has no tensor-core instruction")
    lap("build")

    device = resolve_device("cuda")
    gen = torch.Generator(device).manual_seed(args.seed)
    report: dict = {}
    check_mixture(device, gen, report)
    check_inverse(device, (args.seed, args.seed + 1), report)
    check_fused(device, gen, report)
    check_mixture_bwd(device, gen, report)
    check_fused_bwd(device, gen, report)
    check_train_fwd(device, gen, report)
    check_coloring_kernels(device, (args.seed, args.seed + 1), report)
    check_set_modeling_kernels(device, (args.seed, args.seed + 1), report)
    check_lm_kernels(device, (args.seed, args.seed + 1), report)
    check_molecule_kernels(device, (args.seed, args.seed + 1), report)
    check_big_set_kernels(device, (args.seed, args.seed + 1), report)
    lap("kernel_checks")
    check_masked_f32_pair(device, (args.seed, args.seed + 1), report)
    lap("masked_f32_pair_checks")
    for name, r in {**mixture_resources(logs["mixture"]),
                    **lm_mixture_resources(logs["mixture"]),
                    **fused_bwd_resources(logs["fused_transformer_bf16"]),
                    **big_set_resources(logs),
                    **fma_pair_resources(logs["fused_transformer"]
                                         + logs["fused_transformer_f32_ws"]),
                    **fma_big_resources(logs["fused_transformer_f32_big"])
                    }.items():
        report[name].update(r)
    for r in report.values():
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / PEAK_FLOPS[r["dtype"]] * 1e3
        if "tc_ops" in r:  # the fp32 forward: the lesser of its two bounds
            r["bound_fma_ms"] = max(t_bytes, t_ops)
            t_ops = min(t_ops, r["tc_ops"] / PEAK_FLOPS["tf32"] * 1e3)
            r["bound_tf32x3_ms"] = max(t_bytes, r["tc_ops"]
                                       / PEAK_FLOPS["tf32"] * 1e3)
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    for name, r in report.items():
        size = f"M={r['m']}" if "m" in r else f"rows={r['rows']}"
        print(f"{name} ({size}): kernel {r['ms']!r} ms (host "
              f"{r['host_ms']!r} ms a call), plain {r['plain_ms']!r} ms, "
              f"bound {r['bound_ms']!r} ms ({r['bound_by']}), max abs err "
              f"{r['max_abs_err']:.3g}"
              + (f", relative error {r['rel_err']:.3g}" if "rel_err" in r
                 else "")
              + (f", scratch {r['scratch_mb']:.1f} MB" if "scratch_mb" in r
                 else "")
              + (f", tile {r['tile']} rows, {r['smem']} B of shared memory, "
                 f"{r['blocks_per_sm']} block(s) an SM" if "tile" in r
                 else "")
              + (f", bounds {r['bound_fma_ms']!r} ms on the FMA units and "
                 f"{r['bound_tf32x3_ms']!r} ms as 3xTF32" if "tc_ops" in r
                 else "")
              + (f", TF32 control {r['tf32_control_rel_err']:.3g}"
                 if "tf32_control_rel_err" in r else "")
              + (f", without the mask {r['control_rel_err']:.3g}"
                 if "control_rel_err" in r else "")
              + (f", scratch written {r['scratch_written_mb']:.1f} MB and "
                 "read as much" if "scratch_written_mb" in r else "")
              + (f", operand images {r['images_mb']:.2f} MB"
                 if "images_mb" in r else "")
              + (f", grid {r['grid']}" if "grid" in r else "")
              + (f", residual workspace {r['workspace_mb']:.2f} MB"
                 if "workspace_mb" in r and "regions" not in r else "")
              + (f", in global memory {r['regions']} (workspace "
                 f"{r['workspace_mb']:.2f} MB)" if "regions" in r else "")
              + (f", {r['registers']} registers, {r['spill_bytes']} B "
                 "spilled" if "registers" in r and "lanes" not in r else "")
              + (f", {r['lanes']} lanes an element, {r['registers']} "
                 f"registers, {r['spill_bytes']} B spilled, "
                 f"{r['warps_per_sm_by_registers']} warps an SM by registers"
                 if "lanes" in r else "")
              + (f", {r['design']}, {r['ms_m256']!r} ms at M=256, "
                 f"worst residual {r['residual_ratio']:.3g} of its limit"
                 if "design" in r else "")
              + (f", {r['iterations_mean']:.3g} iterations an element"
                 if "iterations_mean" in r else ""), flush=True)

    timings: dict = {}
    launches = {"serving": serve_flagship(args.seed, timings)}
    print("serving: " + json.dumps(timings), flush=True)
    lap("serving")
    train_timings: dict = {}
    launches["training"] = train_flagship(args.seed, train_timings, card)
    print("training: " + json.dumps(train_timings), flush=True)
    lap("training")
    big_timings: dict = {}
    launches.update(big_set_phase(args.seed, big_timings, card))
    print("sets of 64 and 128: " + json.dumps(big_timings), flush=True)
    lap("big_sets")
    launches["train_step_fp32"] = check_train_step_against_cpu(args.seed,
                                                               {})
    check_train_step_against_cpu(args.seed + 1, {})
    for name in FP32_PAIR:
        check(launches["train_step_fp32"][name] > 0,
              f"the fp32 train step did not launch {name}")
    lap("fp32_train_step_checks")
    fp32_timings: dict = {}
    launches.update(fp32_training_phase(args.seed, fp32_timings, card))
    print("fp32 training: " + json.dumps(fp32_timings), flush=True)
    lap("fp32_training")
    fp32_timings = {}
    launches.update(fp32_big_set_phase(args.seed, fp32_timings, card))
    print("fp32 training at sets of 64 and 128: "
          + json.dumps(fp32_timings), flush=True)
    lap("fp32_big_sets")
    coloring_timings: dict = {}
    launches.update(coloring_phase(args.seed, coloring_timings, card))
    print("coloring: " + json.dumps(coloring_timings), flush=True)
    lap("coloring")
    set_timings: dict = {}
    launches.update(set_modeling_phase(args.seed, set_timings, card))
    print("set modeling: " + json.dumps(set_timings), flush=True)
    lap("set_modeling")
    launches["vardeq_train_step_fp32"] = check_vardeq_step_against_cpu(
        args.seed, {})
    lap("vardeq_train_step_check")
    lm_timings: dict = {}
    launches.update(lm_phase(args.seed, lm_timings, card))
    print("language modeling: " + json.dumps(lm_timings), flush=True)
    lap("language_modeling")
    lm_timings = {}
    launches.update(lm_phase(args.seed, lm_timings, card, net="transformer",
                             num_steps=LM_TRANSFORMER_STEPS))
    print("language modeling, transformer: " + json.dumps(lm_timings),
          flush=True)
    lap("language_modeling_transformer")
    mol_timings: dict = {}
    launches.update(molecule_phase(args.seed, mol_timings, card))
    print("molecules: " + json.dumps(mol_timings), flush=True)
    lap("molecules")
    parallel_timings: dict = {}
    launches.update(parallel_phase(args.seed, parallel_timings, card))
    print("parallel: " + json.dumps(parallel_timings), flush=True)
    lap("parallel")

    kernels = []
    for name, (src, replaces) in SOURCES.items():
        r = report[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[PATH_OF[name]][name],
            "path": PATH_OF[name],
            "launches_by_path": {p: n[name] for p, n in launches.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            **{key: r[key] for key in MIX_KEYS + FUSED_KEYS if key in r},
            **({"at_coloring_shapes": [
                {key: report[c][key] for key in COLORING_KEYS}
                for c in COLORING_REPORTS[name]]}
               if name in COLORING_REPORTS else {}),
            **({"at_set_modeling_shapes": [
                {"case": c, "size": report[c].get("m", report[c].get("rows")),
                 **{key: report[c][key] for key in SET_MODELING_KEYS}}
                for c in SET_MODELING_REPORTS[name]]}
               if name in SET_MODELING_REPORTS else {}),
            **({"at_lm_shapes": [
                {"case": c, **{key: report[c][key] for key in LM_REPORT_KEYS
                               if key in report[c]}}
                for c in LM_REPORTS[name]]}
               if name in LM_REPORTS else {}),
            **({"at_big_set_shapes": [
                {"case": c, **{key: report[c][key] for key in BIG_SET_KEYS
                               if key in report[c]}}
                for c in BIG_SET_REPORTS[name]],
                "launches_at_big_sets": {
                    p: n[name] for p, n in launches.items()
                    if p.startswith(("set64", "set128"))}}
               if name in BIG_SET_REPORTS else {}),
            **({"at_molecule_shapes": [
                {"case": c, "rows": report[c]["rows"],
                 **{key: report[c][key] for key in MOLECULE_REPORT_KEYS},
                 **{key: report[c][key] for key in ("regions",
                                                    "workspace_mb")
                    if key in report[c]},
                 "masked_launches_by_path": {
                     p: n[f"{name}_masked"] for p, n in launches.items()
                     if p.startswith(("molecule", "moses"))}}
                for c in MOLECULE_REPORTS[name]]}
               if name in MOLECULE_REPORTS else {})})
    print("phase seconds: " + json.dumps(phase_s), flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
