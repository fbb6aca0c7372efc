#!/usr/bin/env python3
"""Train a run's config on one card in arms that differ only in the
encoder's gradient or the beta schedule, and print each arm's eval bits/var
every ``--eval_every`` steps from the untrained model on.

- ``kernel``: the port as it trains on the card; the encoder's inverse is
  differentiated by #1', the loop-rule kernel (the reference's rule).
- ``loop``: the same rule from the plain loop on the card under autograd
  (``numerics.mixture_inverse_logit_cdf`` in ``dispatch.mixture_inverse``),
  as XLA does in the reference.
- ``implicit``: the exact derivative instead, the implicit rule at the
  kernel's root (``mixture_inverse_bwd_cuda``), which the card took before
  it took the reference's rule.
- ``beta1``: as ``kernel``, with beta held at 1 from the first step
  instead of the run's sigmoid warm-up from 0.5.

    python3 tools/encoder_grad_ab.py [--runs sum_vardeq shuffle_linear]
        [--arms kernel loop implicit beta1] [--steps 200] [--eval_every 25]
        [--seed 0]

Each arm starts from the same seeded, data-initialised model and draws the
same batches; the Trainer, its config and the eval (one batch of 1,024 with
4 chains) are ``chip_smoke.py``'s.  Prints one JSON line per run: each
arm's untrained and eval bpds, its logged losses and betas, and its wall
time.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@contextlib.contextmanager
def loop_inverse():
    """The inverse of every tensor through the plain loop, under autograd."""
    from categoricalnf_tpu_torch.ops import dispatch
    from categoricalnf_tpu_torch.ops import numerics as nm
    card = dispatch.mixture_inverse
    dispatch.mixture_inverse = nm.mixture_inverse_logit_cdf
    try:
        yield
    finally:
        dispatch.mixture_inverse = card


@contextlib.contextmanager
def implicit_inverse():
    """The inverse of every CUDA tensor through #1, differentiated by the
    implicit rule at its root (``mixture_inverse_bwd_cuda``)."""
    import torch
    from categoricalnf_tpu_torch.ops import dispatch
    from categoricalnf_tpu_torch.ops.cuda import mixture as cm

    class Implicit(torch.autograd.Function):
        @staticmethod
        def forward(ctx, y, pi, mu, ls):
            with torch.no_grad():
                x = cm.mixture_inverse_cuda(y, pi, mu, ls)
            ctx.save_for_backward(x, pi, mu, ls)
            return x

        @staticmethod
        def backward(ctx, gx):
            return cm.mixture_inverse_bwd_cuda(*ctx.saved_tensors,
                                               gx.contiguous())

    card = dispatch.mixture_inverse
    dispatch.mixture_inverse = Implicit.apply
    try:
        yield
    finally:
        dispatch.mixture_inverse = card


ARMS = {"loop": loop_inverse, "implicit": implicit_inverse}


def train_arm(cs, run: str, arm: str, steps: int, eval_every: int,
              seed: int, device: str = "cuda") -> dict:
    import numpy as np
    import torch
    from categoricalnf_tpu_torch import inference
    from categoricalnf_tpu_torch.training.engine import Trainer
    from categoricalnf_tpu_torch.training.schedules import ScheduleSpec
    from categoricalnf_tpu_torch.utils.config import load_config, save_config

    cfg = load_config(os.path.join(REPO, "runs", run))
    a = cfg["args"]
    args = {**a, "seed": seed, "eval_batches_count": 1}
    task = inference.build_task(cfg["task"], args, device=device)
    tcfg = dataclasses.replace(cs.train_config(a, seed, cs.EVAL_CHAINS),
                               num_steps=steps, eval_every=eval_every,
                               log_every=eval_every)
    if arm == "beta1":
        tcfg = dataclasses.replace(tcfg, beta_schedule=ScheduleSpec(
            kind="constant", value=1.0))
    with tempfile.TemporaryDirectory() as out_dir, \
            ARMS.get(arm, contextlib.nullcontext)():
        tcfg = dataclasses.replace(tcfg, out_dir=out_dir)
        save_config(out_dir, {"task": cfg["task"], "args": args})
        trainer = Trainer(task, tcfg)
        trainer.init_model(next(task.train_batches(
            np.random.default_rng(seed))))
        bpd0 = trainer.evaluate(tcfg.eval_samples, 0)["bpd"]
        t0 = time.perf_counter()
        trainer.train(resume=False)
        if task.device.type == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        rows = [json.loads(line) for line in
                open(os.path.join(out_dir, "metrics.jsonl"))]
    vals = [(r["step"], r["bpd"]) for r in rows if r["prefix"] == "val"
            and r["step"] <= steps]
    train = [(r["step"], r["loss"], r["beta"]) for r in rows
             if r["prefix"] == "train"]
    return {"optimum_bpd": task.analytic_optimum_bpd(),
            "untrained_bpd": bpd0, "val_bpd": vals,
            "train_loss_beta": train, "wall_s": secs}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", nargs="+",
                    default=["sum_vardeq", "shuffle_linear"])
    ap.add_argument("--arms", nargs="+",
                    default=["kernel", "loop", "implicit", "beta1"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--eval_every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    cs = _chip_smoke()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", flush=True)
        return 1
    print(cs.card_line(), flush=True)
    for run in args.runs:
        line = {"run": run, "seed": args.seed, "steps": args.steps,
                "card": cs.card_line(), "arms": {}}
        for arm in args.arms:
            line["arms"][arm] = train_arm(cs, run, arm, args.steps,
                                          args.eval_every, args.seed)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
