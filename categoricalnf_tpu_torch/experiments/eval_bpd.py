"""Post-hoc likelihood of a finished run at a chosen importance-sample
count (counterpart of ``experiments/eval_bpd.py``).

The trainer's test uses 32 importance samples; this re-measures a finished
run at IS-128/256 without training (the bound only tightens as the count
grows).  The fp32 importance-sampled bits/var of the split is printed and
appended to the run's ``metrics.jsonl`` as ``{"prefix": "posthoc_<split>",
...}``.  Runs on the card unless ``--device cpu``:

    python -m categoricalnf_tpu_torch.experiments.eval_bpd \
        --run runs_torch/set16 --num_samples 128 --split test
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from categoricalnf_tpu_torch.inference import load_run
from categoricalnf_tpu_torch.training.engine import step_generator


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run", type=str, required=True)
    ap.add_argument("--num_samples", type=int, default=128,
                    help="importance samples per example")
    ap.add_argument("--split", choices=["val", "test"], default="test")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--max_batches", type=int, default=0,
                    help="0 = the whole split")
    ap.add_argument("--no_write", action="store_true",
                    help="print only; do not append to metrics.jsonl")
    ap.add_argument("--compute_dtype", default=None,
                    choices=["float32", "bfloat16"],
                    help="override the run's compute dtype (the density is "
                         "evaluated in the fp32 twin either way)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)

    overrides = ({"compute_dtype": args.compute_dtype}
                 if args.compute_dtype else {})
    handle = load_run(args.run, device=args.device, **overrides)
    task = handle.task
    batches = (task.test_batches() if args.split == "test"
               else task.eval_batches())
    if args.max_batches:
        batches = batches[:args.max_batches]
    bpds = [task.eval_step(batch, args.num_samples,
                           generator=step_generator(task.device, args.seed,
                                                    i)).cpu().numpy()
            for i, batch in enumerate(batches)]
    out = {"prefix": f"posthoc_{args.split}", "step": handle.step,
           "bpd": float(np.mean(np.concatenate(bpds))),
           "num_importance_samples": args.num_samples,
           "num_batches": len(bpds),
           "compute_dtype": args.compute_dtype or "run-default",
           # a probe of part of the split never stands for the whole one
           "partial": bool(args.max_batches)}
    opt = task.analytic_optimum_bpd()
    if opt is not None:
        out["gap_to_optimum"] = out["bpd"] - opt
    print(json.dumps(out), flush=True)
    if not args.no_write:
        with open(os.path.join(args.run, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(out) + "\n")
    return out


if __name__ == "__main__":
    main()
