"""Post-hoc sample quality of a finished run over a sweep of prior
temperatures (counterpart of ``experiments/sample_eval.py``).

Loads the run's newest checkpoint through ``inference.load_run`` and
reports the task's sample metrics at each temperature, one JSON line each
(a token is a scalar, or "t_node:t_exist:t_bond" for tasks with per-stage
temperatures, GraphCNF's),
then writes the table to ``<run>/temperature_sweep.json`` and to a copy
named by the step and the sample count, so that a later sweep of the same
run keeps the earlier one.  Runs on the card unless ``--device cpu``:

    python -m categoricalnf_tpu_torch.experiments.sample_eval \
        --run runs_torch/set16 --temperatures 0.7,0.85,1.0
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys

from categoricalnf_tpu_torch.inference import load_run
from categoricalnf_tpu_torch.training.engine import step_generator


def parse_temp(tok: str):
    """A scalar temperature, or a per-stage tuple from "a:b:c"."""
    parts = [float(x) for x in tok.split(":")]
    return parts[0] if len(parts) == 1 else tuple(parts)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run", type=str, required=True)
    ap.add_argument("--temperatures", type=str, default="0.7,0.85,1.0")
    ap.add_argument("--num_samples", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--best_of_k", type=int, default=1,
                    help="validity@k: a graph counts as valid if any of k "
                         "independent samples is (tasks that support it)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)

    handle = load_run(args.run, device=args.device)
    task = handle.task
    sig = inspect.signature(task.sample_metrics).parameters
    extra = {"num_samples": args.num_samples}
    if args.best_of_k > 1 and "best_of_k" in sig:
        extra["best_of_k"] = args.best_of_k
    temps = [parse_temp(t) for t in args.temperatures.split(",")]
    if any(isinstance(t, tuple) for t in temps) and not getattr(
            task, "supports_stage_temperatures", False):
        print(f"{task.name}: no per-stage temperature support; dropping "
              "triple tokens", file=sys.stderr)
        temps = [t for t in temps if not isinstance(t, tuple)] or [1.0]
    rows = []
    for i, t in enumerate(temps):
        metrics = task.sample_metrics(
            generator=step_generator(task.device, args.seed, i),
            temperature=t, **extra)
        row = {"temperature": list(t) if isinstance(t, tuple) else t,
               "step": handle.step,
               "num_samples": args.num_samples,
               **{k: float(v) for k, v in metrics.items()}}
        rows.append(row)
        print(json.dumps(row), flush=True)
    out = os.path.join(args.run, "temperature_sweep.json")
    suffixed = os.path.join(
        args.run, f"temperature_sweep_{handle.step}_{args.num_samples}.json")
    for path in (out, suffixed):
        with open(path, "w") as f:
            json.dump(rows, f, indent=1)
    print(f"wrote {out} and {suffixed}", file=sys.stderr)
    return rows


if __name__ == "__main__":
    main()
