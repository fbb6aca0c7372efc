#!/usr/bin/env python3
"""Split the gap between ``runs/moses`` served on the card and its CPU copy.

    python3 tools/moses_gap.py [--seed 0] [--steps 8 20]

For each step count: train ``runs/moses`` (synthetic molecules, full width)
that many steps on the card as ``chip_smoke.py``'s molecule phase does
(``train_checked``, whose checks are read, not held, at a few steps), load
the run as the server does, make its coupling nets' output layers random
(``randomize_coupling_nets``, seed + 2), and read the IS bits/var of 16
graphs x 4 chains against a CPU copy on shared noise, as
``check_molecules_against_cpu`` does (its limit: 1e-3).  Then read that gap
again with one part of the card's side at a time swapped for its plain
form: ``set_transformer`` (the node flow's SetTransformer, the masked #3
fp32 3xTF32 twin, by ``plain_forward`` on the card), ``mixture`` (#2, the
couplings' mixture forward at K = 16, by ``numerics`` on the card),
``edge_gnn`` (the EdgeGNNs, plain fp32 on the card, run on the CPU on a
copy of their weights), and ``all`` three.  Beside each, every call of #3
and #2 in the unswapped eval is held against its plain version on the same
inputs on the card, by the limits ``chip_smoke.py`` holds those kernels
to: #3 fp32 within 1e-4 as torch.allclose and F32_FWD_REL of the norm, #2
within 1e-4 as torch.allclose.  One JSON line a step count, the card line
first.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import importlib.util
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@contextlib.contextmanager
def swapped(parts):
    """The card's side with ``parts`` in their plain form."""
    import torch
    from categoricalnf_tpu_torch.networks import SetTransformer
    from categoricalnf_tpu_torch.networks.graph import EdgeGNN
    from categoricalnf_tpu_torch.ops import dispatch
    from categoricalnf_tpu_torch.ops import numerics as nm
    saved = (SetTransformer.forward, dispatch.mixture_forward,
             EdgeGNN.forward)
    edge_forward = EdgeGNN.forward
    twins = {}

    def to_cpu(t):
        return t.cpu() if torch.is_tensor(t) else t

    def edge_on_cpu(self, x, cond=None, mask=None):
        if not x.is_cuda:
            return edge_forward(self, x, cond, mask)
        twin = twins.setdefault(id(self), copy.deepcopy(self).cpu())
        c = None if cond is None else {k: to_cpu(v) for k, v in cond.items()}
        return edge_forward(twin, x.cpu(), c, to_cpu(mask)).to(x.device)

    if "set_transformer" in parts:
        SetTransformer.forward = (
            lambda self, x, cond=None, mask=None:
            self.plain_forward(x, cond, mask))
    if "mixture" in parts:
        dispatch.mixture_forward = nm.mixture_logit_cdf_and_ldj
    if "edge_gnn" in parts:
        EdgeGNN.forward = edge_on_cpu
    try:
        yield
    finally:
        (SetTransformer.forward, dispatch.mixture_forward,
         EdgeGNN.forward) = saved


@contextlib.contextmanager
def held_calls(cs, readings):
    """Each #3 and #2 call of the card's side beside its plain version on
    the same inputs: the largest distances, by kernel, into ``readings``."""
    from categoricalnf_tpu_torch.networks import SetTransformer
    from categoricalnf_tpu_torch.ops import dispatch
    from categoricalnf_tpu_torch.ops import numerics as nm
    fwd, mix = SetTransformer.forward, dispatch.mixture_forward

    def note(name, **vals):
        r = readings.setdefault(name, {"calls": 0})
        r["calls"] += 1
        for k, v in vals.items():
            r[k] = max(r.get(k, 0.0), v)

    def set_transformer(self, x, cond=None, mask=None):
        y = fwd(self, x, cond, mask)
        if x.is_cuda:
            y_p = self.plain_forward(x, cond, mask)
            note("set_transformer", allclose_err=cs.allclose_err(y, y_p),
                 rel_err=cs.rel_err(y, y_p))
        return y

    def mixture(x, pi, mu, ls):
        y, ldj = mix(x, pi, mu, ls)
        if x.is_cuda:
            y_p, ldj_p = nm.mixture_logit_cdf_and_ldj(x, pi, mu, ls)
            note(f"mixture_k{pi.shape[-1]}",
                 allclose_err=max(cs.allclose_err(y, y_p),
                                  cs.allclose_err(ldj, ldj_p)))
        return y, ldj

    SetTransformer.forward, dispatch.mixture_forward = set_transformer, mixture
    try:
        yield
    finally:
        SetTransformer.forward, dispatch.mixture_forward = fwd, mix


def readings(cs, task, seed: int, n: int = 16) -> dict:
    """The eval bpd gap of the card's task against its CPU copy, as is, with
    each part swapped, and the kernels' calls held."""
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
    enc, _ = cs.molecule_graph_noise(cpu, n, 4, seed + 7)
    dev = task.device
    out: dict = {"limit": 1e-3}
    with torch.no_grad():
        bpd_cpu = cpu.eval_step(batch, 4, noise=enc)

        def gap():
            got = task.eval_step(batch, 4, noise=tuple(u.to(dev)
                                                       for u in enc)).cpu()
            return cs.max_err(got, bpd_cpu)

        calls: dict = {}
        with held_calls(cs, calls):
            out["as_is"] = gap()
        out["kernel_calls"] = calls
        for parts in (("set_transformer",), ("mixture",), ("edge_gnn",),
                      ("set_transformer", "mixture", "edge_gnn")):
            with swapped(parts):
                out["all" if len(parts) > 1 else parts[0]] = gap()
    limits = {"set_transformer": {"allclose_err": 1e-4,
                                  "rel_err": cs.F32_FWD_REL}}
    out["kernels_within_limits"] = all(
        v <= limits.get(name, {}).get(k, 1e-4)
        for name, r in calls.items() for k, v in r.items() if k != "calls")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, nargs="+", default=[8, 20])
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    cs = _chip_smoke()
    import torch
    from categoricalnf_tpu_torch import inference
    from categoricalnf_tpu_torch.utils.config import load_config
    from categoricalnf_tpu_torch.utils.device import resolve_device
    if not torch.cuda.is_available():
        sys.exit("moses_gap: no CUDA device")
    resolve_device("cuda")  # TF32 off, as the port's entry points set it
    device = "cuda"
    print(cs.card_line(), flush=True)
    cfg = load_config(os.path.join(REPO, "runs", "moses"))
    a = cfg["args"]
    m_args = {**a, "dataset": "synthetic", "seed": args.seed}
    for steps in args.steps:
        moses = inference.build_task(cfg["task"], m_args, device=device)
        tcfg = dataclasses.replace(
            cs.train_config(a, args.seed, a["eval_samples"]),
            num_steps=steps, eval_every=steps // 2, log_every=steps)
        line: dict = {"steps": steps, "seed": args.seed}
        with tempfile.TemporaryDirectory() as out_dir:
            try:
                cs.train_checked(moses, cfg["task"], m_args, tcfg, out_dir,
                                 {}, ())
                line["train_checks"] = "passed"
            except cs.CheckFailed as e:
                line["train_checks"] = f"failed: {e}"
            served = inference.load_run(out_dir, device=device).task
            cs.randomize_coupling_nets(served.model, args.seed + 2)
            line.update(readings(cs, served, args.seed))
        print(json.dumps(line), flush=True)
        del moses, served
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
