#!/usr/bin/env python3
"""Compare the mixture-CDF kernels of two checkouts on one card: #1 (the
inverse), #2 (the forward) and #2' (its backward), on chip_smoke's seeded
inputs (``chip_smoke.mixture_inputs``), at

- the flagship train step's shape, 1024 x 16 x 4 with K = 8, the logits and
  log-scales strided slices of a [..., 2 + 3K] tensor as the coupling
  passes them;
- eval_bpd's shape, 4096 x 16 x 4 (the forward only runs there);
- K = 16 at 64 x 16 x 4, and K = 16 and K = 3 at M = 91 (7 x 13).

    python3 tools/mixture_ab.py --tree DIR --out A.pt   # DIR: a checkout
    python3 tools/mixture_ab.py --compare A.pt B.pt

The first form imports the port from DIR, runs the kernels, saves their
outputs and prints each kernel's device ms (``chip_smoke.cuda_ms``).  It
also counts the SASS instructions of each instance of the forward and
backward kernels in DIR's built library (``cuobjdump -sass``), and for the
instances the flagship's K = 8 launches it gives the instructions an element
and the time the SMs' warp schedulers need to issue them at the flagship's
M = 65,536 at the card's top clock (a static count: every instruction of
the kernel once a lane, branches not followed).  The
backward runs with the log-scales times 6, so that many lie outside the
clip, as chip_smoke's check does.  The second form says, output by output,
whether the two trees' results are bitwise equal and, where they are not,
the largest gap in ulps.  The inputs, the timing and the card line are this
checkout's ``chip_smoke.py``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys

# name: (shape, K, strided slices, kernels run)
CASES = {
    "flagship": ((1024, 16, 4), 8, True, ("inv", "fwd", "bwd")),
    "eval": ((4096, 16, 4), 8, False, ("fwd",)),
    "k16": ((64, 16, 4), 16, True, ("inv", "fwd", "bwd")),
    "k16_m91": ((7, 13), 16, False, ("inv", "fwd", "bwd")),
    "k3_m91": ((7, 13), 3, False, ("inv", "fwd", "bwd")),
}
OUTPUTS = {"inv": ("x",), "fwd": ("y", "ldj"),
           "bwd": ("gx", "gpi", "gmu", "gls")}


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _as_slices(pi, ls):
    """pi and ls as the coupling passes them: slices [2:2+K] and [2+2K:] of
    one [..., 2 + 3K] tensor (the means, offset, are a tensor of their
    own)."""
    import torch
    k = pi.shape[-1]
    raw = torch.zeros(*pi.shape[:-1], 2 + 3 * k, device=pi.device)
    raw[..., 2:2 + k] = pi
    raw[..., 2 + 2 * k:] = ls
    return raw[..., 2:2 + k], raw[..., 2 + 2 * k:]


def case_calls(cs, cm, name: str, dev):
    """The kernels' calls of case ``name`` on the seeded inputs, by kernel
    ("inv", "fwd", "bwd"); each returns a tuple of outputs."""
    import torch
    shape, k, strided, kernels = CASES[name]
    gen = torch.Generator(dev).manual_seed(7)
    x, pi, mu, ls = cs.mixture_inputs(gen, shape, k, dev)
    y_in = torch.randn(shape, generator=gen, device=dev) * 2.0
    gy = torch.randn(shape, generator=gen, device=dev)
    gl = torch.randn(shape, generator=gen, device=dev)
    ls6 = ls * 6.0
    if strided:
        pi, ls = _as_slices(pi, ls)
        _, ls6 = _as_slices(pi, ls6)
    calls = {
        "inv": lambda: (cm.mixture_inverse_cuda(y_in, pi, mu, ls),),
        "fwd": lambda: cm.mixture_forward_cuda(x, pi, mu, ls),
        "bwd": lambda: cm.mixture_forward_bwd_cuda(x, pi, mu, ls6, gy, gl)}
    return {kern: calls[kern] for kern in kernels}


def _sass_instructions(library: str) -> dict:
    """Per kernel instance of the forward and backward in ``library``
    (``name<template args>``): its SASS instructions but NOPs, and of those
    the MUFU (transcendental), SHFL and branch instructions."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    out = subprocess.run(
        [os.path.join(cuda_home, "bin", "cuobjdump"), "-sass", library],
        capture_output=True, text=True, timeout=300, check=True).stdout
    counts: dict = {}
    cur = None
    for line in out.splitlines():
        if "Function :" in line:
            hit = re.search(
                r"(mixture_forward(?:_bwd)?_kernel)I((?:L[ib]\d+E)+)E", line)
            cur = None
            if hit:
                args = re.findall(r"L[ib](\d+)E", hit.group(2))
                cur = counts[f"{hit.group(1)}<{','.join(args)}>"] = dict(
                    instructions=0, mufu=0, shfl=0, branches=0)
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                       r"([A-Z][A-Z0-9_.]*)", line)
        if cur is None or not ins or ins.group(1) == "NOP":
            continue
        op = ins.group(1)
        cur["instructions"] += 1
        cur["mufu"] += op.startswith("MUFU")
        cur["shfl"] += op.startswith("SHFL")
        cur["branches"] += op.startswith(("BRA", "BRX", "CALL", "RET"))
    return counts


def _issue_us(counts: dict, m: int = 65_536) -> dict:
    """For the forward and backward instances the flagship's K = 8 launches
    (one thread an element with KMAX = 8; or G lanes of C components, G * C
    = 8, built for a full group): instructions an element (G lanes' worth)
    and m elements' warp instructions over the card's warp schedulers (4 an
    SM) at its top SM clock, in microseconds."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    out = {"sms": sms, "max_sm_mhz": mhz}
    for name, c in counts.items():
        args = [int(a) for a in name[name.index("<") + 1:-1].split(",")]
        lanes = 1 if len(args) == 1 else args[0]
        if args not in ([8], [lanes, 8 // lanes, 1]):
            continue
        per_element = c["instructions"] * lanes
        out[name.split("<")[0]] = dict(
            instance=name, instructions_per_element=per_element,
            mufu_per_element=c["mufu"] * lanes,
            issue_us=m * per_element / 32 / (sms * 4 * mhz * 1e6) * 1e6)
    return out


def run(tree: str, out: str) -> None:
    cs = _chip_smoke()
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from categoricalnf_tpu_torch.ops.cuda import build
    from categoricalnf_tpu_torch.ops.cuda import mixture as cm
    if not torch.cuda.is_available():
        sys.exit("mixture_ab: no CUDA device")
    dev = torch.device("cuda")
    saved, ms = {}, {}
    with torch.no_grad():
        for name in CASES:
            for kern, call in case_calls(cs, cm, name, dev).items():
                outs = call()
                torch.cuda.synchronize()
                for o, t in zip(OUTPUTS[kern], outs):
                    saved[f"{name}/{kern}/{o}"] = t.cpu()
                ms[f"{name}/{kern}"] = cs.cuda_ms(call, 50)[0]
    sass = _sass_instructions(build.library_path("mixture"))
    result = {"tree": tree, "card": cs.card_line(), "ms": ms,
              "sass": sass, "k8_issue": _issue_us(sass)}
    torch.save({"outputs": saved, **result}, out)
    print(json.dumps(result), flush=True)


def _ulps(a, b) -> int:
    """The largest distance between a and b in fp32 ulps (the bit patterns
    as ordered integers)."""
    import torch

    def ordered(t):
        i = t.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def compare(a: str, b: str) -> bool:
    import torch
    one, two = torch.load(a), torch.load(b)
    outputs = {}
    same = True
    for key, ta in one["outputs"].items():
        tb = two["outputs"][key]
        equal = torch.equal(ta.view(torch.int32), tb.view(torch.int32))
        outputs[key] = True if equal else {"ulps": _ulps(ta, tb),
                                           "max_abs_diff": float(
                                               (ta - tb).abs().max())}
        same = same and equal
    print(json.dumps({
        "a": one["tree"], "b": two["tree"], "all_bitwise_equal": same,
        "bitwise_equal": outputs,
        "ms": {k: [one["ms"][k], two["ms"][k]] for k in one["ms"]}}),
        flush=True)
    return same


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", help="checkout whose port to run")
    ap.add_argument("--out", help="file for the results")
    ap.add_argument("--compare", nargs=2, metavar="FILE")
    args = ap.parse_args()
    if args.compare:
        return 0 if compare(*args.compare) else 1
    if not (args.tree and args.out):
        ap.error("give --tree and --out, or --compare")
    run(args.tree, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
