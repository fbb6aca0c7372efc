#!/usr/bin/env python3
"""Compare the mixture-CDF kernels of two checkouts on one card: #1 (the
inverse), #2 (the forward) and #2' (its backward), on chip_smoke's seeded
inputs (``chip_smoke.mixture_inputs``), at

- the flagship train step's shape, 1024 x 16 x 4 with K = 8, the logits and
  log-scales strided slices of a [..., 2 + 3K] tensor as the coupling
  passes them;
- eval_bpd's shape, 4096 x 16 x 4 (the forward only runs there);
- a /sample of 4 sets, 4 x 16 x 4 (M = 256, the inverse only);
- K = 16 at 64 x 16 x 4, and K = 16 and K = 3 at M = 91 (7 x 13);
- K = 32 at the language models' shapes: a train step's density pass,
  128 x 256 x 4 (M = 131,072), and the sampling path's M = 512 and 16,
  the logits and log-scales strided; a tree whose kernels take K <= 16
  only (``MAX_K``) skips these.

    python3 tools/mixture_ab.py --tree DIR --out A.pt   # DIR: a checkout
    python3 tools/mixture_ab.py --compare A.pt B.pt

``--cases`` runs some of the cases only, ``--seeds`` with no value skips
the residual readings: to time another split of lanes at K = 32, run
``--cases lm_density lm_m512 lm_m16 --seeds`` on a copy of the tree with
``kWideFwdLanes``/``kWideBwdLanes``/``kWideInvLanes`` edited.

The first form imports the port from DIR, runs the kernels, saves their
outputs and prints each kernel's device ms (``chip_smoke.cuda_ms``).  It
also counts the SASS instructions of each instance of the three kernels in
DIR's built library (``cuobjdump -sass``), and for the instances the
flagship's K = 8 launches it gives the instructions an element and the time
the busiest of the SMs' warp schedulers needs to issue them at M = 65,536
and M = 256 at the card's top clock.  The count is static: every instruction
once a lane, branches not followed, except the inverse's rtsafe loop (the
code between a backward branch and its target), whose body counts its cap
of 48 times (``MAX_ITERS``; an element stops earlier once it is done, so
this is an upper count); where the kernel has two such loops, the linear domain's
and the log domain's for |y| > 64, only the shorter runs (no element of
the timed cases has |y| > 64).  The backward runs with the log-scales times 6,
so that many lie outside the clip, as chip_smoke's check does.  The inverse
is also held by ``chip_smoke.inverse_reading`` on
``chip_smoke.inverse_cases`` at each of ``--seeds``: elements over the
residual limit, the largest ratio to it.  The second form says, output by
output, whether the two trees' results are bitwise equal and, where they are
not, the largest gap in ulps.  The inputs, the timing and the card line are
this checkout's ``chip_smoke.py``.  Imports nothing of JAX.
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
    "sample4": ((4, 16, 4), 8, True, ("inv",)),
    "k16": ((64, 16, 4), 16, True, ("inv", "fwd", "bwd")),
    "k16_m91": ((7, 13), 16, False, ("inv", "fwd", "bwd")),
    "k3_m91": ((7, 13), 3, False, ("inv", "fwd", "bwd")),
    "lm_density": ((128, 256, 4), 32, True, ("inv", "fwd", "bwd")),
    "lm_m512": ((128, 4), 32, True, ("inv", "fwd", "bwd")),
    "lm_m16": ((4, 4), 32, True, ("inv", "fwd", "bwd")),
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
        pi, ls = cs.coupling_slices(pi, ls)
        _, ls6 = cs.coupling_slices(pi, ls6)
    calls = {
        "inv": lambda: (cm.mixture_inverse_cuda(y_in, pi, mu, ls),),
        "fwd": lambda: cm.mixture_forward_cuda(x, pi, mu, ls),
        "bwd": lambda: cm.mixture_forward_bwd_cuda(x, pi, mu, ls6, gy, gl)}
    return {kern: calls[kern] for kern in kernels}


_KERNEL = re.compile(
    r"(mixture_(?:inverse|forward(?:_bwd)?)_kernel)I((?:L[ib]\d+E)+)E")
_INSTRUCTION = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                          r"([A-Z][A-Z0-9_.]*)([^;]*)")
_LABEL = re.compile(r"\s*(\.L_x_\d+):")


def _instance(mangled: str):
    """``name<template args>`` of a mixture kernel's mangled name, else
    None."""
    hit = _KERNEL.search(mangled)
    if not hit:
        return None
    args = re.findall(r"L[ib](\d+)E", hit.group(2))
    return f"{hit.group(1)}<{','.join(args)}>"


def _sass_instructions(library: str) -> dict:
    """Per kernel instance of the three kernels in ``library``
    (``name<template args>``): its SASS instructions but NOPs, and of those
    the MUFU (transcendental), SHFL and branch instructions; and its loops
    (``outside``: instructions before the kernel's closing self-branch that
    lie in no loop; ``loops``: each outermost loop's instructions, from
    the target of a backward branch to that branch); ptxas's registers and
    spills join them in ``run``."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    out = subprocess.run(
        [os.path.join(cuda_home, "bin", "cuobjdump"), "-sass", library],
        capture_output=True, text=True, timeout=300, check=True).stdout
    listings: dict = {}
    cur = None
    for line in out.splitlines():
        if "Function :" in line:
            name = _instance(line)
            cur = None
            if name:
                cur = listings[name] = dict(ops=[], labels={}, pending=[])
            continue
        if cur is None:
            continue
        label = _LABEL.match(line)
        if label:
            cur["pending"].append(label.group(1))
            continue
        ins = _INSTRUCTION.match(line)
        if not ins:
            continue
        addr = int(ins.group(1), 16)
        for name in cur["pending"]:
            cur["labels"][name] = addr
        cur["pending"] = []
        if ins.group(2) != "NOP":
            cur["ops"].append((addr, ins.group(2), ins.group(3)))
    return {name: _count(lst) for name, lst in listings.items()}


def _count(listing: dict) -> dict:
    ops = listing["ops"]
    c = dict(instructions=len(ops),
             mufu=sum(op.startswith("MUFU") for _, op, _ in ops),
             shfl=sum(op.startswith("SHFL") for _, op, _ in ops),
             branches=sum(op.startswith(("BRA", "BRX", "CALL", "RET"))
                          for _, op, _ in ops))
    backward, end = [], None
    for addr, op, rest in ops:
        if not op.startswith("BRA"):
            continue
        hit = re.search(r"0x([0-9a-f]+)|`\((\.L_x_\d+)\)", rest)
        if not hit:
            continue
        target = (int(hit.group(1), 16) if hit.group(1)
                  else listing["labels"].get(hit.group(2)))
        if target is None:
            continue
        if target == addr:
            end = addr if end is None else min(end, addr)
        elif target < addr:
            backward.append((target, addr))
    main = [a for a, _, _ in ops if end is None or a < end]
    outer = [(t, a) for t, a in backward
             if not any(t2 <= t and a <= a2 and (t2, a2) != (t, a)
                        for t2, a2 in backward)]
    bodies = sorted(sum(t <= x <= a for x in main) for t, a in outer)
    c["loops"] = bodies
    c["outside"] = len(main) - sum(bodies)
    return c


def _issue_us(counts: dict, ms=(65_536, 256)) -> dict:
    """For the instances the flagship's K = 8 launches (one thread an
    element with KMAX = 8; or G lanes of C components, G * C = 8, built for
    a full group): the instructions an element (G lanes' worth; for the
    inverse, the shorter loop's body ``MAX_ITERS`` times, or the fixed
    count of a tree from before the early stop, the rest once) and
    the time the busiest warp scheduler (4 an SM; blocks of 256 threads
    spread evenly over the SMs) needs to issue its warps' instructions at
    the card's top SM clock, in microseconds, at each M of ``ms``."""
    import torch
    from categoricalnf_tpu_torch.ops.cuda import mixture as cm
    # the tree's loop count: its cap, or its fixed count in a tree from
    # before the inverse stopped each element once done
    loop_count = getattr(cm, "MAX_ITERS", None) or cm.NUM_ITERS
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    out = {"sms": sms, "max_sm_mhz": mhz}
    for name, c in counts.items():
        args = [int(a) for a in name[name.index("<") + 1:-1].split(",")]
        lanes = 1 if len(args) == 1 else args[0]
        if args != [8] and not (len(args) >= 3 and args[0] * args[1] == 8
                                and args[2] == 1):
            continue
        per_lane = c["instructions"]
        if name.startswith("mixture_inverse") and c["loops"]:
            per_lane = c["outside"] + loop_count * c["loops"][0]
        issue = {}
        for m in ms:
            blocks = -(-m * lanes // 256)
            warps_per_sm = -(-blocks // sms) * 8
            issue[str(m)] = warps_per_sm / 4 * per_lane / mhz
        out[name.split("<")[0]] = dict(
            instance=name, instructions_per_element=per_lane * lanes,
            mufu_per_element=c["mufu"] * lanes, lanes=lanes,
            issue_us=issue,
            issue_us_all_schedulers=ms[0] * per_lane * lanes / 32
            / (sms * 4 * mhz))
    return out


def readings(cs, cm, nm, seeds, dev) -> dict:
    """``chip_smoke.inverse_reading`` of the inverse and, as a control, of
    the plain version cut short (12 bisections, no Newton step), on
    ``chip_smoke.inverse_cases`` at each seed: [over, worst ratio]."""
    out = {}
    for seed in seeds:
        for name, (y, pi, mu, ls) in cs.inverse_cases(seed, dev).items():
            x = cm.mixture_inverse_cuda(y, pi, mu, ls)
            x_p = nm.mixture_inverse_logit_cdf(y, pi, mu, ls)
            cut = nm.mixture_inverse_logit_cdf(y, pi, mu, ls, num_bisect=12,
                                               num_newton=0)
            out[f"{seed}/{name}"] = dict(
                kernel=cs.inverse_reading(x, x_p, y, pi, mu, ls),
                control=cs.inverse_reading(cut, x_p, y, pi, mu, ls),
                max_abs_vs_plain=float((x - x_p).abs().max()))
    return out


def run(tree: str, out: str, seeds, cases) -> None:
    cs = _chip_smoke()
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from categoricalnf_tpu_torch.ops import numerics as nm
    from categoricalnf_tpu_torch.ops.cuda import build
    from categoricalnf_tpu_torch.ops.cuda import mixture as cm
    if not torch.cuda.is_available():
        sys.exit("mixture_ab: no CUDA device")
    dev = torch.device("cuda")
    saved, ms = {}, {}
    with torch.no_grad():
        for name in cases:
            if CASES[name][1] > cm.MAX_K:
                continue
            for kern, call in case_calls(cs, cm, name, dev).items():
                outs = call()
                torch.cuda.synchronize()
                for o, t in zip(OUTPUTS[kern], outs):
                    saved[f"{name}/{kern}/{o}"] = t.cpu()
                ms[f"{name}/{kern}"] = cs.cuda_ms(call, 50)[0]
        residual = readings(cs, cm, nm, seeds, dev)
    sass = _sass_instructions(build.library_path("mixture"))
    with open(build.library_path("mixture") + ".log") as f:
        for mangled, res in cs.kernel_resources(f.read()).items():
            if _instance(mangled) in sass:
                sass[_instance(mangled)].update(res)
    result = {"tree": tree, "card": cs.card_line(), "ms": ms,
              "sass": sass, "k8_issue": _issue_us(sass),
              "residual": residual}
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
        if key not in two["outputs"]:  # a case the other tree skipped
            continue
        tb = two["outputs"][key]
        equal = torch.equal(ta.view(torch.int32), tb.view(torch.int32))
        outputs[key] = True if equal else {"ulps": _ulps(ta, tb),
                                           "max_abs_diff": float(
                                               (ta - tb).abs().max())}
        same = same and equal
    print(json.dumps({
        "a": one["tree"], "b": two["tree"], "all_bitwise_equal": same,
        "bitwise_equal": outputs,
        "ms": {k: [one["ms"][k], two["ms"][k]] for k in one["ms"]
               if k in two["ms"]}}),
        flush=True)
    return same


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", help="checkout whose port to run")
    ap.add_argument("--out", help="file for the results")
    ap.add_argument("--compare", nargs=2, metavar="FILE")
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2],
                    help="seeds of the inverse's residual readings")
    ap.add_argument("--cases", nargs="*", default=list(CASES),
                    choices=list(CASES), help="the cases to run")
    args = ap.parse_args()
    if args.compare:
        return 0 if compare(*args.compare) else 1
    if not (args.tree and args.out):
        ap.error("give --tree and --out, or --compare")
    run(args.tree, args.out, args.seeds, args.cases)
    return 0


if __name__ == "__main__":
    sys.exit(main())
