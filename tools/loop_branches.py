#!/usr/bin/env python3
"""Where the inverse's loop-rule backward (#1') parts from the plain loop on
one card: the order of torch's sums over a short last dimension, the
elementary functions, and the bisections' branches.

    python3 tools/loop_branches.py

Prints JSON lines: (1) for each K of 1..32, the share of 65,536 rows on
which torch.sum, torch.logsumexp and torch.log_softmax give the bits of
the sums in torch_sum_order's order (csrc/mixture.cu) and left to right;
(2) the share of 2^20 values on which expf, logf, log1pf and the log
sigmoid pair of csrc/mixture.cu give torch's bits; (3) for K = 4, 8, 16
and 32 at M = 65,536 (``chip_smoke.inverse_case``'s draws), the share of
elements whose 42 bisection branches equal the plain loop's
(``numerics.mixture_inverse_logit_cdf``), and of rows whose log-softmax
does, for tools/loop_branches.cu built with the sums in torch's order (the
kernel's) and left to right.  Builds into the package's ``_build``.
Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)


def butterfly(e):
    """torch_sum_order's sum of e's last dimension, by elementwise adds."""
    import torch
    k = e.shape[-1]
    w = 1
    while w < k:
        w *= 2
    v = [e[:, t] if t < k else torch.zeros_like(e[:, 0]) for t in range(w)]
    o = w // 2
    while o >= 1:
        for lane in range(o):
            v[lane] = v[lane] + v[lane + o]
        o //= 2
    return v[0]


def left_to_right(e):
    s = e[:, 0]
    for t in range(1, e.shape[-1]):
        s = s + e[:, t]
    return s


def build(tag: str, flags: list) -> ctypes.CDLL:
    from categoricalnf_tpu_torch.ops.cuda import build as b
    os.makedirs(b.BUILD_DIR, exist_ok=True)
    so = os.path.join(b.BUILD_DIR, f"loop_branches_{tag}.so")
    nvcc_flags = [f for f in b.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([b._nvcc(), *nvcc_flags, *flags, "-o", so,
                    os.path.join(ROOT, "tools", "loop_branches.cu")],
                   check=True)
    return ctypes.CDLL(so)


def share(mask) -> float:
    return float(mask.double().mean())


def main() -> int:
    import torch
    from categoricalnf_tpu_torch.ops import numerics as nm
    if not torch.cuda.is_available():
        sys.exit("loop_branches: no CUDA device")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    dev = torch.device("cuda")
    print(json.dumps({"card": cs.card_line(), "torch": torch.__version__}),
          flush=True)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731

    g = torch.Generator(dev).manual_seed(0)
    orders = {}
    for k in range(1, 33):
        v = torch.randn(65536, k, generator=g, device=dev) * 3
        mx = v.amax(-1, keepdim=True)
        e = torch.exp(v - mx)
        got = {"sum": torch.sum(e, -1), "logsumexp": torch.logsumexp(v, -1),
               "log_softmax": torch.log_softmax(v, -1)}
        row = {}
        for name, fn in (("torch_sum_order", butterfly),
                         ("left_to_right", left_to_right)):
            s = fn(e)
            row[name] = [
                share(got["sum"] == s),
                share(got["logsumexp"] == torch.log(s) + mx[:, 0]),
                share((got["log_softmax"] == (v - mx) - torch.log(s)[:, None])
                      .all(-1))]
        orders[k] = row
    print("shares of rows bitwise torch's [sum, logsumexp, log_softmax] by "
          "order: " + json.dumps(orders), flush=True)

    libs = {"torch_sum_order": build("torch_order", []),
            "left_to_right": build("left_to_right", ["-DLEFT_TO_RIGHT"])}
    z = torch.randn(1 << 20, generator=g, device=dev) * 8
    out = torch.empty(4, z.numel(), device=dev)
    assert libs["torch_sum_order"].loop_elementwise(
        ptr(z), ptr(out), ctypes.c_long(z.numel())) == 0
    want = (torch.exp(z), torch.log(z.abs()), torch.log1p(z.abs()),
            torch.nn.functional.logsigmoid(z))
    print("shares of values bitwise torch's: " + json.dumps({
        n: share(a == w) for n, a, w in zip(
            ("expf", "logf", "log1pf", "log_sigmoid"), out, want)}),
        flush=True)

    for k in (4, 8, 16, 32):
        gen = torch.Generator(dev).manual_seed(k)
        y, pi, mu, ls = (t.contiguous() for t in cs.inverse_case(
            gen, (65536,), k, dev, False))
        log_pi, means, log_scales = nm._prep(pi, mu, ls)
        cand = means + torch.exp(log_scales) * y[:, None]
        lo, hi = cand.min(-1).values, cand.max(-1).values
        inv = torch.exp(-log_scales)
        want_bits = torch.zeros_like(y, dtype=torch.int64)
        for it in range(42):
            mid = 0.5 * (lo + hi)
            lsp, lsn = nm._log_sigmoid_pair((mid[:, None] - means) * inv)
            right = (torch.logsumexp(log_pi + lsp, -1)
                     - torch.logsumexp(log_pi + lsn, -1)) < y
            want_bits |= right.long() << it
            lo = torch.where(right, mid, lo)
            hi = torch.where(right, hi, mid)
        row = {}
        for tag, lib in libs.items():
            bits = torch.empty_like(want_bits)
            lp = torch.empty_like(log_pi)
            assert lib.loop_branches(ptr(y), ptr(pi), ptr(mu), ptr(ls),
                                     ctypes.c_long(y.numel()), k, ptr(bits),
                                     ptr(lp)) == 0
            row[tag] = {"branches_equal": share(bits == want_bits),
                        "log_pi_equal": share((lp == log_pi).all(-1))}
        print(f"K = {k}, M = 65,536: " + json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
