#!/usr/bin/env python3
"""How the fp32 coupling nets round, and what that does to the fp32 train
step's gradient check.  Run from the root of a checkout on a machine with
one NVIDIA card:

    python3 tools/f32_forward_rounding.py [--seeds 0 1 2]

Prints JSON lines.  ``forward_vs_fp64``: on chip_smoke's seeded flagship
net at eval_bpd's 65,536 rows, the relative norm error and the signed bias
(the mean of the error times the sign of the exact value, over the mean
magnitude) against the same net in fp64, of the 3xTF32 kernel (calls
without grad), the FMA kernel (differentiable calls) and ``plain_forward``.
Then, for each seed, chip_smoke's fp32 train step held against the same
step in float64 (``train_step_readings``, rules (a)-(c) of
``train_step_failures``) with the coupling nets' output values taken from
one source and their gradient from another (``fwd/bwd``): ``fma`` the FMA
kernels (the port's pair), ``tf32x3`` the port's 3xTF32 forward kernel
and the 3xTF32 backward of ``tools/f32_bwd_tf32x3.py``, ``plain`` plain_forward and its autograd in fp32, ``fp64`` the
same in float64, rounded once.  Each line gives the readings on the
tensors that sit nearest their limits, the tensor nearest rule (b)'s limit
(its error over the limit), and every rule that fails.  The mixture
kernels and the rest of the step are the port's in every pair.  Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import statistics
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def net_forward(ws, x, num_heads, dtype):
    """The coupling net of the 12-tuple ``ws`` in ``dtype``, as
    ``plain_forward`` computes it (differentiable)."""
    import torch
    import torch.nn.functional as F
    (ew, eb, qw, qb, pw, pb, f1w, f1b, f2w, f2b, ow, ob) = (
        w.to(dtype) for w in ws)

    def ln(h):
        mu = h.mean(-1, keepdim=True)
        var = ((h - mu) ** 2).mean(-1, keepdim=True)
        return (h - mu) * torch.rsqrt(var + 1e-5)

    h = x.to(dtype) @ ew + eb[0]
    B, T, H = h.shape
    hd = H // num_heads
    for l in range(qw.shape[0]):
        qkv = (ln(h) @ qw[l] + qb[l]).reshape(B, T, 3, num_heads, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        p = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
        h = h + (p @ v).transpose(1, 2).reshape(B, T, H) @ pw[l] + pb[l]
        m = F.gelu(ln(h) @ f1w[l] + f1b[l], approximate="tanh")
        h = h + m @ f2w[l] + f2b[l]
    return ln(h) @ ow + ob[0]


def forward_errors(cs, device) -> dict:
    import torch
    from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft
    net = cs.flagship_net("float32", device)
    x = torch.randn(cs.EVAL_CHAINS * cs.B, cs.S, cs.D, device=device,
                    generator=torch.Generator(device).manual_seed(3))
    out = {}
    with torch.no_grad():
        ws = ft.flatten_params(net)
        packed = ft.PackedWeights(ws, torch.float32)
        exact = net_forward(ws, x, cs.HEADS, torch.float64)
        for name, y in (
                ("tf32x3", ft.fused_set_transformer(packed, x,
                                                    num_heads=cs.HEADS)),
                ("fma", ft.FusedSetTransformer.apply(x, packed, cs.HEADS,
                                                     None, *ws)),
                ("plain", net.plain_forward(x))):
            err = y.double() - exact
            out[name] = {
                "rel_err": float(err.norm() / exact.norm()),
                "signed_bias": float((err * exact.sign()).mean()
                                     / exact.abs().mean())}
    return out


# the tensors nearest their limits at seeds 0-2 on an H100 80GB HBM3
SENSITIVE = ("flow.layers.0.bias", "flow.layers.2.mean_offsets",
             "flow.layers.4.bias", "flow.layers.1.upper")
PAIRS = (("fma", "fma"), ("tf32x3", "tf32x3"), ("tf32x3", "plain"),
         ("plain", "tf32x3"), ("fp64", "fp64"))


def _tf32x3_pair():
    """The 3xTF32 forward kernel tied to the 3xTF32 backward kernel."""
    import torch
    from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft
    spec = importlib.util.spec_from_file_location(
        "f32_bwd_tf32x3", os.path.join(REPO, "tools", "f32_bwd_tf32x3.py"))
    bwd = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bwd)

    class Tf32x3(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, packed, num_heads, *ws):
            ctx.packed, ctx.num_heads = packed, num_heads
            ctx.save_for_backward(x)
            return ft.fused_set_transformer(packed, x.detach(),
                                            num_heads=num_heads)

        @staticmethod
        def backward(ctx, g):
            (x,) = ctx.saved_tensors
            dx, dws = bwd.fused_set_transformer_bwd(
                ctx.packed, x, g, num_heads=ctx.num_heads)
            return (dx, None, None, *dws)

    return Tf32x3


def use_pair(fwd: str, bwd: str, kernel_forward):
    """A SetTransformer.forward whose output, on the card, takes its values
    from ``fwd`` and its gradient from ``bwd``; CPU tensors take
    ``kernel_forward`` (the port's forward, which sends them to the plain
    path)."""
    import torch
    from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft
    tf32x3 = _tf32x3_pair()

    def net(self, x, kind):
        if kind == "plain":
            return self.plain_forward(x)
        if kind == "fp64":
            ws = ft.flatten_params(self)
            return net_forward(ws, x, self.num_heads,
                               torch.float64).to(x.dtype)
        packed = self._packed_weights(torch.float32)
        fn = ft.FusedSetTransformer if kind == "fma" else tf32x3
        return fn.apply(x, packed, self.num_heads, *ft.flatten_params(self))

    def forward(self, x, cond=None, mask=None):
        if not x.is_cuda:
            return kernel_forward(self, x, cond, mask)
        y = net(self, x, bwd)
        if fwd == bwd:
            return y
        with torch.no_grad():
            y_fwd = net(self, x.detach(), fwd)
        return y + (y_fwd - y).detach()

    return forward


def train_step_pairs(cs, seed: int) -> list:
    from categoricalnf_tpu_torch.networks import SetTransformer
    out = []
    for fwd, bwd in PAIRS:
        kernel_forward = SetTransformer.forward
        SetTransformer.forward = use_pair(fwd, bwd, kernel_forward)
        try:
            readings, _, _ = cs.train_step_readings(seed)
        finally:
            SetTransformer.forward = kernel_forward
        ratio = {k: r[2] / max(cs.KERNELS_VS_PLAIN_CARD, 2 * r[1])
                 for k, r in readings.items()}
        worst = max(ratio, key=ratio.get)
        out.append({
            "seed": seed, "pair": f"{fwd}/{bwd}",
            **{key: {t: readings[t][i] for t in SENSITIVE}
               for i, key in enumerate(("cpu_f32_vs_fp64",
                                        "plain_card_vs_fp64",
                                        "kernels_vs_fp64"))},
            "kernels_vs_fp64_median": statistics.median(
                r[2] for r in readings.values()),
            "nearest_limit_b": [worst, ratio[worst], readings[worst][2]],
            "failed": cs.train_step_failures(readings)})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("f32_forward_rounding: no CUDA device")
    sys.path.insert(0, REPO)
    from categoricalnf_tpu_torch.utils.device import resolve_device
    cs = _chip_smoke()
    device = resolve_device("cuda")
    print(json.dumps({"card": cs.card_line(),
                      "forward_vs_fp64": forward_errors(cs, device)}),
          flush=True)
    for seed in args.seeds:
        for line in train_step_pairs(cs, seed):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
