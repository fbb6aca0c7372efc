#!/usr/bin/env python3
"""How the fp32 coupling-net forwards round, and what that does to the fp32
train step's gradient checks.  Run from the root of a checkout on a machine
with one NVIDIA card:

    python3 tools/f32_forward_rounding.py --forward fma|tf32x3|plain|fp64

Prints one JSON line.  ``forward_vs_fp64``: on chip_smoke's seeded
flagship net at eval_bpd's 65,536 rows, the relative norm error and the
signed bias (the mean of the error times the sign of the exact value, over
the mean magnitude) against the same net in fp64, of the 3xTF32 kernel
(calls without grad), the FMA kernel (differentiable calls) and
``plain_forward``.  ``train_step``: chip_smoke's fp32 train step against its
CPU copy and against the plain path on the card, with every coupling net's
output taken from ``--forward`` (the FMA kernel as the port runs it, the
3xTF32 kernel, the same net in fp32 or in fp64 rounded once) and its
backward the fp32 FMA kernel as always: the worst relative gradient error
of each comparison and every check that fails at chip_smoke's limits.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
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
    ``plain_forward`` computes it."""
    import torch
    import torch.nn.functional as F
    (ew, eb, qw, qb, pw, pb, f1w, f1b, f2w, f2b, ow, ob) = (
        w.detach().to(dtype) for w in ws)

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
                                                     *ws)),
                ("plain", net.plain_forward(x))):
            err = y.double() - exact
            out[name] = {
                "rel_err": float(err.norm() / exact.norm()),
                "signed_bias": float((err * exact.sign()).mean()
                                     / exact.abs().mean())}
    return out


def use_forward(forward: str) -> None:
    """Make every differentiable fp32 net call output ``forward``'s result;
    the backward stays the FMA kernel."""
    import torch
    from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft
    if forward == "fma":
        return
    kernel_forward = ft.FusedSetTransformer.forward

    def patched(ctx, x, packed, num_heads, *ws):
        y = kernel_forward(ctx, x, packed, num_heads, *ws)
        if forward == "tf32x3":
            return ft.fused_set_transformer(packed, x, num_heads=num_heads)
        dtype = torch.float32 if forward == "plain" else torch.float64
        return net_forward(ws, x, num_heads, dtype).to(y.dtype)

    ft.FusedSetTransformer.forward = staticmethod(patched)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--forward", default="fma",
                    choices=["fma", "tf32x3", "plain", "fp64"])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("f32_forward_rounding: no CUDA device")
    sys.path.insert(0, REPO)
    from categoricalnf_tpu_torch.utils.device import resolve_device
    cs = _chip_smoke()
    device = resolve_device("cuda")
    result = {"card": cs.card_line(), "forward": args.forward,
              "forward_vs_fp64": forward_errors(cs, device)}
    use_forward(args.forward)
    failed = []
    cs.check = lambda cond, msg: None if cond else failed.append(msg)
    report: dict = {}
    cs.check_train_step_against_cpu(0, report)
    result["train_step"] = {
        **{k: v for k, v in report.items() if k.startswith(("kernels",
                                                            "plain"))},
        "failed_checks": failed}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
