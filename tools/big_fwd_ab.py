#!/usr/bin/env python3
"""Time #3's BIG forwards (sets of 33-128) for one or more checkouts on one
card: #3 bf16 (``csrc/fused_transformer_bf16.cu``) and #3 fp32 with grad,
the fp32 train step's forward (``csrc/fused_transformer_f32_big.cu``).

    python3 tools/big_fwd_ab.py DIR [DIR ...]

For each DIR, in a process of its own (imports the port from DIR and that
checkout's ``chip_smoke.py``): ptxas's registers and spilled bytes of the
two kernels, and the device ms of a call at 1,024 sets of 64 and of 128 on
``chip_smoke.flagship_net`` (bf16 and fp32), timed by
``chip_smoke.cuda_ms`` over 10 calls, with the sum of each output as a
check that the trees compute alike.  One JSON line a tree.  Give the trees
as A B B A to compare two in one call.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

SETS = (64, 128)


def run_one(tree: str) -> dict:
    root = os.path.abspath(tree)
    os.chdir(root)
    sys.path.insert(0, root)
    import torch
    import chip_smoke as cs
    from categoricalnf_tpu_torch.ops.cuda import build
    from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft
    dev = torch.device("cuda")
    logs = build.build_all(["fused_transformer_bf16",
                            "fused_transformer_f32_big"])
    out: dict = {"tree": tree, "card": cs.card_line(), "ptxas": {}}
    for source, tag in (("fused_transformer_bf16", "bf16"),
                        ("fused_transformer_f32_big", "f32")):
        for name, v in cs.kernel_resources(logs[source]).items():
            if "fused_set_transformer_fwdILb1E" in name:
                out["ptxas"][tag] = v
    nets = {cd: cs.flagship_net(cd, dev) for cd in ("bfloat16", "float32")}
    packed = {cd: net._packed_weights(getattr(torch, cd))
              for cd, net in nets.items()}
    ws = ft.flatten_params(nets["float32"])
    g = torch.Generator(dev).manual_seed(11)
    with torch.no_grad():
        for s in SETS:
            x = torch.randn(cs.B, s, cs.D, generator=g, device=dev)
            calls = {
                "bf16": lambda: ft.fused_set_transformer(
                    packed["bfloat16"], x, num_heads=cs.HEADS),
                "f32_train": lambda: ft.FusedSetTransformer.apply(
                    x, packed["float32"], cs.HEADS, None, *ws)}
            for name, fn in calls.items():
                y = fn()
                ms, _ = cs.cuda_ms(fn, 10)
                out[f"{name}_set{s}"] = {"ms": ms,
                                         "sum": float(y.double().sum())}
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(run_one(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    rc = 0
    for tree in sys.argv[1:]:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", tree]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
