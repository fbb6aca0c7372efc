#!/usr/bin/env python3
"""Time #3 fp32 (the 3xTF32 forward, ``csrc/fused_transformer_tf32x3.cu``)
at sets above 32 for one or more checkouts on one card.

    python3 tools/tf32x3_big_ab.py DIR [DIR ...]

For each DIR, in a process of its own (imports the port from DIR and that
checkout's ``chip_smoke.py``): the device ms of a call on 4 chains x 1024
sets of 48, 64 and 128 rows (the set-64 and set-128 evals' shape, all
three in the ``BIG`` instance; its layout is the checkout's own) on
``chip_smoke.flagship_net("float32")``, timed by
``chip_smoke.cuda_ms`` over 10 calls, and the sum of each output as a
check that the trees compute the same.  One JSON line a tree.  Give the
trees as A B B A to compare two in one call.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def run_one(tree: str) -> dict:
    root = os.path.abspath(tree)
    os.chdir(root)
    sys.path.insert(0, root)
    import torch
    import chip_smoke as cs
    from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft
    dev = torch.device("cuda")
    net = cs.flagship_net("float32", dev)
    out = {}
    with torch.no_grad():
        packed = ft.PackedWeights(ft.flatten_params(net), torch.float32)
        g = torch.Generator(dev).manual_seed(5)
        for s in (48, 64, 128):
            x = torch.randn(cs.EVAL_CHAINS * cs.B, s, cs.D, generator=g,
                            device=dev)
            y = ft.fused_set_transformer(packed, x, num_heads=cs.HEADS)
            ms, _ = cs.cuda_ms(lambda: ft.fused_set_transformer(
                packed, x, num_heads=cs.HEADS), 10)
            out[s] = {"ms": ms, "sum": float(y.double().sum())}
    return {"tree": tree, "card": cs.card_line(), "sets": out}


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
