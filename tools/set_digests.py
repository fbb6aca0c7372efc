#!/usr/bin/env python3
"""Digests of the fused SetTransformer kernels' outputs on fixed inputs,
for a checkout's port, on one card.

    python3 tools/set_digests.py --tree DIR

Imports the port from DIR, builds its kernels and prints one JSON line:
the card, and the sha256 digests (first 16 hex digits) of #3 bf16's
output, #4 bf16's gradients, #3 fp32's output and the fp32 train step's
pair's at sets of 16 and 24, of all five at sets of 64 and 128, and of #4
bf16 at runs/moses' node flow (its ``GLOBAL_H`` instance;
``chip_smoke.set_digests`` of this checkout).  Run on the tree before a
change to the kernels, they are ``chip_smoke.SMALL_SET_DIGESTS``,
``PAIR_AND_BIG_SET_DIGESTS`` and ``MOSES_DIGESTS``, which chip_smoke holds
the checkout's kernels to.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True, help="checkout whose port to run")
    args = ap.parse_args()
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    from categoricalnf_tpu_torch.ops.cuda import build
    if not torch.cuda.is_available():
        sys.exit("set_digests: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all(["fused_transformer", "fused_transformer_bf16",
                     "fused_transformer_tf32x3"])
    print(json.dumps({"tree": args.tree, "card": cs.card_line(),
                      "digests": cs.set_digests(torch.device("cuda"))}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
