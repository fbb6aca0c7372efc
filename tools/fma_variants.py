#!/usr/bin/env python3
"""Where the fp32 train step's pair spends its time: time variants of
``csrc/fused_transformer.cu`` (#3 fp32 with grad and #4 fp32) on one card.

    python3 tools/fma_variants.py [--tree DIR] [--variants base no_wgrad ...]

Each variant is a copy of the checkout DIR's port in a temporary directory
with named edits of that source; ``tools/fused_ab.py --pair`` builds and
times it (the flagship at 1,024, 4,096 and 16,384 rows, the node flow at
hidden 96 and 128 on 1,536 rows), and its results are compared with the
first variant's (bitwise, and device ms).  ``no_rings`` (the dense
products' weights straight from global memory), ``bwd_threads_512``,
``bwd_threads_192``, ``inline_wgrad`` and ``fwd_launch_1`` keep every
output bitwise; the
others leave a phase out or change its arithmetic, give wrong gradients
and say only what that phase costs.  The edits match
the source as this tool was written: an edit that no longer matches stops
the tool.  Prints one JSON line a variant, the card line first.  Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join("categoricalnf_tpu_torch", "csrc", "fused_transformer.cu")

# (text, replacement[, how many times the text occurs]) edits of the
# source, by variant
VARIANTS = {
    "base": [],
    # the weights of the dense products from global memory, no rings
    "no_rings": [("  dm.rings = bytes + rings <= (size_t)kMaxSmem &&",
                  "  dm.rings = false &&")],
    "no_wgrad": [("float* __restrict__ pb, int valid,\n"
                  "                                        bool first) {\n",
                  "float* __restrict__ pb, int valid,\n"
                  "                                        bool first) {\n"
                  "  return;\n")],
    # both dispatchers, the forward's and the backward's
    "no_attention": [("KeyMask& km) {\n  const bool v4 =",
                      "KeyMask& km) {\n  return;\n  const bool v4 =", 2)],
    "no_dense_bwd": [(
        "  const int ldw = pad4(kd), nkg = ldw / kMC, nrg = dm.tile_pad / "
        "kMR;\n",
        "  return;\n  const int ldw = pad4(kd), nkg = ldw / kMC, nrg = "
        "dm.tile_pad / kMR;\n")],
    "no_dense": [(
        "  const int ldw = pad4(n), ncg = ldw / kMC, nrg = dm.tile_pad / "
        "kMR;\n",
        "  return;\n  const int ldw = pad4(n), ncg = ldw / kMC, nrg = "
        "dm.tile_pad / kMR;\n")],
    # the softmax's exp and divisions as fast intrinsics and products
    # (values wrong): what their IEEE sequences cost
    "fast_softmax": [("expf(", "__expf(", 3), ("/ root_hd", "* root_hd", 4),
                     ("own<MAXS, P>(p, m, half) / sum",
                      "own<MAXS, P>(p, m, half) * sum"),
                     ("/ st[1]", "* st[1]", 2)],
    # the weight-gradient scratch stored, never read back (values wrong):
    # what its read-modify-write costs
    "no_scratch_read": [
        ("if (!first)", "if (false)", 3),
        ("first ? acc[i][j] : old[i][j] + acc[i][j]", "acc[i][j]"),
        ("first ? acc[j] : old[j] + acc[j]", "acc[j]")],
    # the backward in blocks of 512 threads (128 registers a thread), or of
    # 192 (6 warps: the items of hidden 96 at 32 rows and of hidden 128 at
    # 24 rows fill them)
    "bwd_threads_512": [("constexpr int kBwdThreads = 256;",
                         "constexpr int kBwdThreads = 512;")],
    "bwd_threads_192": [("constexpr int kBwdThreads = 256;",
                         "constexpr int kBwdThreads = 192;")],
    # the weight gradients inlined into the kernel (bitwise)
    "inline_wgrad": [("__device__ __noinline__ void wgrad_tile(",
                      "__device__ void wgrad_tile(")],
    # the forward at one block an SM by its launch bounds (bitwise)
    "fwd_launch_1": [("__launch_bounds__(kThreads, 2)",
                      "__launch_bounds__(kThreads, 1)")],
    "no_layer_norm": [
        ("__device__ void layer_norm_tile(const float* in, float* out, "
         "const Dims& dm) {\n",
         "__device__ void layer_norm_tile(const float* in, float* out, "
         "const Dims& dm) {\n  return;\n"),
        ("                                    float* gout, const Dims& dm) "
         "{\n  const int lane",
         "                                    float* gout, const Dims& dm) "
         "{\n  return;\n  const int lane")],
}


def variant_tree(tree: str, name: str, root: str) -> str:
    """A copy of ``tree``'s port under ``root`` with ``name``'s edits."""
    dst = os.path.join(root, name)
    shutil.copytree(os.path.join(tree, "categoricalnf_tpu_torch"),
                    os.path.join(dst, "categoricalnf_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = os.path.join(dst, SOURCE)
    with open(path) as f:
        text = f.read()
    for old, new, *times in VARIANTS[name]:
        if text.count(old) != (times[0] if times else 1):
            sys.exit(f"fma_variants: the edit of {name} does not match "
                     f"{SOURCE} as it should")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return dst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(HERE),
                    help="checkout whose port to vary")
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=list(VARIANTS))
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    fused_ab = os.path.join(HERE, "fused_ab.py")
    with tempfile.TemporaryDirectory() as root:
        first = None
        for name in args.variants:
            tree = variant_tree(args.tree, name, root)
            out = os.path.join(root, f"{name}.pt")
            run = subprocess.run([sys.executable, fused_ab, "--tree", tree,
                                  "--out", out, "--pair"],
                                 capture_output=True, text=True)
            if run.returncode != 0:
                print(run.stdout[-2000:], run.stderr[-4000:], flush=True)
                return 1
            result = json.loads(run.stdout.strip().splitlines()[-1])
            line = {"variant": name,
                    "ms": {k: v for k, v in result.items()
                           if k.endswith(tuple("0123456789"))}}
            ptxas = result["fma_pair_ptxas"]
            line["registers"] = {k.split("fused_set_transformer_")[-1][:3]:
                                 v for k, v in ptxas.items()
                                 if "fused_set_transformer" in k}
            if first is None:
                first = out
            else:
                cmp = subprocess.run([sys.executable, fused_ab, "--compare",
                                      first, out], capture_output=True,
                                     text=True)
                line["bitwise_as_first"] = cmp.returncode == 0
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
