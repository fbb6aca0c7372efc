#!/usr/bin/env python3
"""Whether two checkouts compile a CUDA source of the port to the same
machine code, function by function, on a machine with the CUDA toolkit.

    python3 tools/sass_diff.py --source fused_transformer_bf16 OLD NEW

Builds ``csrc/<source>.cu`` of each checkout (the port's own nvcc flags,
into each checkout's git-ignored ``_build/``), dumps each library's SASS
with ``cuobjdump -sass`` and compares the instructions of every function
the first checkout has, with the anonymous namespace's per-build names,
addresses and encodings left out.  Prints one JSON line: the functions
that are the same, those that differ, and those only the second has.
A change that leaves a kernel "code for code" as it was shows it here.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

_ANON = re.compile(
    r"_(?:GLOBAL__N__|INTERNAL_)[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}")


def _library(tree: str, source: str) -> str:
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from "
            "categoricalnf_tpu_torch.ops.cuda import build; "
            f"build.build_all([{source!r}]); "
            f"print(build.library_path({source!r}))")
    out = subprocess.run([sys.executable, "-c", code, tree], check=True,
                         capture_output=True, text=True).stdout
    return out.strip().splitlines()[-1]


def sass_functions(library: str) -> dict:
    """Each function's instructions in ``library``, names normalised."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", library], check=True,
                          capture_output=True, text=True).stdout
    out: dict = {}
    name = None
    for line in text.splitlines():
        if "Function : " in line:
            name = _ANON.sub("ANON", line.split("Function : ")[1].strip())
            out[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if name and m:
            # a call's target by offset moves where other functions moved
            ins = re.sub(r"(CALL\S*) 0x[0-9a-f]+", r"\1", m.group(1))
            out[name].append(_ANON.sub("ANON", ins))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", default="fused_transformer_bf16")
    ap.add_argument("old")
    ap.add_argument("new")
    args = ap.parse_args()
    old, new = (sass_functions(_library(t, args.source))
                for t in (args.old, args.new))
    same = sorted(f for f in old if new.get(f) == old[f])
    print(json.dumps({
        "source": args.source, "same": same,
        "different": sorted(f for f in old if f in new and new[f] != old[f]),
        "missing": sorted(f for f in old if f not in new),
        "new_only": sorted(f for f in new if f not in old)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
