#!/usr/bin/env python3
"""Compare the fused SetTransformer kernels of two checkouts on one card:
in bf16 #3 (the forward) and #4 (the backward) at a flagship train step's
shape, 1024 sets of 16 (16,384 rows); in fp32 #3 at eval_bpd's shape, 4096
sets of 16 (65,536 rows), and the fp32 train step's pair, #3 as a
differentiable call runs it and #4, with the 3xTF32 #4 of
``tools/f32_bwd_tf32x3.py`` where the checkout has it, at 64, 256 and 1024
sets of 16 (1,024, 4,096 and 16,384 rows: a flagship fp32 step,
chip_smoke's checks, a flagship batch) and at GraphCNF's node flow (hidden
96 and 128, 64 graphs of 24 nodes, in 6, out 156, no mask: 1,536 rows),
with ptxas's registers and spills of the pair, and, in checkouts whose
fp32 #4 has a global workspace, that #4 with the workspace layout forced
at hidden 96 and 128 (64 and 128 graphs, masked) against its shared
layout (``chip_smoke.fma_workspace_bitwise``, which fails unless the two
are bitwise equal); and, in checkouts whose kernels take a key mask,
#3/#4 bf16 and #3 fp32 at GraphCNF's node flow (hidden 192, 128 graphs of
24 nodes, masked; fp32 at 4 chains); on chip_smoke's seeded nets.

    python3 tools/fused_ab.py --tree DIR --out A.pt   # DIR: a checkout
    python3 tools/fused_ab.py --tree DIR --out A.pt --pair
    python3 tools/fused_ab.py --compare A.pt B.pt

The first form imports the port from DIR, runs the kernels once, saves
their results and prints each kernel's device ms (``chip_smoke.cuda_ms``)
and the fp32 forward's relative norm error against the tree's own plain
path (TF32 off); with ``--pair`` it runs only the fp32 train step's pair.
The last says whether the bf16 #4's gradients (dx and the 12 weight
gradients) are bitwise equal (at hidden 192 too, with both forwards there:
``bwd_bitwise_equal`` holds all of them) and how far apart the two trees'
forwards are, in each dtype, and whether the fp32 train step's pair gives
bitwise equal outputs (#3) and gradients (#4's dx and 12 weight gradients)
at each of its shapes, and how far apart they are (the largest relative
norm difference; the 3xTF32 #4's against the other tree's FMA #4); it
exits 1 unless every bitwise comparison holds.  The net, the timing and
the card line are this checkout's ``chip_smoke.py``.  Imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import sys


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _tf32x3_bwd(tree: str):
    """The checkout's ``tools/f32_bwd_tf32x3.py``, or None."""
    path = os.path.join(tree, "tools", "f32_bwd_tf32x3.py")
    if not os.path.exists(path):
        return None
    spec = importlib.util.spec_from_file_location("f32_bwd_tf32x3", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run(tree: str, out: str, pair_only: bool = False) -> None:
    cs = _chip_smoke()
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from categoricalnf_tpu_torch.ops.cuda import build
    from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft
    if not torch.cuda.is_available():
        sys.exit("fused_ab: no CUDA device")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    # the pair's sources (its workspace instance in a source of its own
    # in trees that have one)
    pair = [n for n in ("fused_transformer", "fused_transformer_f32_ws")
            if os.path.exists(os.path.join(tree, "categoricalnf_tpu_torch",
                                           "csrc", f"{n}.cu"))]
    result = {"tree": tree, "card": cs.card_line(),
              "fma_pair_ptxas": cs.kernel_resources("".join(
                  build.build_all(pair).values()))}
    if pair_only:
        with torch.no_grad():
            train = _train_pair(cs, ft, dev, None, result)
        torch.save({"train": train, **result}, out)
        print(json.dumps(result), flush=True)
        return
    net = cs.flagship_net("bfloat16", dev)
    g = torch.Generator(dev).manual_seed(2)
    x = torch.randn(cs.B, cs.S, cs.D, generator=g, device=dev)
    gy = torch.randn(cs.B, cs.S, cs.OUT, generator=g, device=dev).bfloat16()
    with torch.no_grad():
        packed = ft.PackedWeights(ft.flatten_params(net), torch.bfloat16)

        def fwd():
            return ft.fused_set_transformer(packed, x, num_heads=cs.HEADS)

        def bwd():
            return ft.fused_set_transformer_bwd(packed, x, gy,
                                                num_heads=cs.HEADS)

        y = fwd()
        dx, dws = bwd()
        torch.cuda.synchronize()
        result.update(fwd_ms=cs.cuda_ms(fwd, 20)[0],
                      bwd_ms=cs.cuda_ms(bwd, 10)[0])

        net32 = cs.flagship_net("float32", dev)
        x32 = torch.randn(cs.EVAL_CHAINS * cs.B, cs.S, cs.D, generator=g,
                          device=dev)
        packed32 = ft.PackedWeights(ft.flatten_params(net32), torch.float32)

        def fwd32():
            return ft.fused_set_transformer(packed32, x32,
                                            num_heads=cs.HEADS)

        y32 = fwd32()
        result["fwd_f32_rel_err"] = cs.rel_err(y32, net32.plain_forward(x32))
        result["fwd_f32_ms"] = cs.cuda_ms(fwd32, 20)[0]

        tf32x3 = _tf32x3_bwd(tree)
        if tf32x3 is not None:
            result["bwd_f32_tf32x3_ptxas"] = {
                k: v for k, v in cs.kernel_resources(tf32x3.build_log())
                .items() if "bwd" in k}
        train = _train_pair(cs, ft, dev, tf32x3, result)
        # GraphCNF's node flow (hidden 192, 128 graphs of 24 nodes, its key
        # mask), in a checkout whose kernels take the mask
        g3 = torch.Generator(dev).manual_seed(4)
        mol = {}
        if _takes_mask(ft):
            mask = cs.molecule_key_mask(0, dev)
            xm = torch.randn(cs.MOL_BATCH, cs.MOL_NODES, cs.MOL_NODE_DIM,
                             generator=g3, device=dev)
            gm = torch.randn(cs.MOL_BATCH, cs.MOL_NODES, cs.MOL_OUT,
                             generator=g3, device=dev).bfloat16()
            netm = cs.molecule_net("bfloat16", dev, 0)
            pm = ft.PackedWeights(ft.flatten_params(netm), torch.bfloat16)
            mol["y"] = ft.fused_set_transformer(pm, xm, num_heads=cs.HEADS,
                                                mask=mask).cpu()
            dxm, dwsm = ft.fused_set_transformer_bwd(
                pm, xm, gm, num_heads=cs.HEADS, mask=mask)
            mol["grads"] = [dxm.cpu()] + [t.cpu() for t in dwsm]
            netm32 = cs.molecule_net("float32", dev, 0)
            pm32 = ft.PackedWeights(ft.flatten_params(netm32), torch.float32)
            mask4 = mask.repeat(cs.EVAL_CHAINS, 1)
            xm4 = torch.randn(cs.EVAL_CHAINS * cs.MOL_BATCH, cs.MOL_NODES,
                              cs.MOL_NODE_DIM, generator=g3, device=dev)
            mol["y32"] = ft.fused_set_transformer(
                pm32, xm4, num_heads=cs.HEADS, mask=mask4).cpu()
            result["mol_fwd_ms"] = cs.cuda_ms(lambda: ft.fused_set_transformer(
                pm, xm, num_heads=cs.HEADS, mask=mask), 20)[0]
            result["mol_bwd_ms"] = cs.cuda_ms(
                lambda: ft.fused_set_transformer_bwd(
                    pm, xm, gm, num_heads=cs.HEADS, mask=mask), 10)[0]
    torch.save({"y": y.cpu(), "dx": dx.cpu(), "y32": y32.cpu(),
                "dws": [t.cpu() for t in dws], "train": train, "mol": mol,
                **result}, out)
    print(json.dumps(result), flush=True)


def _takes_mask(ft) -> bool:
    """Whether the checkout's FusedSetTransformer takes a key mask."""
    return "mask" in inspect.signature(
        ft.FusedSetTransformer.forward).parameters


def _train_pair(cs, ft, dev, tf32x3, result: dict) -> dict:
    """The fp32 train step's pair (#3 as a differentiable call runs it,
    #4) at the flagship's 64, 256 and 1024 sets of 16 and at the node
    flow's hidden 96 and 128 (64 graphs of 24 nodes, no mask: a checkout
    from before the pair took one runs it too), with the 3xTF32 #4 of
    ``tf32x3`` (the checkout's tool, or None) at the flagship's; inputs
    from a generator of their own.  Returns the results by shape."""
    import torch
    net32 = cs.flagship_net("float32", dev)
    ws32 = ft.flatten_params(net32)
    packed32 = ft.PackedWeights(ws32, torch.float32)
    g3 = torch.Generator(dev).manual_seed(3)
    # no key mask here; a checkout from before the mask takes no slot
    mask_slot = (None,) if _takes_mask(ft) else ()
    train = {}
    for sets in (cs.B // 16, cs.B // 4, cs.B):
        rows = sets * cs.S
        xt = torch.randn(sets, cs.S, cs.D, generator=g3, device=dev)
        gt = torch.randn(sets, cs.S, cs.OUT, generator=g3, device=dev)
        train[rows] = _pair(
            cs, lambda: ft.FusedSetTransformer.apply(
                xt, packed32, cs.HEADS, *mask_slot, *ws32),
            lambda: ft.fused_set_transformer_bwd(packed32, xt, gt,
                                                 num_heads=cs.HEADS),
            result, rows)
        if tf32x3 is not None:

            def bwd_tf32x3():
                return tf32x3.fused_set_transformer_bwd(
                    packed32, xt, gt, num_heads=cs.HEADS)

            dxt, dwst = bwd_tf32x3()
            train[f"tf32x3_{rows}"] = [dxt.cpu()] + [t.cpu() for t in dwst]
            result[f"bwd_f32_tf32x3_ms_{rows}"] = cs.cuda_ms(bwd_tf32x3,
                                                             10)[0]
    for hidden in (96, 128):
        netn = cs.molecule_net("float32", dev, 0, hidden, cs.MOL_OUT)
        wsn = ft.flatten_params(netn)
        pn = ft.PackedWeights(wsn, torch.float32)
        xn = torch.randn(64, cs.MOL_NODES, cs.MOL_NODE_DIM, generator=g3,
                         device=dev)
        gn = torch.randn(64, cs.MOL_NODES, cs.MOL_OUT, generator=g3,
                         device=dev)
        train[f"h{hidden}"] = _pair(
            cs, lambda: ft.FusedSetTransformer.apply(
                xn, pn, cs.HEADS, *mask_slot, *wsn),
            lambda: ft.fused_set_transformer_bwd(pn, xn, gn,
                                                 num_heads=cs.HEADS),
            result, f"h{hidden}")
    if hasattr(ft, "FMA_WS_REGIONS"):
        result["workspace_layout"] = cs.fma_workspace_bitwise(dev, 0)
    return train


def _pair(cs, fwd, bwd, result: dict, key) -> list:
    """The fp32 train step's pair once (#3's output, #4's dx and 12 weight
    gradients, on the host) and timed, its device ms into ``result``."""
    y = fwd()
    dx, dws = bwd()
    out = [y.cpu(), dx.cpu()] + [t.cpu() for t in dws]
    result[f"fwd_f32_grad_ms_{key}"] = cs.cuda_ms(fwd, 20)[0]
    result[f"bwd_f32_ms_{key}"] = cs.cuda_ms(bwd, 10)[0]
    return out


def rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def pair_readings(one: dict, two: dict) -> tuple[dict, bool]:
    """The fp32 train step's pair of two runs, shape by shape: whether #3's
    outputs and #4's gradients are bitwise equal, how far apart they are,
    the device ms of each; and whether every comparison is bitwise equal."""
    import torch
    pair = {}
    for key in one["train"]:
        if str(key).startswith("tf32x3"):
            continue
        p, q = one["train"][key], two["train"][key]
        pair[f"train_f32_{key}"] = {
            "fwd_bitwise_equal": torch.equal(p[0], q[0]),
            "bwd_bitwise_equal": all(torch.equal(u, v)
                                     for u, v in zip(p[1:], q[1:])),
            "fwd_grad_rel_diff": rel(p[0], q[0]),
            "bwd_rel_diff_max": max(rel(u, v) for u, v in zip(p[1:], q[1:])),
            "fwd_grad_ms": [one[f"fwd_f32_grad_ms_{key}"],
                            two[f"fwd_f32_grad_ms_{key}"]],
            "bwd_ms": [one[f"bwd_f32_ms_{key}"], two[f"bwd_f32_ms_{key}"]],
            # each tree's 3xTF32 #4 against the other tree's FMA #4
            "tf32x3_bwd": [
                {"ms": a[f"bwd_f32_tf32x3_ms_{key}"],
                 "rel_diff_max": max(rel(u, v) for u, v in zip(
                     a["train"][f"tf32x3_{key}"], b["train"][key][1:]))}
                if f"tf32x3_{key}" in a["train"] else None
                for a, b in ((one, two), (two, one))]}
    return pair, all(v["fwd_bitwise_equal"] and v["bwd_bitwise_equal"]
                     for v in pair.values())


def compare(a: str, b: str) -> bool:
    import torch
    one, two = torch.load(a), torch.load(b)
    pair, pair_same = pair_readings(one, two)
    head = {"a": one["tree"], "b": two["tree"],
            "f32_pair_bitwise_equal": pair_same,
            "fma_pair_ptxas": [one.get("fma_pair_ptxas"),
                               two.get("fma_pair_ptxas")],
            # each tree's fp32 #4 with the workspace forced against its
            # shared layout (held bitwise where the tree has it)
            "workspace_layout": [one.get("workspace_layout"),
                                 two.get("workspace_layout")]}
    if "dx" not in one or "dx" not in two:  # runs of the pair alone
        print(json.dumps({**head, **pair}), flush=True)
        return pair_same
    same = torch.equal(one["dx"], two["dx"]) and all(
        torch.equal(p, q) for p, q in zip(one["dws"], two["dws"]))
    ya, yb = one["y"].float(), two["y"].float()
    fa, fb = one["y32"], two["y32"]
    ma, mb = one.get("mol") or {}, two.get("mol") or {}
    mol = {}
    if ma and mb:
        mol = {"mol_bwd_bitwise_equal": all(
                   torch.equal(p, q) for p, q in zip(ma["grads"],
                                                     mb["grads"])),
               "mol_fwd_bitwise_equal": torch.equal(ma["y"], mb["y"]),
               "mol_fwd_f32_bitwise_equal": torch.equal(ma["y32"], mb["y32"]),
               "mol_fwd_ms": [one["mol_fwd_ms"], two["mol_fwd_ms"]],
               "mol_bwd_ms": [one["mol_bwd_ms"], two["mol_bwd_ms"]]}
        same = same and all(v for k, v in mol.items()
                            if k.endswith("bitwise_equal"))
    print(json.dumps({
        **head, "bwd_bitwise_equal": same, **mol,
        "fwd_bitwise_equal": torch.equal(ya, yb),
        "fwd_rel_diff": float((ya - yb).norm() / yb.norm()),
        "fwd_max_abs_diff": float((ya - yb).abs().max()),
        "fwd_f32_bitwise_equal": torch.equal(fa, fb),
        "fwd_f32_rel_diff": float((fa - fb).norm() / fb.norm()),
        "fwd_f32_ms": [one["fwd_f32_ms"], two["fwd_f32_ms"]],
        "fwd_f32_rel_err": [one["fwd_f32_rel_err"],
                            two["fwd_f32_rel_err"]],
        **pair}), flush=True)
    return same and pair_same


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", help="checkout whose port to run")
    ap.add_argument("--out", help="file for the results")
    ap.add_argument("--compare", nargs=2, metavar="FILE")
    ap.add_argument("--pair", action="store_true",
                    help="run only the fp32 train step's pair")
    args = ap.parse_args()
    if args.compare:
        return 0 if compare(*args.compare) else 1
    if not (args.tree and args.out):
        ap.error("give --tree and --out, or --compare")
    run(args.tree, args.out, args.pair)
    return 0


if __name__ == "__main__":
    sys.exit(main())
