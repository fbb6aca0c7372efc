#!/usr/bin/env python3
"""Where the fused SetTransformer's backward spends its time: time variants
of ``csrc/fused_transformer_fma.cuh`` (#3 fp32 with grad and #4 fp32, the
device code of ``csrc/fused_transformer.cu``) or, at sets above 32, of
``csrc/fused_transformer_bf16.cu`` (#3 and #4 bf16) on one card.

    python3 tools/fma_variants.py [--tree DIR] [--variants base no_wgrad ...]
    python3 tools/fma_variants.py --big [--variants base no_attention_big ...]
    python3 tools/fma_variants.py --big --dtype bfloat16 [--variants ...]
    python3 tools/fma_variants.py --big --twin [--variants base ...]
    python3 tools/fma_variants.py --global_h [--variants base no_wgrad ...]
    python3 tools/fma_variants.py --global_h --ab P C C P

Each variant is a copy of the checkout DIR's port in a temporary directory
with named edits of that source; ``tools/fused_ab.py --pair`` builds and
times it (the flagship at 1,024, 4,096 and 16,384 rows, the node flow at
hidden 96 and 128 on 1,536 rows), and its results are compared with the
first variant's (bitwise, and device ms).  With ``--big`` the variants
build ``csrc/fused_transformer_f32_big.cu`` (the pair's instances for
sets of 33-128) all at once, one nvcc each, and each times #3 fp32 with
grad and #4 fp32 on the flagship's net at 1,024 sets of 64 and of 128,
with ptxas's registers and spilled bytes of both kernels (the spills'
traffic on the card is not measured: ncu does not run there); with
``--dtype bfloat16`` the variants (``BF16_VARIANTS``) build
``csrc/fused_transformer_bf16.cu`` and time #3 bf16 and #4 bf16 the same
way.  The ``_big`` variants leave out a part of #4's attention at the
call sites in its kernel, whose text is the same before and after the
attention's redesign for the H100, so one variant reads the same phase in
both trees: the recompute's attention (``no_attention_big``), the
attention backward (``no_attention_bwd_big``) or its key-major pass
(``no_attention_bwd_kv_big``); ``no_attention_fwd_big`` leaves out #3's
attention at its call site in the forward, likewise the same text before
and after #3's redesign, in both dtypes.
``--global_h`` builds the variants (``GLOBAL_H_VARIANTS``) of
``csrc/fused_transformer_bf16.cu`` and times #4 bf16's ``GLOBAL_H``
instance at runs/moses' node flow (4,608 rows, hidden 256, out 300,
masked), with autograd of its plain version, the digest of its outputs,
``wgrad_tiles_bf16`` alone where the tree has it, and ptxas's registers
and spills; ``--ab`` times whole checkouts so, in the order given, and
compares their outputs bitwise.  Its ``no_`` variants leave out a phase
(the parent's ``no_wgrad`` and ``no_reduce``; ``no_images``,
``no_wgrad_tiles``, ``no_attention``, ``no_dense``, ``no_layer_norm``);
``dense_one_ntile``, ``dense_no_mma``, ``dense_no_ldsm`` and ``wg_no_mma``
take a part out of the dense products or of ``wgrad_tiles``;
``attention_lanes_1``, ``no_stash``, ``images_plain``, ``kchunk_8`` and
``wg_stages_*`` keep every output bitwise.  #3's register routes at sets
above 64 (edits of a tree after that redesign): in bf16
``big_fwd_unsplit`` holds a warp's 16 n-tiles of logits whole at two
blocks an SM, ``big_fwd_launch_1`` at one; in fp32 ``fwd_launch_1``
(under ``--big``) gives the BIG instance one block an SM, and
``big_fwd_halves`` holds a lane's logits in two halves.  ``no_rings``
(the dense products' weights straight from global memory),
``bwd_threads_512``, ``bwd_threads_192``, ``inline_wgrad`` and
``fwd_launch_1`` keep every output bitwise; the
others leave a phase out or change its arithmetic, give wrong gradients
and say only what that phase costs.  The edits match
the source as this tool was written: an edit that no longer matches stops
the tool.  Prints one JSON line a variant, the card line first.  Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join("categoricalnf_tpu_torch", "csrc",
                      "fused_transformer_fma.cuh")

# #3 fp32 with grad's BIG instance (two blocks an SM, 128 registers) with
# its attention at sets above 64 holding a lane's 4 x 16 logits in two
# halves of 4 x 8 under a running max: the statistics over both halves,
# then each half's logits again and its products with V added to the
# output (sums in another order: not bitwise)
_F32_HALVES = """// #3's attention at sets of 65-128 in two halves of the keys (a
// running max), at two blocks an SM.
template <int V>
__device__ __noinline__ void attention_tiled_halves(
    const float* qkv, SetRows<float, kMaxCluster> kv, float* out,
    const Dims& dm, const BigSet& bs) {
  const int H = dm.hidden, nh = dm.heads, hd = H / nh, S = dm.set_size;
  const float inv_root = 1.0f / sqrtf((float)hd);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cg = lane >> 2;
  const int mt = (bs.n_local + 15) / 16;
  for (int item = warp; item < nh * mt; item += kThreads / 32) {
    const int hh = item / mt, r0 = item % mt * 16;
    float mx[4], sum[4], inv_sum[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mx[i] = -INFINITY;
      sum[i] = 0.0f;
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int k0 = 64 * half;
      float l[4][8];
      tile_dots<V, 8>(qkv, dm.ld_big, hh * hd, bs.n_local, r0, kv,
                      H + hh * hd, S, hd, l, k0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float m = mx[i];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int key = k0 + cg + 8 * c;
          l[i][c] = key < S ? logit_of(l[i][c], inv_root, bs.km, key)
                            : -INFINITY;
          m = fmaxf(m, l[i][c]);
        }
        m = row_max(m);
        float s = 0.0f;
#pragma unroll
        for (int c = 0; c < 8; ++c)
          if (k0 + cg + 8 * c < S) s += expf(l[i][c] - m);
        sum[i] = sum[i] * expf(mx[i] - m) + s;
        mx[i] = m;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) inv_sum[i] = 1.0f / row_sum(sum[i]);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int k0 = 64 * half;
      float l[4][8];
      tile_dots<V, 8>(qkv, dm.ld_big, hh * hd, bs.n_local, r0, kv,
                      H + hh * hd, S, hd, l, k0);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int key = k0 + cg + 8 * c;
          l[i][c] = key < S ? expf(logit_of(l[i][c], inv_root, bs.km, key) -
                                   mx[i]) * inv_sum[i]
                            : 0.0f;
        }
      tile_combine<V, 8>(l, kv, 2 * H + hh * hd, S, hd, out, dm.ld_h,
                         hh * hd, r0, bs.n_local, k0);
    }
  }
}

"""

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
    # (values wrong): what their IEEE sequences cost (the sets above 32's
    # attention backward too, which fused_ab.py --pair does not run)
    "fast_softmax": [("expf(", "__expf(", 6), ("/ root_hd", "* root_hd", 4),
                     ("own<MAXS, P>(p, m, half) / sum",
                      "own<MAXS, P>(p, m, half) * sum"),
                     ("/ st[1]", "* st[1]", 3)],
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
    # the forward at one block an SM by its launch bounds (bitwise; under
    # --big its BIG instance)
    "fwd_launch_1": [("__launch_bounds__(kThreads, 2)",
                      "__launch_bounds__(kThreads, 1)")],
    # the sets above 32: #3's attention, by its call site in the forward
    "no_attention_fwd_big": [("    attend<BIG, 1, 2>(big, a, dm, km, bs);",
                              "    if (!BIG) attend<BIG, 1, 2>(big, a, dm, "
                              "km, bs);")],
    # #3's BIG instance with its logits at sets above 64 in two halves
    # (_F32_HALVES; its tiles in TILES_SOURCE, or in SOURCE in older trees)
    "big_fwd_halves": [
        ("    float (&acc)[4][NC]) {", "    float (&acc)[4][NC], int k0 = 0) {"),
        ("      ldv<V>(bv, b.row(min(cg + 8 * c, nb - 1)) + bcol + d0);",
         "      ldv<V>(bv, b.row(min(k0 + cg + 8 * c, nb - 1)) + bcol + d0);"),
        ("    int nb, int hd, float* out, int ld_out, int ocol, int r0, "
         "int n_out) {",
         "    int nb, int hd, float* out, int ld_out, int ocol, int r0, "
         "int n_out, int k0 = 0) {"),
        ("      const float* br = b.row(min(cg + 8 * c, nb - 1)) + bcol + d0;",
         "      const float* br = b.row(min(k0 + cg + 8 * c, nb - 1)) + bcol "
         "+ d0;"),
        ("      if (V == 4 && d + 4 <= hd) {\n        stv<4>(o, h4);",
         "      if (k0 > 0)\n        for (int k = 0; k < 4; ++k)\n"
         "          if (d + k < hd) h4[k] += o[k];\n"
         "      if (V == 4 && d + 4 <= hd) {\n        stv<4>(o, h4);"),
        ("// The attention of a tile between barriers: P lanes an item,",
         _F32_HALVES + "// The attention of a tile between barriers: P lanes "
         "an item,"),
        (("      attention_tiled_big<4, 16, kStats>(qkv, kv, out, stats, dm, "
          "bs);",
          "      attend_tiled<4, 16, kStats>(qkv, kv, out, stats, dm, bs);"),
         ("      if constexpr (kStats) attention_tiled_big<4, 16, kStats>(qkv, "
          "kv, out, stats, dm, bs); else attention_tiled_halves<4>(qkv, kv, "
          "out, dm, bs);",
          "      if constexpr (kStats) attend_tiled<4, 16, kStats>(qkv, kv, "
          "out, stats, dm, bs); else attention_tiled_halves<4>(qkv, kv, out, "
          "dm, bs);")),
        (("      attention_tiled_big<1, 16, kStats>(qkv, kv, out, stats, dm, "
          "bs);",
          "      attend_tiled<1, 16, kStats>(qkv, kv, out, stats, dm, bs);"),
         ("      if constexpr (kStats) attention_tiled_big<1, 16, kStats>(qkv, "
          "kv, out, stats, dm, bs); else attention_tiled_halves<1>(qkv, kv, "
          "out, dm, bs);",
          "      if constexpr (kStats) attend_tiled<1, 16, kStats>(qkv, kv, "
          "out, stats, dm, bs); else attention_tiled_halves<1>(qkv, kv, out, "
          "dm, bs);"))],
    # the sets above 32: the attention of #4's recompute (both calls in
    # its kernel); #4's attention backward, both passes or the key-major one
    "no_attention_big": [("      attend<BIG, kBwdLanesPerItem, 1>(qkv, o, "
                          "dm, km, bs",
                          "      if (!BIG) attend<BIG, kBwdLanesPerItem, 1>("
                          "qkv, o, dm, km, bs", 2)],
    "no_attention_bwd_big": [
        ("      attend_bwd<BIG>(qkv, gs, r2, stats, dm, km, bs",
         "      if (!BIG) attend_bwd<BIG>(qkv, gs, r2, stats, dm, km, bs")],
    "no_attention_bwd_kv_big": [
        (("    attention_bwd_kv_big(qkv, rows, cluster_rows(go, dm.ld_h, "
          "dm),\n",
          "  attention_bwd_kv_big<V, NC>(qkv, rows, cluster_rows(go, "
          "dm.ld_h, dm),\n"),
         ("    if (false) attention_bwd_kv_big(qkv, rows, "
          "cluster_rows(go, dm.ld_h, dm),\n",
          "  if (false) attention_bwd_kv_big<V, NC>(qkv, rows, "
          "cluster_rows(go, dm.ld_h, dm),\n"))],
    # #4's warp-tile attention at sets above 32 inlined into its kernel
    # (bitwise)
    "inline_attention_big": [
        ("__device__ __noinline__ void attention_tiled_big(",
         "__device__ __forceinline__ void attention_tiled_big("),
        ("__device__ __noinline__ void attention_bwd_q_big(",
         "__device__ __forceinline__ void attention_bwd_q_big("),
        ("__device__ __noinline__ void attention_bwd_kv_big(",
         "__device__ __forceinline__ void attention_bwd_kv_big(")],
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


# the variants that --big runs unless told others
BIG_VARIANTS = ["base", "no_attention_fwd_big", "no_attention_big",
                "no_attention_bwd_big",
                "no_attention_bwd_kv_big", "no_dense", "no_dense_bwd",
                "no_wgrad", "no_layer_norm"]

BF16_SOURCE = os.path.join("categoricalnf_tpu_torch", "csrc",
                           "fused_transformer_bf16.cu")

# edits of BF16_SOURCE (--big --dtype bfloat16), as VARIANTS: #4 bf16's
# attention at sets above 32, by the call sites in its kernel, and its
# weight gradients
BF16_VARIANTS = {
    "base": [],
    # #3 bf16's attention at sets above 32, by its call site in the forward
    "no_attention_fwd_big": [
        ("    attend<BIG, kFwdBlocks>(big, a, dm, km, bs);",
         "    if (!BIG) attend<BIG, kFwdBlocks>(big, a, dm, km, bs);")],
    # #3 bf16's BIG instance with its logits at sets above 64 whole (16
    # n-tiles, as #4's recompute: not bitwise), at two blocks an SM or, by
    # its launch bounds, at one
    "big_fwd_unsplit": [("    attention_mma_halves(qkv, kv, o, ld_o, dm, "
                         "bs);",
                         "    attention_mma_big<16, kStats>(qkv, kv, o, ld_o, "
                         "stats, dm, bs);")],
    "big_fwd_launch_1": [("    attention_mma_halves(qkv, kv, o, ld_o, dm, "
                          "bs);",
                          "    attention_mma_big<16, kStats>(qkv, kv, o, "
                          "ld_o, stats, dm, bs);"),
                         ("__launch_bounds__(kThreads, kFwdBlocks)\n"
                          "fused_set_transformer_fwd(",
                          "__launch_bounds__(kThreads, BIG ? 1 : kFwdBlocks)"
                          "\nfused_set_transformer_fwd(")],
    # (the call sites' text before and after the GLOBAL_H instance's
    # attention took kLanes lanes an item)
    "no_attention_big": [(("      attend<BIG>(qkv, o, dm, km, bs",
                           "      attend<BIG, 1, kLanes>(qkv, o, dm, km, bs"),
                          ("      if (!BIG) attend<BIG>(qkv, o, dm, km, bs",
                           "      if (!BIG) attend<BIG, 1, kLanes>(qkv, o, "
                           "dm, km, bs"), 2)],
    "no_attention_bwd_big": [
        (("      attend_bwd<BIG>(qkv, gs, r2, stats, dm, km, bs",
          "      attend_bwd<BIG, kLanes>(qkv, gs, r2, stats, dm, km, bs"),
         ("      if (!BIG) attend_bwd<BIG>(qkv, gs, r2, stats, dm, km, bs",
          "      if (!BIG) attend_bwd<BIG, kLanes>(qkv, gs, r2, stats, dm, "
          "km, bs"))],
    "no_attention_bwd_kv_big": [(("  attention_bwd_kv_big(qkv, rows,",
                                  "  attention_bwd_kv_big<KT>(qkv, "
                                  "local_rows("),
                                 ("  if (false) attention_bwd_kv_big(qkv, "
                                  "rows,", "  if (false) "
                                  "attention_bwd_kv_big<KT>(qkv, "
                                  "local_rows("))],
    # #4's warp-tile attention out of line (__noinline__, bitwise), as it
    # was first written: the kernel's live registers then spill around
    # the calls
    "noinline_attention_big": [
        ("__device__ __forceinline__ void attention_mma_big(",
         "__device__ __noinline__ void attention_mma_big("),
        ("__device__ __forceinline__ void attention_bwd_q_big(",
         "__device__ __noinline__ void attention_bwd_q_big("),
        ("__device__ __forceinline__ void attention_bwd_kv_big(",
         "__device__ __noinline__ void attention_bwd_kv_big(")],
    # parts of #4's warp-tile attention (values wrong): what the IEEE expf
    # of its softmax costs, phase 2's reads of the other block's
    # statistics through distributed shared memory (read from this
    # block's), and phase 2's two products over the set
    "fast_exp_big": [
        ("sum[e >> 1] += expf(l[j][e]", "sum[e >> 1] += __expf(l[j][e]"),
        ("                      ? expf(l[j][e] - mx[e >> 1])",
         "                      ? __expf(l[j][e] - mx[e >> 1])"),
        ("p[j][e] = key < S ? expf(logit_of(",
         "p[j][e] = key < S ? __expf(logit_of("),
        ("p[e] = i < S ? expf(l - mx)", "p[e] = i < S ? __expf(l - mx)")],
    "local_stats_big": [("sts.row(min(i, S - 1)) + st_off",
                         "sts.row(bs.offset + min(i, S - 1) % bs.n_local) "
                         "+ st_off")],
    "no_combine_kv_big": [
        ("    warp_combine<KT, 2>(df, qs, hh * hd",
         "    if (false) warp_combine<KT, 2>(df, qs, hh * hd"),
        ("    warp_combine<KT, 1>(pf, gos, hh * hd",
         "    if (false) warp_combine<KT, 1>(pf, gos, hh * hd")],
    "no_wgrad": [("float* __restrict__ pb, bool first,\n"
                  "                                       const Dims& dm) "
                  "{\n  const int warp = threadIdx.x >> 5, lane",
                  "float* __restrict__ pb, bool first,\n"
                  "                                       const Dims& dm) "
                  "{\n  return;\n  const int warp = threadIdx.x >> 5, "
                  "lane")]}


TWIN_SOURCE = os.path.join("categoricalnf_tpu_torch", "csrc",
                           "fused_transformer_tf32x3.cu")

# The twin's BIG attention on the FMA register tiles of
# csrc/fused_transformer_tiles.cuh (the fp32 pair's attention_tiled_big,
# without statistics) in place of its 3xTF32 warp tiles
_TWIN_FMA = """// The attention of a set above kMaxSet rows on the FMA register tiles.
__device__ __forceinline__ void attend_big_fma(const float* qkv, float* out,
                                               const Dims& dm, int n_local,
                                               const unsigned char* km) {
  const SetRows<float, kMaxCluster> kv = set_rows_of<float, kMaxCluster>(
      qkv, dm.ld_qkv, dm.split, dm.cluster);
  const bool v4 = (dm.hidden / dm.heads) % 4 == 0;
  const bool nc8 = dm.set_size <= 2 * kMaxSet;
  if (v4 && nc8)
    attention_tiled_big<4, 8, false, kWarps>(qkv, dm.ld_qkv, kv, out,
        dm.ld_h, nullptr, 0, dm.hidden, dm.heads, dm.set_size, n_local, km);
  else if (nc8)
    attention_tiled_big<1, 8, false, kWarps>(qkv, dm.ld_qkv, kv, out,
        dm.ld_h, nullptr, 0, dm.hidden, dm.heads, dm.set_size, n_local, km);
  else if (v4)
    attention_tiled_big<4, 16, false, kWarps>(qkv, dm.ld_qkv, kv, out,
        dm.ld_h, nullptr, 0, dm.hidden, dm.heads, dm.set_size, n_local, km);
  else
    attention_tiled_big<1, 16, false, kWarps>(qkv, dm.ld_qkv, kv, out,
        dm.ld_h, nullptr, 0, dm.hidden, dm.heads, dm.set_size, n_local, km);
}

"""

# edits of TWIN_SOURCE (--big --twin), as VARIANTS
TWIN_VARIANTS = {
    "base": [],
    # the BIG instance's attention, by its call site
    "no_attention_fwd_big": [
        ("      attention(big, a, dm, km, valid);\n    else\n",
         "      attention(big, a, dm, km, valid);\n    else if (false)\n")],
    # the attention on the FMA register tiles (_TWIN_FMA)
    "twin_fma_tiles": [
        ("// Floats of one block's shared memory: h and a [tile, ld_h], big",
         _TWIN_FMA + "// Floats of one block's shared memory: h and a [tile, "
         "ld_h], big"),
        ("      attend_big(big, a, stage, dm, rank, km_set);",
         "      attend_big_fma(big, a, dm, valid, km_set);")],
    # the logits above 64 rows whole (16 n-tiles), not in two halves
    "twin_unsplit": [("    attention_warp_tiles<16, true>(qkv, out, stage, "
                      "dm, rank, km);",
                      "    attention_warp_tiles<16, false>(qkv, out, stage, "
                      "dm, rank, km);")],
    # one block an SM by the launch bounds (255 registers)
    "twin_blocks_1": [("constexpr int kBigBlocks = 2;",
                       "constexpr int kBigBlocks = 1;")],
    # the layout before: a set whole in one block where it fits (up to 100
    # rows at the flagship's width), else over a cluster of 2; one block an
    # SM
    "twin_whole_set": [("constexpr int kBigRows = 32;",
                        "constexpr int kBigRows = kMaxBigSet;"),
                       ("constexpr int kBigBlocks = 2;",
                        "constexpr int kBigBlocks = 1;")],
}

# edits of BF16_SOURCE (--global_h), as VARIANTS: #4 bf16's GLOBAL_H
# instance (hidden 256, runs/moses' node flow).  The weight gradients in
# the tile loop (the parent's mma_wgrad) or, after their move to
# wgrad_tiles_bf16, the operand images' stores and that kernel; the slices'
# reduction (the parent's reduce_wgrad launch); the attention and its
# backward by their call sites, the dense products and the LayerNorms (the
# same text before and after that move)
GLOBAL_H_VARIANTS = {
    "base": [],
    "no_wgrad": BF16_VARIANTS["no_wgrad"],
    "no_reduce": [("  reduce_wgrad<bf16><<<", "  if (false) reduce_wgrad<bf16>"
                   "<<<")],
    "no_images": [("bf16* __restrict__ dst,\n"
                   "                                            const Dims& "
                   "dm) {\n",
                   "bf16* __restrict__ dst,\n"
                   "                                            const Dims& "
                   "dm) {\n  return;\n")],
    "no_wgrad_tiles": [("            Dims dm, int grid) {\n",
                        "            Dims dm, int grid) {\n  return;\n")],
    # (the text after the attention's split into two lanes an item, then
    # the parent's, where both the recompute and phase 1 call attend)
    "no_attention": [(("        attention_split<2>(qkv, o, dm, km);",
                       "      attend<BIG>(qkv, o, dm, km, bs"),
                      ("        if (false) attention_split<2>(qkv, o, dm, "
                       "km);",
                       "      if (false) attend<BIG>(qkv, o, dm, km, bs"),
                      (1, 2)),
                     (("        attention_bwd_split<2>(qkv, gs, r2, stats, "
                       "dm, km);",
                       "      attend_bwd<BIG>(qkv, gs, r2, stats, dm, km, "
                       "bs"),
                      ("        if (false) attention_bwd_split<2>(qkv, gs, "
                       "r2, stats, dm, km);",
                       "      if (false) attend_bwd<BIG>(qkv, gs, r2, stats, "
                       "dm, km, bs"))],
    # the GLOBAL_H instance's attention one thread an item, as the others
    # (bitwise)
    "attention_lanes_1": [("attention_split<2>(qkv, o, dm, km);",
                           "attention(qkv, o, dm, km);"),
                          ("attention_bwd_split<2>(qkv, gs, r2, stats, dm, "
                           "km);",
                           "attention_bwd(qkv, gs, r2, stats, dm, km);")],
    "no_dense": [("  const int mtiles = dm.tile_pad >> 4, nk = kp >> 4;\n",
                  "  return;\n  const int mtiles = dm.tile_pad >> 4, nk = kp "
                  ">> 4;\n")],
    # 8 k-steps a chunk of B fragments, every instance (bitwise)
    "kchunk_8": [("constexpr int kKChunk = 4;", "constexpr int kKChunk = 8;")],
    # wgrad_tiles with 8 or 2 tiles in flight a block (bitwise); without
    # its products (the sums of zeros: what the rest of it costs)
    "wg_stages_8": [("constexpr int kWgStages = 4;",
                     "constexpr int kWgStages = 8;")],
    "wg_stages_2": [("constexpr int kWgStages = 4;",
                     "constexpr int kWgStages = 2;")],
    "wg_no_mma": [("    for (int s = 0; s < TP / 16; ++s) {\n      uint32_t "
                   "a[2][4];",
                   "    for (int s = 0; s < 0; ++s) {\n      uint32_t "
                   "a[2][4];")],
    # every warp's B fragments from n-tile 0's rows (values wrong): the
    # dense products with their weights in L1 (what their loads cost)
    "dense_one_ntile": [("    const bf16* bp = bt + (long)(j * 8 + g) * kp "
                         "+ 2 * t;",
                         "    const bf16* bp = bt + (long)g * kp + 2 * t;")],
    # phase 3 recomputes qkv, o, hm and f | m, as the other instances, in
    # place of reading them back from phase 1's stash, which is not written
    # (bitwise)
    "no_stash": [
        ("      if constexpr (GLOBAL_H) stash(qkv, o, h, sg + l * st, true, "
         "dm);\n", ""),
        ("      if constexpr (GLOBAL_H) {\n        // f too, for phase 3",
         "      if constexpr (false) {\n        // f too, for phase 3"),
        ("        stash(qkv, o, hm, sg + l * st, false, dm);\n"
         "        copy16(sg + l * st + TP * (dm.ld_big + 2 * dm.ld_h), f,\n"
         "               4 * TP * dm.ld_f);\n", ""),
        ("      if constexpr (!GLOBAL_H) {", "      {", 2),
        ("        attend<BIG>(qkv, o, dm, km, bs, stats, hm);\n"
         "        set_sync(clustered);\n        if constexpr (BIG) {",
         "        if constexpr (GLOBAL_H)\n"
         "          attention_split<2>(qkv, o, dm, km);\n"
         "        else\n"
         "          attend<BIG>(qkv, o, dm, km, bs, stats, hm);\n"
         "        set_sync(clustered);\n        if constexpr (BIG) {")],
    # the images by plain stores, not streaming ones (bitwise)
    "images_plain": [("      __stcs(to, v);", "      *to = v;")],
    # the dense products without their mma.sync (an xor in its place) or
    # without their A fragments' ldmatrix (values wrong): what each costs
    "dense_no_mma": [("              mma_bf16(acc[mt], a, bq[s][0], "
                      "bq[s][1]);",
                      "              acc[mt][0] += __uint_as_float(a[0] ^ "
                      "bq[s][0] ^ bq[s][1]);")],
    "dense_no_ldsm": [("              ldsm_x4(a, A + (mt * 16 + (lane & 15)) "
                       "* lda + k0);",
                       "              a[0] = a[1] = a[2] = a[3] = k0 + "
                       "lane;")],
    "no_layer_norm": [
        ("                                             const Dims& dm) {\n"
         "  const int lane = threadIdx.x & 31, h = dm.hidden;\n",
         "                                             const Dims& dm) {\n"
         "  return;\n  const int lane = threadIdx.x & 31, h = dm.hidden;\n"),
        ("                                                 bf16* gout, const "
         "Dims& dm) {\n",
         "                                                 bf16* gout, const "
         "Dims& dm) {\n  return;\n")]}
# the variants --global_h runs unless told others (the ones of the tree
# before the weight gradients left the tile loop)
GLOBAL_H_DEFAULT = ["base", "no_wgrad", "no_reduce", "no_attention",
                    "no_dense", "no_layer_norm"]

TILES_SOURCE = os.path.join("categoricalnf_tpu_torch", "csrc",
                            "fused_transformer_tiles.cuh")

# (the sources an edit may match, in order; the variants' edits; the
# source built by --big) by kind
KINDS = {"float32": ((SOURCE, TILES_SOURCE), VARIANTS,
                     "fused_transformer_f32_big"),
         "bfloat16": ((BF16_SOURCE,), BF16_VARIANTS,
                      "fused_transformer_bf16"),
         "twin": ((TWIN_SOURCE,), TWIN_VARIANTS,
                  "fused_transformer_tf32x3"),
         "global_h": ((BF16_SOURCE,), GLOBAL_H_VARIANTS,
                      "fused_transformer_bf16")}


def variant_tree(tree: str, name: str, root: str,
                 kind: str = "float32") -> str:
    """A copy of ``tree``'s port under ``root`` with ``name``'s edits of
    ``kind``'s sources (``KINDS``): each edit in the first of them whose
    text it matches."""
    dst = os.path.join(root, name)
    shutil.copytree(os.path.join(tree, "categoricalnf_tpu_torch"),
                    os.path.join(dst, "categoricalnf_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    sources, table, _ = KINDS[kind]
    texts = {}
    for source in sources:
        path = os.path.join(dst, source)
        if os.path.exists(path):
            with open(path) as f:
                texts[source] = f.read()
    for old, new, *times in table[name]:
        # a pair of tuples: the text before the attention's redesign and
        # after, whichever the tree has
        olds, news = (old, new) if isinstance(old, tuple) else ((old,),
                                                                 (new,))
        # the times each text must occur: one for all, or one each
        want = times[0] if times else 1
        wants = want if isinstance(want, tuple) else (want,) * len(olds)
        hits = [(src, i) for src, text in texts.items()
                for i, o in enumerate(olds) if text.count(o) == wants[i]]
        if not hits:
            sys.exit(f"fma_variants: the edit of {name} does not match "
                     f"{' or '.join(sources)} as it should")
        src, i = hits[0]
        texts[src] = texts[src].replace(olds[i], news[i])
    for source, text in texts.items():
        with open(os.path.join(dst, source), "w") as f:
            f.write(text)
    return dst


BIG_SETS = (64, 128)


def _chip_smoke():
    path = os.path.join(HERE, "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def time_big(tree: str, kind: str = "float32") -> dict:
    """#3 fp32 with grad and #4 fp32 (``bfloat16``: #3 and #4 bf16;
    ``twin``: #3 fp32 without grad) of ``tree``'s port on the flagship's
    net at 1,024 sets (the twin: 4 chains x 1,024) of each of BIG_SETS:
    device ms (``cuda_ms``), and ptxas's registers and spilled bytes of the
    kernels."""
    sys.path.insert(0, os.path.abspath(tree))
    cs = _chip_smoke()
    import torch
    from categoricalnf_tpu_torch.ops.cuda import build
    from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft
    dev = torch.device("cuda")
    source = KINDS[kind][2]
    ptxas = cs.kernel_resources(build.build_all([source])[source])
    out: dict = {"registers": {k: v for k, v in ptxas.items()
                               if "fused_set_transformer" in k}}
    bf16 = kind == "bfloat16"
    dt = torch.bfloat16 if bf16 else torch.float32
    net = cs.flagship_net("bfloat16" if bf16 else "float32", dev)
    ws = ft.flatten_params(net)
    packed = net._packed_weights(dt)
    for s in BIG_SETS:
        g = torch.Generator(dev).manual_seed(s)
        if kind == "twin":
            x = torch.randn(cs.EVAL_CHAINS * cs.B, s, cs.D, generator=g,
                            device=dev)
            with torch.no_grad():
                y = ft.fused_set_transformer(packed, x, num_heads=cs.HEADS)
                out[f"fwd_set{s}"] = cs.cuda_ms(
                    lambda: ft.fused_set_transformer(
                        packed, x, num_heads=cs.HEADS), 10)[0]
                out[f"sum_set{s}"] = float(y.double().sum())
                out[f"rel_err_set{s}"] = cs.rel_err(y, net.plain_forward(x))
            continue
        x = torch.randn(cs.B, s, cs.D, generator=g, device=dev)
        gy = torch.randn(cs.B, s, cs.OUT, generator=g, device=dev).to(dt)
        with torch.no_grad():
            if bf16:
                out[f"fwd_set{s}"] = cs.cuda_ms(
                    lambda: ft.fused_set_transformer(
                        packed, x, num_heads=cs.HEADS), 10)[0]
            else:
                out[f"train_fwd_set{s}"] = cs.cuda_ms(
                    lambda: ft.FusedSetTransformer.apply(
                        x, packed, cs.HEADS, None, *ws), 10)[0]
            out[f"bwd_set{s}"] = cs.cuda_ms(
                lambda: ft.fused_set_transformer_bwd(
                    packed, x, gy, num_heads=cs.HEADS), 5)[0]
    return out


def time_global_h(tree: str) -> dict:
    """#4 bf16 of ``tree``'s port at runs/moses' node flow (192 graphs x 24
    nodes, in 6, hidden 256, MLP 512, 4 heads, 2 blocks, out 300, under
    ``chip_smoke.molecule_key_mask``), its GLOBAL_H instance: device ms of
    the wrapper's call (``bwd_ms``) and of autograd through the plain
    version (``plain_ms``), the sha256 of dx and the 12 gradients
    (``digest``), ptxas's registers and spills of the source's kernels;
    where the tree has ``wgrad_tiles_bf16``, that kernel alone on operand
    images of the call's shape (``wgrad_tiles_ms``)."""
    import hashlib
    sys.path.insert(0, os.path.abspath(tree))
    cs = _chip_smoke()
    import torch
    from categoricalnf_tpu_torch.ops.cuda import build
    from categoricalnf_tpu_torch.ops.cuda import fused_transformer as ft
    dev = torch.device("cuda")
    source = KINDS["global_h"][2]
    ptxas = cs.kernel_resources(build.build_all([source])[source])
    out: dict = {"registers": {k: v for k, v in ptxas.items()
                               if "bwdILb1ELb0E" in k or "wgrad" in k}}
    seed, batch, hidden, out_dim = 0, cs.MOSES_BATCH, cs.MOSES_HIDDEN, \
        cs.MOSES_OUT
    g = torch.Generator(dev).manual_seed(seed + 53)
    mask = cs.molecule_key_mask(seed, dev, batch)
    x = torch.randn(batch, cs.MOL_NODES, cs.MOL_NODE_DIM, generator=g,
                    device=dev)
    gy = torch.randn(batch, cs.MOL_NODES, out_dim, generator=g,
                     device=dev).to(torch.bfloat16)
    net = cs.molecule_net("bfloat16", dev, seed, hidden, out_dim)
    packed = net._packed_weights(torch.bfloat16)
    call = lambda: ft.fused_set_transformer_bwd(  # noqa: E731
        packed, x, gy, num_heads=cs.HEADS, mask=mask)
    with torch.no_grad():
        dx, dws = call()
        h = hashlib.sha256()
        for t in (dx, *dws):
            h.update(t.detach().cpu().contiguous().view(torch.uint8)
                     .numpy().tobytes())
        out["digest"] = h.hexdigest()[:16]
        out["bwd_ms"] = cs.cuda_ms(call, 10)[0]
    params = list(net.parameters())
    xr = x.clone().requires_grad_(True)
    y_p = net.plain_forward(xr, mask=mask)
    out["plain_ms"] = cs.cuda_ms(lambda: torch.autograd.grad(
        y_p, [xr] + params, gy, retain_graph=True), 5)[0]
    if hasattr(ft, "wgrad_tiles_bf16"):
        shape = ft.WgradShape(batch * cs.MOL_NODES, cs.MOL_NODES,
                              cs.MOL_NODE_DIM, hidden, 2, 2 * hidden,
                              out_dim)
        tile = ft.bwd_layout(torch.bfloat16, cs.MOL_NODES, cs.MOL_NODE_DIM,
                             hidden, 2 * hidden, out_dim, cs.HEADS, 2)[0]
        grid = ft.bwd_launch(torch.bfloat16, cs.MOL_NODES, cs.MOL_NODE_DIM,
                             hidden, 2 * hidden, out_dim, cs.HEADS, 2,
                             batch * cs.MOL_NODES, torch.cuda
                             .get_device_properties(dev)
                             .multi_processor_count)[3]
        images = torch.randn(ft.wgrad_workspace_elems(shape, tile),
                             generator=g, device=dev).to(torch.bfloat16)
        with torch.no_grad():
            out["wgrad_tiles_ms"] = cs.cuda_ms(
                lambda: ft.wgrad_tiles_bf16(images, shape, tile, grid),
                20)[0]
    return out


def main_big(args) -> int:
    """Build every variant's BIG source at once, then time each alone
    (``--global_h``: #4 bf16's GLOBAL_H instance; with ``--ab``, the
    checkouts named there unedited, in that order)."""
    kind = ("global_h" if args.global_h else "twin" if args.twin
            else args.dtype)
    source = KINDS[kind][2]
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from "
            "categoricalnf_tpu_torch.ops.cuda import build; "
            f"build.build_all([{source!r}])")
    with tempfile.TemporaryDirectory() as root:
        if args.ab:
            # a copy of each checkout's port ("base": no edit), one build
            # each, timed in the order given
            trees = {f"{i}:{tree}": variant_tree(tree, "base",
                                                 os.path.join(root, str(i)),
                                                 kind)
                     for i, tree in enumerate(args.ab)}
        else:
            trees = {name: variant_tree(args.tree, name, root, kind)
                     for name in args.variants}
        builds = {name: subprocess.Popen(
                      [sys.executable, "-c", code, tree],
                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                      text=True)
                  for name, tree in trees.items()}
        failed = False
        for name, proc in builds.items():
            log = proc.communicate()[0]
            if proc.returncode != 0:
                print(f"{name}: the build failed\n{log[-4000:]}",
                      flush=True)
                failed = True
        if failed:
            return 1
        digests = []
        for name, tree in trees.items():
            run = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--time-big", tree, "--kind", kind],
                                 capture_output=True, text=True)
            if run.returncode != 0:
                print(run.stdout[-2000:], run.stderr[-4000:], flush=True)
                return 1
            line = json.loads(run.stdout.strip().splitlines()[-1])
            print(json.dumps({"variant": name, **line}), flush=True)
            digests.append(line.get("digest"))
    if args.ab:
        same = len(set(digests)) == 1
        print(json.dumps({"bitwise_across_trees": same}), flush=True)
        return 0 if same else 1
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(HERE),
                    help="checkout whose port to vary")
    ap.add_argument("--variants", nargs="+", default=None,
                    choices=sorted(set(VARIANTS) | set(BF16_VARIANTS)
                                   | set(TWIN_VARIANTS)
                                   | set(GLOBAL_H_VARIANTS)))
    ap.add_argument("--big", action="store_true",
                    help="time the instances for sets of 33-128")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="with --big: the fp32 pair or the bf16 kernels")
    ap.add_argument("--twin", action="store_true",
                    help="with --big: the 3xTF32 eval twin (#3 fp32 "
                    "without grad)")
    ap.add_argument("--global_h", action="store_true",
                    help="time #4 bf16's GLOBAL_H instance at runs/moses' "
                    "node flow (GLOBAL_H_VARIANTS)")
    ap.add_argument("--ab", nargs="+", metavar="TREE", default=None,
                    help="with --global_h: time these checkouts as they are, "
                    "in this order (say P C C P), and exit 1 unless their "
                    "outputs are bitwise equal")
    ap.add_argument("--time-big", metavar="TREE", help=argparse.SUPPRESS)
    ap.add_argument("--kind", default="float32", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.time_big:
        print(json.dumps(time_global_h(args.time_big)
                         if args.kind == "global_h"
                         else time_big(args.time_big, args.kind)),
              flush=True)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    if args.big or args.global_h:
        kind = ("global_h" if args.global_h else "twin" if args.twin
                else args.dtype)
        table = KINDS[kind][1]
        args.variants = args.variants or (
            BIG_VARIANTS if kind == "float32" else GLOBAL_H_DEFAULT
            if kind == "global_h" else list(table))
        unknown = set(args.variants) - set(table)
        if unknown:
            ap.error(f"no {kind} variants {sorted(unknown)}")
        return main_big(args)
    args.variants = args.variants or [
        v for v in VARIANTS if not v.endswith("_big")]
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
