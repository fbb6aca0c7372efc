// Register tiles of the FMA units for the fp32 attention of sets of 33 to
// 128 rows, whose rows may lie in the blocks of a thread-block cluster, and
// the scaled or masked logit that they and the 3xTF32 forward's warp tiles
// form.  Included by the fp32 train step's pair (fused_transformer_fma.cuh,
// which runs the tiles) and the 3xTF32 forward (fused_transformer_tf32x3.cu,
// whose attention runs on the tensor cores instead; every field the tiles
// read is an argument, and tools/fma_variants.py --twin times them there).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "fused_transformer.cuh"

namespace {

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void sts4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// V values of a row at once: a float4 where the head width allows it.
template <int V>
__device__ __forceinline__ void ldv(float (&v)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 t = lds4(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
#pragma unroll
    for (int u = 0; u < V; ++u) v[u] = p[u];
  }
}

template <int V>
__device__ __forceinline__ void stv(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    sts4(p, make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int u = 0; u < V; ++u) p[u] = v[u];
  }
}

// Attention at sets above 32 rows (BIG), on register tiles of the FMA
// units: #4 fp32's (its recompute, phase 1 and phase 2) and #3 fp32 with
// grad's, whose output is what #4 recomputes.  A warp owns a 16-row tile
// of one head: its queries' logits against the whole set in the recompute
// and phase 1, its keys' against every query of the set in phase 2.  Lane l holds rows rg + 4i
// (rg = l % 4, i < 4) of the tile against the set's rows cg + 8c (cg =
// l / 4, c < NC: 8 up to 64 rows, 16 up to 128), so each load of V values
// of a row (a float4 where the head width allows) feeds 4 x NC x V FMAs of
// the dot products (``tile_dots``); the products over the set
// (``tile_combine``) sum each lane's rows in registers and add the 8
// lanes' sums by shuffles.  The recompute keeps each query row's softmax
// max and 1 / sum in stats for phase 1, which adds D_i = sum_j p_ij gP_ij
// from the same tile as dQ; phase 2 reads all three, so a pass forms a logit
// once.  The other blocks' rows are read through distributed shared
// memory (SetRows), V values at a time.  Every dot product over the head
// width is one fmaf chain in the order of d, the same in every pass, so
// phase 1 and 2 rebuild the recompute's probabilities bitwise; logits and
// softmax in fp32, a masked key's logit kMaskedLogit before the row's max,
// a masked logit without gradient.

// A logit: the scaled dot product, or kMaskedLogit for a masked key (km:
// the set's key mask, null: none); one product, never contracted.
__device__ __forceinline__ float logit_of(float dot, float inv_root,
                                          const unsigned char* km, int key) {
  return km != nullptr && km[key] == 0 ? kMaskedLogit
                                       : __fmul_rn(dot, inv_root);
}

// Over the 8 lanes that hold one row (xor 4, 8, 16): every lane gets the
// same value.
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int m = 4; m < 32; m *= 2)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int m = 4; m < 32; m *= 2) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// acc[i][c] = sum_{d < hd} a[r0 + rg + 4i][col + d] b[cg + 8c][bcol + d]
// in the order of d (a: this block's rows, lda apart; b: the set's).  A row
// of ``a`` from na and of ``b`` from nb reads the last valid one: the
// callers drop those rows' results, or give their keys no weight.  No load
// is behind a branch, so a lane issues a step's loads together.
template <int V, int NC, int N>
__device__ __forceinline__ void tile_dots(
    const float* a, int lda, int col, int na, int r0,
    const SetRows<float, N>& b, int bcol, int nb, int hd,
    float (&acc)[4][NC]) {
  const int lane = threadIdx.x & 31, rg = lane & 3, cg = lane >> 2;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  for (int d0 = 0; d0 < hd; d0 += V) {
    float av[4][V];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ldv<V>(av[i], a + min(r0 + rg + 4 * i, na - 1) * lda + col + d0);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float bv[V];
      ldv<V>(bv, b.row(min(cg + 8 * c, nb - 1)) + bcol + d0);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < V; ++e)
          acc[i][c] = fmaf(av[i][e], bv[e], acc[i][c]);
    }
  }
}

// out[r0 + rg + 4i][ocol + d] (rows below n_out, ld_out apart) = sum over
// the set's rows k = cg + 8c of w[i][c] b[k][bcol + d], d < hd: each lane
// sums its rows k in their order for 8 columns at a time, then the 8 lanes
// of its rows add their sums (a reduce-scatter over xor 16, 8 and 4), which
// leaves lane (rg, cg) row rg + 4 (cg / 2)'s columns 4 (cg % 2) .. 4 (cg %
// 2) + 3 of the 8.  The weights of the rows from nb are zero, and those
// rows read the last valid one; a column past hd reads the last valid one
// and is not stored.
template <int V, int NC, int N>
__device__ __forceinline__ void tile_combine(
    const float (&w)[4][NC], const SetRows<float, N>& b, int bcol,
    int nb, int hd, float* out, int ld_out, int ocol, int r0, int n_out) {
  const int lane = threadIdx.x & 31, rg = lane & 3, cg = lane >> 2;
  for (int d0 = 0; d0 < hd; d0 += 8) {
    float v[32];  // v[8i + e]: row i, column d0 + e
#pragma unroll
    for (int k = 0; k < 32; ++k) v[k] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float* br = b.row(min(cg + 8 * c, nb - 1)) + bcol + d0;
      float bv[8];
      if (V == 4 && d0 + 8 <= hd) {
        const float4 x = lds4(br), y = lds4(br + 4);
        bv[0] = x.x;
        bv[1] = x.y;
        bv[2] = x.z;
        bv[3] = x.w;
        bv[4] = y.x;
        bv[5] = y.y;
        bv[6] = y.z;
        bv[7] = y.w;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) bv[e] = br[min(e, hd - 1 - d0)];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[8 * i + e] = fmaf(w[i][c], bv[e], v[8 * i + e]);
    }
    float h16[16], h8[8], h4[4];
    const bool b16 = lane & 16, b8 = lane & 8, b4 = lane & 4;
#pragma unroll
    for (int k = 0; k < 16; ++k)
      h16[k] = (b16 ? v[16 + k] : v[k]) +
               __shfl_xor_sync(0xffffffffu, b16 ? v[k] : v[16 + k], 16);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      h8[k] = (b8 ? h16[8 + k] : h16[k]) +
              __shfl_xor_sync(0xffffffffu, b8 ? h16[k] : h16[8 + k], 8);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      h4[k] = (b4 ? h8[4 + k] : h8[k]) +
              __shfl_xor_sync(0xffffffffu, b4 ? h8[k] : h8[4 + k], 4);
    const int r = r0 + rg + 4 * (cg >> 1), d = d0 + 4 * (cg & 1);
    if (r < n_out) {
      float* o = out + r * ld_out + ocol + d;
      if (V == 4 && d + 4 <= hd) {
        stv<4>(o, h4);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (d + k < hd) o[k] = h4[k];
      }
    }
  }
}

// The attention of a set above 32 rows: out = sum_j p_ij v_j for this
// block's n_local rows of the set (qkv: q, k, v at columns 0, H, 2H of
// rows ld apart; out: rows ld_out apart), and (STATS: #4's recompute)
// each row's softmax max and 1 / sum in stats [heads, stats_rows, 3]; kv:
// the set's qkv rows in every block of its cluster, km the set's key mask
// (null: none); WARPS: the block's warps.  An instance a kernel, each out
// of line.
template <int V, int NC, bool STATS, int WARPS, int N>
__device__ __noinline__ void attention_tiled_big(
    const float* qkv, int ld, SetRows<float, N> kv, float* out, int ld_out,
    float* stats, int stats_rows, int H, int nh, int S, int n_local,
    const unsigned char* km) {
  const int hd = H / nh;
  const float inv_root = 1.0f / sqrtf((float)hd);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane & 3, cg = lane >> 2;
  const int mt = (n_local + 15) / 16;
  for (int item = warp; item < nh * mt; item += WARPS) {
    const int hh = item / mt, r0 = item % mt * 16;
    float l[4][NC];
    tile_dots<V, NC>(qkv, ld, hh * hd, n_local, r0, kv, H + hh * hd, S, hd,
                     l);
    float mx[4], inv_sum[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mx[i] = -INFINITY;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int key = cg + 8 * c;
        l[i][c] = key < S ? logit_of(l[i][c], inv_root, km, key)
                          : -INFINITY;
        mx[i] = fmaxf(mx[i], l[i][c]);
      }
      mx[i] = row_max(mx[i]);
      float s = 0.0f;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        if (cg + 8 * c < S) s += expf(l[i][c] - mx[i]);
      inv_sum[i] = 1.0f / row_sum(s);
#pragma unroll
      for (int c = 0; c < NC; ++c)
        l[i][c] = cg + 8 * c < S ? expf(l[i][c] - mx[i]) * inv_sum[i] : 0.0f;
    }
    tile_combine<V, NC>(l, kv, 2 * H + hh * hd, S, hd, out, ld_out,
                        hh * hd, r0, n_local);
    if (STATS && cg == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + rg + 4 * i;
        if (r < n_local) {
          float* st = stats + (hh * stats_rows + r) * 3;
          st[0] = mx[i];
          st[1] = inv_sum[i];
        }
      }
    }
  }
}

}  // namespace
