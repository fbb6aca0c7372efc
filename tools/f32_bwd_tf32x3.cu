// The 3xTF32 fp32 backward of the fused SetTransformer (kernel #4 in fp32),
// on Hopper's tensor cores (sm_90a), kept beside the port rather than in it.
// The fp32 train step runs the FMA pair of
// categoricalnf_tpu_torch/csrc/fused_transformer.cu: with this backward and
// the 3xTF32 forward in its place, chip_smoke.py's gradient check fails on
// an ill-conditioned gradient where nets computed exactly in fp64 fail it
// too (PERF.md; ROADMAP.md, Queue C).  tools/f32_bwd_tf32x3.py builds it
// and launches it for tools/f32_forward_rounding.py and tools/fused_ab.py.
// Once that check is settled it moves into
// categoricalnf_tpu_torch/csrc/fused_transformer_tf32x3.cu and becomes the
// backward of every fp32 call.  The device functions of that file's forward
// are here in the form this kernel needs: mma_dense with the backward's
// epilogues and a ring of B prefetches, whose forward epilogues give the
// forward kernel's values bitwise, so the recompute is the 3xTF32 forward's
// arithmetic.
//
// Replaces the TPU kernel categoricalnf_tpu/ops/pallas/fused_transformer.py
// _fused_bwd in fp32.
//
// Accuracy.  Each fp32 operand v is split into a TF32 high part hi =
// rna(v) and a TF32 remainder lo = rna(v - hi) (cvt.rna.tf32.f32; v - hi is
// exact), and a product is a_lo.b_hi + a_hi.b_lo + a_hi.b_hi on
// mma.sync.m16n8k8.tf32 with fp32 accumulators: the small terms in one
// chain of the tensor cores' accumulator, the large one a k-step at a time
// added in fp32 (mma_3xtf32 says why).  The dropped a_lo.b_lo is below
// fp32's rounding, so the result has fp32's accuracy; a single TF32 pass
// would read about 3e-4 relative error.  The weights are split once
// (tools/f32_bwd_tf32x3.py, bwd_weights); the activations when their A
// fragment is loaded.  No product anywhere takes a single TF32 pass.
//
// LayerNorm, attention, gelu and the bias gradients run on the CUDA cores in
// fp32.  Shared-memory rows are 4 mod 8 floats wide where they fit, so the
// A-fragment loads (lane (g, t) reads row g, column t) fall in 32 distinct
// banks.  The contraction runs over widths padded to 8; the pad columns
// read finite values against the zero pad of the weight layout, so they
// add nothing; shared memory is cleared once so that every value is finite.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fused_transformer.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSet = 32;      // largest set size attention handles
constexpr int kChunk = 8;        // own-row values held in registers
constexpr int kSlack = 8;        // floats past the last buffer (pad reads)

struct Dims {
  long rows;
  int set_size, in_dim, hidden, heads, layers, mlp, out_dim;
  int tile;                       // rows of a tile: whole sets, all stored
  int k_in, k_h, k_f;             // contraction widths padded to 8
  int n_h, n_qkv, n_f, n_out;     // output widths padded to 8
  int ld_x, ld_h, ld_qkv, ld_f, ld_big;  // shared-memory rows (floats)
  int ld_g, ld_r2;                // backward only: g; the second region
  int attn_split;                 // backward only: threads a (head, row)
};

// The 6 split layouts (embed, qkv, proj, fc1, fc2, out; layer-stacked) of
// the forward's products: W^T [pad8(n), 2 pad8(kd)], where the 16 floats
// of output row c and k-step s are, for t < 4, (hi[8s + t], hi[8s + t + 4],
// lo[8s + t], lo[8s + t + 4]): lane (g, t) reads its two B fragments as one
// float4.  The backward also reads w, the same split of W [pad8(kd),
// 2 pad8(n)], the B operands of its input gradients g . W^T.  The 6 fp32
// biases.
struct SplitWeights {
  const float* wt[6];
  const float* w[6];
  const float* b[6];
};

__host__ __device__ inline int pad8(int n) { return (n + 7) / 8 * 8; }

// The smallest width >= n that is 4 mod 8 floats: rows g = 0..7 of an A
// fragment then start in banks 4g (times an odd number) mod 32, and the
// four columns t of each fill the banks between.
__host__ __device__ inline int conflict_free(int n) {
  return n + ((4 - n) % 8 + 8) % 8;
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r & 0xffffe000u;
}

// d += a (16x8, row) . b (8x8, col), TF32 in, fp32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k-step of a . b in 3xTF32: small += a_lo.b_hi + a_hi.b_lo on the
// tensor cores, then big += a_hi.b_hi, that product taken on its own (a
// zero accumulator) and added in fp32 with round-to-nearest.  The tensor
// cores align and truncate the terms they sum, so a chain of the large
// term through their accumulator drifts by several ulps (1.2e-6 relative
// at the flagship on an H100, against 2.5e-7 for fp32 FMAs); the small
// terms are 2^-11 as large, so their chain's truncation is far below
// fp32's rounding.
__device__ __forceinline__ void mma_3xtf32(float (&small)[4],
                                           float (&big)[4],
                                           const uint32_t (&hi)[4],
                                           const uint32_t (&lo)[4],
                                           const float4& b) {
  mma_tf32(small, lo, __float_as_uint(b.x), __float_as_uint(b.y));
  mma_tf32(small, hi, __float_as_uint(b.z), __float_as_uint(b.w));
  float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_tf32(p, hi, __float_as_uint(b.x), __float_as_uint(b.y));
#pragma unroll
  for (int e = 0; e < 4; ++e) big[e] += p[e];
}

enum Epi {
  kStore,      // out = acc + b
  kResidual,   // out += acc + b
  kGelu,       // out = gelu(acc + b)
  kGlobal,     // gout[r, c] = acc + b for rows < valid
  kFc1,        // out = f = acc + b, out2 = gelu(f)
  kBwdStore,   // out = acc
  kBwdGelu,    // out = acc * gelu'(out)   (out holds f)
  kBwdGlobal,  // gout[r, c] = acc for rows < valid
};

// One k-step of a warp's product: the A fragment of rows a0, a1 at
// columns k0 + t, k0 + t + 4, split as it is loaded, against the B
// fragments b0 (and b1 where `two`) of its n-tile pair.
__device__ __forceinline__ void mma_kstep(const float* a0, const float* a1,
                                          int k0, const float4& b0,
                                          const float4& b1, bool two,
                                          float (&small)[2][4],
                                          float (&big)[2][4]) {
  // A fragment: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
  const float av[4] = {a0[k0], a1[k0], a0[k0 + 4], a1[k0 + 4]};
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = tf32_rna(av[i]);
    lo[i] = tf32_rna(av[i] - __uint_as_float(hi[i]));
  }
  mma_3xtf32(small[0], big[0], hi, lo, b0);
  if (two) mma_3xtf32(small[1], big[1], hi, lo, b1);
}

// out[r, c] <- epilogue(A[r, :kp] . W[:kp, c] + b[c]) for the tile's rows
// and c < n.  A: fp32 [tile, lda] in shared memory; bt: a split layout
// [np, 2 kp] (np = pad8(n)).  One warp per (m-tile, pair of 8-column
// n-tiles), the warps of one pair reading the same B, DEPTH k-steps of B
// fragments in flight from L2 (the forward one, the backward kBwdDepth).
// Inlined, so each kernel has its own copy.
template <int EPI, int DEPTH = 1>
__device__ __forceinline__ void mma_dense(const float* A, int lda, int kp,
                                          const float* __restrict__ bt,
                                          int np, int n,
                                          const float* __restrict__ bias,
                                          float* out, int ld_out,
                                          float* __restrict__ gout, int valid,
                                          const Dims& dm,
                                          float* out2 = nullptr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mtiles = (dm.tile + 15) >> 4, ntiles = np >> 3;
  const int pairs = (ntiles + 1) >> 1, nk = kp >> 3;
  for (int task = warp; task < mtiles * pairs; task += kWarps) {
    const int mt = task % mtiles, j0 = (task / mtiles) * 2;
    const bool two = j0 + 1 < ntiles;
    // rows past the tile read its last row again; their results are
    // dropped
    const int r0 = min(mt * 16 + g, dm.tile - 1);
    const int r1 = min(mt * 16 + g + 8, dm.tile - 1);
    const float* a0 = A + r0 * lda + t;
    const float* a1 = A + r1 * lda + t;
    const float4* b0p =
        reinterpret_cast<const float4*>(bt + (long)(j0 * 8 + g) * 2 * kp) + t;
    const float4* b1p = two ? b0p + 4 * kp : b0p;  // 8 rows of 2 kp floats
    float small[2][4], big[2][4];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) small[q][e] = big[q][e] = 0.0f;
    if constexpr (DEPTH == 1) {
      float4 b0 = __ldg(b0p), b1 = __ldg(b1p);
      for (int s = 0; s < nk; ++s) {
        float4 nb0 = b0, nb1 = b1;
        if (s + 1 < nk) {
          nb0 = __ldg(b0p + 4 * (s + 1));
          nb1 = __ldg(b1p + 4 * (s + 1));
        }
        mma_kstep(a0, a1, s * 8, b0, b1, two, small, big);
        b0 = nb0;
        b1 = nb1;
      }
    } else {
      // a ring of DEPTH k-steps' B fragments: step s's slot is refilled
      // with step s + DEPTH as step s is taken
      float4 bq[DEPTH][2];
#pragma unroll
      for (int i = 0; i < DEPTH; ++i) {
        if (i < nk) {
          bq[i][0] = __ldg(b0p + 4 * i);
          bq[i][1] = __ldg(b1p + 4 * i);
        }
      }
      for (int s0 = 0; s0 < nk; s0 += DEPTH) {
#pragma unroll
        for (int i = 0; i < DEPTH; ++i) {
          const int s = s0 + i;
          if (s < nk) {
            const float4 b0 = bq[i][0], b1 = bq[i][1];
            if (s + DEPTH < nk) {
              bq[i][0] = __ldg(b0p + 4 * (s + DEPTH));
              bq[i][1] = __ldg(b1p + 4 * (s + DEPTH));
            }
            mma_kstep(a0, a1, s * 8, b0, b1, two, small, big);
          }
        }
      }
    }

#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (q == 1 && !two) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // accumulator e: row g + 8 (e >> 1), column 2t + (e & 1)
        const int r = mt * 16 + g + 8 * (e >> 1);
        const int c = (j0 + q) * 8 + 2 * t + (e & 1);
        if (r >= dm.tile || c >= n) continue;
        const float acc = big[q][e] + small[q][e];
        if constexpr (EPI == kBwdStore) {
          out[r * ld_out + c] = acc;
        } else if constexpr (EPI == kBwdGelu) {
          float* o = out + r * ld_out + c;
          *o = acc * gelu_tanh_grad(*o);
        } else if constexpr (EPI == kBwdGlobal) {
          if (r < valid) gout[(long)r * n + c] = acc;
        } else {
          const float v = acc + bias[c];
          if constexpr (EPI == kStore) {
            out[r * ld_out + c] = v;
          } else if constexpr (EPI == kResidual) {
            out[r * ld_out + c] += v;
          } else if constexpr (EPI == kGelu) {
            out[r * ld_out + c] = gelu_tanh(v);
          } else if constexpr (EPI == kFc1) {
            out[r * ld_out + c] = v;
            out2[r * ld_out + c] = gelu_tanh(v);
          } else {
            if (r < valid) gout[(long)r * n + c] = v;
          }
        }
      }
    }
  }
}

// LayerNorm without affine, one warp a row: fp32 mean and biased variance.
__device__ __noinline__ void layer_norm_tile(const float* in, float* out,
                                             const Dims& dm) {
  const int lane = threadIdx.x & 31, h = dm.hidden;
  for (int r = threadIdx.x >> 5; r < dm.tile; r += kWarps) {
    const float* row = in + r * dm.ld_h;
    float s = 0.0f;
    for (int c = lane; c < h; c += 32) s += row[c];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mean = s / h;
    float v = 0.0f;
    for (int c = lane; c < h; c += 32) {
      const float d = row[c] - mean;
      v = fmaf(d, d, v);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    const float inv = rsqrtf(v / h + 1e-5f);
    for (int c = lane; c < h; c += 32)
      out[r * dm.ld_h + c] = (row[c] - mean) * inv;
  }
}

// dot[j] += sum_{d < hd} mine[d] * rows[j * ld + d] for j < S, in order of
// d (mine: this thread's row, kChunk values at a time in registers; rows:
// the set's rows, read by all its threads).
template <int MAXS>
__device__ __forceinline__ void set_dots(const float* mine, const float* rows,
                                         int ld, int hd, int S,
                                         float (&dot)[MAXS]) {
  for (int d0 = 0; d0 < hd; d0 += kChunk) {
    float v[kChunk];
#pragma unroll
    for (int e = 0; e < kChunk; ++e) v[e] = d0 + e < hd ? mine[d0 + e] : 0.0f;
#pragma unroll
    for (int j = 0; j < MAXS; ++j) {
      if (j < S) {
        const float* rj = rows + j * ld + d0;
#pragma unroll
        for (int e = 0; e < kChunk; ++e)
          if (d0 + e < hd) dot[j] = fmaf(v[e], rj[e], dot[j]);
      }
    }
  }
}

// The softmax row of query r in head hh: p[j] = softmax_j(q_r.k_j /
// sqrt(hd)) for j < S (zero past S), with its max and sum, all fp32.
template <int MAXS>
__device__ __forceinline__ void attn_row(const float* qkv, int r, int hh,
                                         const Dims& dm, float (&p)[MAXS],
                                         float& mx, float& sum) {
  const int H = dm.hidden, hd = H / dm.heads, S = dm.set_size;
  const float inv_root = 1.0f / sqrtf((float)hd);
  const int ld = dm.ld_qkv;
#pragma unroll
  for (int j = 0; j < MAXS; ++j) p[j] = 0.0f;
  set_dots<MAXS>(qkv + r * ld + hh * hd, qkv + (r / S) * S * ld + H + hh * hd,
                 ld, hd, S, p);
  mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < MAXS; ++j) {
    if (j < S) {
      p[j] = p[j] * inv_root;
      mx = fmaxf(mx, p[j]);
    }
  }
  sum = 0.0f;
#pragma unroll
  for (int j = 0; j < MAXS; ++j) {
    if (j < S) {
      p[j] = expf(p[j] - mx);
      sum += p[j];
    }
  }
  const float inv_sum = 1.0f / sum;
#pragma unroll
  for (int j = 0; j < MAXS; ++j) p[j] *= inv_sum;
}

// Attention within each set, one thread per (head, query row): logits
// q.k / sqrt(hd), softmax, then out = sum_j p_j v_j, all fp32.
template <int MAXS>
__device__ __noinline__ void attention_tile(const float* qkv, float* out,
                                            const Dims& dm) {
  const int H = dm.hidden, nh = dm.heads, hd = H / nh, S = dm.set_size;
  const int ld = dm.ld_qkv;
  for (int item = threadIdx.x; item < dm.tile * nh; item += blockDim.x) {
    const int hh = item / dm.tile;
    const int r = item % dm.tile;
    const float* set = qkv + (r / S) * S * ld;
    float p[MAXS], mx, sum;
    attn_row<MAXS>(qkv, r, hh, dm, p, mx, sum);
    const float* v = set + 2 * H + hh * hd;
    float* o = out + r * dm.ld_h + hh * hd;
    for (int d = 0; d < hd; ++d) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < MAXS; ++j)
        if (j < S) acc = fmaf(p[j], v[j * ld + d], acc);
      o[d] = acc;
    }
  }
}

__device__ __forceinline__ void attention(const float* qkv, float* out,
                                          const Dims& dm) {
  if (dm.set_size <= 16)
    attention_tile<16>(qkv, out, dm);
  else
    attention_tile<kMaxSet>(qkv, out, dm);
}

// ---------------------------------------------------------------------------
// Backward (kernel #4) in fp32: replaces _fused_bwd (body _bwd_kernel, math
// _net_forward), which reruns a tile's forward and pulls the cotangent back
// with jax.vjp.  Here each backward is written out: dense layers, LN
// without affine (fp32 statistics), tanh-gelu, the softmax per set and head
// and the two attention products, all in fp32, as autograd through
// plain_forward computes them.
//
// Bound on an H100.  At the flagship width the backward does about 3x the
// forward's 164k multiply-adds a row (the recompute, the input gradients,
// the weight gradients): 4.0 GFLOP at 4,096 rows, 24 us as three TF32
// products on the tensor cores (60 us on the FMA units), against 1.9 MB of
// x, g and dx and 1.9 MB of weights and fp32 gradients.  It is bound by
// operations, and by the weight-gradient scratch below where the grid is
// wide.
//
// Design: the structure of the port's bf16 backward
// (csrc/fused_transformer_bf16.cu) with 3xTF32 products.  A persistent grid, each block walking the tiles
// blockIdx.x, blockIdx.x + gridDim.x, ...; per tile the forward is rerun
// with the 3xTF32 forward's device functions (mma_dense, LN, attention:
// the same arithmetic), keeping only the residual stream h at each block
// boundary; then the blocks are walked in reverse, each recomputed from its
// h.  dx goes to global memory and the weight gradients to the block's own
// fp32 scratch slice, which reduce_wgrad sums in slice order (bitwise
// deterministic, no float atomics).
// 1. Input gradients g . W^T run on mma_dense, B from the split layout of W
//    that tools/f32_bwd_tf32x3.py builds (SplitWeights::w).
// 2. Weight gradients X^T . G (wgrad_tile) run on the same 3xTF32 products,
//    X^T and G split in registers as they leave shared memory, the large
//    product a k-step at a time added in fp32 as in mma_3xtf32.
// 3. Attention, LN, gelu and the bias gradients stay on the CUDA cores in
//    fp32; the attention backward gives each (head, row) attn_split threads
//    that share its outputs, so that every thread of the block has work.
// 4. Shared memory holds h at the L + 1 block boundaries, five [tile, H]
//    buffers, qkv and one region for the MLP pair, the qkv gradient, g or x:
//    94 KB for the flagship's 16-row tiles, two blocks an SM.  Rows are 4
//    mod 8 floats wide, as in the forward, where they fit.
// Rows past valid in a tile hold finite values whose cotangents are zero;
// the weight gradients also skip them.

// Rows a backward tile aims for (whole sets): 16, two blocks an SM (the
// launch bounds give each 128 registers).  At the flagship on an H100,
// 16-row tiles took 0.466, 0.586 and 2.894 ms at 1,024, 4,096 and 16,384
// rows against 0.726, 0.802 and 3.532 ms for 32-row tiles, one block an SM.
constexpr int kBwdTileTarget = 16;
constexpr int kBwdBlocks = 2;
// k-steps of B fragments that the backward's products keep in flight: 4
// took 3-7% less time than 1 there
constexpr int kBwdDepth = 4;

// The weight and bias gradients of a dense layer over the tile's rows r <
// valid, added into this block's fp32 scratch slice (its first tile
// stores): pw[k, c] (+)= sum_r X[r, k] G[r, c] in 3xTF32 on the tensor
// cores, one warp per 16 x 32 block of pw, A = X^T and B = G split as they
// are loaded; pb[c] (+)= sum_r G[r, c] on the CUDA cores.  Each element is
// always written by the same thread, so no atomics are needed.
__device__ __noinline__ void wgrad_tile(const float* X, int ldx, int kd,
                                        const float* G, int ldg, int n,
                                        float* __restrict__ pw,
                                        float* __restrict__ pb, bool first,
                                        int valid) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mtiles = (kd + 15) >> 4, ngroups = (n + 31) >> 5;
  const int nk = (valid + 7) >> 3;
  for (int task = warp; task < mtiles * ngroups; task += kWarps) {
    const int k0 = (task / ngroups) * 16, c0 = (task % ngroups) * 32;
    const int nq = min(4, (n - c0 + 7) >> 3);  // 8-column n-tiles here
    float small[4][4], big[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) small[q][e] = big[q][e] = 0.0f;
    const int ka = k0 + g, kb = ka + 8;
    for (int s = 0; s < nk; ++s) {
      const int ra = s * 8 + t, rb = ra + 4;
      const bool va = ra < valid, vb = rb < valid;
      // A[m][kk] = X[8s + kk][k0 + m]: (g, t), (g + 8, t), (g, t + 4),
      // (g + 8, t + 4)
      const float av[4] = {va && ka < kd ? X[ra * ldx + ka] : 0.0f,
                           va && kb < kd ? X[ra * ldx + kb] : 0.0f,
                           vb && ka < kd ? X[rb * ldx + ka] : 0.0f,
                           vb && kb < kd ? X[rb * ldx + kb] : 0.0f};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        hi[i] = tf32_rna(av[i]);
        lo[i] = tf32_rna(av[i] - __uint_as_float(hi[i]));
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q >= nq) break;
        // B[kk][col] = G[8s + kk][c0 + 8q + col]: (t, g), (t + 4, g)
        const int c = c0 + 8 * q + g;
        const float b0 = va && c < n ? G[ra * ldg + c] : 0.0f;
        const float b1 = vb && c < n ? G[rb * ldg + c] : 0.0f;
        const uint32_t h0 = tf32_rna(b0), h1 = tf32_rna(b1);
        const float4 b = make_float4(
            __uint_as_float(h0), __uint_as_float(h1),
            __uint_as_float(tf32_rna(b0 - __uint_as_float(h0))),
            __uint_as_float(tf32_rna(b1 - __uint_as_float(h1))));
        mma_3xtf32(small[q], big[q], hi, lo, b);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q >= nq) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // accumulator e: row k0 + g + 8 (e >> 1), column 2t + (e & 1)
        const int k = k0 + g + 8 * (e >> 1);
        const int c = c0 + 8 * q + 2 * t + (e & 1);
        if (k < kd && c < n) {
          float* p = pw + (long)k * n + c;
          const float v = big[q][e] + small[q][e];
          *p = first ? v : *p + v;
        }
      }
    }
  }
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    float s = 0.0f;
    for (int r = 0; r < valid; ++r) s += G[r * ldg + c];
    pb[c] = first ? s : pb[c] + s;
  }
}

// Backward of LN without affine, one warp a row, from the forward's input
// x and the output's cotangent g: dx = inv * (g - mean(g) - xhat *
// mean(g * xhat)), with the statistics as layer_norm_tile computes them;
// with RES it is added to gout (the residual branch's gradient).
template <bool RES>
__device__ __noinline__ void layer_norm_bwd_tile(const float* x,
                                                 const float* g, float* gout,
                                                 const Dims& dm) {
  const int lane = threadIdx.x & 31, h = dm.hidden;
  for (int r = threadIdx.x >> 5; r < dm.tile; r += kWarps) {
    const float* row = x + r * dm.ld_h;
    const float* gr = g + r * dm.ld_h;
    float s = 0.0f;
    for (int c = lane; c < h; c += 32) s += row[c];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mean = s / h;
    float v = 0.0f;
    for (int c = lane; c < h; c += 32) {
      const float d = row[c] - mean;
      v = fmaf(d, d, v);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    const float inv = rsqrtf(v / h + 1e-5f);
    float sg = 0.0f, sgx = 0.0f;
    for (int c = lane; c < h; c += 32) {
      sg += gr[c];
      sgx = fmaf(gr[c], (row[c] - mean) * inv, sgx);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sg += __shfl_xor_sync(0xffffffffu, sg, o);
      sgx += __shfl_xor_sync(0xffffffffu, sgx, o);
    }
    const float mg = sg / h, mgx = sgx / h;
    for (int c = lane; c < h; c += 32) {
      const float xhat = (row[c] - mean) * inv;
      const float d = inv * (gr[c] - mg - xhat * mgx);
      float* o = gout + r * dm.ld_h + c;
      *o = RES ? *o + d : d;
    }
  }
}

// The columns [d0, d1) of a head that thread `part` of attn_split writes.
__device__ __forceinline__ void split_range(int part, int hd, int split,
                                            int& d0, int& d1) {
  d0 = part * hd / split;
  d1 = (part + 1) * hd / split;
}

// Attention backward, phase 1: attn_split threads per (head, query row),
// each recomputing the row's softmax and writing its share of the query
// gradient sum_j gl_ij / sqrt(hd) k_j, with gl_ij = p_ij (gP_ij - D_i),
// gP_ij = go_i . v_j and D_i = sum_j p_ij gP_ij; the first keeps the row's
// max, sum and D_i for phase 2.
template <int MAXS>
__device__ __noinline__ void attention_bwd_q(const float* qkv,
                                             const float* go, float* gqkv,
                                             float* stats, const Dims& dm) {
  const int H = dm.hidden, nh = dm.heads, hd = H / nh, S = dm.set_size;
  const float inv_root = 1.0f / sqrtf((float)hd);
  const int ld = dm.ld_qkv, items = dm.tile * nh;
  for (int it = threadIdx.x; it < items * dm.attn_split; it += blockDim.x) {
    const int part = it / items, item = it % items;
    const int hh = item / dm.tile, r = item % dm.tile;
    const float* set = qkv + (r / S) * S * ld;
    float p[MAXS], mx, sum, gp[MAXS];
    attn_row<MAXS>(qkv, r, hh, dm, p, mx, sum);
#pragma unroll
    for (int j = 0; j < MAXS; ++j) gp[j] = 0.0f;
    set_dots<MAXS>(go + r * dm.ld_h + hh * hd, set + 2 * H + hh * hd, ld, hd,
                   S, gp);
    float D = 0.0f;
#pragma unroll
    for (int j = 0; j < MAXS; ++j)
      if (j < S) D = fmaf(p[j], gp[j], D);
    // the softmax's backward, then the 1/sqrt(hd) scale of the logits
#pragma unroll
    for (int j = 0; j < MAXS; ++j)
      if (j < S) gp[j] = p[j] * (gp[j] - D) * inv_root;
    int d0, d1;
    split_range(part, hd, dm.attn_split, d0, d1);
    const float* k = set + H + hh * hd;
    float* gq = gqkv + r * ld + hh * hd;
    for (int d = d0; d < d1; ++d) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < MAXS; ++j)
        if (j < S) acc = fmaf(gp[j], k[j * ld + d], acc);
      gq[d] = acc;
    }
    if (part == 0) {
      float* st = stats + (hh * dm.tile + r) * 3;
      st[0] = mx;
      st[1] = sum;
      st[2] = D;
    }
  }
}

// Phase 2: attn_split threads per (head, key row j): gk_j = sum_i gl_ij /
// sqrt(hd) q_i and gv_j = sum_i p_ij go_i over the queries of j's set, with
// p_ij recomputed from phase 1's row statistics as the forward computes it.
template <int MAXS>
__device__ __noinline__ void attention_bwd_kv(const float* qkv,
                                              const float* go, float* gqkv,
                                              const float* stats,
                                              const Dims& dm) {
  const int H = dm.hidden, nh = dm.heads, hd = H / nh, S = dm.set_size;
  const float inv_root = 1.0f / sqrtf((float)hd);
  const int ld = dm.ld_qkv, items = dm.tile * nh;
  for (int it = threadIdx.x; it < items * dm.attn_split; it += blockDim.x) {
    const int part = it / items, item = it % items;
    const int hh = item / dm.tile, j = item % dm.tile;
    const int set0 = (j / S) * S;
    const float* q = qkv + set0 * ld + hh * hd;
    const float* gos = go + set0 * dm.ld_h + hh * hd;
    float gl[MAXS], pq[MAXS];
#pragma unroll
    for (int i = 0; i < MAXS; ++i) gl[i] = pq[i] = 0.0f;
    // q_i . k_j and go_i . v_j for the set's queries i
    set_dots<MAXS>(qkv + j * ld + H + hh * hd, q, ld, hd, S, gl);
    set_dots<MAXS>(qkv + j * ld + 2 * H + hh * hd, gos, dm.ld_h, hd, S, pq);
#pragma unroll
    for (int i = 0; i < MAXS; ++i) {
      if (i < S) {
        const float* st = stats + (hh * dm.tile + set0 + i) * 3;
        const float p = expf(gl[i] * inv_root - st[0]) * (1.0f / st[1]);
        gl[i] = p * (pq[i] - st[2]) * inv_root;
        pq[i] = p;
      }
    }
    int d0, d1;
    split_range(part, hd, dm.attn_split, d0, d1);
    float* gk = gqkv + j * ld + H + hh * hd;
    for (int d = d0; d < d1; ++d) {
      float ak = 0.0f, av = 0.0f;
#pragma unroll
      for (int i = 0; i < MAXS; ++i) {
        if (i < S) {
          ak = fmaf(gl[i], q[i * ld + d], ak);
          av = fmaf(pq[i], gos[i * dm.ld_h + d], av);
        }
      }
      gk[d] = ak;
      gk[H + d] = av;
    }
  }
}

__device__ __forceinline__ void attention_bwd(const float* qkv,
                                              const float* go, float* gqkv,
                                              float* stats, const Dims& dm) {
  if (dm.set_size <= 16) {
    attention_bwd_q<16>(qkv, go, gqkv, stats, dm);
    __syncthreads();
    attention_bwd_kv<16>(qkv, go, gqkv, stats, dm);
  } else {
    attention_bwd_q<kMaxSet>(qkv, go, gqkv, stats, dm);
    __syncthreads();
    attention_bwd_kv<kMaxSet>(qkv, go, gqkv, stats, dm);
  }
}

// A [tile, ld] tile of a [rows, width] fp32 input, zero past valid rows and
// past width.
__device__ void load_rows(const float* __restrict__ src, long row0, int valid,
                          int width, float* dst, int ld, const Dims& dm) {
  for (int i = threadIdx.x; i < dm.tile * ld; i += blockDim.x) {
    const int r = i / ld, c = i % ld;
    dst[i] = r < valid && c < width ? src[(row0 + r) * width + c] : 0.0f;
  }
}

__device__ __forceinline__ void copy_floats(const float* src, float* dst,
                                            int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// Floats of one backward block's shared memory: h at the L + 1 block
// boundaries and five [tile, ld_h] buffers (gh, a, o, hm, gs), qkv [tile,
// ld_qkv], the region [tile, ld_r2] for the MLP pair f | m, the qkv
// gradient, g or x, the softmax statistics [heads, tile, 3], and the slack
// that the last row's padded contraction reads.
__host__ __device__ inline size_t bwd_smem_floats(const Dims& dm) {
  return (size_t)dm.tile * ((dm.layers + 6) * dm.ld_h + dm.ld_qkv +
                            dm.ld_r2 + 3 * dm.heads) +
         kSlack;
}

__global__ void __launch_bounds__(kThreads, kBwdBlocks)
fused_set_transformer_bwd_tf32x3(const float* __restrict__ x,
                                 const float* __restrict__ g,
                                 SplitWeights wt, float* __restrict__ dx,
                                 float* __restrict__ part, Dims dm) {
  extern __shared__ __align__(16) float smem[];
  const int H = dm.hidden, RH = dm.mlp, L = dm.layers, T = dm.tile;
  const int hsz = T * dm.ld_h;
  float* hs = smem;                   // [L + 1] residual streams
  float* gh = hs + (L + 1) * hsz;     // d loss / d h
  float* a = gh + hsz;                // LN outputs
  float* o = a + hsz;                 // attention output
  float* hm = o + hsz;                // h after the attention residual
  float* gs = hm + hsz;               // ga, ga2, go, ga1
  float* qkv = gs + hsz;              // [T, ld_qkv]
  float* r2 = qkv + T * dm.ld_qkv;    // [T, ld_r2]: f | m, gqkv, g, x
  float* stats = r2 + T * dm.ld_r2;   // [heads, T, 3]
  float* f = r2;                      // [T, ld_f] pre-gelu, then its grad
  float* m = r2 + T * dm.ld_f;        // [T, ld_f] gelu(f)
  // one layer of each stacked layout: the forward's W^T, then W
  const long t_qkv = (long)dm.n_qkv * 2 * dm.k_h;
  const long t_hh = (long)dm.n_h * 2 * dm.k_h;  // proj, W^T and W alike
  const long t_fc1 = (long)dm.n_f * 2 * dm.k_h;
  const long t_fc2 = (long)dm.n_h * 2 * dm.k_f;
  const long w_qkv = (long)dm.n_h * 2 * dm.n_qkv;
  const long w_fc1 = (long)dm.n_h * 2 * dm.k_f;
  const long w_fc2 = (long)dm.n_f * 2 * dm.k_h;
  const Offsets og = grad_offsets(dm);
  float* pw = part + blockIdx.x * og.off[12];
  const long ntiles = (dm.rows + T - 1) / T;

  const int total = (int)bwd_smem_floats(dm);
  for (int i = threadIdx.x; i < total; i += blockDim.x) smem[i] = 0.0f;
  __syncthreads();
  for (long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const bool first = t == blockIdx.x;
    const long row0 = t * T;
    const long left = dm.rows - row0;
    const int valid = left < T ? (int)left : T;

    // 1. forward, keeping h at each block boundary
    load_rows(x, row0, valid, dm.in_dim, r2, dm.ld_x, dm);
    __syncthreads();
    mma_dense<kStore, kBwdDepth>(r2, dm.ld_x, dm.k_in, wt.wt[0], dm.n_h, H,
        wt.b[0], hs, dm.ld_h, nullptr, valid, dm);
    __syncthreads();
    for (int l = 0; l < L; ++l) {
      float* h = hs + (l + 1) * hsz;
      copy_floats(hs + l * hsz, h, hsz);
      __syncthreads();
      layer_norm_tile(h, a, dm);
      __syncthreads();
      mma_dense<kStore, kBwdDepth>(a, dm.ld_h, dm.k_h, wt.wt[1] + l * t_qkv,
          dm.n_qkv, 3 * H, wt.b[1] + l * 3 * H, qkv, dm.ld_qkv, nullptr, valid,
          dm);
      __syncthreads();
      attention(qkv, o, dm);
      __syncthreads();
      mma_dense<kResidual, kBwdDepth>(o, dm.ld_h, dm.k_h, wt.wt[2] + l * t_hh,
          dm.n_h, H, wt.b[2] + l * H, h, dm.ld_h, nullptr, valid, dm);
      __syncthreads();
      layer_norm_tile(h, a, dm);
      __syncthreads();
      mma_dense<kGelu, kBwdDepth>(a, dm.ld_h, dm.k_h, wt.wt[3] + l * t_fc1,
          dm.n_f, RH, wt.b[3] + l * RH, m, dm.ld_f, nullptr, valid, dm);
      __syncthreads();
      mma_dense<kResidual, kBwdDepth>(m, dm.ld_f, dm.k_f, wt.wt[4] + l * t_fc2,
          dm.n_h, H, wt.b[4] + l * H, h, dm.ld_h, nullptr, valid, dm);
      __syncthreads();
    }

    // 2. output layer: y = LN(h_L) @ Wo + bo
    layer_norm_tile(hs + L * hsz, a, dm);
    load_rows(g, row0, valid, dm.out_dim, r2, dm.ld_g, dm);
    __syncthreads();
    wgrad_tile(a, dm.ld_h, H, r2, dm.ld_g, dm.out_dim, pw + og.off[10],
               pw + og.off[11], first, valid);
    mma_dense<kBwdStore, kBwdDepth>(r2, dm.ld_g, dm.n_out, wt.w[5], dm.n_h, H,
        nullptr, gs, dm.ld_h, nullptr, valid, dm);
    __syncthreads();
    layer_norm_bwd_tile<false>(hs + L * hsz, gs, gh, dm);
    __syncthreads();

    // 3. the blocks in reverse, each recomputed from its input h
    for (int l = L - 1; l >= 0; --l) {
      const float* h = hs + l * hsz;
      layer_norm_tile(h, a, dm);
      copy_floats(h, hm, hsz);
      __syncthreads();
      mma_dense<kStore, kBwdDepth>(a, dm.ld_h, dm.k_h, wt.wt[1] + l * t_qkv,
          dm.n_qkv, 3 * H, wt.b[1] + l * 3 * H, qkv, dm.ld_qkv, nullptr, valid,
          dm);
      __syncthreads();
      attention(qkv, o, dm);
      __syncthreads();
      mma_dense<kResidual, kBwdDepth>(o, dm.ld_h, dm.k_h, wt.wt[2] + l * t_hh,
          dm.n_h, H, wt.b[2] + l * H, hm, dm.ld_h, nullptr, valid, dm);
      __syncthreads();
      layer_norm_tile(hm, a, dm);
      __syncthreads();
      mma_dense<kFc1, kBwdDepth>(a, dm.ld_h, dm.k_h, wt.wt[3] + l * t_fc1,
          dm.n_f, RH, wt.b[3] + l * RH, f, dm.ld_f, nullptr, valid, dm, m);
      __syncthreads();
      // MLP: h_out = hm + m @ W2 + b2, m = gelu(f)
      wgrad_tile(m, dm.ld_f, RH, gh, dm.ld_h, H,
                 pw + og.off[8] + (long)l * RH * H, pw + og.off[9] + l * H,
                 first, valid);
      mma_dense<kBwdGelu, kBwdDepth>(gh, dm.ld_h, dm.k_h, wt.w[4] + l * w_fc2,
          dm.n_f, RH, nullptr, f, dm.ld_f, nullptr, valid, dm);
      __syncthreads();
      wgrad_tile(a, dm.ld_h, H, f, dm.ld_f, RH,
                 pw + og.off[6] + (long)l * H * RH, pw + og.off[7] + l * RH,
                 first, valid);
      mma_dense<kBwdStore, kBwdDepth>(f, dm.ld_f, dm.k_f, wt.w[3] + l * w_fc1,
          dm.n_h, H, nullptr, gs, dm.ld_h, nullptr, valid, dm);
      __syncthreads();
      layer_norm_bwd_tile<true>(hm, gs, gh, dm);
      __syncthreads();
      // attention: hm = h + o @ Wp + bp
      wgrad_tile(o, dm.ld_h, H, gh, dm.ld_h, H,
                 pw + og.off[4] + (long)l * H * H, pw + og.off[5] + l * H,
                 first, valid);
      mma_dense<kBwdStore, kBwdDepth>(gh, dm.ld_h, dm.k_h, wt.w[2] + l * t_hh,
          dm.n_h, H, nullptr, gs, dm.ld_h, nullptr, valid, dm);
      layer_norm_tile(h, a, dm);  // a1 again, for the qkv weights
      __syncthreads();
      attention_bwd(qkv, gs, r2, stats, dm);
      __syncthreads();
      wgrad_tile(a, dm.ld_h, H, r2, dm.ld_qkv, 3 * H,
                 pw + og.off[2] + (long)l * H * 3 * H,
                 pw + og.off[3] + l * 3 * H, first, valid);
      mma_dense<kBwdStore, kBwdDepth>(r2, dm.ld_qkv, dm.n_qkv,
          wt.w[1] + l * w_qkv, dm.n_h, H, nullptr, gs, dm.ld_h, nullptr, valid,
          dm);
      __syncthreads();
      layer_norm_bwd_tile<true>(h, gs, gh, dm);
      __syncthreads();
    }

    // 4. embed: h_0 = x @ We + be
    load_rows(x, row0, valid, dm.in_dim, r2, dm.ld_x, dm);
    __syncthreads();
    wgrad_tile(r2, dm.ld_x, dm.in_dim, gh, dm.ld_h, H, pw + og.off[0],
               pw + og.off[1], first, valid);
    mma_dense<kBwdGlobal, kBwdDepth>(gh, dm.ld_h, dm.k_h, wt.w[0], dm.k_in,
        dm.in_dim, nullptr, nullptr, 0, dx + row0 * dm.in_dim, valid, dm);
    __syncthreads();
  }
}

// The backward's tile, whole sets up to kBwdTileTarget rows (one set where
// a set is larger), and leading dimensions, the first of these whose
// shared memory fits: conflict-free rows; rows at their true width.
// Returns false where neither fits.  tools/f32_bwd_tf32x3.py bwd_shape
// mirrors it.
bool pick_bwd_layout(Dims& dm, int max_smem) {
  const int tt = kBwdTileTarget;
  dm.tile = (tt >= dm.set_size ? tt / dm.set_size : 1) * dm.set_size;
  for (int i = 0; i < 2; ++i) {
    const bool spread = i == 0;
    auto ld = [spread](int n) { return spread ? conflict_free(n) : n; };
    dm.ld_x = ld(dm.in_dim);
    dm.ld_h = ld(dm.hidden);
    dm.ld_qkv = ld(3 * dm.hidden);
    dm.ld_f = ld(dm.mlp);
    dm.ld_g = ld(dm.out_dim);
    int r2 = 2 * dm.ld_f;
    if (dm.ld_qkv > r2) r2 = dm.ld_qkv;
    if (dm.ld_g > r2) r2 = dm.ld_g;
    if (dm.ld_x > r2) r2 = dm.ld_x;
    dm.ld_r2 = r2;
    if (sizeof(float) * bwd_smem_floats(dm) <= (size_t)max_smem) return true;
  }
  return false;
}

// The widths of a call (the layout picks the tile and the rows).
Dims make_dims(long rows, int set_size, int in_dim, int hidden, int heads,
               int layers, int mlp, int out_dim) {
  Dims dm;
  dm.rows = rows;
  dm.set_size = set_size;
  dm.in_dim = in_dim;
  dm.hidden = hidden;
  dm.heads = heads;
  dm.layers = layers;
  dm.mlp = mlp;
  dm.out_dim = out_dim;
  dm.k_in = pad8(in_dim);
  dm.k_h = pad8(hidden);
  dm.k_f = pad8(mlp);
  dm.n_h = pad8(hidden);
  dm.n_qkv = pad8(3 * hidden);
  dm.n_f = pad8(mlp);
  dm.n_out = pad8(out_dim);
  dm.ld_g = dm.ld_r2 = 0;
  dm.attn_split = 1;
  return dm;
}

cudaError_t max_smem_optin(int* max_smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(max_smem,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

}  // namespace

extern "C" {

// Backward in fp32: x [rows, in] and g [rows, out]; writes dx [rows, in]
// and the 12 fp32 weight gradients, flat in flatten_params order, to dw.
// w: the 6 split layouts W^T of the forward, then the 6 split layouts W
// (see SplitWeights; embed, qkv, proj, fc1, fc2, out); b: the 6 fp32
// biases.  part is fp32 scratch of grid x (the size of dw); grid (<= the
// number of tiles) is the number of persistent blocks.  Returns
// cudaGetLastError().
int fused_set_transformer_bwd_f32_tf32x3(const void* x, const void* g,
                                  const void* const* w, const float* const* b,
                                  void* dx, float* part, float* dw, long rows,
                                  int set_size, int in_dim, int hidden,
                                  int heads, int layers, int mlp, int out_dim,
                                  int grid, void* stream) {
  if (set_size < 1 || set_size > kMaxSet || heads < 1 || hidden % heads ||
      grid < 1 || rows % set_size)
    return (int)cudaErrorInvalidValue;
  Dims dm = make_dims(rows, set_size, in_dim, hidden, heads, layers, mlp,
                      out_dim);
  int max_smem = 0;
  cudaError_t err = max_smem_optin(&max_smem);
  if (err != cudaSuccess) return (int)err;
  if (!pick_bwd_layout(dm, max_smem)) return (int)cudaErrorInvalidValue;
  // threads a (head, row) in the attention backward, so that the block's
  // threads all have work
  const int hd = hidden / heads, items = dm.tile * heads;
  dm.attn_split = items >= kThreads ? 1 : kThreads / items;
  if (dm.attn_split > hd) dm.attn_split = hd;
  if (rows == 0) return (int)cudaSuccess;
  const long ntiles = (rows + dm.tile - 1) / dm.tile;
  if (grid > ntiles) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * bwd_smem_floats(dm);
  err = cudaFuncSetAttribute(fused_set_transformer_bwd_tf32x3,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  SplitWeights wt;
  for (int j = 0; j < 6; ++j) {
    wt.wt[j] = (const float*)w[j];
    wt.w[j] = (const float*)w[6 + j];
    wt.b[j] = b[j];
  }
  cudaStream_t s = (cudaStream_t)stream;
  fused_set_transformer_bwd_tf32x3<<<grid, kThreads, smem, s>>>(
      (const float*)x, (const float*)g, wt, (float*)dx, part, dm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Offsets og = grad_offsets(dm);
  reduce_wgrad<float><<<(unsigned)((og.off[12] + kThreads - 1) / kThreads),
                        kThreads, 0, s>>>(part, grid, og, dw);
  return (int)cudaGetLastError();
}

}  // extern "C"
