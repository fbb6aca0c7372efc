// Fused SetTransformer forward (kernel #3) in fp32, on Hopper's tensor cores
// (sm_90a) with a 3xTF32 split: the eval_model twin's coupling net.  The
// fp32 backward (#4) stays the CUDA-core kernel of fused_transformer.cu;
// the bf16 pair is fused_transformer_bf16.cu.
//
// Replaces the TPU kernel categoricalnf_tpu/ops/pallas/fused_transformer.py
// _fused_fwd (body _fwd_kernel -> _net_forward) in fp32: embed -> L x [LN ->
// QKV -> per-set, per-head attention -> proj + residual; LN -> fc1 ->
// gelu(tanh) -> fc2 + residual] -> LN -> out, for a tile of whole sets.
//
// Bound on an H100.  At the flagship width (H=96, 4 heads, 2 blocks, S=16,
// in 4, out 104) the net does about 164k multiply-adds a row, 21.5 GFLOP at
// eval_bpd's 65,536 rows, against 16 B of x and 416 B of y a row and 0.6 MB
// of weights: it is bound by operations.  On the FMA units (67 TFLOP/s)
// that is 0.32 ms; as three TF32 products on the tensor cores (494.7
// TFLOP/s dense) 0.13 ms.
//
// Accuracy.  Every density evaluation runs in fp32, and a single TF32
// product (10 mantissa bits) would not: it reads about 3e-4 relative error
// against fp32.  Each fp32 operand v is split into a TF32 high part hi =
// rna(v) and a TF32 remainder lo = rna(v - hi) (cvt.rna.tf32.f32; v - hi is
// exact), and a product is a_lo.b_hi + a_hi.b_lo + a_hi.b_hi on
// mma.sync.m16n8k8.tf32 with fp32 accumulators: the small terms in one
// chain of the tensor cores' accumulator, the large one a k-step at a time
// added in fp32 (mma_3xtf32 says why).  The dropped a_lo.b_lo is below
// fp32's rounding, so the result has fp32's accuracy.  The weights
// are split once a repack (PackedWeights); the activations when their A
// fragment is loaded.  No product anywhere takes a single TF32 pass.
//
// Design.  One block of 8 warps a tile of whole sets, 32 rows at the
// flagship (two 16-row m-tiles), no persistent loop.  Shared memory holds
// three fp32 buffers for the whole net: h (the residual stream), a (the LN
// output, then the attention output) and big (x, then qkv, then the MLP
// hidden layer): 63 KB at the flagship, three blocks an SM.  A tile's rows
// are exactly its sets (no padded rows are stored); an m-tile that runs
// past them reads its last row again and stores nothing there.  Leading
// dimensions are 4 mod 8 floats, so the A-fragment loads (lane (g, t) reads
// row g, column t) fall in 32 distinct banks; where a wide net does not fit
// so, the tile drops to 16 rows, and then the rows to their true width
// (bank conflicts, same results).  The contraction runs over widths padded
// to 8; the pad columns read the next row's finite values (or zeros past
// the last buffer) against the zero pad of the weight layout, so they add
// nothing; shared memory is cleared once so that every value is finite.
// Each dense product: one warp per (16-row m-tile, 16 output columns),
// B fragments of the split weights loaded as one 16-byte read a lane a
// k-step, one k-step ahead; bias, residual and tanh-gelu in the fp32
// epilogue; the output layer's rows < valid straight to global memory.
// LayerNorm (one warp a row) and, at sets up to 32, attention (one thread
// per head and query row, its own row in registers, the set's rows
// broadcast, set loops unrolled only to 16 or 32) run on the CUDA cores in
// fp32, out of line.
//
// Key mask.  The entry point takes an optional key mask, one byte a row of
// x (0 = the key is masked), as the reference's masked attention: the
// scaled logit of a masked key becomes -1e9 before the row's max, so its
// probability is exactly 0 where any key of the set is valid, and a set
// whose keys are all masked attends uniformly over them.  A null mask
// leaves the arithmetic as it was.
//
// Sets of 33 to 128 rows: a BIG instance (the one for sets up to 32 holds
// none of its code), a set over a thread-block cluster as the fp32 train
// step's pair splits it (2 blocks up to 64 rows, 4 up to 128, ceil(S /
// cluster) rows a block: at most 32, the tile of the sets up to 32, so
// three blocks fit an SM's shared memory), every row-wise phase in its own
// block; attention on warp tiles of the tensor cores in 3xTF32 (described
// where it starts, below), reading the other blocks' keys and values
// through distributed shared memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fused_transformer_tiles.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSet = 32;      // largest set the unrolled attention takes
constexpr int kMaxBigSet = 128;  // largest set handled (BIG instance)
constexpr int kMaxCluster = 4;   // blocks a set spans at most (BIG)
// Rows of a set above kMaxSet that a block holds at most: the set spans
// the fewest of 1, 2, kMaxCluster blocks that keeps it within this.
constexpr int kBigRows = 32;
// Rows a tile aims for (whole sets): 32, two m-tiles, three blocks an SM.
// 64-row tiles (126 KB, one block of 8 warps an SM) took 1.66 ms against
// 0.96 ms at the flagship on an H100.
constexpr int kTileTarget = 32;
constexpr int kMinTile = 16;     // the fallback where a net does not fit
constexpr int kBlocks = 3;       // blocks an SM the launch bounds allow
// The BIG instance's: two blocks an SM (128 registers a thread; its
// shared memory, with the stage of its heads, holds two).
constexpr int kBigBlocks = 2;
// 8-column steps of the head width whose fragments a warp holds at once
// (24: the flagship's head width)
constexpr int kAttnSteps = 3;
constexpr int kChunk = 8;        // own-row values held in registers
constexpr int kSlack = 8;        // floats past the last buffer (pad reads)

struct Dims {
  long rows;
  int set_size, in_dim, hidden, heads, layers, mlp, out_dim;
  int tile;                       // rows of a tile: whole sets, all stored
  int cluster, split;  // blocks a set spans (1, 2, 4); rows of each but
                       // the last
  int k_in, k_h, k_f;             // contraction widths padded to 8
  int n_h, n_qkv, n_f, n_out;     // output widths padded to 8
  int ld_x, ld_h, ld_qkv, ld_f, ld_big;  // shared-memory rows (floats)
  int ld_stage;  // BIG: rows of the stage of its block's heads
};

// The 6 split layouts (embed, qkv, proj, fc1, fc2, out; layer-stacked):
// W^T [pad8(n), 2 pad8(kd)], where the 16 floats of output row c and
// k-step s are, for t < 4, (hi[8s + t], hi[8s + t + 4], lo[8s + t],
// lo[8s + t + 4]): lane (g, t) reads its two B fragments as one float4.
// The 6 fp32 biases.
struct SplitWeights {
  const float* wt[6];
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
  kStore,     // out = acc + b
  kResidual,  // out += acc + b
  kGelu,      // out = gelu(acc + b)
  kGlobal,    // gout[r, c] = acc + b for rows < valid
};

// out[r, c] <- epilogue(A[r, :kp] . W[:kp, c] + b[c]) for the tile's rows
// and c < n.  A: fp32 [tile, lda] in shared memory; bt: a split layout
// [np, 2 kp] (np = pad8(n)).  One warp per (m-tile, pair of 8-column
// n-tiles), the warps of one pair reading the same B.  Inlined, so each
// kernel has its own copy.
template <int EPI>
__device__ __forceinline__ void mma_dense(const float* A, int lda, int kp,
                                          const float* __restrict__ bt,
                                          int np, int n,
                                          const float* __restrict__ bias,
                                          float* out, int ld_out,
                                          float* __restrict__ gout, int valid,
                                          const Dims& dm) {
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
    float4 b0 = __ldg(b0p), b1 = __ldg(b1p);
    for (int s = 0; s < nk; ++s) {
      float4 nb0 = b0, nb1 = b1;
      if (s + 1 < nk) {
        nb0 = __ldg(b0p + 4 * (s + 1));
        nb1 = __ldg(b1p + 4 * (s + 1));
      }
      const int k0 = s * 8;
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
      b0 = nb0;
      b1 = nb1;
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
        const float v = (big[q][e] + small[q][e]) + bias[c];
        if constexpr (EPI == kStore) {
          out[r * ld_out + c] = v;
        } else if constexpr (EPI == kResidual) {
          out[r * ld_out + c] += v;
        } else if constexpr (EPI == kGelu) {
          out[r * ld_out + c] = gelu_tanh(v);
        } else {
          if (r < valid) gout[(long)r * n + c] = v;
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

// Attention within each set, one thread per (head, query row): logits
// q.k / sqrt(hd), the logit of a key with km[j] == 0 (j < valid) set to
// kMaskedLogit, softmax, then out = sum_j p_j v_j, all fp32.  Rows past
// valid are whole sets whose outputs are dropped; their keys read as valid.
template <int MAXS>
__device__ __noinline__ void attention_tile(const float* qkv, float* out,
                                            const Dims& dm,
                                            const unsigned char* km,
                                            int valid) {
  const int H = dm.hidden, nh = dm.heads, hd = H / nh, S = dm.set_size;
  const float inv_root = 1.0f / sqrtf((float)hd);
  const int ld = dm.ld_qkv;
  for (int item = threadIdx.x; item < dm.tile * nh; item += blockDim.x) {
    const int hh = item / dm.tile;
    const int r = item % dm.tile;
    const int set0 = (r / S) * S;
    const float* set = qkv + set0 * ld;
    float p[MAXS];
#pragma unroll
    for (int j = 0; j < MAXS; ++j) p[j] = 0.0f;
    set_dots<MAXS>(qkv + r * ld + hh * hd, set + H + hh * hd, ld, hd, S, p);
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < MAXS; ++j) {
      if (j < S) {
        const bool masked =
            km != nullptr && set0 + j < valid && km[set0 + j] == 0;
        p[j] = masked ? kMaskedLogit : p[j] * inv_root;
        mx = fmaxf(mx, p[j]);
      }
    }
    float sum = 0.0f;
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
                                          const Dims& dm,
                                          const unsigned char* km,
                                          int valid) {
  if (dm.set_size <= 16)
    attention_tile<16>(qkv, out, dm, km, valid);
  else
    attention_tile<kMaxSet>(qkv, out, dm, km, valid);
}

// ---- Sets above kMaxSet rows: attention on warp tiles -------------------
//
// Each block of the set's cluster takes a share of its heads (head hh in
// block hh % cluster) for every row of the set: it first copies the q, k
// and v columns of its heads from every block's qkv rows into a stage of
// its own shared memory, 16 bytes a thread where the widths allow (the
// other blocks' through distributed shared memory), so that the attention
// reads only its own shared memory, then writes each row's output to the
// block that holds the row.  A warp owns a 16-row m-tile of one head's
// queries against the whole set: their logits in the fp32 accumulators of
// mma.sync.m16n8k8 (8 n-tiles of 8 keys up to 64 rows, 16 up to 128), each
// formed once in 3xTF32 as the dense products form theirs (the operands
// split hi + lo as a fragment is loaded, the large term added in fp32 a
// k-step at a time).  The row's max and sum are taken in fp32 over the 4
// lanes of a quad by shuffles, with a masked key's logit kMaskedLogit
// before the max and no weight past the set; the probabilities go from the
// accumulators straight into the A fragments of P.V, also in 3xTF32:
// n-tile kk of the logits is k-step kk of P, its elements (2t, 2t + 1) at
// k = t and t + 4, so V's B fragment takes key 2t at k = t and key 2t + 1
// at k = t + 4.

// The hi and lo TF32 parts of a fragment's four fp32 values.
__device__ __forceinline__ void split_a(const float (&v)[4],
                                        uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = tf32_rna(v[i]);
    lo[i] = tf32_rna(v[i] - __uint_as_float(hi[i]));
  }
}

// A k-step's B fragment from its values at k = t and t + 4, in the order
// of the split weight layouts: hi, hi, lo, lo.
__device__ __forceinline__ float4 split_b(float x, float y) {
  const uint32_t hx = tf32_rna(x), hy = tf32_rna(y);
  return make_float4(__uint_as_float(hx), __uint_as_float(hy),
                     __uint_as_float(tf32_rna(x - __uint_as_float(hx))),
                     __uint_as_float(tf32_rna(y - __uint_as_float(hy))));
}

// The column of accumulator element e of n-tile j (its row is g or g + 8
// as e < 2 or not).
__device__ __forceinline__ int acc_col(int j, int e) {
  return 8 * j + 2 * (threadIdx.x & 3) + (e & 1);
}

// Over the 4 lanes of a quad (the lanes of one accumulator row).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// acc[j] = the 16 x 8 tile of dot products over hd of query rows r0 + g,
// r0 + g + 8 of ``q`` with key rows k0 + 8j .. k0 + 8j + 7 of ``k`` (both
// ld apart, from their head's column), in 3xTF32: A's fragments of
// kAttnSteps k-steps held split, B's split as they load.  A row from n
// reads the last valid one (the callers drop those rows' results, or give
// their keys no weight); a column from hd reads the last valid one and
// counts as zero in A.
template <int KT>
__device__ __forceinline__ void warp_dots(const float* q, const float* k,
                                          int ld, int r0, int k0, int n,
                                          int hd, float (&acc)[KT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* a0 = q + min(r0 + g, n - 1) * ld;
  const float* a1 = q + min(r0 + g + 8, n - 1) * ld;
#pragma unroll
  for (int j = 0; j < KT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  for (int d0 = 0; d0 < hd; d0 += 8 * kAttnSteps) {
    uint32_t hi[kAttnSteps][4], lo[kAttnSteps][4];
#pragma unroll
    for (int s = 0; s < kAttnSteps; ++s) {
      // A fragment: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
      const int c0 = d0 + 8 * s + t, c1 = c0 + 4;
      const int e0 = min(c0, hd - 1), e1 = min(c1, hd - 1);
      const float v[4] = {c0 < hd ? a0[e0] : 0.0f, c0 < hd ? a1[e0] : 0.0f,
                          c1 < hd ? a0[e1] : 0.0f, c1 < hd ? a1[e1] : 0.0f};
      split_a(v, hi[s], lo[s]);
    }
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const float* row = k + min(k0 + 8 * j + g, n - 1) * ld;
      float small[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int s = 0; s < kAttnSteps; ++s) {
        if (d0 + 8 * s < hd) {
          const int c0 = d0 + 8 * s + t;
          mma_3xtf32(small, acc[j], hi[s], lo[s],
                     split_b(row[min(c0, hd - 1)], row[min(c0 + 4, hd - 1)]));
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += small[e];
    }
  }
}

// Rows r0 + g, r0 + g + 8 of the set (those below n) of ``out`` (the
// buffer of the block that holds each row, ld_out apart, from column oc)
// = (ADD: out +) the sum over keys k0 + acc_col(kk, e) of p . v, p the
// warp's probabilities in its logits' accumulator layout and v the rows of
// ``v`` (ld apart, from its head's column), in 3xTF32, kAttnSteps n-tiles
// of 8 columns at a time.  A key from n reads the last valid row (its p is
// zero); a column from hd reads the last valid one and is not stored.
template <int KT, bool ADD>
__device__ __forceinline__ void warp_pv(const float (&p)[KT][4],
                                        const float* v, int ld, int k0,
                                        int n, int hd,
                                        const SetRows<float, kMaxCluster>& out,
                                        int oc, int r0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int n0 = 0; n0 < hd; n0 += 8 * kAttnSteps) {
    float small[kAttnSteps][4], big[kAttnSteps][4];
#pragma unroll
    for (int q = 0; q < kAttnSteps; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) small[q][e] = big[q][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      // A fragment: C's elements 0, 2 (key 2t) at k = t, 1, 3 at t + 4
      const float pv[4] = {p[kk][0], p[kk][2], p[kk][1], p[kk][3]};
      uint32_t hi[4], lo[4];
      split_a(pv, hi, lo);
      const int key = k0 + 8 * kk + 2 * t;
      const float* v0 = v + min(key, n - 1) * ld;
      const float* v1 = v + min(key + 1, n - 1) * ld;
#pragma unroll
      for (int q = 0; q < kAttnSteps; ++q) {
        if (n0 + 8 * q < hd) {
          const int c = min(n0 + 8 * q + g, hd - 1);
          mma_3xtf32(small[q], big[q], hi, lo, split_b(v0[c], v1[c]));
        }
      }
    }
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = r0 + g + 8 * h2;
      if (r >= n) continue;
      // the row's buffer, in this block or another of the cluster
      float* o = const_cast<float*>(out.row(r)) + oc;
#pragma unroll
      for (int q = 0; q < kAttnSteps; ++q)
#pragma unroll
        for (int e = 2 * h2; e < 2 * h2 + 2; ++e) {
          const int d = n0 + acc_col(q, e);
          if (d < hd) {
            const float val = big[q][e] + small[q][e];
            o[d] = ADD ? o[d] + val : val;
          }
        }
    }
  }
}

// The q, k and v columns of this block's heads (head rank + i cluster in
// slot i) for every row of the set, from the qkv rows of the block that
// holds it, to ``stage``: q, k, v one after the other, each [S, ld_stage]
// with slot i's head at column i hd; float4 copies where every row and
// column they touch is 16-byte aligned.  The caller syncs the block
// after.
__device__ __forceinline__ void stage_heads(const float* qkv, float* stage,
                                            const Dims& dm, int rank) {
  const int H = dm.hidden, nh = dm.heads, hd = H / nh, S = dm.set_size;
  const int cl = dm.cluster, slots = (nh + cl - 1) / cl;
  const SetRows<float, kMaxCluster> rows =
      set_rows_of<float, kMaxCluster>(qkv, dm.ld_qkv, dm.split, cl);
  const bool v4 = hd % 4 == 0 && dm.ld_qkv % 4 == 0 &&
                  dm.ld_stage % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(qkv) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(stage) % 16 == 0;
  const int w = v4 ? hd / 4 : hd;  // copies a head's row
  const int total = slots * 3 * S * w;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int c = i % w, j = i / w % S, part = i / (w * S) % 3;
    const int slot = i / (w * S * 3), hh = rank + slot * cl;
    if (hh >= nh) continue;
    const float* src = rows.row(j) + part * H + hh * hd;
    float* dst = stage + (part * S + j) * dm.ld_stage + slot * hd;
    if (v4)
      *reinterpret_cast<float4*>(dst + 4 * c) =
          *reinterpret_cast<const float4*>(src + 4 * c);
    else
      dst[c] = src[c];
  }
}

// The attention of a set above kMaxSet rows (km: its key mask, null:
// none) into the attention output ``out`` (ld_h apart) of the blocks that
// hold its rows: this block's heads for every row, staged (stage_heads),
// each warp a (head, m-tile) item, the logits of KT n-tiles; HALVES holds
// them KT / 2 at a time: the row's max and sum over the two halves of the
// keys under a running max (the sum of the first rescaled where the second
// raises the max), then each half's logits again, their probabilities
// from the final max and 1 / sum, P.V of the second half added to the
// first's.  Between the cluster's barriers that order the qkv rows before
// it and its reads and writes before the next writes.
template <int KT, bool HALVES>
__device__ __forceinline__ void attention_warp_tiles(
    const float* qkv, float* out, float* stage, const Dims& dm, int rank,
    const unsigned char* km) {
  const int H = dm.hidden, nh = dm.heads, hd = H / nh, S = dm.set_size;
  const int cl = dm.cluster, slots = (nh + cl - 1) / cl;
  const float inv_root = 1.0f / sqrtf((float)hd);
  const int ld = dm.ld_stage, kv_off = S * ld;  // k from q, v from k
  stage_heads(qkv, stage, dm, rank);
  __syncthreads();
  const SetRows<float, kMaxCluster> orows =
      set_rows_of<float, kMaxCluster>(out, dm.ld_h, dm.split, cl);
  const int mt = (S + 15) / 16;
  constexpr int kParts = HALVES ? 2 : 1;
  constexpr int KP = KT / kParts;  // n-tiles of logits held at once
  for (int item = threadIdx.x >> 5; item < slots * mt; item += kWarps) {
    const int slot = item / mt, r0 = item % mt * 16;
    const int hh = rank + slot * cl;
    if (hh >= nh) continue;
    const float* qh = stage + slot * hd;
    const float* kh = qh + kv_off;
    const float* vh = kh + kv_off;
    float l[KP][4];
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int part = 0; part < kParts; ++part) {
      const int k0 = 8 * KP * part;
      warp_dots<KP>(qh, kh, ld, r0, k0, S, hd, l);
      float m[2] = {mx[0], mx[1]}, s[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < KP; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + acc_col(j, e);
          l[j][e] = key < S ? logit_of(l[j][e], inv_root, km, key)
                            : -INFINITY;
          m[e >> 1] = fmaxf(m[e >> 1], l[j][e]);
        }
      m[0] = quad_max(m[0]);
      m[1] = quad_max(m[1]);
      // exp(l - m), kept as p's numerator where the logits stay whole
#pragma unroll
      for (int j = 0; j < KP; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x =
              k0 + acc_col(j, e) < S ? expf(l[j][e] - m[e >> 1]) : 0.0f;
          s[e >> 1] += x;
          if (!HALVES) l[j][e] = x;
        }
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        sum[h2] = part == 0 ? s[h2] : sum[h2] * expf(mx[h2] - m[h2]) + s[h2];
        mx[h2] = m[h2];
      }
    }
    const float inv_sum[2] = {1.0f / quad_sum(sum[0]),
                              1.0f / quad_sum(sum[1])};
#pragma unroll
    for (int part = 0; part < kParts; ++part) {
      const int k0 = 8 * KP * part;
      if (HALVES) warp_dots<KP>(qh, kh, ld, r0, k0, S, hd, l);
#pragma unroll
      for (int j = 0; j < KP; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + acc_col(j, e);
          if (!HALVES)
            l[j][e] *= inv_sum[e >> 1];
          else if (key < S)
            l[j][e] = expf(logit_of(l[j][e], inv_root, km, key) -
                           mx[e >> 1]) * inv_sum[e >> 1];
          else
            l[j][e] = 0.0f;
        }
      if (part == 0)
        warp_pv<KP, false>(l, vh, ld, k0, S, hd, orows, hh * hd, r0);
      else
        warp_pv<KP, true>(l, vh, ld, k0, S, hd, orows, hh * hd, r0);
    }
  }
}

// The attention of a set above kMaxSet rows at its size: 8 n-tiles of
// logits up to 2 kMaxSet rows, whole; 16 above, in two halves of 8 (whole,
// they spilled about 2 KB at 128 registers and ran 1.1-1.3x slower on an
// H100, PERF.md).
__device__ __forceinline__ void attend_big(const float* qkv, float* out,
                                           float* stage, const Dims& dm,
                                           int rank,
                                           const unsigned char* km) {
  if (dm.set_size <= 2 * kMaxSet)
    attention_warp_tiles<8, false>(qkv, out, stage, dm, rank, km);
  else
    attention_warp_tiles<16, true>(qkv, out, stage, dm, rank, km);
}

// Floats of one block's shared memory: h and a [tile, ld_h], big [tile,
// ld_big] (x, qkv or the MLP hidden layer), the slack that the last row's
// padded contraction reads and, for a set above kMaxSet rows, the stage
// of its block's heads' q, k and v [3, S, ld_stage].
__host__ __device__ inline size_t smem_floats(const Dims& dm) {
  return (size_t)dm.tile * (2 * dm.ld_h + dm.ld_big) + kSlack +
         (dm.set_size > kMaxSet ? (size_t)3 * dm.set_size * dm.ld_stage
                                : 0);
}

// The launch bounds give registers for the three blocks an SM that shared
// memory holds at the flagship (63 KB each).  BIG: the instance for sets
// above kMaxSet rows (a set over a cluster, attention on warp tiles);
// without it the instance for sets up to kMaxSet, whose code holds nothing
// of that; its launch bounds are kBigBlocks'.
template <bool BIG>
__global__ void __launch_bounds__(kThreads, BIG ? kBigBlocks : kBlocks)
fused_set_transformer_fwd_tf32x3(const float* __restrict__ x,
                                 const unsigned char* __restrict__ key_mask,
                                 SplitWeights wt, float* __restrict__ y,
                                 Dims dm) {
  extern __shared__ __align__(16) float smem[];
  const int H = dm.hidden, RH = dm.mlp, L = dm.layers, T = dm.tile;
  float* h = smem;                // [T, ld_h] residual stream
  float* a = h + T * dm.ld_h;     // [T, ld_h] LN / attention output
  float* big = a + T * dm.ld_h;   // x, qkv, the MLP hidden layer
  float* stage = big + T * dm.ld_big + kSlack;  // BIG
  // a set over a cluster: this block's part of set blockIdx.x / cluster
  const bool clustered = BIG && dm.cluster > 1;
  const int rank = clustered ? (int)cg::this_cluster().block_rank() : 0;
  long row0;
  int valid;
  if (clustered) {
    row0 = (blockIdx.x / dm.cluster) * (long)dm.set_size + rank * dm.split;
    valid = min(dm.split, dm.set_size - rank * dm.split);
  } else {
    row0 = blockIdx.x * (long)T;
    const long left = dm.rows - row0;
    valid = left < T ? (int)left : T;
  }
  const unsigned char* km = key_mask ? key_mask + row0 : nullptr;
  // a set above kMaxSet rows: its key mask from its first row
  const unsigned char* km_set = km ? km - rank * dm.split : nullptr;

  const int total = (int)smem_floats(dm);
  for (int i = threadIdx.x; i < total; i += blockDim.x) smem[i] = 0.0f;
  __syncthreads();
  for (int i = threadIdx.x; i < valid * dm.in_dim; i += blockDim.x) {
    const int r = i / dm.in_dim, c = i % dm.in_dim;
    big[r * dm.ld_x + c] = x[row0 * dm.in_dim + i];
  }
  __syncthreads();
  mma_dense<kStore>(big, dm.ld_x, dm.k_in, wt.wt[0], dm.n_h, H, wt.b[0], h,
                    dm.ld_h, nullptr, valid, dm);
  __syncthreads();
  for (int l = 0; l < L; ++l) {
    layer_norm_tile(h, a, dm);
    __syncthreads();
    mma_dense<kStore>(a, dm.ld_h, dm.k_h,
                      wt.wt[1] + (long)l * dm.n_qkv * 2 * dm.k_h, dm.n_qkv,
                      3 * H, wt.b[1] + l * 3 * H, big, dm.ld_qkv, nullptr,
                      valid, dm);
    set_sync(clustered);
    if constexpr (!BIG)
      attention(big, a, dm, km, valid);
    else
      attend_big(big, a, stage, dm, rank, km_set);
    set_sync(clustered);
    mma_dense<kResidual>(a, dm.ld_h, dm.k_h,
                         wt.wt[2] + (long)l * dm.n_h * 2 * dm.k_h, dm.n_h, H,
                         wt.b[2] + l * H, h, dm.ld_h, nullptr, valid, dm);
    __syncthreads();
    layer_norm_tile(h, a, dm);
    __syncthreads();
    mma_dense<kGelu>(a, dm.ld_h, dm.k_h,
                     wt.wt[3] + (long)l * dm.n_f * 2 * dm.k_h, dm.n_f, RH,
                     wt.b[3] + l * RH, big, dm.ld_f, nullptr, valid, dm);
    __syncthreads();
    mma_dense<kResidual>(big, dm.ld_f, dm.k_f,
                         wt.wt[4] + (long)l * dm.n_h * 2 * dm.k_f, dm.n_h, H,
                         wt.b[4] + l * H, h, dm.ld_h, nullptr, valid, dm);
    __syncthreads();
  }
  // output layer: y = LN(h_L) @ Wo + bo, straight to global memory
  layer_norm_tile(h, a, dm);
  __syncthreads();
  mma_dense<kGlobal>(a, dm.ld_h, dm.k_h, wt.wt[5], dm.n_out, dm.out_dim,
                     wt.b[5], nullptr, 0, y + row0 * dm.out_dim, valid, dm);
}

// The leading dimensions of a tile of dm.tile rows (and of the stage of a
// set above kMaxSet: the q, k or v columns of a block's heads, ceil(heads
// / cluster) of them), conflict-free where ``spread``, else the rows' true
// widths; whether its shared memory fits.
bool layout_fits(Dims& dm, bool spread, int max_smem) {
  auto ld = [spread](int n) { return spread ? conflict_free(n) : n; };
  dm.ld_stage = ld((dm.heads + dm.cluster - 1) / dm.cluster *
                   (dm.hidden / dm.heads));
  dm.ld_x = ld(dm.in_dim);
  dm.ld_h = ld(dm.hidden);
  dm.ld_qkv = ld(3 * dm.hidden);
  dm.ld_f = ld(dm.mlp);
  dm.ld_big = dm.ld_qkv > dm.ld_f ? dm.ld_qkv : dm.ld_f;
  if (dm.ld_x > dm.ld_big) dm.ld_big = dm.ld_x;
  return sizeof(float) * smem_floats(dm) <= (size_t)max_smem;
}

// The tile and leading dimensions of a call, the first of these whose
// shared memory fits: whole sets up to 32 rows with conflict-free rows;
// whole sets up to 16 rows (one set where a set is larger) with
// conflict-free rows; the same with rows at their true width.  Returns
// false where none fits.  ops/cuda/fused_transformer.py fwd_shape mirrors
// it.
//
// A set above kMaxSet rows spans the fewest of 1, 2 and kMaxCluster blocks
// of a cluster that keeps its rows a block (ceil(S / cluster), the tile)
// within kBigRows, with conflict-free rows, else at their true width.
bool pick_layout(Dims& dm, int max_smem) {
  dm.cluster = 1;
  dm.split = dm.set_size;
  if (dm.set_size > kMaxSet) {
    for (int cl = 1; cl <= kMaxCluster; cl *= 2) {
      dm.cluster = cl;
      dm.split = (dm.set_size + cl - 1) / cl;
      dm.tile = dm.split;
      if (dm.split <= kBigRows &&
          (layout_fits(dm, true, max_smem) ||
           layout_fits(dm, false, max_smem)))
        return true;
    }
    return false;
  }
  const int targets[3] = {kTileTarget, kMinTile, kMinTile};
  for (int i = 0; i < 3; ++i) {
    const int tt = targets[i];
    dm.tile = (tt >= dm.set_size ? tt / dm.set_size : 1) * dm.set_size;
    if (layout_fits(dm, i < 2, max_smem)) return true;
  }
  return false;
}

}  // namespace

extern "C" {

// Forward in fp32: x [rows, in] to y [rows, out].  key_mask: null or one
// byte a row of x (0 = a masked key of its set).  w: the 6 split layouts
// (see SplitWeights; embed, qkv, proj, fc1, fc2, out); b: their 6 fp32
// biases, in the same order.  Returns cudaGetLastError().
int fused_set_transformer_fwd_f32(const void* x, const void* key_mask,
                                  const void* const* w,
                                  const float* const* b, void* y, long rows,
                                  int set_size, int in_dim, int hidden,
                                  int heads, int layers, int mlp, int out_dim,
                                  void* stream) {
  if (set_size < 1 || set_size > kMaxBigSet || heads < 1 ||
      hidden % heads || rows % set_size)
    return (int)cudaErrorInvalidValue;
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
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (!pick_layout(dm, max_smem)) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  SplitWeights wt;
  for (int j = 0; j < 6; ++j) {
    wt.wt[j] = (const float*)w[j];
    wt.b[j] = b[j];
  }
  const size_t smem = sizeof(float) * smem_floats(dm);
  const auto kernel = set_size > kMaxSet
                          ? fused_set_transformer_fwd_tf32x3<true>
                          : fused_set_transformer_fwd_tf32x3<false>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid =
      dm.cluster > 1 ? (unsigned)(dm.cluster * (rows / set_size))
                     : (unsigned)((rows + dm.tile - 1) / dm.tile);
  return (int)launch_clustered(kernel, grid, kThreads, smem,
                               (cudaStream_t)stream, dm.cluster,
                               (const float*)x,
                               (const unsigned char*)key_mask, wt, (float*)y,
                               dm);
}

}  // extern "C"
