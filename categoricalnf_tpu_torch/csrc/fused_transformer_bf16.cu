// Fused SetTransformer forward (kernel #3) and backward (kernel #4) in
// bf16, on Hopper's tensor cores (sm_90a).  Both kernels are built from the
// same device functions, so the forward and the backward's recompute are
// one arithmetic: the same tiles, sum order and epilogues.  The fp32
// kernels are the templates of fused_transformer.cu.
//
// Forward (fused_set_transformer_fwd, at the end of the file) replaces the
// TPU kernel categoricalnf_tpu/ops/pallas/fused_transformer.py _fused_fwd
// (body _fwd_kernel -> _net_forward): embed -> L x [LN -> QKV -> per-set,
// per-head attention -> proj + residual; LN -> fc1 -> gelu(tanh) -> fc2 +
// residual] -> LN -> out, for a tile of whole sets.  At the flagship width
// it does about 164k multiply-adds a row (5.4 GFLOP at 16,384 rows, 5.4 us
// at 989 TFLOP/s) against 224 B of x and y a row and 0.3 MB of weights: it
// is bound by operations.  Its design is the backward's phase 1 without
// what only the backward needs (the residual copies, the weight-gradient
// scratch): three bf16 buffers in shared memory (the residual h; the LN
// output, then the attention output; qkv or the MLP hidden layer), 63 KB
// for a 64-row tile at the flagship width, so two blocks of 8 warps share
// an SM with the registers to spare (kFwdBlocks); one block a tile, no
// persistent loop; every dense product on mma.sync as below, the output
// layer's straight to global memory.
//
// Backward (fused_set_transformer_bwd) replaces _fused_bwd (body
// _bwd_kernel, math _net_forward), which recomputes a
// tile's forward and pulls the cotangent back with jax.vjp.  The function
// and its rounding points are those of the fp32/bf16 template backward in
// fused_transformer.cu, which this file replaces for bf16: every cotangent
// is rounded to bf16 where the forward rounds its primal, as autograd
// through plain_forward does; LN statistics, softmax, gelu and every
// epilogue run in fp32.
//
// Bound on an H100.  At the flagship width (H=96, 4 heads, 2 blocks, S=16,
// in 4, out 104) the backward does about 3x the forward's 164k
// multiply-adds a row (recompute, input and weight gradients): 16 GFLOP at
// 16,384 rows, 16 us at 989 TFLOP/s, against 0.4 MB of x, g and dx and
// 1 MB of weights and fp32 gradients.  It is bound by operations.
//
// Design.  The structure is the template kernel's: a persistent grid, each
// block walking the tiles blockIdx.x, blockIdx.x + gridDim.x, ...; per tile
// the forward is rerun keeping only the residual stream h at each block
// boundary, then the blocks are walked in reverse, each recomputed from its
// h; dx goes to global memory and the weight gradients to the block's own
// fp32 scratch slice, which reduce_wgrad sums in slice order (bitwise
// deterministic, no float atomics).  What the template kernel lost time on,
// and what this one does about it:
// 1. No tensor cores.  Every dense product (the forward recompute, the
//    input gradients, the weight gradients) runs on
//    mma.sync.m16n8k16.bf16 with fp32 accumulators; A comes from shared
//    memory by ldmatrix (ldmatrix.trans for the weight gradients' X^T and
//    G), B of the forward and input-gradient products straight from L2 in
//    the layouts PackedWeights builds once a repack (W^T and W, zero-padded
//    to multiples of 16), loaded four k-steps at a time one chunk ahead.
//    Only attention, LayerNorm and the bias gradients stay on the CUDA
//    cores (about 4% of the multiply-adds).
// 2. Shared-memory bound loops.  ldmatrix moves a 16 x 16 operand in one
//    instruction per warp, against one load per FMA (two in the weight
//    gradients' row walk).  The CUDA-core phases hold their own row in
//    registers and read the rows they share as broadcasts.  They are out of
//    line (__noinline__) and the attention unrolls its set loops only as far
//    as the set needs (16 or 32): inlined at every call site and unrolled
//    to 32, their code made the kernel about 1.5x slower on an H100.
// 3. Footprint and latency.  Every value the bf16 kernel kept in shared
//    memory was already rounded to bf16, so it is stored as bf16 (only the
//    softmax statistics stay fp32): 194 KB for a 64-row tile at the
//    flagship width, one block of 8 warps an SM (32-row tiles where a
//    wider or deeper net would not fit, and where even those do not, the
//    residual copies at the block boundaries in a global workspace, the
//    GLOBAL_H layout: 219,136 B at hidden 256, sets of 24, 2 transformer
//    blocks, against 252,928 with them; that instance also keeps phase 1's
//    qkv, o, hm and f | m there for phase 3, runs its attention two lanes
//    an item, and leaves its weight gradients to wgrad_tiles, below).  Leading dimensions are a
//    multiple of 16 plus 8 elements, so ldmatrix's eight 16-byte rows fall
//    in distinct banks.
// 4. Scratch traffic.  A 64-row tile (4 sets of 16) halves the number of
//    read-modify-writes of the 159,368 fp32 gradients a row, and the slice's
//    old values are loaded before the products that add to them.
// Padded lanes of the A operands are zero (shared memory is cleared once a
// block, every producer writes zeros past the true width, and the weight
// layouts' pads are zero), so the padding adds nothing.  Rows past the
// last valid set carry zero cotangents, so they add nothing to dW.
//
// Key mask.  Both entry points take an optional key mask, one byte a row
// of x (0 = the key is masked), as the reference's masked attention: the
// scaled logit of a masked key becomes -1e9 before the row's max, so its
// probability is exactly 0 where any key of the set is valid, and a set
// whose keys are all masked attends uniformly over them.  The backward's
// recompute rebuilds the same probabilities and gives a masked logit no
// gradient (the reference's where() passes none to it).  A null mask
// leaves every instruction of the arithmetic as it was.
//
// Sets of 33 to 128 rows (the reference's Pallas tiles take sets of 64 and
// 128, its XLA path the others).  Each kernel has a BIG instance; the
// instances for sets up to 32 hold none of its code, so they are the code
// and the bits of the kernels before it.  A BIG tile is one set: whole
// where it is at most 64 rows (the dense products' four m-tiles) and
// fits, else half of it (rounded up) on each block of a cluster of two
// (cudaLaunchKernelEx with the cluster dimension), each block with the
// 64-row layout.  Every row-wise phase stays in its block; attention reads
// the other block's rows through distributed shared memory (SetRows,
// fused_transformer.cuh) behind cluster barriers: once qkv is made, after
// the attention (before a layer overwrites qkv or the MLP's region), and
// in the backward between its two passes (phase 2 reads the other block's
// queries, output cotangents and softmax statistics) and after them.
// Both kernels' attention runs on the tensor cores, a warp a head's 16
// rows against the whole set (attention_mma_big: the forward's, and the
// backward's recompute, which keeps the rows' statistics;
// attention_bwd_q_big query-major, then dK and dV key-major over both
// blocks' queries, attention_bwd_kv_big: no block adds into another's
// rows), so up to 64 rows the forward's output is what the recompute
// rebuilds; above, the forward sums a row's softmax over two halves of
// the keys (attention_mma_halves), in another order.  The
// weight-gradient partials stay one a block.  Bound as above: at the
// set-64 run's 65,536 rows the forward does 23.9 GFLOP (24 us at 989
// TFLOP/s); it is latency-bound (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fused_transformer.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSet = 32;   // largest set the unrolled attention takes
constexpr int kMaxBigSet = 128;  // largest set handled (BIG instances)
constexpr int kTileTarget = 64;            // rows a tile aims for
constexpr int kMaxMTiles = kTileTarget / 16;  // 16-row m-tiles in a tile
constexpr int kKChunk = 4;   // k-steps whose B fragments load together
constexpr int kChunk = 8;    // row values held in registers at a time
constexpr int kLnVals = 8;   // LN values a lane holds: hidden <= 256
// Forward blocks an SM that the launch bounds give registers for.  Shared
// memory holds three at the flagship tile, but at 16,384 rows the 256 tiles
// fill only two an SM, and the registers of three (80 a thread) spill: the
// kernel took 0.155 ms at three against 0.132 ms at two on an H100.
// The BIG instance (sets of 33-128) keeps two: its attention spills at 128
// registers, more so where a warp's 16 rows of logits span 16 n-tiles
// (sets above 64, so those hold them in two halves), yet two blocks an SM
// ran it 1.2-1.6x faster than one block with 255 registers and no spills
// (PERF.md).
constexpr int kFwdBlocks = 2;

struct Dims {
  long rows;
  int set_size, in_dim, hidden, heads, layers, mlp, out_dim;
  int tile, tile_pad;                 // rows of a tile; padded to 16
  int cluster, split;  // blocks a set spans (1, 2); rows of it in rank 0
  int p_in, p_h, p_big, p_f, p_out;   // widths padded to 16
  int ld_h, ld_big, ld_f, ld_g, ld_x, ld_r2;  // shared-memory rows (bf16)
};

// The 6 matrices (embed, qkv, proj, fc1, fc2, out), each W [kd, n] (layer
// stacked) as wt = W^T [pad(n), pad(kd)] for the forward products and
// w = W [pad(kd), pad(n)] for the input gradients, and the 6 fp32 biases.
struct PadWeights {
  const bf16* wt[6];
  const bf16* w[6];
  const float* b[6];
};

__host__ __device__ inline int pad16(int n) { return (n + 15) / 16 * 16; }

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float rnd(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The key mask of one tile: m[r] for the tile's rows r < valid (0 = the
// key is masked), or no mask.  Rows past valid are whole sets whose
// outputs are dropped, so their keys are read as valid.
struct KeyMask {
  const unsigned char* m;
  int valid;
};

__device__ __forceinline__ bool key_masked(const KeyMask& km, int r) {
  return km.m != nullptr && r < km.valid && km.m[r] == 0;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8x8 bf16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a (16x16, row) . b (16x8, col), bf16 in, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ldg_pair(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

enum Epi {
  kStore,      // out = R(acc + b)
  kResidual,   // out = R(out + R(acc + b))
  kGelu,       // out = R(gelu(R(acc + b)))
  kFc1,        // out = f = R(acc + b), out2 = R(gelu(f))
  kBwdStore,   // out = R(acc)
  kBwdGelu,    // out = R(R(acc) * gelu'(out))   (out holds f)
  kBwdGlobal,  // gout[r, c] = R(acc) for rows < valid, c < n
  kGlobal,     // gout[r, c] = R(acc + b) for rows < valid, c < n
};

// out[r, c] <- epilogue(A[r, :] . B[:, c]) for the tile's rows and c <
// np, on the tensor cores.  A: bf16 [tile_pad, lda] in shared memory, kp
// columns (a multiple of 16, zero past the true width).  bt: B^T [np, kp]
// in global memory (W^T for a forward product, W for an input gradient),
// zero past the true sizes.  One warp per 8-column n-tile, over all the
// tile's m-tiles; the B fragments of kKChunk k-steps are loaded one chunk
// ahead.  Columns n <= c < np are written as zeros (kBwdGlobal and kGlobal
// skip them), so a buffer's pad stays zero for its next use as A.  Inlined,
// so that each kernel has its own copy, compiled to its register budget.
template <int EPI>
__device__ __forceinline__ void mma_dense(const bf16* A, int lda, int kp,
                          const bf16* __restrict__ bt, int np, int n,
                          const float* __restrict__ bias, bf16* out,
                          int ld_out, bf16* out2, bf16* __restrict__ gout,
                          int valid, const Dims& dm) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mtiles = dm.tile_pad >> 4, nk = kp >> 4;
  for (int j = warp; j < (np >> 3); j += kWarps) {
    float acc[kMaxMTiles][4];
#pragma unroll
    for (int mt = 0; mt < kMaxMTiles; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][e] = 0.0f;
    // lane (g, t) reads B^T[j * 8 + g][k0 + 2t, +1] and [k0 + 8 + 2t, +1]
    const bf16* bp = bt + (long)(j * 8 + g) * kp + 2 * t;
    uint32_t bq[kKChunk][2], bn[kKChunk][2];
#pragma unroll
    for (int s = 0; s < kKChunk; ++s)
      if (s < nk) {
        bq[s][0] = ldg_pair(bp + s * 16);
        bq[s][1] = ldg_pair(bp + s * 16 + 8);
      }
    for (int kc = 0; kc < nk; kc += kKChunk) {
#pragma unroll
      for (int s = 0; s < kKChunk; ++s)
        if (kc + kKChunk + s < nk) {
          bn[s][0] = ldg_pair(bp + (kc + kKChunk + s) * 16);
          bn[s][1] = ldg_pair(bp + (kc + kKChunk + s) * 16 + 8);
        }
#pragma unroll
      for (int s = 0; s < kKChunk; ++s) {
        if (kc + s < nk) {
          const int k0 = (kc + s) * 16 + (lane >> 4) * 8;
#pragma unroll
          for (int mt = 0; mt < kMaxMTiles; ++mt) {
            if (mt < mtiles) {
              uint32_t a[4];
              ldsm_x4(a, A + (mt * 16 + (lane & 15)) * lda + k0);
              mma_bf16(acc[mt], a, bq[s][0], bq[s][1]);
            }
          }
        }
      }
#pragma unroll
      for (int s = 0; s < kKChunk; ++s) {
        bq[s][0] = bn[s][0];
        bq[s][1] = bn[s][1];
      }
    }

    const int c = j * 8 + 2 * t;  // this lane's columns c, c + 1
#pragma unroll
    for (int mt = 0; mt < kMaxMTiles; ++mt) {
      if (mt >= mtiles) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = mt * 16 + g + 8 * half;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool in = c + e < n;
          float a = acc[mt][2 * half + e];
          if constexpr (EPI == kStore || EPI == kResidual || EPI == kGelu ||
                        EPI == kFc1 || EPI == kGlobal)
            a = in ? rnd(a + bias[c + e]) : 0.0f;
          else
            a = in ? rnd(a) : 0.0f;
          v[e] = a;
        }
        if constexpr (EPI == kBwdGlobal || EPI == kGlobal) {
          if (r < valid) {
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (c + e < n)
                gout[(long)r * n + c + e] = __float2bfloat16_rn(v[e]);
          }
        } else {
          __nv_bfloat162* o =
              reinterpret_cast<__nv_bfloat162*>(out + r * ld_out + c);
          if constexpr (EPI == kStore || EPI == kBwdStore) {
            *o = __floats2bfloat162_rn(v[0], v[1]);
          } else if constexpr (EPI == kResidual) {
            const float2 h = __bfloat1622float2(*o);
            *o = __floats2bfloat162_rn(h.x + v[0], h.y + v[1]);
          } else if constexpr (EPI == kGelu) {
            *o = __floats2bfloat162_rn(gelu_tanh(v[0]), gelu_tanh(v[1]));
          } else if constexpr (EPI == kFc1) {
            *o = __floats2bfloat162_rn(v[0], v[1]);
            *reinterpret_cast<__nv_bfloat162*>(out2 + r * ld_out + c) =
                __floats2bfloat162_rn(gelu_tanh(v[0]), gelu_tanh(v[1]));
          } else {  // kBwdGelu
            const float2 f = __bfloat1622float2(*o);
            *o = __floats2bfloat162_rn(v[0] * gelu_tanh_grad(f.x),
                                       v[1] * gelu_tanh_grad(f.y));
          }
        }
      }
    }
  }
}

// The weight and bias gradients of a dense layer over the tile's rows,
// added into this block's fp32 scratch slice (the block's first tile
// stores): pw[k, c] (+)= sum_r X[r, k] G[r, c] on the tensor cores, one
// warp per 16 x 32 block of pw (A = X^T and B = G by ldmatrix.trans), and
// pb[c] (+)= sum_r G[r, c] on the CUDA cores.  Each element is always
// written by the same thread, so no atomics are needed.
__device__ __noinline__ void mma_wgrad(const bf16* X, int ldx, int kd,
                                       const bf16* G, int ldg, int n,
                                       float* __restrict__ pw,
                                       float* __restrict__ pb, bool first,
                                       const Dims& dm) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, m8 = lane >> 3, l8 = lane & 7;
  const int mtiles = (kd + 15) >> 4, ngroups = (n + 31) >> 5;
  const int nk = dm.tile_pad >> 4;
  for (int task = warp; task < mtiles * ngroups; task += kWarps) {
    const int k0 = (task / ngroups) * 16, c0 = (task % ngroups) * 32;
    const bool two = c0 + 16 < n;  // n-tiles 2 and 3 hold columns < n
    // element i of n-tile q: row k0 + g + 8 (i >> 1), column c0 + 8q + 2t
    // + (i & 1), as the accumulator fragment lays it out; the slice's old
    // values are loaded before the products
    float old[4][4], acc[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + g + 8 * (i >> 1), c = c0 + 8 * q + 2 * t + (i & 1);
        old[q][i] = !first && k < kd && c < n ? pw[(long)k * n + c] : 0.0f;
        acc[q][i] = 0.0f;
      }
    for (int s = 0; s < nk; ++s) {
      uint32_t a[4], b[4];
      // A[m][kk] = X[16s + kk][k0 + m]: matrix m8 holds rows 16s + 8 (m8
      // >> 1) + l8, columns k0 + 8 (m8 & 1)
      ldsm_x4_trans(a, X + (s * 16 + (m8 >> 1) * 8 + l8) * ldx + k0 +
                           (m8 & 1) * 8);
      // B[kk][c] = G[16s + kk][c0 + c]: matrix m8 holds rows 16s + 8 (m8
      // & 1) + l8, columns c0 + 8 (m8 >> 1) (+ 16 for n-tiles 2, 3)
      const bf16* gb = G + (s * 16 + (m8 & 1) * 8 + l8) * ldg + c0 +
                       (m8 >> 1) * 8;
      ldsm_x4_trans(b, gb);
      mma_bf16(acc[0], a, b[0], b[1]);
      mma_bf16(acc[1], a, b[2], b[3]);
      if (two) {
        ldsm_x4_trans(b, gb + 16);
        mma_bf16(acc[2], a, b[0], b[1]);
        mma_bf16(acc[3], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + g + 8 * (i >> 1), c = c0 + 8 * q + 2 * t + (i & 1);
        if (k < kd && c < n) pw[(long)k * n + c] = old[q][i] + acc[q][i];
      }
  }
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    float s = 0.0f;
#pragma unroll 8
    for (int r = 0; r < dm.tile_pad; ++r) s += bf(G[r * ldg + c]);
    pb[c] = first ? s : pb[c] + s;
  }
}

// LayerNorm without affine and its backward: one warp per row, two rows at
// a time, each lane holding the row's columns lane + 32 i (i < kLnVals) in
// registers; fp32 mean and biased variance.
struct LnRow {
  float x[kLnVals];
  float mean, inv;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void ln_stats(const bf16* row, int h, LnRow& ln) {
  const int lane = threadIdx.x & 31;
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < kLnVals; ++i) {
    const int c = lane + 32 * i;
    ln.x[i] = c < h ? bf(row[c]) : 0.0f;
    s += ln.x[i];
  }
  ln.mean = warp_sum(s) / h;
  float v = 0.0f;
#pragma unroll
  for (int i = 0; i < kLnVals; ++i) {
    const float d = ln.x[i] - ln.mean;
    if (lane + 32 * i < h) v = fmaf(d, d, v);
  }
  ln.inv = rsqrtf(warp_sum(v) / h + 1e-5f);
}

// out = R(LN(in)) for the tile's rows.  BLOCKS, here and in the attention,
// is the calling kernel's blocks an SM (the backward's 1 by default): each
// kernel calls its own out-of-line copy, compiled to its register budget.
template <int BLOCKS = 1>
__device__ __noinline__ void layer_norm_tile(const bf16* in, bf16* out,
                                             const Dims& dm) {
  const int lane = threadIdx.x & 31, h = dm.hidden;
  for (int r0 = (threadIdx.x >> 5) * 2; r0 < dm.tile_pad; r0 += 2 * kWarps) {
    LnRow ln[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) ln_stats(in + (r0 + q) * dm.ld_h, h, ln[q]);
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int i = 0; i < kLnVals; ++i) {
        const int c = lane + 32 * i;
        if (c < h)
          out[(r0 + q) * dm.ld_h + c] =
              __float2bfloat16_rn((ln[q].x[i] - ln[q].mean) * ln[q].inv);
      }
  }
}

// Backward of LN without affine, from the forward's input x and the
// output's (rounded) cotangent g: dx = inv * (g - mean(g) - xhat *
// mean(g * xhat)), rounded; with RES it is added to gout (the residual
// branch's gradient) and rounded again.
template <bool RES>
__device__ __noinline__ void layer_norm_bwd_tile(const bf16* x, const bf16* g,
                                                 bf16* gout, const Dims& dm) {
  const int lane = threadIdx.x & 31, h = dm.hidden;
  for (int r0 = (threadIdx.x >> 5) * 2; r0 < dm.tile_pad; r0 += 2 * kWarps) {
    LnRow ln[2];
    float gr[2][kLnVals], mg[2], mgx[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) ln_stats(x + (r0 + q) * dm.ld_h, h, ln[q]);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float sg = 0.0f, sgx = 0.0f;
#pragma unroll
      for (int i = 0; i < kLnVals; ++i) {
        const int c = lane + 32 * i;
        gr[q][i] = c < h ? bf(g[(r0 + q) * dm.ld_h + c]) : 0.0f;
        if (c < h) {
          sg += gr[q][i];
          sgx = fmaf(gr[q][i], (ln[q].x[i] - ln[q].mean) * ln[q].inv, sgx);
        }
      }
      mg[q] = warp_sum(sg) / h;
      mgx[q] = warp_sum(sgx) / h;
    }
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int i = 0; i < kLnVals; ++i) {
        const int c = lane + 32 * i;
        if (c < h) {
          const float xhat = (ln[q].x[i] - ln[q].mean) * ln[q].inv;
          const float d = rnd(ln[q].inv * (gr[q][i] - mg[q] - xhat * mgx[q]));
          bf16* o = gout + (r0 + q) * dm.ld_h + c;
          *o = __float2bfloat16_rn(RES ? bf(*o) + d : d);
        }
      }
  }
}

// The attention runs on the CUDA cores, one thread per (head, row), with
// the loops over a set's rows unrolled to MAXS (16 or 32: attention<>
// picks the smaller that holds the set) so their values stay in registers,
// and each thread's own row held in registers kChunk values at a time, so
// that the other rows, which every thread of the set reads, are broadcasts.

// dot[j] += sum_{d < hd} mine[d] * rows[j * ld + d] for j < S, in order of
// d (mine: this thread's row; rows: the set's rows, read by all its
// threads).
template <int MAXS>
__device__ __forceinline__ void set_dots(const bf16* mine, const bf16* rows,
                                         int ld, int hd, int S,
                                         float (&dot)[MAXS]) {
  for (int d0 = 0; d0 < hd; d0 += kChunk) {
    float v[kChunk];
#pragma unroll
    for (int e = 0; e < kChunk; ++e)
      v[e] = d0 + e < hd ? bf(mine[d0 + e]) : 0.0f;
#pragma unroll
    for (int j = 0; j < MAXS; ++j) {
      if (j < S) {
        const bf16* rj = rows + j * ld + d0;
#pragma unroll
        for (int e = 0; e < kChunk; ++e)
          if (d0 + e < hd) dot[j] = fmaf(v[e], bf(rj[e]), dot[j]);
      }
    }
  }
}

// The softmax row of query r in head hh: p[j] (fp32, unrounded) for j < S,
// with its max and sum; a masked key's scaled logit is kMaskedLogit.
template <int MAXS>
__device__ __forceinline__ void attn_row(const bf16* qkv, int r, int hh,
                                         const Dims& dm, const KeyMask& km,
                                         float (&p)[MAXS], float& mx,
                                         float& sum) {
  const int H = dm.hidden, hd = H / dm.heads, S = dm.set_size;
  const int set0 = (r / S) * S;
  const float inv_root = 1.0f / sqrtf((float)hd);
#pragma unroll
  for (int j = 0; j < MAXS; ++j) p[j] = 0.0f;
  set_dots<MAXS>(qkv + r * dm.ld_big + hh * hd,
                 qkv + (r / S) * S * dm.ld_big + H + hh * hd, dm.ld_big, hd,
                 S, p);
  mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < MAXS; ++j) {
    if (j < S) {
      p[j] = key_masked(km, set0 + j) ? kMaskedLogit : p[j] * inv_root;
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
  for (int j = 0; j < MAXS; ++j)
    if (j < S) p[j] = p[j] * inv_sum;
}

// out[d] = R(sum_{j < S} w[j] * rows[j * ld + d]) for d < hd.
template <int MAXS>
__device__ __forceinline__ void set_combine(const float (&w)[MAXS],
                                            const bf16* rows, int ld, int hd,
                                            int S, bf16* out) {
  for (int d = 0; d < hd; ++d) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < MAXS; ++j)
      if (j < S) acc = fmaf(w[j], bf(rows[j * ld + d]), acc);
    out[d] = __float2bfloat16_rn(acc);
  }
}

// Attention within each set: the probabilities rounded before A.V, the
// output rounded.
template <int MAXS, int BLOCKS>
__device__ __noinline__ void attention_tile(const bf16* qkv, bf16* out,
                                            const Dims& dm, KeyMask km) {
  const int H = dm.hidden, nh = dm.heads, hd = H / nh, S = dm.set_size;
  for (int item = threadIdx.x; item < dm.tile * nh; item += blockDim.x) {
    const int hh = item / dm.tile;
    const int r = item % dm.tile;
    float p[MAXS], mx, sum;
    attn_row<MAXS>(qkv, r, hh, dm, km, p, mx, sum);
#pragma unroll
    for (int j = 0; j < MAXS; ++j)
      if (j < S) p[j] = rnd(p[j]);
    set_combine<MAXS>(p, qkv + (r / S) * S * dm.ld_big + 2 * H + hh * hd,
                      dm.ld_big, hd, S, out + r * dm.ld_h + hh * hd);
  }
}

// Attention backward, phase 1: one thread per (head, query row).  Writes
// the query gradient R(sum_j gl_ij / sqrt(hd) * k_j), with gl_ij = p_ij
// (gP_ij - D_i), gP_ij = R(go_i . v_j) the cotangent of the rounded
// probabilities and D_i = sum_j p_ij gP_ij, and keeps the row's max, sum
// and D_i for phase 2.  Rows past the last whole set, and the columns
// past 3H, get zeros.
template <int MAXS>
__device__ __noinline__ void attention_bwd_q(const bf16* qkv, const bf16* go,
                                             bf16* gqkv, float* stats,
                                             const Dims& dm, KeyMask km) {
  const int H = dm.hidden, nh = dm.heads, hd = H / nh, S = dm.set_size;
  const float inv_root = 1.0f / sqrtf((float)hd);
  const bf16 zero = __float2bfloat16_rn(0.0f);
  const int wpad = dm.p_big - 3 * H;
  if (wpad > 0)
    for (int i = threadIdx.x; i < dm.tile_pad * wpad; i += blockDim.x)
      gqkv[(i / wpad) * dm.ld_big + 3 * H + i % wpad] = zero;
  for (int item = threadIdx.x; item < dm.tile_pad * nh;
       item += blockDim.x) {
    const int hh = item / dm.tile_pad;
    const int r = item % dm.tile_pad;
    bf16* gq = gqkv + r * dm.ld_big + hh * hd;
    if (r >= dm.tile) {
      for (int d = 0; d < hd; ++d) gq[d] = gq[H + d] = gq[2 * H + d] = zero;
      continue;
    }
    const bf16* set = qkv + (r / S) * S * dm.ld_big;
    float p[MAXS], mx, sum, gp[MAXS];
    attn_row<MAXS>(qkv, r, hh, dm, km, p, mx, sum);
#pragma unroll
    for (int j = 0; j < MAXS; ++j) gp[j] = 0.0f;
    set_dots<MAXS>(go + r * dm.ld_h + hh * hd, set + 2 * H + hh * hd,
                   dm.ld_big, hd, S, gp);
    float D = 0.0f;
#pragma unroll
    for (int j = 0; j < MAXS; ++j) {
      if (j < S) {
        gp[j] = rnd(gp[j]);
        D = fmaf(p[j], gp[j], D);
      }
    }
    // the softmax's backward, then the 1/sqrt(hd) scale of the logits; a
    // masked logit takes none
    const int set0 = (r / S) * S;
#pragma unroll
    for (int j = 0; j < MAXS; ++j)
      if (j < S)
        gp[j] = key_masked(km, set0 + j) ? 0.0f
                                         : p[j] * (gp[j] - D) * inv_root;
    set_combine<MAXS>(gp, set + H + hh * hd, dm.ld_big, hd, S, gq);
    float* st = stats + (hh * dm.tile_pad + r) * 3;
    st[0] = mx;
    st[1] = sum;
    st[2] = D;
  }
}

// Phase 2: one thread per (head, key row j): gk_j = R(sum_i gl_ij /
// sqrt(hd) * q_i) and gv_j = R(sum_i R(p_ij) go_i), over the queries of
// j's set, with p_ij recomputed from the row statistics of phase 1.
template <int MAXS>
__device__ __noinline__ void attention_bwd_kv(const bf16* qkv, const bf16* go,
                                              bf16* gqkv, const float* stats,
                                              const Dims& dm, KeyMask km) {
  const int H = dm.hidden, nh = dm.heads, hd = H / nh, S = dm.set_size;
  const float inv_root = 1.0f / sqrtf((float)hd);
  for (int item = threadIdx.x; item < dm.tile * nh; item += blockDim.x) {
    const int hh = item / dm.tile;
    const int j = item % dm.tile;
    const int set0 = (j / S) * S;
    const bool masked = key_masked(km, j);
    float gl[MAXS], pq[MAXS];
#pragma unroll
    for (int ii = 0; ii < MAXS; ++ii) gl[ii] = pq[ii] = 0.0f;
    // q_i . k_j and go_i . v_j for the set's queries i
    set_dots<MAXS>(qkv + j * dm.ld_big + H + hh * hd,
                   qkv + set0 * dm.ld_big + hh * hd, dm.ld_big, hd, S, gl);
    set_dots<MAXS>(qkv + j * dm.ld_big + 2 * H + hh * hd,
                   go + set0 * dm.ld_h + hh * hd, dm.ld_h, hd, S, pq);
#pragma unroll
    for (int ii = 0; ii < MAXS; ++ii) {
      if (ii < S) {
        const float* st = stats + (hh * dm.tile_pad + set0 + ii) * 3;
        // the unmasked expression as it was, so that its contraction and
        // so its bits stay
        const float p =
            masked ? expf(kMaskedLogit - st[0]) * (1.0f / st[1])
                   : expf(gl[ii] * inv_root - st[0]) * (1.0f / st[1]);
        gl[ii] = masked ? 0.0f : p * (rnd(pq[ii]) - st[2]) * inv_root;
        pq[ii] = rnd(p);
      }
    }
    bf16* gk = gqkv + j * dm.ld_big + H + hh * hd;
    set_combine<MAXS>(gl, qkv + set0 * dm.ld_big + hh * hd, dm.ld_big, hd,
                      S, gk);
    set_combine<MAXS>(pq, go + set0 * dm.ld_h + hh * hd, dm.ld_h, hd, S,
                      gk + H);
  }
}

// The same three passes for the GLOBAL_H instance, LANES adjacent lanes an
// item (one thread an item leaves 160 of 256 threads idle at sets of 24 in
// a 24-row tile): each lane takes the dots with every LANES-th row of the
// set and every LANES-th output column, and the item's lanes exchange the
// dots by shuffles, so that each lane holds the item's whole row of them.
// Every sum is the one-thread version's, in its order: the same bits.

// own[jj] += sum_{d < hd} mine[d] * rows[j * ld + d] for the rows j = jj
// LANES + sub < S, in order of d (set_dots' sums of those rows).
template <int MAXS, int LANES>
__device__ __forceinline__ void set_dots_split(const bf16* mine,
                                               const bf16* rows, int ld,
                                               int hd, int S, int sub,
                                               float (&own)[MAXS / LANES]) {
  for (int d0 = 0; d0 < hd; d0 += kChunk) {
    float v[kChunk];
#pragma unroll
    for (int e = 0; e < kChunk; ++e)
      v[e] = d0 + e < hd ? bf(mine[d0 + e]) : 0.0f;
#pragma unroll
    for (int jj = 0; jj < MAXS / LANES; ++jj) {
      const int j = jj * LANES + sub;
      if (j < S) {
        const bf16* rj = rows + j * ld + d0;
#pragma unroll
        for (int e = 0; e < kChunk; ++e)
          if (d0 + e < hd) own[jj] = fmaf(v[e], bf(rj[e]), own[jj]);
      }
    }
  }
}

// The item's lanes: lane ``base + sub`` of the warp, sub < LANES.
template <int LANES>
struct ItemLanes {
  int sub, base;
  unsigned mask;
  __device__ ItemLanes() {
    const int lane = threadIdx.x & 31;
    sub = lane % LANES;
    base = lane - sub;
    mask = ((1u << LANES) - 1) << base;
  }
};

// all[j] = the dot of row j, from the lane that took it.
template <int MAXS, int LANES>
__device__ __forceinline__ void gather_dots(const float (&own)[MAXS / LANES],
                                            float (&all)[MAXS],
                                            const ItemLanes<LANES>& il) {
#pragma unroll
  for (int jj = 0; jj < MAXS / LANES; ++jj)
#pragma unroll
    for (int s = 0; s < LANES; ++s)
      all[jj * LANES + s] = __shfl_sync(il.mask, own[jj], il.base + s);
}

// set_dots of all the set's rows into all[], through the item's lanes.
template <int MAXS, int LANES>
__device__ __forceinline__ void item_dots(const bf16* mine, const bf16* rows,
                                          int ld, int hd, int S,
                                          const ItemLanes<LANES>& il,
                                          float (&all)[MAXS]) {
  float own[MAXS / LANES];
#pragma unroll
  for (int jj = 0; jj < MAXS / LANES; ++jj) own[jj] = 0.0f;
  set_dots_split<MAXS, LANES>(mine, rows, ld, hd, S, il.sub, own);
  gather_dots<MAXS, LANES>(own, all, il);
}

// attn_row through the item's lanes (each lane ends with the whole row).
template <int MAXS, int LANES>
__device__ __forceinline__ void attn_row_split(const bf16* qkv, int r, int hh,
                                               const Dims& dm,
                                               const KeyMask& km,
                                               const ItemLanes<LANES>& il,
                                               float (&p)[MAXS], float& mx,
                                               float& sum) {
  const int H = dm.hidden, hd = H / dm.heads, S = dm.set_size;
  const int set0 = (r / S) * S;
  const float inv_root = 1.0f / sqrtf((float)hd);
  item_dots<MAXS, LANES>(qkv + r * dm.ld_big + hh * hd,
                         qkv + (r / S) * S * dm.ld_big + H + hh * hd,
                         dm.ld_big, hd, S, il, p);
  mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < MAXS; ++j) {
    if (j < S) {
      p[j] = key_masked(km, set0 + j) ? kMaskedLogit : p[j] * inv_root;
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
  for (int j = 0; j < MAXS; ++j)
    if (j < S) p[j] = p[j] * inv_sum;
}

// set_combine's columns d = sub, sub + LANES, ...
template <int MAXS, int LANES>
__device__ __forceinline__ void set_combine_split(const float (&w)[MAXS],
                                                  const bf16* rows, int ld,
                                                  int hd, int S, bf16* out,
                                                  int sub) {
  for (int d = sub; d < hd; d += LANES) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < MAXS; ++j)
      if (j < S) acc = fmaf(w[j], bf(rows[j * ld + d]), acc);
    out[d] = __float2bfloat16_rn(acc);
  }
}

template <int MAXS, int LANES>
__device__ __noinline__ void attention_tile_split(const bf16* qkv, bf16* out,
                                                  const Dims& dm,
                                                  KeyMask km) {
  const int H = dm.hidden, nh = dm.heads, hd = H / nh, S = dm.set_size;
  const ItemLanes<LANES> il;
  for (int item = threadIdx.x / LANES; item < dm.tile * nh;
       item += blockDim.x / LANES) {
    const int hh = item / dm.tile;
    const int r = item % dm.tile;
    float p[MAXS], mx, sum;
    attn_row_split<MAXS, LANES>(qkv, r, hh, dm, km, il, p, mx, sum);
#pragma unroll
    for (int j = 0; j < MAXS; ++j)
      if (j < S) p[j] = rnd(p[j]);
    set_combine_split<MAXS, LANES>(
        p, qkv + (r / S) * S * dm.ld_big + 2 * H + hh * hd, dm.ld_big, hd, S,
        out + r * dm.ld_h + hh * hd, il.sub);
  }
}

template <int MAXS, int LANES>
__device__ __noinline__ void attention_bwd_q_split(const bf16* qkv,
                                                   const bf16* go, bf16* gqkv,
                                                   float* stats,
                                                   const Dims& dm,
                                                   KeyMask km) {
  const int H = dm.hidden, nh = dm.heads, hd = H / nh, S = dm.set_size;
  const float inv_root = 1.0f / sqrtf((float)hd);
  const bf16 zero = __float2bfloat16_rn(0.0f);
  const int wpad = dm.p_big - 3 * H;
  if (wpad > 0)
    for (int i = threadIdx.x; i < dm.tile_pad * wpad; i += blockDim.x)
      gqkv[(i / wpad) * dm.ld_big + 3 * H + i % wpad] = zero;
  const ItemLanes<LANES> il;
  for (int item = threadIdx.x / LANES; item < dm.tile_pad * nh;
       item += blockDim.x / LANES) {
    const int hh = item / dm.tile_pad;
    const int r = item % dm.tile_pad;
    bf16* gq = gqkv + r * dm.ld_big + hh * hd;
    if (r >= dm.tile) {
      for (int d = il.sub; d < hd; d += LANES)
        gq[d] = gq[H + d] = gq[2 * H + d] = zero;
      continue;
    }
    const bf16* set = qkv + (r / S) * S * dm.ld_big;
    float p[MAXS], mx, sum, gp[MAXS];
    attn_row_split<MAXS, LANES>(qkv, r, hh, dm, km, il, p, mx, sum);
    item_dots<MAXS, LANES>(go + r * dm.ld_h + hh * hd, set + 2 * H + hh * hd,
                           dm.ld_big, hd, S, il, gp);
    float D = 0.0f;
#pragma unroll
    for (int j = 0; j < MAXS; ++j) {
      if (j < S) {
        gp[j] = rnd(gp[j]);
        D = fmaf(p[j], gp[j], D);
      }
    }
    // the softmax's backward, then the 1/sqrt(hd) scale of the logits; a
    // masked logit takes none
    const int set0 = (r / S) * S;
#pragma unroll
    for (int j = 0; j < MAXS; ++j)
      if (j < S)
        gp[j] = key_masked(km, set0 + j) ? 0.0f
                                         : p[j] * (gp[j] - D) * inv_root;
    set_combine_split<MAXS, LANES>(gp, set + H + hh * hd, dm.ld_big, hd, S,
                                   gq, il.sub);
    if (il.sub == 0) {
      float* st = stats + (hh * dm.tile_pad + r) * 3;
      st[0] = mx;
      st[1] = sum;
      st[2] = D;
    }
  }
}

template <int MAXS, int LANES>
__device__ __noinline__ void attention_bwd_kv_split(const bf16* qkv,
                                                    const bf16* go,
                                                    bf16* gqkv,
                                                    const float* stats,
                                                    const Dims& dm,
                                                    KeyMask km) {
  const int H = dm.hidden, nh = dm.heads, hd = H / nh, S = dm.set_size;
  const float inv_root = 1.0f / sqrtf((float)hd);
  const ItemLanes<LANES> il;
  for (int item = threadIdx.x / LANES; item < dm.tile * nh;
       item += blockDim.x / LANES) {
    const int hh = item / dm.tile;
    const int j = item % dm.tile;
    const int set0 = (j / S) * S;
    const bool masked = key_masked(km, j);
    float gl[MAXS], pq[MAXS];
    // q_i . k_j and go_i . v_j for the set's queries i
    item_dots<MAXS, LANES>(qkv + j * dm.ld_big + H + hh * hd,
                           qkv + set0 * dm.ld_big + hh * hd, dm.ld_big, hd,
                           S, il, gl);
    item_dots<MAXS, LANES>(qkv + j * dm.ld_big + 2 * H + hh * hd,
                           go + set0 * dm.ld_h + hh * hd, dm.ld_h, hd, S, il,
                           pq);
#pragma unroll
    for (int ii = 0; ii < MAXS; ++ii) {
      if (ii < S) {
        const float* st = stats + (hh * dm.tile_pad + set0 + ii) * 3;
        // the unmasked expression as it was, so that its contraction and
        // so its bits stay
        const float p =
            masked ? expf(kMaskedLogit - st[0]) * (1.0f / st[1])
                   : expf(gl[ii] * inv_root - st[0]) * (1.0f / st[1]);
        gl[ii] = masked ? 0.0f : p * (rnd(pq[ii]) - st[2]) * inv_root;
        pq[ii] = rnd(p);
      }
    }
    bf16* gk = gqkv + j * dm.ld_big + H + hh * hd;
    set_combine_split<MAXS, LANES>(gl, qkv + set0 * dm.ld_big + hh * hd,
                                   dm.ld_big, hd, S, gk, il.sub);
    set_combine_split<MAXS, LANES>(pq, go + set0 * dm.ld_h + hh * hd,
                                   dm.ld_h, hd, S, gk + H, il.sub);
  }
}

template <int LANES>
__device__ __forceinline__ void attention_split(const bf16* qkv, bf16* out,
                                                const Dims& dm,
                                                const KeyMask& km) {
  if (dm.set_size <= 16)
    attention_tile_split<16, LANES>(qkv, out, dm, km);
  else
    attention_tile_split<kMaxSet, LANES>(qkv, out, dm, km);
}

template <int LANES>
__device__ __forceinline__ void attention_bwd_split(const bf16* qkv,
                                                    const bf16* go,
                                                    bf16* gqkv, float* stats,
                                                    const Dims& dm,
                                                    const KeyMask& km) {
  if (dm.set_size <= 16) {
    attention_bwd_q_split<16, LANES>(qkv, go, gqkv, stats, dm, km);
    __syncthreads();
    attention_bwd_kv_split<16, LANES>(qkv, go, gqkv, stats, dm, km);
  } else {
    attention_bwd_q_split<kMaxSet, LANES>(qkv, go, gqkv, stats, dm, km);
    __syncthreads();
    attention_bwd_kv_split<kMaxSet, LANES>(qkv, go, gqkv, stats, dm, km);
  }
}

// The three attention passes at the smallest unroll that holds a set.
template <int BLOCKS = 1>
__device__ __forceinline__ void attention(const bf16* qkv, bf16* out,
                                          const Dims& dm, const KeyMask& km) {
  if (dm.set_size <= 16)
    attention_tile<16, BLOCKS>(qkv, out, dm, km);
  else
    attention_tile<kMaxSet, BLOCKS>(qkv, out, dm, km);
}

__device__ __forceinline__ void attention_bwd(const bf16* qkv,
                                              const bf16* go, bf16* gqkv,
                                              float* stats, const Dims& dm,
                                              const KeyMask& km) {
  if (dm.set_size <= 16) {
    attention_bwd_q<16>(qkv, go, gqkv, stats, dm, km);
    __syncthreads();
    attention_bwd_kv<16>(qkv, go, gqkv, stats, dm, km);
  } else {
    attention_bwd_q<kMaxSet>(qkv, go, gqkv, stats, dm, km);
    __syncthreads();
    attention_bwd_kv<kMaxSet>(qkv, go, gqkv, stats, dm, km);
  }
}

// A block's part of a set above kMaxSet rows (a tile holds one): whether
// the set spans a cluster of two blocks, the rows of it in this block, the
// first of them in the set, and the set's key mask (null: none).
struct BigSet {
  bool clustered;
  int n_local, offset;
  const unsigned char* km;
};

// Attention at sets above kMaxSet rows, on the tensor cores.  A warp
// owns a 16-row m-tile of one head: its queries' logits against the whole
// set in the recompute and phase 1, its keys' against every query of the
// set in phase 2, KT n-tiles of 8 (8 up to 64 rows, 16 up to 128) in the
// fp32 accumulators of mma.sync.m16n8k16 (a head width's last 8 or fewer
// columns a k8 step, zero past the width).  The probabilities and the
// logits' cotangents go from the accumulators straight into the A
// fragments of the next product (the FlashAttention-2 register layout:
// n-tiles 2kk and 2kk + 1 of C are k-step kk of A), so a logit is formed
// once a pass.  The recompute keeps each query row's softmax max and
// 1 / sum in stats for phase 1, which adds D_i = sum_j p_ij R(gP_ij) from
// the same tile as dQ; phase 2 reads all three.  #3 runs the recompute's
// pass without the statistics (above 64 rows with its logits in two
// halves, attention_mma_halves).  Where a set spans two
// blocks, each pass first copies the other block's rows it reads (K and V,
// or Q and the output cotangent) once, 16 bytes a thread, into a region of
// its own tile that is dead during the pass (``stage``), so every operand
// lies in the block's shared memory; a 16-row group of them comes in by
// ldmatrix where the head width is a multiple of 8 and the group lies in
// one buffer, else in 32-bit pairs.  Rounding points as plain_forward:
// logits and softmax in fp32, a masked key's logit kMaskedLogit before the
// row's max, p rounded to bf16 before A.V and dV,
// R(gP), every output rounded once; a logit's cotangent dS (fp32) enters
// dQ and dK as bf16 hi + lo, so the products keep 16 bits of its mantissa.
// Rows past this block's part of the set are zero.

// (lo, hi) rounded to bf16, packed as a fragment register holds them.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t bits16(const bf16* p) {
  return *reinterpret_cast<const unsigned short*>(p);
}

// row[c], row[c + 1] packed, zero past n; ``even``: n is even, so row + c
// is 4-byte aligned for every even c and one load reads both.  A column
// past n reads column 0 and is zeroed after the load: no load is behind a
// branch, so a warp issues a fragment's loads together.
__device__ __forceinline__ uint32_t ld_pair(const bf16* row, int c, int n,
                                            bool even) {
  if (even) {
    const uint32_t v =
        *reinterpret_cast<const uint32_t*>(row + (c < n ? c : 0));
    return c < n ? v : 0u;
  }
  const uint32_t lo = bits16(row + (c < n ? c : 0));
  const uint32_t hi = bits16(row + (c + 1 < n ? c + 1 : 0));
  return (c < n ? lo : 0u) | (c + 1 < n ? hi << 16 : 0u);
}

// a[c], b[c] packed (two rows' column c).
__device__ __forceinline__ uint32_t ld_two(const bf16* a, const bf16* b,
                                           int c) {
  return bits16(a + c) | bits16(b + c) << 16;
}

// Two 8x8 bf16 matrices; lanes 0-15 give the row addresses.
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a (16x8, row) . b (8x8, col), bf16 in, fp32 accumulators.
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], uint32_t a0,
                                            uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// The rows of one operand of a set in this block's shared memory: the
// block's own part (set rows offset .. offset + n_local - 1) in ``own``,
// the other block's (from set row other0) staged in ``other``, each
// pointer at the operand's first column.
struct LocalRows {
  const bf16* own;
  const bf16* other;
  int ld_own, ld_other, offset, n_local, other0;
  __device__ __forceinline__ const bf16* row(int k) const {
    const int j = k - offset;
    return j >= 0 && j < n_local ? own + j * ld_own
                                 : other + (k - other0) * ld_other;
  }
  // rows k0 .. k0 + 15 lie in one buffer, below nb
  __device__ __forceinline__ bool one_buffer(int k0, int nb) const {
    const bool mine = k0 >= offset && k0 + 16 <= offset + n_local;
    const bool theirs = k0 + 16 <= offset || k0 >= offset + n_local;
    return k0 + 16 <= nb && (mine || theirs);
  }
};

// acc[j] = the 16 x 8 tile of rows r0 .. r0 + 15 of ``a`` (rows lda apart,
// from column col) against rows 8j .. 8j + 7 of ``b`` (from column bcol):
// the dot products over the head width hd, a warp's m-tile by KT n-tiles.
// ``fast``: hd is a multiple of 8, so every fragment is 16-byte aligned
// and comes by ldmatrix (B's where its 16-row group lies in one buffer).
// A row of ``a`` from na and of ``b`` from nb reads the last valid one: the
// callers drop those rows' results, or give their keys no weight.
template <int KT>
__device__ __forceinline__ void warp_dots(const bf16* a, int lda, int col,
                                          int na, int r0,
                                          const LocalRows& b, int bcol,
                                          int nb, int hd, bool fast,
                                          float (&acc)[KT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool even = hd % 2 == 0;
  const bf16* a0 = a + min(r0 + g, na - 1) * lda + col;
  const bf16* a1 = a + min(r0 + g + 8, na - 1) * lda + col;
  // ldmatrix: lane l gives row (l & 15) of A, column half l >> 4; of B's
  // 16-row group, row (l & 7) + 8 (l >> 4), column half (l >> 3) & 1
  const bf16* al = a + min(r0 + (lane & 15), na - 1) * lda + col +
                   (lane >> 4) * 8;
  const int bk = (lane & 7) + 8 * (lane >> 4), bh = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int j = 0; j < KT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  for (int d0 = 0; d0 < hd; d0 += 16) {
    const int c = d0 + 2 * t;
    const bool k16 = hd - d0 > 8;
    uint32_t af[4];
    if (fast && k16) {
      ldsm_x4(af, al + d0);
    } else if (fast) {
      uint32_t h[2];
      ldsm_x2(h, al + d0);  // lanes 0-15: rows 0-15 at column d0
      af[0] = h[0];
      af[1] = h[1];
    } else {
      af[0] = ld_pair(a0, c, hd, even);
      af[1] = ld_pair(a1, c, hd, even);
      af[2] = ld_pair(a0, c + 8, hd, even);
      af[3] = ld_pair(a1, c + 8, hd, even);
    }
#pragma unroll
    for (int jp = 0; jp < KT / 2; ++jp) {
      uint32_t bf[4];
      if (fast && b.one_buffer(16 * jp, nb)) {
        // k16: b0, b1 of n-tile 2jp, then of 2jp + 1; k8: b0 of both
        const bf16* p = b.row(16 * jp + bk) + bcol + d0;
        if (k16) {
          ldsm_x4(bf, p + bh);
        } else {
          uint32_t h[2];
          ldsm_x2(h, b.row(16 * jp + (lane & 7) + bh) + bcol + d0);
          bf[0] = h[0];
          bf[2] = h[1];
        }
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bf16* br = b.row(min(16 * jp + 8 * h + g, nb - 1)) + bcol;
          bf[2 * h] = ld_pair(br, c, hd, even);
          bf[2 * h + 1] = k16 ? ld_pair(br, c + 8, hd, even) : 0u;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (k16)
          mma_bf16(acc[2 * jp + h], af, bf[2 * h], bf[2 * h + 1]);
        else
          mma_bf16_k8(acc[2 * jp + h], af[0], af[1], bf[2 * h]);
      }
    }
  }
}

// The column of accumulator element e of n-tile j (its row is g or g + 8
// as e < 2 or not).
__device__ __forceinline__ int acc_col(int j, int e) {
  return 8 * j + 2 * (threadIdx.x & 3) + (e & 1);
}

// The accumulators rounded to bf16 and packed in pairs (elements 0, 1 and
// 2, 3 of each n-tile: a row's two columns).
template <int KT>
__device__ __forceinline__ void pack_acc(const float (&v)[KT][4],
                                         uint32_t (&out)[KT][2]) {
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    out[j][0] = pack_bf16(v[j][0], v[j][1]);
    out[j][1] = pack_bf16(v[j][2], v[j][3]);
  }
}

// Element ``hi`` (0: the low half) of a packed pair, as fp32.
__device__ __forceinline__ float unpack_bf16(uint32_t w, int hi) {
  return __uint_as_float(hi ? w & 0xffff0000u : w << 16);
}

// A logit: the scaled dot product, or kMaskedLogit for a masked key (km:
// the set's key mask, null: none).  One product, never contracted, so
// that every pass forms the same value.
__device__ __forceinline__ float logit_of(float dot, float inv_root,
                                          const unsigned char* km, int key) {
  return km != nullptr && km[key] == 0 ? kMaskedLogit
                                       : __fmul_rn(dot, inv_root);
}

// Sum over the 4 lanes of a quad (the lanes of one accumulator row).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// A fragments of the 16 x 8KT tile held as accumulators: k-step kk from
// n-tiles 2kk and 2kk + 1, each value rounded to bf16 (hi); ``lo`` (where
// given) the rounding of what hi leaves.
template <int KT>
__device__ __forceinline__ void acc_to_a(const float (&v)[KT][4],
                                         uint32_t (&hi)[KT / 2][4],
                                         uint32_t (*lo)[4] = nullptr) {
#pragma unroll
  for (int kk = 0; kk < KT / 2; ++kk) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* s = v[2 * kk + q / 2] + 2 * (q % 2);
      hi[kk][q] = pack_bf16(s[0], s[1]);
      if (lo != nullptr)
        lo[kk][q] = pack_bf16(s[0] - rnd(s[0]), s[1] - rnd(s[1]));
    }
  }
}

// out rows r0 + g, r0 + g + 8 (those below n_out; ld_out apart, from
// column ocol) = R(sum over the A fragments' NA parts of A . B), B the
// rows 0 .. 8 KT - 1 of ``b`` from column bcol: the 16 x hd product of a
// tile of weights with the set's rows, two n-tiles of 8 columns at a time
// (B by ldmatrix.trans where ``fast`` and a k-step's 16 rows lie in one
// buffer).  The weights of the rows from nb are zero, and those rows read
// the last valid one; a column past hd reads the last valid one and is not
// stored.
template <int KT, int NA>
__device__ __forceinline__ void warp_combine(
    const uint32_t (&af)[NA][KT / 2][4], const LocalRows& b, int bcol,
    int nb, int hd, bool fast, bf16* out, int ld_out, int ocol, int r0,
    int n_out) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // ldmatrix.trans: lane l gives row (l & 7) + 8 ((l >> 3) & 1) of a
  // k-step's 16, column block l >> 4
  const int bk = (lane & 7) + 8 * ((lane >> 3) & 1), bh = (lane >> 4) * 8;
  for (int n0 = 0; n0 < hd; n0 += 16) {
    const bool two = n0 + 8 < hd;
    float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int kk = 0; kk < KT / 2; ++kk) {
      uint32_t bf[4];
      if (fast && b.one_buffer(16 * kk, nb)) {
        const bf16* p = b.row(16 * kk + bk) + bcol + n0;
        if (two) {
          ldsm_x4_trans(bf, p + bh);
        } else {
          uint32_t h[2];
          ldsm_x2_trans(h, p);
          bf[0] = h[0];
          bf[1] = h[1];
        }
      } else {
        const bf16* br[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          br[q] = b.row(min(16 * kk + 2 * t + (q & 1) + 8 * (q >> 1), nb - 1));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = bcol + min(n0 + 8 * h + g, hd - 1);
          bf[2 * h] = ld_two(br[0], br[1], c);
          bf[2 * h + 1] = ld_two(br[2], br[3], c);
        }
      }
#pragma unroll
      for (int p = 0; p < NA; ++p) {
        mma_bf16(acc[0], af[p][kk], bf[0], bf[1]);
        if (two) mma_bf16(acc[1], af[p][kk], bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + g + 8 * (e >> 1);
        const int d = n0 + 8 * h + 2 * t + (e & 1);
        if (r < n_out && d < hd)
          out[r * ld_out + ocol + d] = __float2bfloat16_rn(acc[h][e]);
      }
  }
}

// The other block's rows of the set (``src`` in its shared memory, ld_src
// apart, columns c0 .. c0 + w - 1, n rows) to ``dst`` (ld_dst apart), by
// every thread of the block: 16 bytes at a time where every row and column
// is 16-byte aligned, else 2.
__device__ __forceinline__ void stage_rows(const bf16* src, int ld_src,
                                           int c0, int w, int n, bf16* dst,
                                           int ld_dst) {
  if ((c0 | w | ld_src | ld_dst) % 8 == 0) {
    const int w8 = w / 8;
    for (int i = threadIdx.x; i < n * w8; i += blockDim.x) {
      const int r = i / w8, c = i % w8 * 8;
      *reinterpret_cast<uint4*>(dst + r * ld_dst + c) =
          *reinterpret_cast<const uint4*>(src + r * ld_src + c0 + c);
    }
  } else {
    for (int i = threadIdx.x; i < n * w; i += blockDim.x)
      dst[i / w * ld_dst + i % w] = src[i / w * ld_src + c0 + i % w];
  }
}

// Rows of the staged copy: 2H wide (K | V, or Q | output cotangent), a
// multiple of 16 plus 8 as the tile's other buffers.
__host__ __device__ inline int stage_ld(int hidden) {
  return pad16(2 * hidden) + 8;
}

// The set's rows of columns c0 of ``mine`` (this block's buffer, ld apart)
// and of columns sc0 of the staged copy of the other block's (``stage``;
// the whole set in this block where it does not span a cluster).
__device__ __forceinline__ LocalRows local_rows(const bf16* mine, int ld,
                                                int c0, const bf16* stage,
                                                int sc0, const Dims& dm,
                                                const BigSet& bs) {
  LocalRows v;
  v.own = mine + c0;
  v.other = stage + sc0;
  v.ld_own = ld;
  v.ld_other = stage_ld(dm.hidden);
  v.offset = bs.offset;
  v.n_local = bs.n_local;
  v.other0 = bs.offset == 0 ? bs.n_local : 0;
  return v;
}

// The other block's rows of ``buf`` (ld apart, columns c0 .. c0 + w - 1)
// staged at column sc0 of ``stage``; the caller syncs the block before the
// copy is read.
__device__ __forceinline__ void stage_other(const bf16* buf, int ld, int c0,
                                            int w, bf16* stage, int sc0,
                                            const Dims& dm,
                                            const BigSet& bs) {
  if (!bs.clustered) return;
  cg::cluster_group cl = cg::this_cluster();
  const bf16* src = cl.map_shared_rank(const_cast<bf16*>(buf),
                                       1 - (int)cl.block_rank());
  stage_rows(src, ld, c0, w, dm.set_size - bs.n_local, stage + sc0,
             stage_ld(dm.hidden));
}

// The attention of a set above kMaxSet rows: out = R(sum_j R(p_ij) v_j)
// for this block's rows of the set (ld_out apart), and (STATS: #4's
// recompute) each row's softmax max and 1 / sum in stats [heads,
// tile_pad, 3] (kv: K from column 0, V from column H of the set's rows).
// A warp reads its item's Q rows before it writes their output, and no
// other warp reads them, so the output may go over Q.
template <int KT, bool STATS>
__device__ __forceinline__ void attention_mma_big(const bf16* qkv,
                                               LocalRows kv, bf16* out,
                                               int ld_out, float* stats,
                                               const Dims& dm,
                                               const BigSet& bs) {
  const int H = dm.hidden, nh = dm.heads, hd = H / nh, S = dm.set_size;
  const float inv_root = 1.0f / sqrtf((float)hd);
  const bool fast = hd % 8 == 0;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int mt = (bs.n_local + 15) / 16;
  for (int item = warp; item < nh * mt; item += kWarps) {
    const int hh = item / mt, r0 = item % mt * 16;
    float l[KT][4];
    warp_dots<KT>(qkv, dm.ld_big, hh * hd, bs.n_local, r0, kv, hh * hd, S,
                  hd, fast, l);
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = acc_col(j, e);
        l[j][e] = key < S ? logit_of(l[j][e], inv_root, bs.km, key)
                          : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], l[j][e]);
      }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (acc_col(j, e) < S) sum[e >> 1] += expf(l[j][e] - mx[e >> 1]);
    sum[0] = quad_sum(sum[0]);
    sum[1] = quad_sum(sum[1]);
    const float inv_sum[2] = {1.0f / sum[0], 1.0f / sum[1]};
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        l[j][e] = acc_col(j, e) < S
                      ? expf(l[j][e] - mx[e >> 1]) * inv_sum[e >> 1]
                      : 0.0f;
    uint32_t pf[1][KT / 2][4];
    acc_to_a<KT>(l, pf[0]);
    warp_combine<KT, 1>(pf, kv, H + hh * hd, S, hd, fast, out, ld_out,
                        hh * hd, r0, bs.n_local);
    if (STATS && (threadIdx.x & 3) == 0) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int r = r0 + g + 8 * h2;
        if (r < bs.n_local) {
          float* st = stats + (hh * dm.tile_pad + r) * 3;
          st[0] = mx[h2];
          st[1] = inv_sum[h2];
        }
      }
    }
  }
}

// #3's attention at sets of 65-128 (16 n-tiles), as attention_mma_big
// without the statistics but with a warp's logits held 8 n-tiles at a
// time, so that two blocks fit an SM's registers: the row's max and sum
// over the two halves of the keys under a running max (the sum of the
// first half rescaled where the second raises the max: another order of
// the sum than the recompute's), then each half's logits again, their
// probabilities from the final max and 1 / sum into the A fragments of
// P.V over the whole set.
__device__ __forceinline__ LocalRows keys_from(LocalRows v, int k0) {
  v.offset -= k0;
  v.other0 -= k0;
  return v;
}

__device__ __forceinline__ void attention_mma_halves(const bf16* qkv,
                                                     LocalRows kv, bf16* out,
                                                     int ld_out,
                                                     const Dims& dm,
                                                     const BigSet& bs) {
  const int H = dm.hidden, nh = dm.heads, hd = H / nh, S = dm.set_size;
  const float inv_root = 1.0f / sqrtf((float)hd);
  const bool fast = hd % 8 == 0;
  const int warp = threadIdx.x >> 5;
  const int mt = (bs.n_local + 15) / 16;
  for (int item = warp; item < nh * mt; item += kWarps) {
    const int hh = item / mt, r0 = item % mt * 16;
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int k0 = 64 * half;
      float l[8][4];
      warp_dots<8>(qkv, dm.ld_big, hh * hd, bs.n_local, r0,
                   keys_from(kv, k0), hh * hd, S - k0, hd, fast, l);
      float m[2] = {mx[0], mx[1]}, s[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + acc_col(j, e);
          l[j][e] = key < S ? logit_of(l[j][e], inv_root, bs.km, key)
                            : -INFINITY;
          m[e >> 1] = fmaxf(m[e >> 1], l[j][e]);
        }
      m[0] = quad_max(m[0]);
      m[1] = quad_max(m[1]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + acc_col(j, e) < S) s[e >> 1] += expf(l[j][e] - m[e >> 1]);
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        sum[h2] = sum[h2] * expf(mx[h2] - m[h2]) + s[h2];
        mx[h2] = m[h2];
      }
    }
    const float inv_sum[2] = {1.0f / quad_sum(sum[0]),
                              1.0f / quad_sum(sum[1])};
    uint32_t pf[1][8][4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int k0 = 64 * half;
      float l[8][4];
      warp_dots<8>(qkv, dm.ld_big, hh * hd, bs.n_local, r0,
                   keys_from(kv, k0), hh * hd, S - k0, hd, fast, l);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + acc_col(j, e);
          l[j][e] = key < S ? expf(logit_of(l[j][e], inv_root, bs.km, key) -
                                   mx[e >> 1]) * inv_sum[e >> 1]
                            : 0.0f;
        }
      uint32_t ph[4][4];
      acc_to_a<8>(l, ph);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) pf[0][4 * half + kk][q] = ph[kk][q];
    }
    warp_combine<16, 1>(pf, kv, H + hh * hd, S, hd, fast, out, ld_out,
                        hh * hd, r0, bs.n_local);
  }
}

// Attention backward of a set above kMaxSet rows, phase 1 (query-major):
// for this block's query rows, gP = R(go . v_j), p from the recompute's
// statistics, D_i = sum_j p_ij gP_ij, the logits' cotangent dS = p (gP -
// D) / sqrt(hd) (none for a masked key), and gq = R(dS . K); D goes to
// stats (kv as the recompute's).  Rows past this block's part of the set,
// to tile_pad, and the columns past 3H get zeros.
template <int KT>
__device__ __forceinline__ void attention_bwd_q_big(const bf16* qkv,
                                                 LocalRows kv,
                                                 const bf16* go, bf16* gqkv,
                                                 float* stats, const Dims& dm,
                                                 const BigSet& bs) {
  const int H = dm.hidden, nh = dm.heads, hd = H / nh, S = dm.set_size;
  const float inv_root = 1.0f / sqrtf((float)hd);
  const bool fast = hd % 8 == 0;
  const bf16 zero = __float2bfloat16_rn(0.0f);
  const int wpad = dm.p_big - 3 * H;
  if (wpad > 0)
    for (int i = threadIdx.x; i < dm.tile_pad * wpad; i += blockDim.x)
      gqkv[(i / wpad) * dm.ld_big + 3 * H + i % wpad] = zero;
  const int past = dm.tile_pad - bs.n_local;
  for (int i = threadIdx.x; i < past * 3 * H; i += blockDim.x)
    gqkv[(bs.n_local + i / (3 * H)) * dm.ld_big + i % (3 * H)] = zero;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int mt = (bs.n_local + 15) / 16;
  for (int item = warp; item < nh * mt; item += kWarps) {
    const int hh = item / mt, r0 = item % mt * 16;
    float p[KT][4];
    uint32_t gpk[KT][2];  // R(gP), packed as bf16 pairs
    warp_dots<KT>(go, dm.ld_h, hh * hd, bs.n_local, r0, kv, H + hh * hd, S,
                  hd, fast, p);
    pack_acc<KT>(p, gpk);
    warp_dots<KT>(qkv, dm.ld_big, hh * hd, bs.n_local, r0, kv, hh * hd, S,
                  hd, fast, p);
    float mx[2], inv_sum[2], D[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = min(r0 + g + 8 * h2, bs.n_local - 1);
      const float* st = stats + (hh * dm.tile_pad + r) * 3;
      mx[h2] = st[0];
      inv_sum[h2] = st[1];
    }
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = acc_col(j, e);
        p[j][e] = key < S ? expf(logit_of(p[j][e], inv_root, bs.km, key) -
                                 mx[e >> 1]) * inv_sum[e >> 1]
                          : 0.0f;
        D[e >> 1] = fmaf(p[j][e], unpack_bf16(gpk[j][e >> 1], e & 1),
                         D[e >> 1]);
      }
    D[0] = quad_sum(D[0]);
    D[1] = quad_sum(D[1]);
    // the softmax's backward, then the 1/sqrt(hd) scale of the logits; a
    // masked logit takes none
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = acc_col(j, e);
        p[j][e] = key >= S || (bs.km != nullptr && bs.km[key] == 0)
                      ? 0.0f
                      : p[j][e] * (unpack_bf16(gpk[j][e >> 1], e & 1) -
                                   D[e >> 1]) * inv_root;
      }
    uint32_t df[2][KT / 2][4];
    acc_to_a<KT>(p, df[0], df[1]);
    warp_combine<KT, 2>(df, kv, hh * hd, S, hd, fast, gqkv, dm.ld_big,
                        hh * hd, r0, bs.n_local);
    if ((threadIdx.x & 3) == 0) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int r = r0 + g + 8 * h2;
        if (r < bs.n_local) stats[(hh * dm.tile_pad + r) * 3 + 2] = D[h2];
      }
    }
  }
}

// Phase 2 (key-major): for this block's key rows j, the logits against
// every query i of the set, p_ij from the query's statistics (qs, gos: the
// set's Q and output cotangents; sts: its statistics, head 0's, a head's
// tile_pad rows further, in both blocks), gk_j = R(sum_i dS_ij q_i) and
// gv_j = R(sum_i R(p_ij) go_i).
template <int KT>
__device__ __forceinline__ void attention_bwd_kv_big(const bf16* qkv,
                                                  LocalRows qs, LocalRows gos,
                                                  SetRows<float> sts,
                                                  bf16* gqkv, const Dims& dm,
                                                  const BigSet& bs) {
  const int H = dm.hidden, nh = dm.heads, hd = H / nh, S = dm.set_size;
  const float inv_root = 1.0f / sqrtf((float)hd);
  const bool fast = hd % 8 == 0;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int mt = (bs.n_local + 15) / 16;
  for (int item = warp; item < nh * mt; item += kWarps) {
    const int hh = item / mt, r0 = item % mt * 16;
    const int st_off = hh * dm.tile_pad * 3;
    float lt[KT][4];
    uint32_t gpk[KT][2];  // R(gP^T), packed as bf16 pairs
    warp_dots<KT>(qkv, dm.ld_big, 2 * H + hh * hd, bs.n_local, r0, gos,
                  hh * hd, S, hd, fast, lt);
    pack_acc<KT>(lt, gpk);
    warp_dots<KT>(qkv, dm.ld_big, H + hh * hd, bs.n_local, r0, qs, hh * hd,
                  S, hd, fast, lt);
    bool masked[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int j = r0 + g + 8 * h2;
      masked[h2] = bs.km != nullptr && j < bs.n_local &&
                   bs.km[bs.offset + j] == 0;
    }
    uint32_t df[2][KT / 2][4], pf[1][KT / 2][4];
#pragma unroll
    for (int jt = 0; jt < KT; ++jt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = acc_col(jt, e);
        // a query past the set reads the last one's statistics, no weight
        const float* st = sts.row(min(i, S - 1)) + st_off;
        const float mx = st[0], inv_sum = st[1], D = st[2];
        const float l = masked[e >> 1] ? kMaskedLogit
                                       : __fmul_rn(lt[jt][e], inv_root);
        p[e] = i < S ? expf(l - mx) * inv_sum : 0.0f;
        lt[jt][e] = i >= S || masked[e >> 1]
                        ? 0.0f
                        : p[e] * (unpack_bf16(gpk[jt][e >> 1], e & 1) - D) *
                              inv_root;
      }
      // p into its A fragment (k-step jt / 2, as acc_to_a places it)
      pf[0][jt / 2][2 * (jt & 1)] = pack_bf16(p[0], p[1]);
      pf[0][jt / 2][2 * (jt & 1) + 1] = pack_bf16(p[2], p[3]);
    }
    acc_to_a<KT>(lt, df[0], df[1]);
    warp_combine<KT, 2>(df, qs, hh * hd, S, hd, fast, gqkv, dm.ld_big,
                        H + hh * hd, r0, bs.n_local);
    warp_combine<KT, 1>(pf, gos, hh * hd, S, hd, fast, gqkv, dm.ld_big,
                        2 * H + hh * hd, r0, bs.n_local);
  }
}

// The attention of a tile: attention() for sets up to kMaxSet rows (the
// kernels' instances without BIG), else over the set's rows in this block
// and, in a cluster, the other's, on the tensor cores, the other block's K
// and V staged in ``stage``: #4's recompute (BLOCKS 1) keeps the rows'
// softmax statistics in stats for its backward; #3 (BLOCKS kFwdBlocks)
// keeps none, holds its logits in two halves above 64 rows
// (attention_mma_halves) and stages in the region of ``out``, which is at
// least the staged rows' size (fwd_smem_bytes), so over a cluster its
// rows' output goes over their Q, then to ``out`` (zero past H: the
// output projection reads the padded columns).
template <bool BIG, int BLOCKS = 1>
__device__ __forceinline__ void attend(bf16* qkv, bf16* out,
                                       const Dims& dm, const KeyMask& km,
                                       const BigSet& bs,
                                       float* stats = nullptr,
                                       bf16* stage = nullptr) {
  if constexpr (!BIG) {
    attention<BLOCKS>(qkv, out, dm, km);
    return;
  }
  constexpr bool kStats = BLOCKS == 1;
  const int H = dm.hidden;
  if constexpr (!kStats) stage = out;
  stage_other(qkv, dm.ld_big, H, 2 * H, stage, 0, dm, bs);
  __syncthreads();
  const LocalRows kv = local_rows(qkv, dm.ld_big, H, stage, 0, dm, bs);
  bf16* o = out;
  int ld_o = dm.ld_h;
  if (!kStats && bs.clustered) {
    o = qkv;
    ld_o = dm.ld_big;
  }
  if (dm.set_size <= 64)
    attention_mma_big<8, kStats>(qkv, kv, o, ld_o, stats, dm, bs);
  else if constexpr (kStats)
    attention_mma_big<16, kStats>(qkv, kv, o, ld_o, stats, dm, bs);
  else
    attention_mma_halves(qkv, kv, o, ld_o, dm, bs);
  if (kStats || !bs.clustered) return;
  __syncthreads();
  const bf16 zero = __float2bfloat16_rn(0.0f);
  for (int i = threadIdx.x; i < dm.tile_pad * dm.ld_h; i += blockDim.x) {
    const int r = i / dm.ld_h, c = i % dm.ld_h;
    out[i] = c < H ? qkv[r * dm.ld_big + c] : zero;
  }
}

// Its backward (stats: the recompute's; ``stage``: a region dead during
// it): phase 1 on the other block's K and V staged, then, after the
// cluster's barrier where the set spans two blocks (phase 2 reads the
// other block's output cotangents and statistics), phase 2 on its Q and
// output cotangents staged.
template <int KT>
__device__ __forceinline__ void attention_bwd_big(const bf16* qkv,
                                                  const bf16* go, bf16* gqkv,
                                                  float* stats, bf16* stage,
                                                  const Dims& dm,
                                                  const BigSet& bs) {
  const int H = dm.hidden;
  stage_other(qkv, dm.ld_big, H, 2 * H, stage, 0, dm, bs);
  __syncthreads();
  attention_bwd_q_big<KT>(qkv, local_rows(qkv, dm.ld_big, H, stage, 0, dm,
                                          bs),
                          go, gqkv, stats, dm, bs);
  set_sync(bs.clustered);
  stage_other(qkv, dm.ld_big, 0, H, stage, 0, dm, bs);
  stage_other(go, dm.ld_h, 0, H, stage, H, dm, bs);
  __syncthreads();
  attention_bwd_kv_big<KT>(qkv, local_rows(qkv, dm.ld_big, 0, stage, 0, dm,
                                           bs),
                           local_rows(go, dm.ld_h, 0, stage, H, dm, bs),
                           set_rows_of<float, 2>(stats, 3, dm.split,
                                                 bs.clustered ? 2 : 1),
                           gqkv, dm, bs);
}

template <bool BIG>
__device__ __forceinline__ void attend_bwd(const bf16* qkv, const bf16* go,
                                           bf16* gqkv, float* stats,
                                           const Dims& dm, const KeyMask& km,
                                           const BigSet& bs,
                                           bf16* stage = nullptr) {
  if constexpr (!BIG)
    attention_bwd(qkv, go, gqkv, stats, dm, km);
  else if (dm.set_size <= 64)
    attention_bwd_big<8>(qkv, go, gqkv, stats, stage, dm, bs);
  else
    attention_bwd_big<16>(qkv, go, gqkv, stats, stage, dm, bs);
}

// The rows of this block's tile t: in a cluster of two, its part of set t,
// else tile t of dm.tile rows; and (BIG) the set's part in a BigSet.
template <bool BIG>
__device__ __forceinline__ void tile_rows(const Dims& dm, long t,
                                          const unsigned char* key_mask,
                                          long& row0, int& valid,
                                          BigSet& bs) {
  if constexpr (!BIG) {
    row0 = t * dm.tile;
    const long left = dm.rows - row0;
    valid = left < dm.tile ? (int)left : dm.tile;
    return;
  }
  bs.clustered = dm.cluster == 2;
  const int rank = bs.clustered ? (int)cg::this_cluster().block_rank() : 0;
  if (bs.clustered) {
    row0 = t * dm.set_size + rank * dm.split;
    valid = rank == 0 ? dm.split : dm.set_size - dm.split;
  } else {
    row0 = t * dm.tile;
    const long left = dm.rows - row0;
    valid = left < dm.tile ? (int)left : dm.tile;
  }
  bs.n_local = valid;
  bs.offset = rank * dm.split;
  bs.km = key_mask ? key_mask + row0 - bs.offset : nullptr;
}

// 16-byte copies and clears; every region is a multiple of 16 bytes and
// 16-byte aligned.
__device__ __forceinline__ void copy16(const void* src, void* dst,
                                       int bytes) {
  const uint4* s = static_cast<const uint4*>(src);
  uint4* d = static_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x) d[i] = s[i];
}

__device__ __forceinline__ void clear16(void* dst, int bytes) {
  uint4* d = static_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x)
    d[i] = make_uint4(0u, 0u, 0u, 0u);
}

// A [tile_pad, ld] tile of a [rows, width] bf16 input, zero past valid
// rows and past width.
__device__ void load_rows(const bf16* __restrict__ src, long row0, int valid,
                          int width, bf16* dst, int ld, const Dims& dm) {
  const bf16 zero = __float2bfloat16_rn(0.0f);
  for (int i = threadIdx.x; i < dm.tile_pad * ld; i += blockDim.x) {
    const int r = i / ld, c = i % ld;
    dst[i] = r < valid && c < width ? src[(row0 + r) * width + c] : zero;
  }
}

// Shared-memory bytes of one block: the residual stream at each of the
// layers + 1 block boundaries (GLOBAL_H: only the current one, the others
// in the block's global workspace), five [tile, ld_h] buffers (gh, a, o,
// hm, gs), qkv, a region for the MLP pair / the qkv gradient / g / x (all
// bf16), and the fp32 softmax statistics.
__host__ __device__ inline size_t smem_bytes(const Dims& dm, bool global_h) {
  const int copies = global_h ? 1 : dm.layers + 1;
  return 2 * (size_t)dm.tile_pad *
             ((copies + 5) * dm.ld_h + dm.ld_big + dm.ld_r2) +
         4 * (size_t)dm.tile_pad * 3 * dm.heads;
}

// The operand images of the GLOBAL_H instance's weight gradients, which
// it leaves in global memory for wgrad_tiles: each a [tile_pad, width
// padded to 16] bf16 image of a tile's rows, pad rows included, so that the
// products see the values the tile held.  Tile t's images start at t *
// tile: x, g, R(LN(h_L)) (the output layer's input) and the cotangent of
// h_0 (the embed's), then for each layer (layer apart) its LN outputs a1
// and a2, the attention output o, the MLP's m = R(gelu(f)), and the
// cotangents into fc2 (of the block's output), fc1 (of f), proj (of hm)
// and qkv.
struct Images {
  long tile, layer;                               // elements of each
  long x, g, a_out, g_embed;                      // in a tile
  long a1, o, a2, m, g_fc2, g_fc1, g_proj, g_qkv;  // layer 0's, in a tile
};

__host__ __device__ inline Images images_of(const Dims& dm) {
  const long tp = dm.tile_pad, ph = tp * dm.p_h, pf = tp * dm.p_f;
  Images im;
  im.x = 0;
  im.g = tp * dm.p_in;
  im.a_out = im.g + tp * dm.p_out;
  im.g_embed = im.a_out + ph;
  im.a1 = im.g_embed + ph;
  im.o = im.a1 + ph;
  im.a2 = im.o + ph;
  im.m = im.a2 + ph;
  im.g_fc2 = im.m + pf;
  im.g_fc1 = im.g_fc2 + ph;
  im.g_proj = im.g_fc1 + pf;
  im.g_qkv = im.g_proj + ph;
  im.layer = im.g_qkv + tp * dm.p_big - im.a1;
  im.tile = im.a1 + dm.layers * im.layer;
  return im;
}

// The [tile_pad, w] image of the tile's rows of src (rows ld apart; w a
// multiple of 8) at dst: a warp a row, 16 bytes a lane, by streaming
// stores (st.global.cs: evicted first from L2, where the images would
// otherwise push out the weights that every tile's dense products read
// from it; plain stores timed slower).  (TMA bulk copies, a row each,
// issued by a lane a warp, timed no faster.)
__device__ __forceinline__ void store_image(const bf16* src, int ld, int w,
                                            bf16* __restrict__ dst,
                                            const Dims& dm) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < dm.tile_pad; r += kWarps)
    for (int c = 8 * lane; c < w; c += 8 * 32) {
      uint4* to = reinterpret_cast<uint4*>(dst + (long)r * w + c);
      const uint4 v = *reinterpret_cast<const uint4*>(src + r * ld + c);
      __stcs(to, v);
    }
}

// GLOBAL_H: qkv [tile, ld_big], o and hm [tile, ld_h] to (out) or from a
// layer's stash in the workspace, whole images.  Phase 3 reads back what
// phase 1 made of each h in place of its recompute (the same values: the
// recompute is the forward's arithmetic on the same h).
__device__ __forceinline__ void stash(bf16* qkv, bf16* o, bf16* hm, bf16* sg,
                                      bool out, const Dims& dm) {
  const int big = dm.tile_pad * dm.ld_big, hsz = dm.tile_pad * dm.ld_h;
  if (out) {
    copy16(qkv, sg, 2 * big);
    copy16(o, sg + big, 2 * hsz);
    copy16(hm, sg + big + hsz, 2 * hsz);
  } else {
    copy16(sg, qkv, 2 * big);
    copy16(sg + big, o, 2 * hsz);
    copy16(sg + big + hsz, hm, 2 * hsz);
  }
}

// GLOBAL_H: a dense layer's operands X [tile, kd] and its output's
// cotangent G [tile, n] stored as images for wgrad_tiles, at the offsets
// xm and gm of Images in tile t's images (of all tiles' at ``images``), of
// layer l's (l >= 0) or of the tile's.
__device__ __forceinline__ void store_operands(const bf16* X, int ldx,
                                               int kd, const bf16* G,
                                               int ldg, int n, bf16* images,
                                               long t, int l, long Images::*xm,
                                               long Images::*gm,
                                               const Dims& dm) {
  const Images im = images_of(dm);
  bf16* img = images + t * im.tile + (l >= 0 ? l * im.layer : 0);
  store_image(X, ldx, pad16(kd), img + im.*xm, dm);
  store_image(G, ldg, pad16(n), img + im.*gm, dm);
}

// GLOBAL_H is the layout of a net whose copies of h do not fit in shared
// memory with the rest (the molecule nets of hidden 256 at sets of 24):
// shared memory holds one residual stream, phase 1 writes h at the block
// boundaries 0 .. L - 1 to the CUDA block's slice of hws ([L, tile_pad,
// ld_h] bf16, 4.5 MB at grid 132, hidden 256 and L = 2, so it stays in the
// 50 MB L2) before each transformer block changes it, and phase 3 copies
// each back before that block's recompute.  The copies are whole
// [tile_pad, ld_h] images, so every instruction of the arithmetic reads the
// values the shared layout reads: the same bits, for one copy of h out and
// one back through L2 a boundary and tile.  Its weight gradients leave the
// tile loop: at each of the six dense layers' sites the block stores the
// operands as images (Images, 446 KB a 32-row tile at hidden 256), and
// wgrad_tiles, launched after it, contracts them over all tiles in the
// order the shared layout's slices and reduce_wgrad sum them, so dx and
// the 12 gradients are the shared layout's bits where both fit (hws holds
// the images after the copies of h and the stash; the instance takes no
// part, writes no slice and dw stays for wgrad_tiles).
// Phase 3 reads back the qkv, o, hm and f | m that phase 1 made from the
// same h (stash, after the copies of h in hws) in place of recomputing
// them, and the attention runs two lanes an item (attention_split); both
// keep every sum as it was.  Without GLOBAL_H (every net that fits) the code is
// the shared layout's, instruction for instruction (tools/sass_diff.py).
//
// BIG: the instance for sets above kMaxSet rows (one set a tile, over a
// cluster of two where it does not fit one block; attention on warp tiles);
// without it the instance is the one for sets up to kMaxSet, whose code
// holds nothing of that.
template <bool GLOBAL_H, bool BIG>
__global__ void __launch_bounds__(kThreads, 1)
fused_set_transformer_bwd(const bf16* __restrict__ x,
                          const unsigned char* __restrict__ key_mask,
                          const bf16* __restrict__ g, PadWeights wt,
                          bf16* __restrict__ dx, float* __restrict__ part,
                          bf16* __restrict__ hws, Dims dm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int H = dm.hidden, RH = dm.mlp, L = dm.layers, OUT = dm.out_dim;
  const int TP = dm.tile_pad, IN = dm.in_dim;
  const int PH = dm.p_h, PB = dm.p_big, PF = dm.p_f;
  const int hsz = TP * dm.ld_h;
  bf16* hs = smem;  // [L + 1] residual streams (GLOBAL_H: the current one)
  bf16* gh = hs + (GLOBAL_H ? 1 : L + 1) * hsz;  // d loss / d h
  bf16* a = gh + hsz;                // LN outputs
  bf16* o = a + hsz;                 // attention output (rounded)
  bf16* hm = o + hsz;                // h after the attention residual
  bf16* gs = hm + hsz;               // ga, ga2, go, ga1
  bf16* qkv = gs + hsz;              // [TP, ld_big]
  bf16* r2 = qkv + TP * dm.ld_big;   // [TP, ld_r2]: f | m, gqkv, g, x
  float* stats = reinterpret_cast<float*>(r2 + TP * dm.ld_r2);
  bf16* f = r2;                      // [TP, ld_f] pre-gelu, then its grad
  bf16* m = r2 + TP * dm.ld_f;       // [TP, ld_f] R(gelu(f))
  const Offsets og = grad_offsets(dm);
  // this block's slice of the weight gradients (GLOBAL_H: none)
  float* pw = GLOBAL_H ? nullptr : part + blockIdx.x * og.off[12];
  // a set in a cluster of two: the cluster walks the sets, each of its
  // blocks its part of one
  const bool clustered = BIG && dm.cluster == 2;
  const long slot = clustered ? blockIdx.x / 2 : blockIdx.x;
  const long stride = clustered ? gridDim.x / 2 : gridDim.x;
  const long ntiles = clustered ? dm.rows / dm.set_size
                                : (dm.rows + dm.tile - 1) / dm.tile;
  // GLOBAL_H: this block's copies of h at the block boundaries 0 .. L - 1
  // and each layer's qkv, o, hm and f | m from phase 1; after every
  // block's, the operand images of all tiles
  bf16* hg = GLOBAL_H ? hws + (long)blockIdx.x * L * hsz : nullptr;
  const long st = (long)TP * (dm.ld_big + 2 * dm.ld_h + 2 * dm.ld_f);
  bf16* sg = GLOBAL_H ? hws + (long)gridDim.x * L * hsz +
                            (long)blockIdx.x * L * st
                      : nullptr;
  bf16* images = GLOBAL_H ? hws + (long)gridDim.x * L * (hsz + st) : nullptr;

  clear16(smem_raw, (int)smem_bytes(dm, GLOBAL_H));
  __syncthreads();
  for (long t = slot; t < ntiles; t += stride) {
    const bool first = t == slot;
    long row0;
    int valid;
    BigSet bs;
    tile_rows<BIG>(dm, t, key_mask, row0, valid, bs);
    const KeyMask km = {key_mask ? key_mask + row0 : nullptr, valid};

    // 1. forward, keeping h at each block boundary
    load_rows(x, row0, valid, IN, r2, dm.ld_x, dm);
    __syncthreads();
    mma_dense<kStore>(r2, dm.ld_x, dm.p_in, wt.wt[0], PH, H, wt.b[0], hs,
                      dm.ld_h, nullptr, nullptr, valid, dm);
    __syncthreads();
    for (int l = 0; l < L; ++l) {
      bf16* h = hs;
      if constexpr (GLOBAL_H) {
        copy16(h, hg + (long)l * hsz, 2 * hsz);  // h_l, kept for phase 3
      } else {
        h = hs + (l + 1) * hsz;
        copy16(hs + l * hsz, h, 2 * hsz);
      }
      __syncthreads();
      layer_norm_tile(h, a, dm);
      __syncthreads();
      mma_dense<kStore>(a, dm.ld_h, PH, wt.wt[1] + (long)l * PB * PH, PB,
                        3 * H, wt.b[1] + l * 3 * H, qkv, dm.ld_big, nullptr,
                        nullptr, valid, dm);
      set_sync(clustered);
      // hm | gs unused here
      if constexpr (GLOBAL_H)
        attention_split<2>(qkv, o, dm, km);
      else
        attend<BIG>(qkv, o, dm, km, bs, stats, hm);
      set_sync(clustered);
      mma_dense<kResidual>(o, dm.ld_h, PH, wt.wt[2] + (long)l * PH * PH, PH,
                           H, wt.b[2] + l * H, h, dm.ld_h, nullptr, nullptr,
                           valid, dm);
      __syncthreads();
      if constexpr (GLOBAL_H) stash(qkv, o, h, sg + l * st, true, dm);
      layer_norm_tile(h, a, dm);
      __syncthreads();
      if constexpr (GLOBAL_H) {
        // f too, for phase 3
        mma_dense<kFc1>(a, dm.ld_h, PH, wt.wt[3] + (long)l * PF * PH, PF, RH,
                        wt.b[3] + l * RH, f, dm.ld_f, m, nullptr, valid, dm);
        __syncthreads();
        copy16(f, sg + l * st + TP * (dm.ld_big + 2 * dm.ld_h),
               4 * TP * dm.ld_f);
      } else {
        mma_dense<kGelu>(a, dm.ld_h, PH, wt.wt[3] + (long)l * PF * PH, PF,
                         RH, wt.b[3] + l * RH, m, dm.ld_f, nullptr, nullptr,
                         valid, dm);
        __syncthreads();
      }
      mma_dense<kResidual>(m, dm.ld_f, PF, wt.wt[4] + (long)l * PH * PF, PH,
                           H, wt.b[4] + l * H, h, dm.ld_h, nullptr, nullptr,
                           valid, dm);
      __syncthreads();
    }

    // 2. output layer: y = dense(R(LN(h_L)))
    // h_L: the last copy, or the one residual stream (GLOBAL_H)
    layer_norm_tile(hs + (GLOBAL_H ? 0 : L) * hsz, a, dm);
    load_rows(g, row0, valid, OUT, r2, dm.ld_g, dm);
    __syncthreads();
    if constexpr (GLOBAL_H)
      store_operands(a, dm.ld_h, H, r2, dm.ld_g, OUT, images, t, -1,
                     &Images::a_out, &Images::g, dm);
    else
      mma_wgrad(a, dm.ld_h, H, r2, dm.ld_g, OUT, pw + og.off[10],
                pw + og.off[11], first, dm);
    mma_dense<kBwdStore>(r2, dm.ld_g, dm.p_out, wt.w[5], PH, H, nullptr, gs,
                         dm.ld_h, nullptr, nullptr, valid, dm);
    __syncthreads();
    layer_norm_bwd_tile<false>(hs + (GLOBAL_H ? 0 : L) * hsz, gs, gh, dm);
    __syncthreads();

    // 3. the blocks in reverse, each recomputed from its input h
    for (int l = L - 1; l >= 0; --l) {
      const bf16* h = hs;
      if constexpr (GLOBAL_H) {
        copy16(hg + (long)l * hsz, hs, 2 * hsz);  // h_l back from phase 1
        // and what phase 1 made from it, in place of its recompute
        stash(qkv, o, hm, sg + l * st, false, dm);
        copy16(sg + l * st + TP * (dm.ld_big + 2 * dm.ld_h), f,
               4 * TP * dm.ld_f);
        __syncthreads();
      } else {
        h = hs + l * hsz;
      }
      if constexpr (!GLOBAL_H) {
        layer_norm_tile(h, a, dm);
        if constexpr (!BIG) copy16(h, hm, 2 * hsz);
        __syncthreads();
        mma_dense<kStore>(a, dm.ld_h, PH, wt.wt[1] + (long)l * PB * PH, PB,
                          3 * H, wt.b[1] + l * 3 * H, qkv, dm.ld_big, nullptr,
                          nullptr, valid, dm);
        set_sync(clustered);
        attend<BIG>(qkv, o, dm, km, bs, stats, hm);
        set_sync(clustered);
        if constexpr (BIG) {
          // hm | gs held the other block's K and V during the attention
          copy16(h, hm, 2 * hsz);
          __syncthreads();
        }
        mma_dense<kResidual>(o, dm.ld_h, PH, wt.wt[2] + (long)l * PH * PH,
                             PH, H, wt.b[2] + l * H, hm, dm.ld_h, nullptr,
                             nullptr, valid, dm);
        __syncthreads();
      }
      layer_norm_tile(hm, a, dm);
      __syncthreads();
      if constexpr (!GLOBAL_H) {
        mma_dense<kFc1>(a, dm.ld_h, PH, wt.wt[3] + (long)l * PF * PH, PF, RH,
                        wt.b[3] + l * RH, f, dm.ld_f, m, nullptr, valid, dm);
        __syncthreads();
      }
      // MLP: h_out = R(hm + R(m @ W2 + b2)), m = R(gelu(f))
      if constexpr (GLOBAL_H)
        store_operands(m, dm.ld_f, RH, gh, dm.ld_h, H, images, t, l,
                       &Images::m, &Images::g_fc2, dm);
      else
        mma_wgrad(m, dm.ld_f, RH, gh, dm.ld_h, H,
                  pw + og.off[8] + (long)l * RH * H, pw + og.off[9] + l * H,
                  first, dm);
      mma_dense<kBwdGelu>(gh, dm.ld_h, PH, wt.w[4] + (long)l * PF * PH, PF,
                          RH, nullptr, f, dm.ld_f, nullptr, nullptr, valid,
                          dm);
      __syncthreads();
      if constexpr (GLOBAL_H)
        store_operands(a, dm.ld_h, H, f, dm.ld_f, RH, images, t, l,
                       &Images::a2, &Images::g_fc1, dm);
      else
        mma_wgrad(a, dm.ld_h, H, f, dm.ld_f, RH,
                  pw + og.off[6] + (long)l * H * RH, pw + og.off[7] + l * RH,
                  first, dm);
      mma_dense<kBwdStore>(f, dm.ld_f, PF, wt.w[3] + (long)l * PH * PF, PH,
                           H, nullptr, gs, dm.ld_h, nullptr, nullptr, valid,
                           dm);
      __syncthreads();
      layer_norm_bwd_tile<true>(hm, gs, gh, dm);
      __syncthreads();
      // attention: hm = R(h + R(o @ Wp + bp))
      if constexpr (GLOBAL_H)
        store_operands(o, dm.ld_h, H, gh, dm.ld_h, H, images, t, l,
                       &Images::o, &Images::g_proj, dm);
      else
        mma_wgrad(o, dm.ld_h, H, gh, dm.ld_h, H,
                  pw + og.off[4] + (long)l * H * H, pw + og.off[5] + l * H,
                  first, dm);
      mma_dense<kBwdStore>(gh, dm.ld_h, PH, wt.w[2] + (long)l * PH * PH, PH,
                           H, nullptr, gs, dm.ld_h, nullptr, nullptr, valid,
                           dm);
      layer_norm_tile(h, a, dm);  // a1 again, for the qkv weights
      __syncthreads();
      // o | hm dead
      if constexpr (GLOBAL_H)
        attention_bwd_split<2>(qkv, gs, r2, stats, dm, km);
      else
        attend_bwd<BIG>(qkv, gs, r2, stats, dm, km, bs, o);
      set_sync(clustered);
      if constexpr (GLOBAL_H)
        store_operands(a, dm.ld_h, H, r2, dm.ld_big, 3 * H, images, t, l,
                       &Images::a1, &Images::g_qkv, dm);
      else
        mma_wgrad(a, dm.ld_h, H, r2, dm.ld_big, 3 * H,
                  pw + og.off[2] + (long)l * H * 3 * H,
                  pw + og.off[3] + l * 3 * H, first, dm);
      mma_dense<kBwdStore>(r2, dm.ld_big, PB, wt.w[1] + (long)l * PH * PB,
                           PH, H, nullptr, gs, dm.ld_h, nullptr, nullptr,
                           valid, dm);
      __syncthreads();
      layer_norm_bwd_tile<true>(h, gs, gh, dm);
      __syncthreads();
    }

    // 4. embed: h_0 = R(x @ We + be)
    load_rows(x, row0, valid, IN, r2, dm.ld_x, dm);
    __syncthreads();
    if constexpr (GLOBAL_H)
      store_operands(r2, dm.ld_x, IN, gh, dm.ld_h, H, images, t, -1,
                     &Images::x, &Images::g_embed, dm);
    else
      mma_wgrad(r2, dm.ld_x, IN, gh, dm.ld_h, H, pw + og.off[0],
                pw + og.off[1], first, dm);
    mma_dense<kBwdGlobal>(gh, dm.ld_h, PH, wt.w[0], dm.p_in, IN, nullptr,
                          nullptr, 0, nullptr, dx + row0 * IN, valid, dm);
    __syncthreads();
  }
}

// ---- The GLOBAL_H instance's weight gradients ------------------------------
//
// wgrad_tiles replaces, for the GLOBAL_H instance, the sum that _bwd_kernel
// (categoricalnf_tpu/ops/pallas/fused_transformer.py) keeps in its
// VMEM-resident output blocks across the sequential grid: dW = X^T G and
// db = sum G of the ten dense products (embed; each layer's qkv, proj,
// fc1, fc2; out) over every row, from the operand images the instance left
// (Images).  Each block owns a kWgK x kWgN tile of one product's dW, or
// (the blocks after those) 2 kWgN columns of its db, and sums it over all
// tiles: the tiles' two slices of X and G (of G alone for db) stream
// through a ring of kWgStages stages in shared memory by cp.async,
// fragments by ldmatrix.trans, products on mma.sync.m16n8k16 with fp32
// accumulators, a warp 32 x 32; a thread a column of db.
// The sum order is the shared layout's, so the bits are: that layout's
// persistent block b (of ``grid``) took tiles b, b + grid, ... and kept
// P = 0 + A(b), then P + A(t) for each later tile t, in its slice, and
// reduce_wgrad summed S = ((0 + P_0) + P_1) + ... over the slices; A(t) is
// the chain of tile_pad / 16 mma k-steps from zero accumulators over tile
// t's rows in order (a bias: the fp32 sum of its rows in order, and P =
// A(b) first).  The matrices are rounded to bf16 at the end, the biases stay
// fp32.  Same instruction, fragments and positions give the same A(t); the
// adds are the same adds.
// Bound at runs/moses' node flow (4,608 rows in 192 tiles of 32, hidden
// 256, MLP 512, out 300, 2 layers): the valid rows of X and G at their own
// widths read once, 64.2 MB (4,608 x 6,962 bf16; the images' pad rows and
// columns add nothing), and the 4.5 MB of dw written: 0.0205 ms at 3.35
// TB/s; the 10.4 GFLOP of those rows' products take 0.011 ms at 989
// TFLOP/s.  It is bound by bytes; it reads the 85.7 MB of images, and each
// block reads its two slices of every tile: 440 MB from L2 over its 280 +
// 33 blocks, 2-3 an SM in one wave.  (128 x 128 of dW a block, 278 MB over
// 72 + 17 blocks of 8 warps, one an SM, ran slower on an H100: PERF.md.)
constexpr int kWgK = 64, kWgN = 64;  // a block's tile of dW (rows, cols)
constexpr int kWgThreads = 128;      // 4 warps, each 32 x 32 of it
constexpr int kWgBlocks = 3;         // blocks an SM its launch bounds allow
constexpr int kWgLd = kWgN + 8;  // a slice's rows in shared memory (bf16)
constexpr int kWgStages = 4;     // tiles in flight a block
static_assert(kWgThreads == 2 * kWgN, "a bias block: a thread a column");

// One product of the weight gradients: its images (offsets in a tile,
// widths), its sizes, and where its dW and db go in dw.
struct WgProduct {
  long x, g;
  int wx, wg, kd, n;
  long w, b;
};

// Product p: 0 the embed, 1 + 4 l + q layer l's qkv, proj, fc1, fc2 (q =
// 0 .. 3), 1 + 4 L the output layer.
__host__ __device__ inline WgProduct wg_product(const Dims& dm,
                                                const Images& im,
                                                const Offsets& og, int p) {
  const long H = dm.hidden, RH = dm.mlp;
  if (p == 0)
    return {im.x, im.g_embed, dm.p_in, dm.p_h, dm.in_dim, dm.hidden,
            og.off[0], og.off[1]};
  if (p == 1 + 4 * dm.layers)
    return {im.a_out, im.g, dm.p_h, dm.p_out, dm.hidden, dm.out_dim,
            og.off[10], og.off[11]};
  const long l = (p - 1) / 4, lo = l * im.layer;
  switch ((p - 1) % 4) {
    case 0:
      return {im.a1 + lo, im.g_qkv + lo, dm.p_h, dm.p_big, dm.hidden,
              3 * dm.hidden, og.off[2] + l * H * 3 * H, og.off[3] + l * 3 * H};
    case 1:
      return {im.o + lo, im.g_proj + lo, dm.p_h, dm.p_h, dm.hidden,
              dm.hidden, og.off[4] + l * H * H, og.off[5] + l * H};
    case 2:
      return {im.a2 + lo, im.g_fc1 + lo, dm.p_h, dm.p_f, dm.hidden, dm.mlp,
              og.off[6] + l * H * RH, og.off[7] + l * RH};
    default:
      return {im.m + lo, im.g_fc2 + lo, dm.p_f, dm.p_h, dm.mlp, dm.hidden,
              og.off[8] + l * RH * H, og.off[9] + l * H};
  }
}

// A product's blocks: its dW tiles, and its db's runs of 2 kWgN columns.
__host__ __device__ inline int wg_mat_blocks(const WgProduct& pr) {
  return (pr.kd + kWgK - 1) / kWgK * ((pr.n + kWgN - 1) / kWgN);
}

__host__ __device__ inline int wg_bias_blocks(const WgProduct& pr) {
  return (pr.n + 2 * kWgN - 1) / (2 * kWgN);
}

// wgrad_tiles' grid: every product's dW blocks, then every product's db
// blocks.
__host__ __device__ inline int wg_grid(const Dims& dm) {
  const Images im = images_of(dm);
  const Offsets og = grad_offsets(dm);
  int blocks = 0;
  for (int p = 0; p < 2 + 4 * dm.layers; ++p) {
    const WgProduct pr = wg_product(dm, im, og, p);
    blocks += wg_mat_blocks(pr) + wg_bias_blocks(pr);
  }
  return blocks;
}

__host__ __device__ inline size_t wg_smem_bytes(const Dims& dm) {
  return (size_t)kWgStages * 2 * dm.tile_pad * kWgLd * sizeof(bf16);
}

// 16 bytes from global to shared memory, or 16 zero bytes where !in.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The walk over the tiles in the shared layout's order: slice b (of grid)
// its count tiles b, b + grid, ...; j the current one's place in its slice.
struct TileWalk {
  int per, extra, grid, b, j, count;
  __device__ void start(int ntiles, int g) {
    grid = g;
    per = ntiles / g;
    extra = ntiles % g;
    b = j = 0;
    count = extra > 0 ? per + 1 : per;
  }
  __device__ int tile() const { return b + j * grid; }
  __device__ void next() {
    if (++j == count) {
      j = 0;
      ++b;
      count = b < extra ? per + 1 : per;
    }
  }
};

__global__ void __launch_bounds__(kWgThreads, kWgBlocks)
wgrad_tiles(const bf16* __restrict__ images, float* __restrict__ dw,
            Dims dm, int grid) {
  extern __shared__ __align__(16) unsigned char wg_raw[];
  bf16* ring = reinterpret_cast<bf16*>(wg_raw);
  const Images im = images_of(dm);
  const Offsets og = grad_offsets(dm);
  const int np = 2 + 4 * dm.layers;
  // this block's product and part: a dW tile (k0, c0), or (bias) the db
  // columns c0 .. c0 + 2 kWgN - 1
  int p = 0, blk = blockIdx.x;
  WgProduct pr = wg_product(dm, im, og, 0);
  while (blk >= wg_mat_blocks(pr) && p + 1 < np) {
    blk -= wg_mat_blocks(pr);
    pr = wg_product(dm, im, og, ++p);
  }
  const bool bias = blk >= wg_mat_blocks(pr);
  if (bias) {
    blk -= wg_mat_blocks(pr);
    p = 0;
    pr = wg_product(dm, im, og, 0);
    while (blk >= wg_bias_blocks(pr)) {
      blk -= wg_bias_blocks(pr);
      pr = wg_product(dm, im, og, ++p);
    }
  }
  const int ncb = (pr.n + kWgN - 1) / kWgN;
  const int k0 = bias ? 0 : blk / ncb * kWgK;
  const int c0 = bias ? blk * 2 * kWgN : blk % ncb * kWgN;
  const int TP = dm.tile_pad, stage = 2 * TP * kWgLd;
  const int ntiles = (int)((dm.rows + dm.tile - 1) / dm.tile);
  const int tid = threadIdx.x;
  // this thread's copies of a stage: 16 bytes (chunk ch) of rows tid /
  // (kWgN / 8) + u kWgThreads / (kWgN / 8) of the two slices (X's columns
  // k0 .. k0 + kWgK - 1 then G's c0 .. c0 + kWgN - 1; a bias block: G's
  // c0 .. c0 + kWgN - 1 then the next kWgN), zeros past the images' widths
  constexpr int kChunks = kWgN / 8;
  const int ch = tid % kChunks;
  const auto load = [&](int slot, long tile) {
    const bf16* src = images + tile * im.tile;
    bf16* dst = ring + slot * stage + ch * 8;
    for (int row = tid / kChunks; row < 2 * TP;
         row += kWgThreads / kChunks) {
      const int second = row >= TP, r = second ? row - TP : row;
      const int col = (bias ? c0 + second * kWgN : second ? c0 : k0) + 8 * ch;
      const int w = bias || second ? pr.wg : pr.wx;
      const bool in = col < w;
      cp_async16(dst + row * kWgLd,
                 in ? src + (bias || second ? pr.g : pr.x) + (long)r * w + col
                    : images,
                 in);
    }
  };
  TileWalk fetch, walk;
  fetch.start(ntiles, grid);
  walk.start(ntiles, grid);
#pragma unroll
  for (int i = 0; i < kWgStages - 1; ++i) {
    if (i < ntiles) {
      load(i, fetch.tile());
      fetch.next();
    }
    cp_async_commit();
  }
  if (bias) {
    // a thread a column: P and S of column c0 + tid
    const int c = c0 + tid;
    const bf16* col = ring + (tid >= kWgN) * TP * kWgLd + tid % kWgN;
    float pb = 0.0f, sb = 0.0f;
    for (int i = 0; i < ntiles; ++i) {
      cp_async_wait<kWgStages - 2>();
      __syncthreads();  // stage i landed; stage i - 1's slot is free
      if (i + kWgStages - 1 < ntiles) {
        load((i + kWgStages - 1) % kWgStages, fetch.tile());
        fetch.next();
      }
      cp_async_commit();
      const bf16* gc = col + (i % kWgStages) * stage;
      float sum = 0.0f;
#pragma unroll 8
      for (int r = 0; r < TP; ++r) sum += bf(gc[r * kWgLd]);
      pb = walk.j == 0 ? sum : pb + sum;
      if (walk.j == walk.count - 1) sb += pb;
      walk.next();
    }
    if (c < pr.n) dw[pr.b + c] = sb;
    return;
  }
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, m8 = lane >> 3, l8 = lane & 7;
  const int wk = (warp >> 1) * 32, wc = (warp & 1) * 32;
  // element e of n-tile q of m-tile mt: dW row k0 + wk + 16 mt + g + 8 (e
  // >> 1), column c0 + wc + 8 q + 2 t + (e & 1)
  float P[2][4][4], S[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) P[mt][q][e] = S[mt][q][e] = 0.0f;
  // as mma_wgrad: A[m][kk] = X[16s + kk][k0 + m], B[kk][c] = G[16s + kk][c0
  // + c], each lane's ldmatrix.trans rows
  const int a_off = ((m8 >> 1) * 8 + l8) * kWgLd + wk + (m8 & 1) * 8;
  const int b_off = (TP + (m8 & 1) * 8 + l8) * kWgLd + wc + (m8 >> 1) * 8;
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<kWgStages - 2>();
    __syncthreads();  // stage i landed; stage i - 1's slot is free
    if (i + kWgStages - 1 < ntiles) {
      load((i + kWgStages - 1) % kWgStages, fetch.tile());
      fetch.next();
    }
    cp_async_commit();
    const bf16* st = ring + (i % kWgStages) * stage;
    float acc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][q][e] = 0.0f;
    for (int s = 0; s < TP / 16; ++s) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm_x4_trans(a[mt], st + a_off + s * 16 * kWgLd + 16 * mt);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        uint32_t b[4];
        ldsm_x4_trans(b, st + b_off + s * 16 * kWgLd + 16 * nb);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * nb], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * nb + 1], a[mt], b[2], b[3]);
        }
      }
    }
    const bool first = walk.j == 0, last = walk.j == walk.count - 1;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          P[mt][q][e] = (first ? 0.0f : P[mt][q][e]) + acc[mt][q][e];
          if (last) S[mt][q][e] += P[mt][q][e];
        }
    walk.next();
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + wk + 16 * mt + g + 8 * (e >> 1);
        const int c = c0 + wc + 8 * q + 2 * t + (e & 1);
        if (k < pr.kd && c < pr.n)
          dw[pr.w + (long)k * pr.n + c] = Cd<bf16>::round(S[mt][q][e]);
      }
}

// Shared-memory bytes of one forward block: h and a [tile, ld_h], and the
// region that holds x, then qkv or the MLP hidden layer (all bf16); where
// a set spans a cluster of two, a's region also holds the other block's K
// and V during the attention (split rows of stage_ld), and is the larger
// of the two.
__host__ __device__ inline int fwd_ld_big(const Dims& dm) {
  const int w = dm.ld_big > dm.ld_f ? dm.ld_big : dm.ld_f;
  return w > dm.ld_x ? w : dm.ld_x;
}

__host__ __device__ inline size_t fwd_a_elems(const Dims& dm) {
  const size_t a = (size_t)dm.tile_pad * dm.ld_h;
  const size_t staged = (size_t)dm.split * stage_ld(dm.hidden);
  return dm.cluster == 2 && staged > a ? staged : a;
}

__host__ __device__ inline size_t fwd_smem_bytes(const Dims& dm) {
  return 2 * ((size_t)dm.tile_pad * (dm.ld_h + fwd_ld_big(dm)) +
              fwd_a_elems(dm));
}

// The forward: one block a tile, the same steps as the backward's phase 1
// with one residual stream h.  a holds the LN output, then the attention
// output (the LN output is spent once qkv is made); big holds x, qkv, then
// the MLP hidden layer.  Rows past the last set (tile <= r < tile_pad) and
// past valid hold finite values that no valid row reads: every dense
// product, LN and the epilogues act row by row, and attention within sets.
// BIG as in the backward, with a last, its region the staged copy's too
// (fwd_smem_bytes).
template <bool BIG>
__global__ void __launch_bounds__(kThreads, kFwdBlocks)
fused_set_transformer_fwd(const bf16* __restrict__ x,
                          const unsigned char* __restrict__ key_mask,
                          PadWeights wt, bf16* __restrict__ y, Dims dm) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H = dm.hidden, RH = dm.mlp, L = dm.layers, TP = dm.tile_pad;
  const int PH = dm.p_h, PB = dm.p_big, PF = dm.p_f;
  bf16* h = reinterpret_cast<bf16*>(smem_raw);  // [TP, ld_h] residual
  bf16* a = h + TP * dm.ld_h;                   // [TP, ld_h] LN / attention
  bf16* big = a + TP * dm.ld_h;                 // x, qkv, MLP hidden layer
  if constexpr (BIG) {
    big = a;
    a = big + TP * fwd_ld_big(dm);
  }
  const bool clustered = BIG && dm.cluster == 2;
  long row0;
  int valid;
  BigSet bs;
  tile_rows<BIG>(dm, clustered ? blockIdx.x / 2 : blockIdx.x, key_mask,
                 row0, valid, bs);
  const KeyMask km = {key_mask ? key_mask + row0 : nullptr, valid};

  clear16(smem_raw, (int)fwd_smem_bytes(dm));
  __syncthreads();
  load_rows(x, row0, valid, dm.in_dim, big, dm.ld_x, dm);
  __syncthreads();
  mma_dense<kStore>(big, dm.ld_x, dm.p_in, wt.wt[0], PH, H, wt.b[0], h,
                    dm.ld_h, nullptr, nullptr, valid, dm);
  __syncthreads();
  for (int l = 0; l < L; ++l) {
    layer_norm_tile<kFwdBlocks>(h, a, dm);
    __syncthreads();
    mma_dense<kStore>(a, dm.ld_h, PH, wt.wt[1] + (long)l * PB * PH, PB,
                      3 * H, wt.b[1] + l * 3 * H, big, dm.ld_big, nullptr,
                      nullptr, valid, dm);
    set_sync(clustered);
    attend<BIG, kFwdBlocks>(big, a, dm, km, bs);
    set_sync(clustered);
    mma_dense<kResidual>(a, dm.ld_h, PH, wt.wt[2] + (long)l * PH * PH, PH, H,
                         wt.b[2] + l * H, h, dm.ld_h, nullptr, nullptr, valid,
                         dm);
    __syncthreads();
    layer_norm_tile<kFwdBlocks>(h, a, dm);
    __syncthreads();
    mma_dense<kGelu>(a, dm.ld_h, PH, wt.wt[3] + (long)l * PF * PH, PF, RH,
                     wt.b[3] + l * RH, big, dm.ld_f, nullptr, nullptr, valid,
                     dm);
    __syncthreads();
    mma_dense<kResidual>(big, dm.ld_f, PF, wt.wt[4] + (long)l * PH * PF, PH,
                         H, wt.b[4] + l * H, h, dm.ld_h, nullptr, nullptr,
                         valid, dm);
    __syncthreads();
  }
  // output layer: y = R(R(LN(h_L)) @ Wo + bo), straight to global memory
  layer_norm_tile<kFwdBlocks>(h, a, dm);
  __syncthreads();
  mma_dense<kGlobal>(a, dm.ld_h, PH, wt.wt[5], dm.p_out, dm.out_dim, wt.b[5],
                     nullptr, 0, nullptr, y + row0 * dm.out_dim, valid, dm);
}

// The widths of a call (the caller picks the tile).
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
  dm.p_in = pad16(in_dim);
  dm.p_h = pad16(hidden);
  dm.p_big = pad16(3 * hidden);
  dm.p_f = pad16(mlp);
  dm.p_out = pad16(out_dim);
  // a multiple of 16 elements plus 8: ldmatrix's 16-byte rows at an odd
  // multiple of 16 bytes apart fall in distinct banks
  dm.ld_h = dm.p_h + 8;
  dm.ld_big = dm.p_big + 8;
  dm.ld_f = dm.p_f + 8;
  dm.ld_g = dm.p_out + 8;
  dm.ld_x = dm.p_in + 8;
  int r2 = 2 * dm.ld_f;
  if (dm.ld_big > r2) r2 = dm.ld_big;
  if (dm.ld_g > r2) r2 = dm.ld_g;
  if (dm.ld_x > r2) r2 = dm.ld_x;
  dm.ld_r2 = r2;
  dm.cluster = 1;
  dm.split = set_size;
  return dm;
}

// Whole sets up to `target` rows (one set where a set is larger), padded
// to 16-row m-tiles.
void set_tile(Dims& dm, int target) {
  dm.tile = (target >= dm.set_size ? target / dm.set_size : 1) * dm.set_size;
  dm.tile_pad = pad16(dm.tile);
}

// A set above kMaxSet rows takes a tile of its own, spread over ``cl``
// blocks of a cluster (1: the whole set in one), rank 0 holding the first
// split = ceil(S / cl) rows.  The entries take cl = 1 where the tile is at
// most kTileTarget rows (mma_dense's m-tiles) and its layout fits, else
// 2; returns false where the tile is over kTileTarget rows.
bool split_set(Dims& dm, int cl) {
  dm.cluster = cl;
  dm.split = (dm.set_size + cl - 1) / cl;
  dm.tile = dm.split;
  dm.tile_pad = pad16(dm.tile);
  return dm.tile_pad <= kTileTarget;
}

cudaError_t max_smem_optin(int* max_smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(max_smem,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// The entry points' bodies (below), for the instances of sets up to
// kMaxSet (BIG false) or above (true).
template <bool BIG>
int fwd_entry(const void* x, const void* key_mask, const void* const* w,
              const float* const* b, void* y, long rows, int set_size,
              int in_dim, int hidden, int heads, int layers, int mlp,
              int out_dim, void* stream) {
  if (set_size < 1 || set_size > kMaxBigSet || heads < 1 ||
      hidden % heads || hidden > 32 * kLnVals || rows % set_size ||
      (set_size > kMaxSet) != BIG)
    return (int)cudaErrorInvalidValue;
  Dims dm = make_dims(rows, set_size, in_dim, hidden, heads, layers, mlp,
                      out_dim);
  int max_smem = 0;
  cudaError_t err = max_smem_optin(&max_smem);
  if (err != cudaSuccess) return (int)err;
  // 64-row tiles, or 32-row ones where a net too wide for 64 rows (not the
  // flagship) would not fit in shared memory; a set above kMaxSet rows
  // whole, or over a cluster of two
  size_t smem = 0;
  if constexpr (BIG) {
    bool fits = false;
    for (int cl = 1; cl <= 2 && !fits; ++cl) {
      fits = split_set(dm, cl);
      smem = fwd_smem_bytes(dm);
      fits = fits && smem <= (size_t)max_smem;
    }
    if (!fits) return (int)cudaErrorInvalidValue;
  } else {
    for (int target = kTileTarget; target >= kTileTarget / 2; target /= 2) {
      set_tile(dm, target);
      smem = fwd_smem_bytes(dm);
      if (smem <= (size_t)max_smem) break;
    }
  }
  if (rows == 0) return (int)cudaSuccess;
  const auto kernel = fused_set_transformer_fwd<BIG>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  PadWeights wt;
  for (int j = 0; j < 6; ++j) {
    wt.wt[j] = (const bf16*)w[j];
    wt.w[j] = nullptr;
    wt.b[j] = b[j];
  }
  const unsigned grid =
      dm.cluster == 2 ? (unsigned)(2 * (rows / set_size))
                      : (unsigned)((rows + dm.tile - 1) / dm.tile);
  return (int)launch_clustered(kernel, grid, kThreads, smem,
                               (cudaStream_t)stream, dm.cluster,
                               (const bf16*)x, (const unsigned char*)key_mask,
                               wt, (bf16*)y, dm);
}

template <bool BIG>
int bwd_entry(const void* x, const void* key_mask, const void* g,
              const void* const* w, const float* const* b, void* dx,
              float* part, float* dw, void* hws, long rows, int set_size,
              int in_dim, int hidden, int heads, int layers, int mlp,
              int out_dim, int grid, int global_h, void* stream) {
  if (set_size < 1 || set_size > kMaxBigSet || heads < 1 ||
      hidden % heads || hidden > 32 * kLnVals || grid < 1 ||
      rows % set_size || (set_size > kMaxSet) != BIG)
    return (int)cudaErrorInvalidValue;
  Dims dm = make_dims(rows, set_size, in_dim, hidden, heads, layers, mlp,
                      out_dim);
  int max_smem = 0;
  cudaError_t err = max_smem_optin(&max_smem);
  if (err != cudaSuccess) return (int)err;
  // 64-row tiles, or 32-row ones where a net too wide or deep for 64 rows
  // (not the flagship) would not fit in shared memory; the shared layout
  // first, then the global one
  size_t smem = 0;
  bool fits = false, use_global = false;
  if constexpr (BIG) {
    // a set above kMaxSet rows: the whole set in one block, else over a
    // cluster of two, the residual copies in shared memory (the BIG
    // instance has no global layout)
    if (global_h) return (int)cudaErrorInvalidValue;
    for (int cl = 1; cl <= 2 && !fits; ++cl) {
      fits = split_set(dm, cl);
      smem = smem_bytes(dm, false);
      fits = fits && smem <= (size_t)max_smem;
    }
  } else {
    for (int pass = global_h ? 1 : 0; pass < 2 && !fits; ++pass) {
      use_global = pass == 1;
      for (int target = kTileTarget; target >= kTileTarget / 2;
           target /= 2) {
        set_tile(dm, target);
        smem = smem_bytes(dm, use_global);
        fits = smem <= (size_t)max_smem;
        if (fits) break;
      }
    }
  }
  if (!fits || (use_global && hws == nullptr))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  // a cluster's blocks walk the sets together: an even grid
  const long ntiles = dm.cluster == 2 ? 2 * (rows / set_size)
                                      : (rows + dm.tile - 1) / dm.tile;
  if (grid > ntiles || grid % dm.cluster) return (int)cudaErrorInvalidValue;
  auto kernel = fused_set_transformer_bwd<false, BIG>;
  if constexpr (!BIG)
    if (use_global) kernel = fused_set_transformer_bwd<true, false>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  PadWeights wt;
  for (int j = 0; j < 6; ++j) {
    wt.wt[j] = (const bf16*)w[j];
    wt.w[j] = (const bf16*)w[6 + j];
    wt.b[j] = b[j];
  }
  cudaStream_t s = (cudaStream_t)stream;
  err = launch_clustered(kernel, (unsigned)grid, kThreads, smem, s,
                         dm.cluster, (const bf16*)x,
                         (const unsigned char*)key_mask, (const bf16*)g, wt,
                         (bf16*)dx, part, (bf16*)hws, dm);
  if (err != cudaSuccess) return (int)err;
  // the global layout leaves its operand images in hws: the caller
  // launches wgrad_tiles on them next (wgrad_tiles_bf16)
  if (use_global) return (int)cudaSuccess;
  const Offsets og = grad_offsets(dm);
  reduce_wgrad<bf16><<<(unsigned)((og.off[12] + kThreads - 1) / kThreads),
                       kThreads, 0, s>>>(part, grid, og, dw);
  return (int)cudaGetLastError();
}

int wgrad_entry(const void* images, float* dw, long rows, int set_size,
                int in_dim, int hidden, int layers, int mlp, int out_dim,
                int tile, int grid, void* stream) {
  Dims dm = make_dims(rows, set_size, in_dim, hidden, 1, layers, mlp,
                      out_dim);
  dm.tile = tile;
  dm.tile_pad = pad16(tile);
  if (tile < 1 || dm.tile_pad > kTileTarget || layers < 1 || grid < 1 ||
      rows < 0 || grid > (rows + tile - 1) / tile)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const int blocks = wg_grid(dm);
  const size_t smem = wg_smem_bytes(dm);
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  wgrad_tiles<<<blocks, kWgThreads, smem, (cudaStream_t)stream>>>(
      (const bf16*)images, dw, dm, grid);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Forward in bf16: x [rows, in] (bf16) to y [rows, out] (bf16).  key_mask
// is null or one byte a row of x (0 = a masked key of its set).  w holds
// the 6 forward layouts W^T [pad(n), pad(kd)] of the backward's w (embed,
// qkv, proj, fc1, fc2, out; layer-stacked; zero-padded to multiples of 16),
// b the 6 fp32 biases.
int fused_set_transformer_fwd_bf16(const void* x, const void* key_mask,
                                   const void* const* w,
                                   const float* const* b, void* y, long rows,
                                   int set_size, int in_dim, int hidden,
                                   int heads, int layers, int mlp,
                                   int out_dim, void* stream) {
  const auto entry = set_size > kMaxSet ? fwd_entry<true> : fwd_entry<false>;
  return entry(x, key_mask, w, b, y, rows, set_size, in_dim, hidden, heads,
               layers, mlp, out_dim, stream);
}

// Backward in bf16: x [rows, in] and g [rows, out] in bf16, key_mask as
// the forward's; writes dx
// [rows, in] (bf16) and the 12 fp32 weight gradients, flat in
// flatten_params order (the matrices' rounded to bf16), to dw.  w holds 12
// bf16 matrices: the 6 forward layouts W^T [pad(n), pad(kd)], then the 6
// input-gradient layouts W [pad(kd), pad(n)] (embed, qkv, proj, fc1, fc2,
// out; layer-stacked; zero-padded to multiples of 16); b the 6 fp32
// biases.  part is fp32 scratch of grid x (the size of dw); grid (<= the
// number of tiles) is the number of persistent blocks.  The layout: the
// residual copies in shared memory at 64-row tiles, else at 32-row ones,
// else (or with global_h = 1, which checks that only the storage moves)
// in hws (null where the shared layout is taken), at 64 rows, else 32.
// The global layout takes no part and writes no dw: hws (bf16) holds
// each block's copies of h and its stash, then the tiles' operand images
// (ft.h_workspace_elems, stash_workspace_elems, wgrad_workspace_elems),
// and wgrad_tiles_bf16 on the images, at the same grid, writes dw.  A set above
// 32 rows takes the BIG instance: global_h must be 0 (its residual copies
// stay in shared memory) and grid even where a set spans a cluster of two.
int fused_set_transformer_bwd_bf16(const void* x, const void* key_mask,
                                   const void* g,
                                   const void* const* w,
                                   const float* const* b, void* dx,
                                   float* part, float* dw, void* hws,
                                   long rows, int set_size, int in_dim,
                                   int hidden, int heads, int layers, int mlp,
                                   int out_dim, int grid, int global_h,
                                   void* stream) {
  const auto entry = set_size > kMaxSet ? bwd_entry<true> : bwd_entry<false>;
  return entry(x, key_mask, g, w, b, dx, part, dw, hws, rows, set_size,
               in_dim, hidden, heads, layers, mlp, out_dim, grid, global_h,
               stream);
}

// The weight gradients of the backward's global layout: dw (fp32, flat in
// flatten_params order, the matrices' rounded to bf16) from the operand
// images that fused_set_transformer_bwd_bf16 left in its hws, over the
// ceil(rows / tile) tiles of ``tile`` rows, summed in the order of the
// shared layout's ``grid`` slices (the grid that call was given).
int wgrad_tiles_bf16(const void* images, float* dw, long rows, int set_size,
                     int in_dim, int hidden, int layers, int mlp,
                     int out_dim, int tile, int grid, void* stream) {
  return wgrad_entry(images, dw, rows, set_size, in_dim, hidden, layers, mlp,
                     out_dim, tile, grid, stream);
}

}  // extern "C"
