// Fused SetTransformer forward and backward for Hopper (sm_90a), in fp32 on
// the FMA units: the forward of a differentiable call (kernel #3 of the
// fp32 train step) and the fp32 backward (kernel #4, described where it
// starts, further down).  The forward of a call without grad (the
// eval_model twin) is the 3xTF32 tensor-core kernel of
// fused_transformer_tf32x3.cu; the bf16 forward and backward are the
// tensor-core kernels of fused_transformer_bf16.cu.
//
// Why a differentiable call keeps this forward: its output and the
// backward's recompute are one arithmetic, and the fp32 train step's
// gradients of a data-initialised ActNorm bias and of the mixture offsets
// are so ill-conditioned that any other rounding of the nets' forward (the
// 3xTF32 kernel's, or an fp64 forward rounded once) moves them by 5e-4 to
// 1.4e-3 relative on an H100, past the limits that chip_smoke.py holds
// the train step to (PERF.md, tools/f32_forward_rounding.py).  So every
// output of this pair is bitwise what the first (simple) version of these
// kernels computed: each sum is the same fmaf chain in the same order, and
// the cast points, the reductions of LN and softmax, the tiles, the
// persistent blocks' tiles and the order of the weight-gradient sums are
// that version's.
//
// Replaces the TPU kernel categoricalnf_tpu/ops/pallas/fused_transformer.py
// _fused_fwd (body _fwd_kernel -> _net_forward): the whole coupling net,
// embed -> L x [LN -> QKV -> per-set, per-head attention -> proj +
// residual; LN -> fc1 -> gelu(tanh) -> fc2 + residual] -> LN -> out, for a
// tile of whole sets.
//
// Bound on an H100.  At the flagship width (H=96, 4 heads, 2 blocks, S=16,
// in 4, out 104) the net does about 164k multiply-adds a row, 21.5 GFLOP at
// eval_bpd's 65,536 rows, while it reads 16 B and writes 416 B a row in
// fp32 plus 0.6 MB of weights: it is bound by operations (67 TFLOP/s fp32
// without the tensor cores), not by bytes.
//
// Design.  One block of 256 threads per tile of whole sets (32 rows at
// S=16); no row is carried across blocks and the ragged last tile is
// masked.  The activations of the tile stay in shared memory for the whole
// net (h, an LN/attention buffer, and one buffer for qkv or the MLP hidden
// layer), so the only device-memory traffic is x in, y out and the
// weights, which stay in L2.  Every dense product is register-tiled: a
// thread owns 4 rows x 4 columns of the output, reads its 4 rows' inputs
// as float4 along the contraction (4 steps a load) and the weights as one
// float4 of 4 columns a step, so 16 FMAs take 2 loads where the first
// version took one shared-memory load each.  Neighbouring threads own
// neighbouring rows (a thread's rows are strided by a quarter of the
// tile): their float4 loads of 8 rows fall in distinct banks because every
// shared-memory row is 4 mod 8 floats wide (conflict_free), and the 8
// threads of a warp that share a weight column group read it at once.
// The forward products read W [pad4(kd), pad4(n)] and the input gradients
// W^T [pad4(n), pad4(kd)] (both zero-padded, packed once by the wrapper),
// so each reads its weights along the output.  The weights come from L2,
// whose latency 8 to 16 warps an SM cannot hide: each warp copies the
// weight rows of its column groups into a ring of its own in shared
// memory with cp.async, 3 steps ahead of its products (``ring_chains``;
// where the ring does not fit beside a block's buffers, the loads go
// straight to global memory, one step ahead).  Attention runs per set and
// per head on one lane an item in the forward and two in the backward
// (``pair_swap``), reading the set's keys and values as float4
// broadcasts; LN runs a warp a row, 4 rows of a warp at once.  The cast
// points are the reference's: LN statistics in fp32; every dense output
// once after the fp32 bias add; attention logits and softmax in fp32.
//
// Key mask.  Both entry points take an optional key mask, one byte a row
// of x (0 = the key is masked), as the reference's masked attention: the
// scaled logit of a masked key becomes -1e9 before the row's max, so its
// probability is exactly 0 where any key of the set is valid, and a set
// whose keys are all masked attends uniformly over them.  The backward's
// recompute rebuilds the same probabilities and gives a masked logit no
// gradient.  A null mask leaves every value as it was.
//
// The backward does about 3x the forward's multiply-adds (recompute, dX,
// dW; 4x as written, since it reruns each block's forward once more) and
// moves x, g, dx, the weights and the fp32 weight gradients: it is bound by
// operations too.


#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "fused_transformer.cuh"
#include "fused_transformer_tiles.cuh"

namespace {

constexpr int kThreads = 256;     // the forward's block
constexpr int kBwdThreads = 256;  // the backward's block
constexpr int kRowPad = 8;         // a tile's rows are padded to this
constexpr int kMR = 4;             // rows of a thread's output micro-tile
constexpr int kMC = 4;             // its columns: one float4
constexpr int kMaxSet = 32;        // largest set of the unrolled attention
constexpr int kMaxBigSet = 128;    // largest set of the BIG instances
constexpr int kMaxCluster = 4;     // blocks a set spans at most (BIG)
constexpr int kTileTarget = 32;    // rows a tile aims for (whole sets)
constexpr int kMaxSmem = 232448;   // an H100 block's shared memory
// A dense product's weights come through a ring in shared memory, a warp's
// own: kRingSteps steps of 4 contraction indices in flight (cp.async), of
// the at most kRingCg column groups its 32 items span (a tile pads to 24
// rows or more, so 6 row groups or more).
constexpr int kRingSteps = 4;
constexpr int kRingCg = 6;
constexpr int kRingStage = 4 * kRingCg * 4;          // floats of a step
constexpr int kRingWarp = kRingSteps * kRingStage;   // floats of a warp
constexpr int kLnRows = 4;  // rows a warp of LN normalises at once

// The 6 matrices (embed, qkv, proj, fc1, fc2, out) as wt = W^T [pad4(n),
// pad4(kd)] for the input gradients and w = W [pad4(kd), pad4(n)] for the
// forward products (block weights stacked on a leading layer axis), and
// the 6 fp32 biases.
struct FmaWeights {
  const float* wt[6];
  const float* w[6];
  const float* b[6];
};

struct Dims {
  long rows;
  int set_size, in_dim, hidden, heads, layers, mlp, out_dim;
  int tile, tile_pad;
  // shared-memory rows (floats): h, qkv (the forward's widest buffer), the
  // MLP buffers, the output cotangent, x; the backward's second big region
  int ld_h, ld_big, ld_f, ld_g, ld_x, ld_r2;
  int rings;  // whether the block has its warps' weight rings
  // the backward's regions in its per-block global workspace: the first
  // ws of (the residual copies, the MLP pair, qkv); 0 where all is shared
  int ws;
  // blocks of the cluster a set spans (1: tiles of whole sets) and the
  // set's rows in each of them but the last (BIG)
  int cluster, split;
};

__host__ __device__ inline int pad4(int n) { return (n + 3) / 4 * 4; }

// The smallest width >= n that is 4 mod 8 floats: float4 loads of 8
// neighbouring rows fall in distinct banks.
__host__ __device__ inline int conflict_free(int n) {
  return n + ((4 - n) % 8 + 8) % 8;
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

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float& at(float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

enum Epi { kStore, kResidual, kGelu, kGlobal };

// acc[i][j] += a[i] * w[j] for a thread's micro-tile: one fmaf each, in
// the chain of the output (i, j).
__device__ __forceinline__ void fma_tile(float (&acc)[kMR][kMC],
                                         const float (&a)[kMR],
                                         const float4& w) {
#pragma unroll
  for (int i = 0; i < kMR; ++i) {
    acc[i][0] = fmaf(a[i], w.x, acc[i][0]);
    acc[i][1] = fmaf(a[i], w.y, acc[i][1]);
    acc[i][2] = fmaf(a[i], w.z, acc[i][2]);
    acc[i][3] = fmaf(a[i], w.w, acc[i][3]);
  }
}

// A step of 4 contraction indices: a thread's 4 rows' inputs and 4 weight
// rows of its 4 columns.
struct Step {
  float4 a[kMR];
  float4 w[4];
};

__device__ __forceinline__ void load_step(Step& s, const float* in, int ld_in,
                                          int r0, int rs, int k,
                                          const float* __restrict__ wk,
                                          int ldw) {
#pragma unroll
  for (int i = 0; i < kMR; ++i) s.a[i] = lds4(in + (r0 + i * rs) * ld_in + k);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) s.w[kk] = ldg4(wk + (long)(k + kk) * ldw);
}

__device__ __forceinline__ void fma_step(float (&acc)[kMR][kMC],
                                         const Step& s) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    float a[kMR];
#pragma unroll
    for (int i = 0; i < kMR; ++i) a[i] = at(s.a[i], kk);
    fma_tile(acc, a, s.w[kk]);
  }
}

// The last kd % 4 contraction indices, the weights read from global memory.
__device__ __forceinline__ void tail_chains(const float* in, int ld_in,
                                            int r0, int rs, int k, int kd,
                                            const float* __restrict__ wk,
                                            int ldw,
                                            float (&acc)[kMR][kMC]) {
  for (; k < kd; ++k) {
    const float4 wv = ldg4(wk + (long)k * ldw);
    float a[kMR];
#pragma unroll
    for (int i = 0; i < kMR; ++i) a[i] = in[(r0 + i * rs) * ld_in + k];
    fma_tile(acc, a, wv);
  }
}

// acc[i][j] = sum_k in[r_i, k] * wk[k * ldw + j] for k < kd, one fmaf chain
// an output from 0 in k order; r_i = r0 + i * rs.  The inputs are read as
// float4 along k, the weights as a float4 a step from global memory; the
// next step's loads are issued before this step's products (two buffers,
// in turn).  The path of a block with no room for the rings.
__device__ __forceinline__ void dense_chains(const float* in, int ld_in,
                                             int r0, int rs, int kd,
                                             const float* __restrict__ wk,
                                             int ldw,
                                             float (&acc)[kMR][kMC]) {
#pragma unroll
  for (int i = 0; i < kMR; ++i)
#pragma unroll
    for (int j = 0; j < kMC; ++j) acc[i][j] = 0.0f;
  int k = 0;
  if (kd >= 4) {
    Step s0, s1;
    load_step(s0, in, ld_in, r0, rs, 0, wk, ldw);
    for (; k + 8 <= kd; k += 8) {
      load_step(s1, in, ld_in, r0, rs, k + 4, wk, ldw);
      fma_step(acc, s0);
      if (k + 12 <= kd) load_step(s0, in, ld_in, r0, rs, k + 8, wk, ldw);
      fma_step(acc, s1);
    }
    if (k + 4 <= kd) {  // a last step, in s0
      fma_step(acc, s0);
      k += 4;
    }
  }
  tail_chains(in, ld_in, r0, rs, k, kd, wk, ldw, acc);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// dense_chains with the weights through the warp's ring: its lanes < 4 span
// copy a step's 4 weight rows of the warp's column groups cg_lo .. cg_lo +
// span - 1 (w is the product's column 0) kRingSteps - 1 steps ahead, and
// every lane reads its own float4s of the step from the ring.  The whole
// warp calls it together.
__device__ __forceinline__ void ring_chains(const float* in, int ld_in,
                                            int r0, int rs, int kd,
                                            const float* __restrict__ w,
                                            int ldw, int cg, int cg_lo,
                                            int span, float* ring,
                                            float (&acc)[kMR][kMC]) {
#pragma unroll
  for (int i = 0; i < kMR; ++i)
#pragma unroll
    for (int j = 0; j < kMC; ++j) acc[i][j] = 0.0f;
  const int lane = threadIdx.x % 32, steps = kd / 4;
  const bool copier = lane < 4 * span;
  const int ck = copier ? lane / span : 0, cc = copier ? lane % span : 0;
  const float* src = w + (long)ck * ldw + (cg_lo + cc) * kMC;
  float* dst = ring + (ck * kRingCg + cc) * kMC;
  const float* mine = ring + (cg - cg_lo) * kMC;
#pragma unroll
  for (int t = 0; t < kRingSteps - 1; ++t) {
    if (copier && t < steps)
      cp_async16(dst + t * kRingStage, src + (long)(4 * t) * ldw);
    cp_commit();
  }
  for (int s = 0; s < steps; ++s) {
    const int t = s + kRingSteps - 1;
    if (copier && t < steps)
      cp_async16(dst + (t % kRingSteps) * kRingStage,
                 src + (long)(4 * t) * ldw);
    cp_commit();
    cp_wait<kRingSteps - 1>();  // step s has landed
    __syncwarp();
    const float* ws = mine + (s % kRingSteps) * kRingStage;
    Step st;
#pragma unroll
    for (int i = 0; i < kMR; ++i)
      st.a[i] = lds4(in + (r0 + i * rs) * ld_in + 4 * s);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) st.w[kk] = lds4(ws + kk * kRingCg * kMC);
    fma_step(acc, st);
    __syncwarp();  // before the slot is filled again
  }
  tail_chains(in, ld_in, r0, rs, 4 * steps, kd, w + cg * kMC, ldw, acc);
}

// The chains of item it (of total = nrg x ncg, rows fastest) of a product,
// a lane of the warp whose items start at base: through the warp's ring
// where the block has the rings, else straight from global memory.
__device__ __forceinline__ void item_chains(const float* in, int ld_in,
                                            int kd,
                                            const float* __restrict__ w,
                                            int ldw, int nrg, int total,
                                            int base, int it, float* rings,
                                            float (&acc)[kMR][kMC]) {
  const int rg = it % nrg, cg = it / nrg;
  if (rings == nullptr) {
    dense_chains(in, ld_in, rg, nrg, kd, w + cg * kMC, ldw, acc);
    return;
  }
  const int last = base + 31 < total ? base + 31 : total - 1;
  ring_chains(in, ld_in, rg, nrg, kd, w, ldw, cg, base / nrg,
              last / nrg - base / nrg + 1,
              rings + threadIdx.x / 32 * kRingWarp, acc);
}

// out[r, c] <- epilogue(in[r, :kd] @ w[kd, n] + b[c]) for the tile's rows,
// w = W [pad4(kd), pad4(n)].  Thread item owns rows rg + i * tile_pad / 4
// and columns 4 cg .. 4 cg + 3; neighbouring items take neighbouring rows.
template <int EPI>
__device__ void dense_tile(const float* in, int ld_in, int kd,
                           const float* __restrict__ w,
                           const float* __restrict__ b, int n, float* out,
                           int ld_out, float* __restrict__ gout, int valid,
                           const Dims& dm, float* rings) {
  const int ldw = pad4(n), ncg = ldw / kMC, nrg = dm.tile_pad / kMR;
  const int total = nrg * ncg, lane = threadIdx.x % 32;
  for (int base = threadIdx.x - lane; base < total; base += blockDim.x) {
    const int item = base + lane;
    const int it = item < total ? item : base;
    float acc[kMR][kMC];
    item_chains(in, ld_in, kd, w, ldw, nrg, total, base, it, rings, acc);
    if (item >= total) continue;
    const int rg = it % nrg;
    const int c0 = (it / nrg) * kMC;
    if (EPI != kGlobal && c0 + kMC <= n) {
      const float4 bias = make_float4(b[c0], b[c0 + 1], b[c0 + 2],
                                      b[c0 + 3]);
#pragma unroll
      for (int i = 0; i < kMR; ++i) {
        float* o = out + (rg + i * nrg) * ld_out + c0;
        float4 v = EPI == kResidual ? lds4(o) : make_float4(0, 0, 0, 0);
#pragma unroll
        for (int j = 0; j < kMC; ++j) {
          const float y = acc[i][j] + at(bias, j);
          if constexpr (EPI == kStore) {
            at(v, j) = y;
          } else if constexpr (EPI == kResidual) {
            at(v, j) = at(v, j) + y;
          } else {
            at(v, j) = gelu_tanh(y);
          }
        }
        sts4(o, v);
      }
      continue;
    }
#pragma unroll
    for (int j = 0; j < kMC; ++j) {
      const int c = c0 + j;
      if (c >= n) break;
      const float bias = b[c];
#pragma unroll
      for (int i = 0; i < kMR; ++i) {
        const int r = rg + i * nrg;
        const float y = acc[i][j] + bias;
        if constexpr (EPI == kStore) {
          out[r * ld_out + c] = y;
        } else if constexpr (EPI == kResidual) {
          out[r * ld_out + c] = out[r * ld_out + c] + y;
        } else if constexpr (EPI == kGelu) {
          out[r * ld_out + c] = gelu_tanh(y);
        } else {
          if (r < valid) gout[(long)r * n + c] = y;
        }
      }
    }
  }
}

// A warp's q-th row of the kLnRows it normalises at once, r0 + q * nw, or
// r0 where that is past the tile (computed, not stored).
__device__ __forceinline__ int ln_row(int r0, int q, int nw, const Dims& dm) {
  const int r = r0 + q * nw;
  return r < dm.tile_pad ? r : r0;
}

// LayerNorm without affine, one warp per row, kLnRows rows of a warp at
// once (their reductions interleaved, each in its own order): fp32 mean and
// biased variance.
__device__ void layer_norm_tile(const float* in, float* out, const Dims& dm) {
  const int lane = threadIdx.x % 32, nw = blockDim.x / 32;
  const int h = dm.hidden;
  for (int r0 = threadIdx.x / 32; r0 < dm.tile_pad; r0 += kLnRows * nw) {
    const float* row[kLnRows];
    float s[kLnRows], v[kLnRows], mean[kLnRows], inv[kLnRows];
#pragma unroll
    for (int q = 0; q < kLnRows; ++q) {
      row[q] = in + ln_row(r0, q, nw, dm) * dm.ld_h;
      s[q] = v[q] = 0.0f;
    }
    for (int c = lane; c < h; c += 32)
#pragma unroll
      for (int q = 0; q < kLnRows; ++q) s[q] += row[q][c];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int q = 0; q < kLnRows; ++q)
        s[q] += __shfl_xor_sync(0xffffffffu, s[q], o);
#pragma unroll
    for (int q = 0; q < kLnRows; ++q) mean[q] = s[q] / h;
    for (int c = lane; c < h; c += 32)
#pragma unroll
      for (int q = 0; q < kLnRows; ++q) {
        const float d = row[q][c] - mean[q];
        v[q] = fmaf(d, d, v[q]);
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int q = 0; q < kLnRows; ++q)
        v[q] += __shfl_xor_sync(0xffffffffu, v[q], o);
#pragma unroll
    for (int q = 0; q < kLnRows; ++q) inv[q] = rsqrtf(v[q] / h + 1e-5f);
#pragma unroll
    for (int q = 0; q < kLnRows; ++q) {
      const int r = r0 + q * nw;
      if (r < dm.tile_pad)
        for (int c = lane; c < h; c += 32)
          out[r * dm.ld_h + c] = (row[q][c] - mean[q]) * inv[q];
    }
  }
}

// The attention passes give each (head, row) item to P neighbouring lanes
// (P = 1 or 2): lane part h = lane % P takes the set's rows j = Pm + h of
// the products over d (each one lane's fmaf chain, as a single thread
// computes it) and the chunks d = (Pc + h) V of those over the set, and
// with P = 2 the pair swaps its halves of each set-long vector
// (``pair_swap``), so every value is the one thread's.  The backward runs
// pairs, on all 8 warps where a lane an item fills 4 (its registers have
// room for the swapped vectors); the forward, 16 warps an SM at 128
// registers a thread, runs a lane an item.  Loops over items go a warp at
// a time, so every lane reaches every swap; a lane past the last item
// computes on its warp's first and stores nothing.
constexpr int kBwdLanesPerItem = 2;

// full[j] for the set's rows from each lane's mine[m] = value of row
// Pm + h.
template <int MAXS, int P>
__device__ __forceinline__ void pair_swap(const float (&mine)[MAXS / P],
                                          int half, float (&full)[MAXS]) {
#pragma unroll
  for (int m = 0; m < MAXS / P; ++m) {
    if constexpr (P == 1) {
      full[m] = mine[m];
    } else {
      const float other = __shfl_xor_sync(0xffffffffu, mine[m], 1);
      full[2 * m] = half ? other : mine[m];
      full[2 * m + 1] = half ? mine[m] : other;
    }
  }
}

// The lane's own entry m of a set-long vector: row Pm + h.
template <int MAXS, int P>
__device__ __forceinline__ float own(const float (&full)[MAXS], int m,
                                     int half) {
  if constexpr (P == 1) return full[m];
  return half ? full[2 * m + 1] : full[2 * m];
}

// acc[m] = a . rows[Pm + h] over d < hd for the lane's rows of a set (ld
// apart, j < S), one fmaf chain a row from 0 in d order.
template <int V, int MAXS, int P>
__device__ __forceinline__ void set_dots(const float* a, const float* rows,
                                         int ld, int hd, int S, int half,
                                         float (&acc)[MAXS / P]) {
#pragma unroll
  for (int m = 0; m < MAXS / P; ++m) acc[m] = 0.0f;
  const float* mine = rows + half * ld;
  for (int d = 0; d < hd; d += V) {
    float av[V];
    ldv<V>(av, a + d);
#pragma unroll
    for (int m = 0; m < MAXS / P; ++m) {
      if (P * m + half < S) {
        float bv[V];
        ldv<V>(bv, mine + P * m * ld + d);
#pragma unroll
        for (int u = 0; u < V; ++u) acc[m] = fmaf(av[u], bv[u], acc[m]);
      }
    }
  }
}

// out[d] = sum_j c[j] rows[j][d] over the S rows of a set, one fmaf chain
// an element from 0 in j order, for the lane's chunks of d.
template <int V, int MAXS, int P>
__device__ __forceinline__ void set_combine(const float (&c)[MAXS],
                                            const float* rows, int ld,
                                            int hd, int S, int half,
                                            float* out) {
  for (int d = half * V; d < hd; d += P * V) {
    float acc[V];
#pragma unroll
    for (int u = 0; u < V; ++u) acc[u] = 0.0f;
#pragma unroll
    for (int j = 0; j < MAXS; ++j) {
      if (j < S) {
        float bv[V];
        ldv<V>(bv, rows + j * ld + d);
#pragma unroll
        for (int u = 0; u < V; ++u) acc[u] = fmaf(c[j], bv[u], acc[u]);
      }
    }
    stv<V>(out + d, acc);
  }
}

// The softmax row of query r in head hh over its set, in each lane of the
// item: p[j] (fp32) for j < S, with its max and sum; a masked key's scaled
// logit is -1e9.
template <int V, int MAXS, int P>
__device__ __forceinline__ void attn_row(const float* qkv, int r, int hh,
                                         const Dims& dm, const KeyMask& km,
                                         int half, float (&p)[MAXS],
                                         float& mx, float& sum) {
  const int H = dm.hidden, hd = H / dm.heads, S = dm.set_size;
  const float root_hd = sqrtf((float)hd);
  const int set0 = (r / S) * S;
  float t[MAXS / P];
  set_dots<V, MAXS, P>(qkv + r * dm.ld_big + hh * hd,
                    qkv + set0 * dm.ld_big + H + hh * hd, dm.ld_big, hd, S,
                    half, t);
#pragma unroll
  for (int m = 0; m < MAXS / P; ++m)
    if (P * m + half < S)
      t[m] = key_masked(km, set0 + P * m + half) ? kMaskedLogit
                                                 : t[m] / root_hd;
  pair_swap<MAXS, P>(t, half, p);
  mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < MAXS; ++j)
    if (j < S) mx = fmaxf(mx, p[j]);
#pragma unroll
  for (int m = 0; m < MAXS / P; ++m)
    if (P * m + half < S) t[m] = expf(own<MAXS, P>(p, m, half) - mx);
  pair_swap<MAXS, P>(t, half, p);
  sum = 0.0f;
#pragma unroll
  for (int j = 0; j < MAXS; ++j)
    if (j < S) sum += p[j];
#pragma unroll
  for (int m = 0; m < MAXS / P; ++m)
    if (P * m + half < S) t[m] = own<MAXS, P>(p, m, half) / sum;
  pair_swap<MAXS, P>(t, half, p);
}

// Attention within each set, P lanes per (head, query row).
template <int V, int MAXS, int P>
__device__ void attention_tile(const float* qkv, float* out, const Dims& dm,
                               const KeyMask& km) {
  const int H = dm.hidden, nh = dm.heads, hd = H / nh, S = dm.set_size;
  const int lane = threadIdx.x % 32, half = lane % P;
  const int items = dm.tile * nh;
  for (int base = threadIdx.x / 32 * (32 / P); base < items;
       base += blockDim.x / P) {
    const int item = base + lane / P;
    const int it = item < items ? item : base;
    const int hh = it / dm.tile;
    const int r = it % dm.tile;
    float p[MAXS], mx, sum;
    attn_row<V, MAXS, P>(qkv, r, hh, dm, km, half, p, mx, sum);
    if (item < items)
      set_combine<V, MAXS, P>(
          p, qkv + (r / S) * S * dm.ld_big + 2 * H + hh * hd, dm.ld_big, hd,
          S, half, out + r * dm.ld_h + hh * hd);
  }
}

// The attention passes at the head width's load width (float4 where it is
// a multiple of 4) and the smallest unroll that holds a set, P lanes an
// item.
template <int P>
__device__ __forceinline__ void attention(const float* qkv, float* out,
                                          const Dims& dm, const KeyMask& km) {
  const bool v4 = (dm.hidden / dm.heads) % 4 == 0;
  if (dm.set_size <= 16) {
    if (v4)
      attention_tile<4, 16, P>(qkv, out, dm, km);
    else
      attention_tile<1, 16, P>(qkv, out, dm, km);
  } else {
    if (v4)
      attention_tile<4, kMaxSet, P>(qkv, out, dm, km);
    else
      attention_tile<1, kMaxSet, P>(qkv, out, dm, km);
  }
}

__device__ __forceinline__ void load_x_tile(const float* __restrict__ x,
                                            long row0, int valid, float* dst,
                                            const Dims& dm) {
  for (int i = threadIdx.x; i < dm.tile_pad * dm.ld_x; i += blockDim.x) {
    const int r = i / dm.ld_x, c = i % dm.ld_x;
    dst[i] = r < valid && c < dm.in_dim ? x[(row0 + r) * dm.in_dim + c]
                                        : 0.0f;
  }
}

// Layer offsets of the stacked block matrices (the padded layouts).
__device__ __forceinline__ long layer_stride(int kd, int n) {
  return (long)pad4(kd) * pad4(n);
}

// ---- Sets of 33 to 128 rows (the BIG instances) ---------------------------
//
// A set above kMaxSet rows is a tile of its own over a thread-block cluster
// (make_dims): 2 blocks up to 64 rows, 4 up to 128, dm.split = ceil(S /
// cluster) rows in each block but the last.  So each block keeps the tile
// layout of the sets up to 32 (at most 32 rows padded to 8, the weight
// rings), and every row-wise phase (LN, the dense products, the MLP, the
// weight-gradient partials, one slice a block) runs unchanged.  Attention
// alone crosses blocks, reading the other blocks' rows through distributed
// shared memory between cluster barriers, on register tiles: the
// forward's and the backward's recompute by attention_tiled_big (the
// forward's instance keeps no statistics), the backward's by
// attention_bwd_q_big and attention_bwd_kv_big (below), dQ query-major and
// dK, dV key-major over every block's queries, so that no sum crosses
// blocks.  The two split a set alike and sum the attention in one order,
// so the forward's output is bitwise what the recompute rebuilds, as at
// the sets up to 32.  The backward's persistent
// grid walks the sets a cluster at a time.  The instances without BIG hold
// none of this: their code is the one of the sets up to 32.

// A block's part of a set above kMaxSet rows: its first row in the set,
// its rows, and the set's key mask (null: none).
struct BigSet {
  int offset, n_local;
  const unsigned char* km;
};

// The rows of this block's tile t: tile t of dm.tile rows, or (BIG) its
// rank's part of set t, described in bs too.
template <bool BIG>
__device__ __forceinline__ void tile_rows(const Dims& dm, long t,
                                          const unsigned char* key_mask,
                                          long& row0, int& valid,
                                          BigSet& bs) {
  if constexpr (!BIG) {
    row0 = t * dm.tile;
    const long left = dm.rows - row0;
    valid = left < dm.tile ? (int)left : dm.tile;
  } else {
    bs.offset = (int)cg::this_cluster().block_rank() * dm.split;
    bs.n_local = min(dm.split, dm.set_size - bs.offset);
    bs.km = key_mask ? key_mask + t * dm.set_size : nullptr;
    row0 = t * dm.set_size + bs.offset;
    valid = bs.n_local;
  }
}

// The set's rows of one of this block's buffers (ld apart) over its
// cluster.
__device__ __forceinline__ SetRows<float, kMaxCluster> cluster_rows(
    const float* mine, int ld, const Dims& dm) {
  return set_rows_of<float, kMaxCluster>(mine, ld, dm.split, dm.cluster);
}

// attention_tiled_big on a block's part of a set (STATS: #4's recompute,
// in blocks of kBwdThreads; else #3, of kThreads).
template <int V, int NC, bool STATS>
__device__ __forceinline__ void attend_tiled(
    const float* qkv, const SetRows<float, kMaxCluster>& kv, float* out,
    float* stats, const Dims& dm, const BigSet& bs) {
  attention_tiled_big<V, NC, STATS, (STATS ? kBwdThreads : kThreads) / 32>(
      qkv, dm.ld_big, kv, out, dm.ld_h, stats, dm.tile_pad, dm.hidden,
      dm.heads, dm.set_size, bs.n_local, bs.km);
}

// The attention of a tile between barriers: P lanes an item, the block's
// barriers; BIG over the block's part of its set between cluster barriers
// (the first orders the other blocks' qkv before the reads, the second the
// reads before their next writes), on register tiles (attention_tiled_big,
// at the set's head width and size): #4's recompute (BLOCKS 1) keeps the
// rows' softmax statistics in stats for its backward, #3 (BLOCKS 2) none.
template <bool BIG, int P, int BLOCKS>
__device__ __forceinline__ void attend(const float* qkv, float* out,
                                       const Dims& dm, const KeyMask& km,
                                       const BigSet& bs,
                                       float* stats = nullptr) {
  set_sync(BIG);
  if constexpr (BIG) {
    const SetRows<float, kMaxCluster> kv = cluster_rows(qkv, dm.ld_big, dm);
    const bool v4 = (dm.hidden / dm.heads) % 4 == 0;
    constexpr bool kStats = BLOCKS == 1;
    if (dm.set_size <= 2 * kMaxSet && v4)
      attend_tiled<4, 8, kStats>(qkv, kv, out, stats, dm, bs);
    else if (dm.set_size <= 2 * kMaxSet)
      attend_tiled<1, 8, kStats>(qkv, kv, out, stats, dm, bs);
    else if (v4)
      attend_tiled<4, 16, kStats>(qkv, kv, out, stats, dm, bs);
    else
      attend_tiled<1, 16, kStats>(qkv, kv, out, stats, dm, bs);
  } else {
    attention<P>(qkv, out, dm, km);
  }
  set_sync(BIG);
}

// The forward of a differentiable call: the backward's phase 1 with one
// residual stream and the output layer.  BIG: a block a part of a set, as
// above, the grid a cluster a set.  Two blocks an SM, BIG too: its
// attention spills at 128 registers (a lane's 4 x 16 logits at 128 rows),
// yet ran 1.2-1.4x faster than one block with 255 registers, and as fast
// as its logits in two halves (PERF.md).
template <bool BIG>
__global__ void __launch_bounds__(kThreads, 2)
fused_set_transformer_fwd(const float* __restrict__ x,
                          const unsigned char* __restrict__ key_mask,
                          FmaWeights wt, float* __restrict__ y, Dims dm) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* h = smem;                         // [tile_pad, ld_h] residual
  float* a = h + dm.tile_pad * dm.ld_h;    // [tile_pad, ld_h] LN / attn
  float* big = a + dm.tile_pad * dm.ld_h;  // [tile_pad, ld_big] qkv / mlp
  float* rings = dm.rings ? big + dm.tile_pad * dm.ld_big : nullptr;
  const int H = dm.hidden, RH = dm.mlp;
  long row0;
  int valid;
  BigSet bs{};
  tile_rows<BIG>(dm, BIG ? blockIdx.x / dm.cluster : blockIdx.x, key_mask,
                 row0, valid, bs);
  const KeyMask km = {key_mask ? key_mask + row0 : nullptr, valid};

  load_x_tile(x, row0, valid, big, dm);
  __syncthreads();
  dense_tile<kStore>(big, dm.ld_x, dm.in_dim, wt.w[0], wt.b[0], H, h,
                     dm.ld_h, nullptr, valid, dm, rings);
  __syncthreads();
  for (int l = 0; l < dm.layers; ++l) {
    layer_norm_tile(h, a, dm);
    __syncthreads();
    dense_tile<kStore>(a, dm.ld_h, H, wt.w[1] + l * layer_stride(H, 3 * H),
                       wt.b[1] + l * 3 * H, 3 * H, big, dm.ld_big, nullptr,
                       valid, dm, rings);
    attend<BIG, 1, 2>(big, a, dm, km, bs);
    dense_tile<kResidual>(a, dm.ld_h, H, wt.w[2] + l * layer_stride(H, H),
                          wt.b[2] + l * H, H, h, dm.ld_h, nullptr, valid, dm,
                          rings);
    __syncthreads();
    layer_norm_tile(h, a, dm);
    __syncthreads();
    dense_tile<kGelu>(a, dm.ld_h, H, wt.w[3] + l * layer_stride(H, RH),
                      wt.b[3] + l * RH, RH, big, dm.ld_big, nullptr, valid,
                      dm, rings);
    __syncthreads();
    dense_tile<kResidual>(big, dm.ld_big, RH,
                          wt.w[4] + l * layer_stride(RH, H), wt.b[4] + l * H,
                          H, h, dm.ld_h, nullptr, valid, dm, rings);
    __syncthreads();
  }
  layer_norm_tile(h, a, dm);
  __syncthreads();
  dense_tile<kGlobal>(a, dm.ld_h, H, wt.w[5], wt.b[5], dm.out_dim, nullptr,
                      0, y + row0 * dm.out_dim, valid, dm, rings);
}

// ---------------------------------------------------------------------------
// Backward (kernel #4, fp32): replaces _fused_bwd (body _bwd_kernel), which
// recomputes a tile's forward and pulls the cotangent back with jax.vjp.
// There is no autodiff here, so each backward is written out: dense
// layers, LN without affine (fp32 statistics), tanh-gelu, the softmax per
// set and head and the two attention products, each as autograd through
// plain_forward computes it.
//
// Design.  A persistent grid: each block walks the tiles blockIdx.x,
// blockIdx.x + gridDim.x, ...  For a tile it reruns the forward, keeping
// only the residual stream h at each block boundary in shared memory, then
// walks the blocks in reverse, recomputing each block's internals from its
// h.  dx goes straight to global memory.  Weight gradients are summed in
// fp32 into the block's own slice of a scratch buffer (the first tile
// stores, later ones add; each element always by the same thread), so no
// float atomics are used, and a second kernel sums the slices in a fixed
// order: the result is bitwise deterministic.  The input gradients use the
// forward's register tiles (chains over the output columns, through
// W^T); each weight gradient is a register-tiled outer product over the
// tile's rows in row order, a thread owning 4 k x 4 c, a warp a patch of
// 4 x 8 of those so that its two float4 loads a row move 64 and 128 bytes;
// a thread fetches its scratch slice's old values before its row loop, and
// the scratch goes through L2 as streaming data, so that at a flagship
// batch (80 MB of slices) it does not push the weights out of L2.
//
// Where a block does not fit in shared memory (GraphCNF's node flow at
// hidden 192 and 256, sets of 24: 281,856 and 374,016 B), its [tile, .]
// regions move to the CUDA block's slice of a global workspace, in a
// fixed order until the rest fits (``Dims::ws``): (1) the residual copies
// at the block boundaries 0 .. L - 1, as the bf16 kernel's GLOBAL_H,
// leaving one residual stream in shared memory; (2) the MLP pair f | m;
// (3) qkv.  Hidden 192 moves (1) and (2), 256 all three (about 14
// buffers of width H against the 9.3 a block holds there): 112,128 and
// 223,104 B a block, 14.4 and 29.4 MB at their grids, inside L2.  The
// regions are whole [tile_pad, ld] images read and written by the same
// instructions, so every output is bitwise the shared layout's at the
// same tile and grid; the weight rings stay where they fit beside the
// rest (not at 192 or 256).

// Padded rows (>= valid) carry zero gradients, so they add nothing.

enum BwdEpi { kBwdStore, kBwdGelu, kBwdGlobal };

// out[r, k] <- sum_c g[r, c] * w[k, c] for k < kd: the input gradient of a
// dense layer with weight w [kd, n], read through wt = W^T [pad4(n),
// pad4(kd)].  kBwdGelu multiplies by gelu'(pre-activation held in
// out[r, k]) (the gelu's own backward); kBwdGlobal writes rows < valid to
// gout [rows, kd].
template <int EPI>
__device__ void dense_bwd_tile(const float* g, int ld_g, int n,
                               const float* __restrict__ wt, int kd,
                               float* out, int ld_out,
                               float* __restrict__ gout, int valid,
                               const Dims& dm, float* rings) {
  const int ldw = pad4(kd), nkg = ldw / kMC, nrg = dm.tile_pad / kMR;
  const int total = nrg * nkg, lane = threadIdx.x % 32;
  for (int base = threadIdx.x - lane; base < total; base += blockDim.x) {
    const int item = base + lane;
    const int it = item < total ? item : base;
    float acc[kMR][kMC];
    item_chains(g, ld_g, n, wt, ldw, nrg, total, base, it, rings, acc);
    if (item >= total) continue;
    const int rg = it % nrg;
    const int k0 = (it / nrg) * kMC;
    if (EPI == kBwdStore && k0 + kMC <= kd) {
#pragma unroll
      for (int i = 0; i < kMR; ++i)
        sts4(out + (rg + i * nrg) * ld_out + k0,
             make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
      continue;
    }
#pragma unroll
    for (int j = 0; j < kMC; ++j) {
      const int k = k0 + j;
      if (k >= kd) break;
#pragma unroll
      for (int i = 0; i < kMR; ++i) {
        const int r = rg + i * nrg;
        if constexpr (EPI == kBwdStore) {
          out[r * ld_out + k] = acc[i][j];
        } else if constexpr (EPI == kBwdGelu) {
          float* o = out + r * ld_out + k;
          *o = acc[i][j] * gelu_tanh_grad(*o);
        } else {
          if (r < valid) gout[(long)r * kd + k] = acc[i][j];
        }
      }
    }
  }
}

// The weight and bias gradients of a dense layer over the tile's rows:
// pw[k, c] (+)= sum_r x[r, k] g[r, c] and pb[c] (+)= sum_r g[r, c], into
// this block's fp32 scratch slice; the first tile of the block stores.
// The (k, c) outputs go in micro-tiles of 4 x 4, a warp taking a patch of
// 4 x 8 micro-tiles; then the bias's column groups, one thread each.  A
// micro-tile's old values are asked of L2 and read before its products, as
// float4 where the slice's rows are 16-byte aligned.  The scratch is read
// and written with the streaming cache hint (evict first): at a flagship
// batch the grid's slices (80 MB) are larger than L2, and would push the
// weights out of it.  It is not inlined: with the kernel's other phases
// around it the kernel spilled registers, and took longer
// (tools/fma_variants.py inline_wgrad).
__device__ __noinline__ void wgrad_tile(const float* x, int ld_x, int kd,
                                        const float* g, int ld_g, int n,
                                        float* __restrict__ pw,
                                        float* __restrict__ pb, int valid,
                                        bool first) {
  const int nkg = pad4(kd) / 4, ncg = pad4(n) / 4;
  const int ppc = (ncg + 7) / 8;                      // patches along c
  const int npatch = ppc * ((nkg + 3) / 4);
  const bool vec = n % 4 == 0 && ((size_t)pw & 15) == 0;
  for (int item = threadIdx.x; item < npatch * 32 + ncg;
       item += blockDim.x) {
    if (item >= npatch * 32) {  // a column group of the bias
      const int c0 = (item - npatch * 32) * 4;
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float old[4];
      if (!first)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c0 + j < n) old[j] = __ldcs(pb + c0 + j);
      for (int r = 0; r < valid; ++r) {
        const float4 gv = lds4(g + r * ld_g + c0);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] += at(gv, j);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c0 + j < n) __stcs(pb + c0 + j, first ? acc[j] : old[j] + acc[j]);
      continue;
    }
    const int patch = item / 32, lane = item % 32;
    const int kg = (patch / ppc) * 4 + lane / 8;
    const int cg = (patch % ppc) * 8 + lane % 8;
    if (kg >= nkg || cg >= ncg) continue;
    const int k0 = kg * 4, c0 = cg * 4;
    if (!first) {  // to L2 before the loads, which may be scheduled later
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (k0 + i < kd)
          asm volatile("prefetch.global.L2 [%0];" ::"l"(
              pw + (long)(k0 + i) * n + c0));
    }
    float old[4][4];
    if (!first) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* src = pw + (long)(k0 + i) * n + c0;
        if (k0 + i >= kd) continue;
        if (vec) {
          const float4 v = __ldcs(reinterpret_cast<const float4*>(src));
          old[i][0] = v.x;
          old[i][1] = v.y;
          old[i][2] = v.z;
          old[i][3] = v.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (c0 + j < n) old[i][j] = __ldcs(src + j);
        }
      }
    }
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
    for (int r = 0; r < valid; ++r) {
      const float4 xv = lds4(x + r * ld_x + k0);
      const float4 gv = lds4(g + r * ld_g + c0);
      const float a[4] = {xv.x, xv.y, xv.z, xv.w};
      fma_tile(acc, a, gv);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (k0 + i >= kd) continue;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = first ? acc[i][j] : old[i][j] + acc[i][j];
      float* dst = pw + (long)(k0 + i) * n + c0;
      if (vec) {
        __stcs(reinterpret_cast<float4*>(dst),
               make_float4(v[0], v[1], v[2], v[3]));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c0 + j < n) __stcs(dst + j, v[j]);
      }
    }
  }
}

// Backward of LN without affine, one warp per row, from the forward's
// input x and the output's cotangent g:
// dx = inv * (g - mean(g) - xhat * mean(g * xhat)); with RES it is added
// to gout (the residual branch's gradient).
template <bool RES>
__device__ void layer_norm_bwd_tile(const float* x, const float* g,
                                    float* gout, const Dims& dm) {
  const int lane = threadIdx.x % 32, nw = blockDim.x / 32;
  const int h = dm.hidden;
  for (int r0 = threadIdx.x / 32; r0 < dm.tile_pad; r0 += kLnRows * nw) {
    const float *row[kLnRows], *gr[kLnRows];
    float s[kLnRows], v[kLnRows], mean[kLnRows], inv[kLnRows];
    float sg[kLnRows], sgx[kLnRows], mg[kLnRows], mgx[kLnRows];
#pragma unroll
    for (int q = 0; q < kLnRows; ++q) {
      const int r = ln_row(r0, q, nw, dm);
      row[q] = x + r * dm.ld_h;
      gr[q] = g + r * dm.ld_h;
      s[q] = v[q] = sg[q] = sgx[q] = 0.0f;
    }
    for (int c = lane; c < h; c += 32)
#pragma unroll
      for (int q = 0; q < kLnRows; ++q) s[q] += row[q][c];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int q = 0; q < kLnRows; ++q)
        s[q] += __shfl_xor_sync(0xffffffffu, s[q], o);
#pragma unroll
    for (int q = 0; q < kLnRows; ++q) mean[q] = s[q] / h;
    for (int c = lane; c < h; c += 32)
#pragma unroll
      for (int q = 0; q < kLnRows; ++q) {
        const float d = row[q][c] - mean[q];
        v[q] = fmaf(d, d, v[q]);
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int q = 0; q < kLnRows; ++q)
        v[q] += __shfl_xor_sync(0xffffffffu, v[q], o);
#pragma unroll
    for (int q = 0; q < kLnRows; ++q) inv[q] = rsqrtf(v[q] / h + 1e-5f);
    for (int c = lane; c < h; c += 32)
#pragma unroll
      for (int q = 0; q < kLnRows; ++q) {
        sg[q] += gr[q][c];
        sgx[q] = fmaf(gr[q][c], (row[q][c] - mean[q]) * inv[q], sgx[q]);
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int q = 0; q < kLnRows; ++q) {
        sg[q] += __shfl_xor_sync(0xffffffffu, sg[q], o);
        sgx[q] += __shfl_xor_sync(0xffffffffu, sgx[q], o);
      }
#pragma unroll
    for (int q = 0; q < kLnRows; ++q) {
      mg[q] = sg[q] / h;
      mgx[q] = sgx[q] / h;
    }
#pragma unroll
    for (int q = 0; q < kLnRows; ++q) {
      const int r = r0 + q * nw;
      if (r >= dm.tile_pad) continue;
      for (int c = lane; c < h; c += 32) {
        const float xhat = (row[q][c] - mean[q]) * inv[q];
        const float d = inv[q] * (gr[q][c] - mg[q] - xhat * mgx[q]);
        float* o = gout + r * dm.ld_h + c;
        *o = RES ? *o + d : d;
      }
    }
  }
}

// Attention backward, phase 1: a pair of lanes per (head, query row).
// Writes the query gradient sum_j gl_ij / sqrt(hd) * k_j and keeps the
// row's max, sum and D_i = sum_j p_ij gP_ij for phase 2; gP_ij = go_i .
// v_j is the cotangent of the probabilities.  A masked logit takes no
// gradient.
template <int V, int MAXS>
__device__ void attention_bwd_q(const float* qkv, const float* go,
                                float* gqkv, float* stats, const Dims& dm,
                                const KeyMask& km) {
  const int H = dm.hidden, nh = dm.heads, hd = H / nh, S = dm.set_size;
  const float root_hd = sqrtf((float)hd);
  const int lane = threadIdx.x % 32, half = lane % 2;
  const int items = dm.tile_pad * nh;
  for (int base = threadIdx.x / 32 * 16; base < items;
       base += blockDim.x / 2) {
    const int item = base + lane / 2;
    const int it = item < items ? item : base;
    const int hh = it / dm.tile_pad;
    // rows past the last whole set have no attention: their item computes
    // on row 0 and stores zeros
    const bool pad = it % dm.tile_pad >= dm.tile;
    const int r = pad ? 0 : it % dm.tile_pad;
    const int set0 = (r / S) * S;
    const float* set = qkv + set0 * dm.ld_big + hh * hd;
    float p[MAXS], mx, sum, gp[MAXS], t[MAXS / 2];
    attn_row<V, MAXS, 2>(qkv, r, hh, dm, km, half, p, mx, sum);
    set_dots<V, MAXS, 2>(go + r * dm.ld_h + hh * hd, set + 2 * H, dm.ld_big,
                      hd, S, half, t);
    pair_swap<MAXS, 2>(t, half, gp);
    float D = 0.0f;
#pragma unroll
    for (int j = 0; j < MAXS; ++j)
      if (j < S) D = fmaf(p[j], gp[j], D);
    // the softmax's backward, then the 1/sqrt(hd) scale of the logits
#pragma unroll
    for (int m = 0; m < MAXS / 2; ++m) {
      if (2 * m + half < S) {
        const float pm = own<MAXS, 2>(p, m, half);
        const float gm = own<MAXS, 2>(gp, m, half);
        t[m] = key_masked(km, set0 + 2 * m + half) ? 0.0f
                                                   : pm * (gm - D) / root_hd;
      }
    }
    pair_swap<MAXS, 2>(t, half, gp);
    if (item >= items) continue;
    if (pad) {
      float* gq = gqkv + (it % dm.tile_pad) * dm.ld_big + hh * hd;
      for (int d = half; d < hd; d += 2)
        gq[d] = gq[H + d] = gq[2 * H + d] = 0.0f;
      continue;
    }
    set_combine<V, MAXS, 2>(gp, set + H, dm.ld_big, hd, S, half,
                         gqkv + r * dm.ld_big + hh * hd);
    if (half == 0) {
      float* st = stats + (hh * dm.tile_pad + r) * 3;
      st[0] = mx;
      st[1] = sum;
      st[2] = D;
    }
  }
}

// Phase 2: a pair of lanes per (head, key row j): gk_j = sum_i gl_ij /
// sqrt(hd) * q_i and gv_j = sum_i p_ij go_i, over the queries of j's set,
// with p_ij recomputed from the row statistics of phase 1.
template <int V, int MAXS>
__device__ void attention_bwd_kv(const float* qkv, const float* go,
                                 float* gqkv, const float* stats,
                                 const Dims& dm, const KeyMask& km) {
  const int H = dm.hidden, nh = dm.heads, hd = H / nh, S = dm.set_size;
  const float root_hd = sqrtf((float)hd);
  const int lane = threadIdx.x % 32, half = lane % 2;
  const int items = dm.tile * nh;
  for (int base = threadIdx.x / 32 * 16; base < items;
       base += blockDim.x / 2) {
    const int item = base + lane / 2;
    const int it = item < items ? item : base;
    const int hh = it / dm.tile;
    const int j = it % dm.tile;
    const int set0 = (j / S) * S;
    const bool masked = key_masked(km, j);
    float gl[MAXS], pq[MAXS], a[MAXS / 2], b[MAXS / 2];
    // q_i . k_j and go_i . v_j for the lane's queries i of the set
    set_dots<V, MAXS, 2>(qkv + j * dm.ld_big + H + hh * hd,
                      qkv + set0 * dm.ld_big + hh * hd, dm.ld_big, hd, S,
                      half, a);
    set_dots<V, MAXS, 2>(qkv + j * dm.ld_big + 2 * H + hh * hd,
                      go + set0 * dm.ld_h + hh * hd, dm.ld_h, hd, S, half,
                      b);
#pragma unroll
    for (int m = 0; m < MAXS / 2; ++m) {
      if (2 * m + half < S) {
        const float* st = stats + (hh * dm.tile_pad + set0 + 2 * m + half) * 3;
        const float p = masked ? expf(kMaskedLogit - st[0]) / st[1]
                               : expf(a[m] / root_hd - st[0]) / st[1];
        a[m] = masked ? 0.0f : p * (b[m] - st[2]) / root_hd;
        b[m] = p;
      }
    }
    pair_swap<MAXS, 2>(a, half, gl);
    pair_swap<MAXS, 2>(b, half, pq);
    if (item >= items) continue;
    float* gk = gqkv + j * dm.ld_big + H + hh * hd;
    set_combine<V, MAXS, 2>(gl, qkv + set0 * dm.ld_big + hh * hd, dm.ld_big,
                         hd, S, half, gk);
    set_combine<V, MAXS, 2>(pq, go + set0 * dm.ld_h + hh * hd, dm.ld_h, hd, S,
                         half, gk + H);
  }
}

template <int V, int MAXS>
__device__ __forceinline__ void attention_bwd_at(const float* qkv,
                                                 const float* go, float* gqkv,
                                                 float* stats, const Dims& dm,
                                                 const KeyMask& km) {
  attention_bwd_q<V, MAXS>(qkv, go, gqkv, stats, dm, km);
  __syncthreads();
  attention_bwd_kv<V, MAXS>(qkv, go, gqkv, stats, dm, km);
}

__device__ __forceinline__ void attention_bwd(const float* qkv,
                                              const float* go, float* gqkv,
                                              float* stats, const Dims& dm,
                                              const KeyMask& km) {
  const bool v4 = (dm.hidden / dm.heads) % 4 == 0;
  if (dm.set_size <= 16) {
    if (v4)
      attention_bwd_at<4, 16>(qkv, go, gqkv, stats, dm, km);
    else
      attention_bwd_at<1, 16>(qkv, go, gqkv, stats, dm, km);
  } else {
    if (v4)
      attention_bwd_at<4, kMaxSet>(qkv, go, gqkv, stats, dm, km);
    else
      attention_bwd_at<1, kMaxSet>(qkv, go, gqkv, stats, dm, km);
  }
}

// Attention backward of a set above kMaxSet rows, phase 1 (query-major):
// for this block's query rows, gP = go . v_j, p from the recompute's
// statistics, D_i = sum_j p_ij gP_ij, the logits' cotangent dS = p (gP -
// D) / sqrt(hd) (none for a masked key) and gq = dS . K; D goes to stats.
// Rows past this block's part of the set, to tile_pad, get zero
// gradients.
template <int V, int NC>
__device__ __noinline__ void attention_bwd_q_big(
    const float* qkv, SetRows<float, kMaxCluster> kv, const float* go,
    float* gqkv, float* stats, const Dims& dm, const BigSet& bs) {
  const int H = dm.hidden, nh = dm.heads, hd = H / nh, S = dm.set_size;
  const float inv_root = 1.0f / sqrtf((float)hd);
  const int past = dm.tile_pad - bs.n_local;
  for (int i = threadIdx.x; i < past * 3 * H; i += blockDim.x)
    gqkv[(bs.n_local + i / (3 * H)) * dm.ld_big + i % (3 * H)] = 0.0f;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane & 3, cg = lane >> 2;
  const int mt = (bs.n_local + 15) / 16;
  for (int item = warp; item < nh * mt; item += kBwdThreads / 32) {
    const int hh = item / mt, r0 = item % mt * 16;
    float gp[4][NC], p[4][NC];
    tile_dots<V, NC>(go, dm.ld_h, hh * hd, bs.n_local, r0, kv,
                     2 * H + hh * hd, S, hd, gp);
    tile_dots<V, NC>(qkv, dm.ld_big, hh * hd, bs.n_local, r0, kv,
                     H + hh * hd, S, hd, p);
    float D[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = min(r0 + rg + 4 * i, bs.n_local - 1);
      const float* st = stats + (hh * dm.tile_pad + r) * 3;
      const float mx = st[0], inv_sum = st[1];
      float d = 0.0f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int key = cg + 8 * c;
        p[i][c] = key < S ? expf(logit_of(p[i][c], inv_root, bs.km, key) -
                                 mx) * inv_sum
                          : 0.0f;
        d = fmaf(p[i][c], gp[i][c], d);
      }
      D[i] = row_sum(d);
      // the softmax's backward, then the 1/sqrt(hd) scale of the logits;
      // a masked logit takes none
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int key = cg + 8 * c;
        p[i][c] = key >= S || (bs.km != nullptr && bs.km[key] == 0)
                      ? 0.0f
                      : p[i][c] * (gp[i][c] - D[i]) * inv_root;
      }
    }
    tile_combine<V, NC>(p, kv, H + hh * hd, S, hd, gqkv, dm.ld_big, hh * hd,
                        r0, bs.n_local);
    if (cg == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + rg + 4 * i;
        if (r < bs.n_local) stats[(hh * dm.tile_pad + r) * 3 + 2] = D[i];
      }
    }
  }
}

// Phase 2 (key-major): for this block's key rows j, the logits against
// every query i of the set, p_ij from the query's statistics (qs, gos and
// sts: the set's qkv rows, attention-output cotangents and statistics,
// head 0's, a head's tile_pad rows further, in every block of its
// cluster), gk_j = sum_i dS_ij q_i and gv_j = sum_i p_ij go_i.
template <int V, int NC>
__device__ __noinline__ void attention_bwd_kv_big(
    const float* qkv, SetRows<float, kMaxCluster> qs,
    SetRows<float, kMaxCluster> gos, SetRows<float, kMaxCluster> sts,
    float* gqkv, const Dims& dm, const BigSet& bs) {
  const int H = dm.hidden, nh = dm.heads, hd = H / nh, S = dm.set_size;
  const float inv_root = 1.0f / sqrtf((float)hd);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane & 3, cg = lane >> 2;
  const int mt = (bs.n_local + 15) / 16;
  for (int item = warp; item < nh * mt; item += kBwdThreads / 32) {
    const int hh = item / mt, r0 = item % mt * 16;
    const int st_off = hh * dm.tile_pad * 3;
    float lt[4][NC], gpt[4][NC];
    tile_dots<V, NC>(qkv, dm.ld_big, H + hh * hd, bs.n_local, r0, qs,
                     hh * hd, S, hd, lt);
    tile_dots<V, NC>(qkv, dm.ld_big, 2 * H + hh * hd, bs.n_local, r0, gos,
                     hh * hd, S, hd, gpt);
    bool masked[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = r0 + rg + 4 * i;
      masked[i] = bs.km != nullptr && j < bs.n_local &&
                  bs.km[bs.offset + j] == 0;
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      // a query past the set reads the last one's statistics, no weight
      const int q = cg + 8 * c;
      const float* st = sts.row(min(q, S - 1)) + st_off;
      const float mx = st[0], inv_sum = st[1], D = st[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = 0.0f, ds = 0.0f;
        if (q < S) {
          const float l = masked[i] ? kMaskedLogit
                                    : __fmul_rn(lt[i][c], inv_root);
          p = expf(l - mx) * inv_sum;
          ds = masked[i] ? 0.0f : p * (gpt[i][c] - D) * inv_root;
        }
        lt[i][c] = ds;
        gpt[i][c] = p;
      }
    }
    tile_combine<V, NC>(lt, qs, hh * hd, S, hd, gqkv, dm.ld_big,
                        H + hh * hd, r0, bs.n_local);
    tile_combine<V, NC>(gpt, gos, hh * hd, S, hd, gqkv, dm.ld_big,
                        2 * H + hh * hd, r0, bs.n_local);
  }
}

// Both passes of the attention backward (BIG), with a cluster barrier
// between them, since phase 2 reads the other blocks' cotangents and
// statistics.
template <int V, int NC>
__device__ __forceinline__ void attention_bwd_big(
    const float* qkv, const float* go, float* gqkv, float* stats,
    const Dims& dm, const BigSet& bs) {
  const SetRows<float, kMaxCluster> rows = cluster_rows(qkv, dm.ld_big, dm);
  attention_bwd_q_big<V, NC>(qkv, rows, go, gqkv, stats, dm, bs);
  set_sync(true);
  attention_bwd_kv_big<V, NC>(qkv, rows, cluster_rows(go, dm.ld_h, dm),
                              cluster_rows(stats, 3, dm), gqkv, dm, bs);
}

// The attention backward of a tile; BIG at the set's head width (float4
// rows where it is a multiple of 4) and size (8 or 16 of the set's rows a
// lane).
template <bool BIG>
__device__ __forceinline__ void attend_bwd(const float* qkv, const float* go,
                                           float* gqkv, float* stats,
                                           const Dims& dm, const KeyMask& km,
                                           const BigSet& bs) {
  if constexpr (!BIG) {
    attention_bwd(qkv, go, gqkv, stats, dm, km);
  } else {
    const bool v4 = (dm.hidden / dm.heads) % 4 == 0;
    if (dm.set_size <= 2 * kMaxSet) {
      if (v4)
        attention_bwd_big<4, 8>(qkv, go, gqkv, stats, dm, bs);
      else
        attention_bwd_big<1, 8>(qkv, go, gqkv, stats, dm, bs);
    } else {
      if (v4)
        attention_bwd_big<4, 16>(qkv, go, gqkv, stats, dm, bs);
      else
        attention_bwd_big<1, 16>(qkv, go, gqkv, stats, dm, bs);
    }
  }
}

__device__ __forceinline__ void copy_tile(const float* src, float* dst,
                                          const Dims& dm) {
  for (int i = threadIdx.x * 4; i < dm.tile_pad * dm.ld_h;
       i += blockDim.x * 4)
    sts4(dst + i, lds4(src + i));
}

// Floats of one block's slice of the workspace: the residual copies at
// the block boundaries 0 .. L - 1, the MLP pair, qkv, as far as dm.ws
// moves them.
__host__ __device__ inline long ws_floats(const Dims& dm) {
  long n = 0;
  if (dm.ws >= 1) n += (long)dm.layers * dm.tile_pad * dm.ld_h;
  if (dm.ws >= 2) n += 2L * dm.tile_pad * dm.ld_f;
  if (dm.ws >= 3) n += (long)dm.tile_pad * dm.ld_big;
  return n;
}

// WS: dm.ws > 0, the layout with the workspace ws ([grid, ws_floats]);
// without it (every net that fits) the code is the shared layout's.  BIG:
// the instance for sets above kMaxSet rows (above), its layout all in
// shared memory; a cluster walks the sets, each block its part of one.
template <bool WS, bool BIG>
__global__ void __launch_bounds__(kBwdThreads, 1)
fused_set_transformer_bwd(const float* __restrict__ x,
                          const unsigned char* __restrict__ key_mask,
                          const float* __restrict__ g, FmaWeights wt,
                          float* __restrict__ dx, float* __restrict__ part,
                          float* ws, Dims dm) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int H = dm.hidden, RH = dm.mlp, L = dm.layers, OUT = dm.out_dim;
  const int TP = dm.tile_pad, IN = dm.in_dim;
  const int hsz = TP * dm.ld_h;
  const bool qkv_shared = !WS || dm.ws < 3;
  float* hs = smem;                  // [L + 1] residual streams (WS: one)
  float* gh = hs + (WS ? 1 : L + 1) * hsz;  // d loss / d h
  float* a = gh + hsz;               // LN outputs
  float* o = a + hsz;                // attention output
  float* hm = o + hsz;               // h after the attention residual
  float* gs = hm + hsz;              // ga, ga2, go, ga1
  float* qkv = gs + hsz;             // [TP, ld_big]
  float* r2 = qkv + (qkv_shared ? TP * dm.ld_big : 0);
  // r2 [TP, ld_r2]: f | m (where shared), gqkv, g, x
  float* stats = r2 + TP * dm.ld_r2; // [heads, TP, 3]
  float* rings = dm.rings ? stats + TP * 3 * dm.heads : nullptr;
  float* f = r2;                     // [TP, ld_f] pre-gelu, then its grad
  float* m = r2 + TP * dm.ld_f;      // [TP, ld_f] gelu(f)
  // WS: this block's copies of h at the block boundaries 0 .. L - 1, then
  // f | m and qkv where they moved
  float* hg = nullptr;
  if constexpr (WS) {
    hg = ws + blockIdx.x * ws_floats(dm);
    float* next = hg + (long)L * hsz;
    if (dm.ws >= 2) {
      f = next;
      m = f + TP * dm.ld_f;
      next = m + TP * dm.ld_f;
    }
    if (dm.ws >= 3) qkv = next;
  }
  static_assert(!(WS && BIG), "the BIG instance has no workspace layout");
  const Offsets og = grad_offsets(dm);
  float* pw = part + blockIdx.x * og.off[12];
  const long slot = BIG ? blockIdx.x / dm.cluster : blockIdx.x;
  const long stride = BIG ? gridDim.x / dm.cluster : gridDim.x;
  const long ntiles = BIG ? dm.rows / dm.set_size
                          : (dm.rows + dm.tile - 1) / dm.tile;
  const long s_qkv = layer_stride(H, 3 * H), s_proj = layer_stride(H, H);
  const long s_fc1 = layer_stride(H, RH), s_fc2 = layer_stride(RH, H);

  for (long t = slot; t < ntiles; t += stride) {
    const bool first = t == slot;
    long row0;
    int valid;
    BigSet bs{};
    tile_rows<BIG>(dm, t, key_mask, row0, valid, bs);
    const KeyMask km = {key_mask ? key_mask + row0 : nullptr, valid};

    // 1. forward, keeping h at each block boundary
    load_x_tile(x, row0, valid, r2, dm);
    __syncthreads();
    dense_tile<kStore>(r2, dm.ld_x, IN, wt.w[0], wt.b[0], H, hs, dm.ld_h,
                       nullptr, valid, dm, rings);
    __syncthreads();
    for (int l = 0; l < L; ++l) {
      float* h = hs;
      if constexpr (WS) {
        copy_tile(hs, hg + (long)l * hsz, dm);  // h_l, kept for phase 3
      } else {
        h = hs + (l + 1) * hsz;
        copy_tile(hs + l * hsz, h, dm);
      }
      __syncthreads();
      layer_norm_tile(h, a, dm);
      __syncthreads();
      dense_tile<kStore>(a, dm.ld_h, H, wt.w[1] + l * s_qkv,
                         wt.b[1] + l * 3 * H, 3 * H, qkv, dm.ld_big, nullptr,
                         valid, dm, rings);
      attend<BIG, kBwdLanesPerItem, 1>(qkv, o, dm, km, bs, stats);
      dense_tile<kResidual>(o, dm.ld_h, H, wt.w[2] + l * s_proj,
                            wt.b[2] + l * H, H, h, dm.ld_h, nullptr, valid,
                            dm, rings);
      __syncthreads();
      layer_norm_tile(h, a, dm);
      __syncthreads();
      dense_tile<kGelu>(a, dm.ld_h, H, wt.w[3] + l * s_fc1,
                        wt.b[3] + l * RH, RH, m, dm.ld_f, nullptr, valid, dm,
                        rings);
      __syncthreads();
      dense_tile<kResidual>(m, dm.ld_f, RH, wt.w[4] + l * s_fc2,
                            wt.b[4] + l * H, H, h, dm.ld_h, nullptr, valid,
                            dm, rings);
      __syncthreads();
    }

    // 2. output layer: y = dense(LN(h_L)); h_L is the last copy, or the
    // one residual stream (WS)
    const float* h_last = hs + (WS ? 0 : L) * hsz;
    layer_norm_tile(h_last, a, dm);
    for (int i = threadIdx.x; i < TP * OUT; i += blockDim.x) {
      const int r = i / OUT, c = i % OUT;
      r2[r * dm.ld_g + c] = r < valid ? g[row0 * OUT + i] : 0.0f;
    }
    __syncthreads();
    wgrad_tile(a, dm.ld_h, H, r2, dm.ld_g, OUT, pw + og.off[10],
               pw + og.off[11], valid, first);
    dense_bwd_tile<kBwdStore>(r2, dm.ld_g, OUT, wt.wt[5], H, gs, dm.ld_h,
                              nullptr, valid, dm, rings);
    __syncthreads();
    layer_norm_bwd_tile<false>(h_last, gs, gh, dm);
    __syncthreads();

    // 3. the blocks in reverse, each recomputed from its input h
    for (int l = L - 1; l >= 0; --l) {
      const float* h = hs;
      if constexpr (WS) {
        copy_tile(hg + (long)l * hsz, hs, dm);  // h_l back from phase 1
        __syncthreads();
      } else {
        h = hs + l * hsz;
      }
      layer_norm_tile(h, a, dm);
      copy_tile(h, hm, dm);
      __syncthreads();
      dense_tile<kStore>(a, dm.ld_h, H, wt.w[1] + l * s_qkv,
                         wt.b[1] + l * 3 * H, 3 * H, qkv, dm.ld_big, nullptr,
                         valid, dm, rings);
      attend<BIG, kBwdLanesPerItem, 1>(qkv, o, dm, km, bs, stats);
      dense_tile<kResidual>(o, dm.ld_h, H, wt.w[2] + l * s_proj,
                            wt.b[2] + l * H, H, hm, dm.ld_h, nullptr, valid,
                            dm, rings);
      __syncthreads();
      layer_norm_tile(hm, a, dm);
      __syncthreads();
      dense_tile<kStore>(a, dm.ld_h, H, wt.w[3] + l * s_fc1,
                         wt.b[3] + l * RH, RH, f, dm.ld_f, nullptr, valid,
                         dm, rings);
      __syncthreads();
      for (int i = threadIdx.x; i < TP * RH; i += blockDim.x) {
        const int r = i / RH, c = i % RH;
        m[r * dm.ld_f + c] = gelu_tanh(f[r * dm.ld_f + c]);
      }
      __syncthreads();
      // MLP: h_out = hm + (m @ W2 + b2), m = gelu(f)
      wgrad_tile(m, dm.ld_f, RH, gh, dm.ld_h, H, pw + og.off[8] +
                 (long)l * RH * H, pw + og.off[9] + l * H, valid, first);
      dense_bwd_tile<kBwdGelu>(gh, dm.ld_h, H, wt.wt[4] + l * s_fc2, RH, f,
                               dm.ld_f, nullptr, valid, dm, rings);
      __syncthreads();
      wgrad_tile(a, dm.ld_h, H, f, dm.ld_f, RH, pw + og.off[6] +
                 (long)l * H * RH, pw + og.off[7] + l * RH, valid, first);
      dense_bwd_tile<kBwdStore>(f, dm.ld_f, RH, wt.wt[3] + l * s_fc1, H, gs,
                                dm.ld_h, nullptr, valid, dm, rings);
      __syncthreads();
      layer_norm_bwd_tile<true>(hm, gs, gh, dm);
      __syncthreads();
      // attention: hm = h + (o @ Wp + bp)
      wgrad_tile(o, dm.ld_h, H, gh, dm.ld_h, H, pw + og.off[4] +
                 (long)l * H * H, pw + og.off[5] + l * H, valid, first);
      dense_bwd_tile<kBwdStore>(gh, dm.ld_h, H, wt.wt[2] + l * s_proj, H, gs,
                                dm.ld_h, nullptr, valid, dm, rings);
      layer_norm_tile(h, a, dm);  // a1 again, for the qkv weights
      __syncthreads();
      attend_bwd<BIG>(qkv, gs, r2, stats, dm, km, bs);
      set_sync(BIG);
      wgrad_tile(a, dm.ld_h, H, r2, dm.ld_big, 3 * H, pw + og.off[2] +
                 (long)l * H * 3 * H, pw + og.off[3] + l * 3 * H, valid,
                 first);
      dense_bwd_tile<kBwdStore>(r2, dm.ld_big, 3 * H, wt.wt[1] + l * s_qkv,
                                H, gs, dm.ld_h, nullptr, valid, dm, rings);
      __syncthreads();
      layer_norm_bwd_tile<true>(h, gs, gh, dm);
      __syncthreads();
    }

    // 4. embed: h_0 = x @ We + be
    load_x_tile(x, row0, valid, r2, dm);
    __syncthreads();
    wgrad_tile(r2, dm.ld_x, IN, gh, dm.ld_h, H, pw + og.off[0],
               pw + og.off[1], valid, first);
    dense_bwd_tile<kBwdGlobal>(gh, dm.ld_h, H, wt.wt[0], IN, nullptr, 0,
                               dx + row0 * IN, valid, dm, rings);
    __syncthreads();
  }
}

void set_bwd_regions(Dims& dm, int ws);

// The tile and shared-memory rows of a net, as both kernels lay them out
// (ops/cuda/fused_transformer.py bwd_layout and fma_fwd_shape mirror
// them): tiles of whole sets up to kTileTarget rows for sets up to kMaxSet,
// or (big) a set of kMaxSet + 1 .. kMaxBigSet rows over a cluster of 2
// blocks up to 64 rows and of kMaxCluster above, ceil(S / cluster) rows a
// block.
bool make_dims(Dims& dm, long rows, int set_size, int in_dim, int hidden,
               int heads, int layers, int mlp, int out_dim, bool big) {
  if (set_size < 1 || set_size > kMaxBigSet || (set_size > kMaxSet) != big ||
      heads < 1 || hidden % heads || rows % set_size || in_dim < 1 ||
      out_dim < 1 || layers < 0 || mlp < 1)
    return false;
  dm.rows = rows;
  dm.set_size = set_size;
  dm.in_dim = in_dim;
  dm.hidden = hidden;
  dm.heads = heads;
  dm.layers = layers;
  dm.mlp = mlp;
  dm.out_dim = out_dim;
  dm.cluster = big ? (set_size <= 2 * kMaxSet ? 2 : kMaxCluster) : 1;
  dm.split = (set_size + dm.cluster - 1) / dm.cluster;
  dm.tile = big ? dm.split
                : (kTileTarget >= set_size ? kTileTarget / set_size : 1) *
                      set_size;
  dm.tile_pad = (dm.tile + kRowPad - 1) / kRowPad * kRowPad;
  dm.ld_h = conflict_free(hidden);
  dm.ld_big = conflict_free(3 * hidden);
  dm.ld_f = conflict_free(mlp);
  dm.ld_g = conflict_free(out_dim);
  dm.ld_x = pad4(in_dim);
  dm.rings = 0;
  set_bwd_regions(dm, 0);
  return true;
}

// The backward's layout with its first ``ws`` regions in the global
// workspace (see fused_set_transformer_bwd): r2 holds the MLP pair where
// it stays in shared memory, and always the qkv gradient, g and x.
void set_bwd_regions(Dims& dm, int ws) {
  dm.ws = ws;
  int r2 = ws >= 2 ? 0 : 2 * dm.ld_f;
  if (dm.ld_big > r2) r2 = dm.ld_big;
  if (dm.ld_g > r2) r2 = dm.ld_g;
  if (dm.ld_x > r2) r2 = dm.ld_x;
  dm.ld_r2 = r2;
}

// Shared-memory floats of one backward block without the weight rings:
// the residual copies at the L + 1 block boundaries (one stream where they
// are in the workspace), five [tile, ld_h] buffers, qkv (where it is
// shared), r2 and the softmax statistics.
size_t bwd_smem_floats(const Dims& dm) {
  const int copies = dm.ws >= 1 ? 1 : dm.layers + 1;
  const int qkv = dm.ws >= 3 ? 0 : dm.ld_big;
  return (size_t)dm.tile_pad *
         ((copies + 5) * dm.ld_h + qkv + dm.ld_r2 + 3 * dm.heads);
}

// The backward's layout: the first of 0, 1, 2, 3 regions in the workspace
// with which its buffers fit in shared memory (3 with ``all_global``, which
// checks that only the storage moves); false where none fits.
bool pick_bwd_regions(Dims& dm, bool all_global) {
  for (int ws = all_global ? 3 : 0; ws <= 3; ++ws) {
    set_bwd_regions(dm, ws);
    if (sizeof(float) * bwd_smem_floats(dm) <= (size_t)kMaxSmem) return true;
  }
  return false;
}

// The bytes of a block of `threads` with `floats` of buffers and, where
// they fit beside them, its warps' weight rings (dm.rings).  A ring holds
// the column groups of 32 items of 6 row groups or more, so of tiles
// padded to 24 rows or more: every tile of whole sets of up to 32.
size_t with_rings(size_t floats, int threads, Dims& dm) {
  const size_t bytes = sizeof(float) * floats;
  const size_t rings = sizeof(float) * (size_t)(threads / 32) * kRingWarp;
  dm.rings = bytes + rings <= (size_t)kMaxSmem &&
             dm.tile_pad >= kRingCg * kMR;
  return dm.rings ? bytes + rings : bytes;
}

// The forward's shared memory: h, the LN/attention output and the widest
// of x, qkv and the MLP hidden layer (which share one buffer, dm.ld_big
// widened to it), and the rings where they fit.
size_t fwd_smem(Dims& dm) {
  int big = dm.ld_big > dm.ld_f ? dm.ld_big : dm.ld_f;
  if (dm.ld_x > big) big = dm.ld_x;
  dm.ld_big = big;
  return with_rings((size_t)dm.tile_pad * (2 * dm.ld_h + dm.ld_big), kThreads,
                    dm);
}

FmaWeights fma_weights(const void* const* w, const float* const* b) {
  FmaWeights wt;
  for (int j = 0; j < 6; ++j) {
    wt.wt[j] = (const float*)w[j];
    wt.w[j] = (const float*)w[6 + j];
    wt.b[j] = b[j];
  }
  return wt;
}

// The fp32 backward at a set of up to kMaxSet rows, behind the arguments
// of fused_set_transformer_bwd_f32: its layout (every region in shared
// memory where it fits, else regions in ws; global_ws = 1 moves all
// three) launched on the instance WS of that layout, whose entry lives in
// its own source so that the two build in parallel; a layout of the other
// instance is refused.
template <bool WS>
int bwd_f32_entry(const void* x, const void* key_mask, const void* g,
                  const void* const* w, const float* const* b, void* dx,
                  float* part, float* dw, void* ws, long rows, int set_size,
                  int in_dim, int hidden, int heads, int layers, int mlp,
                  int out_dim, int grid, int global_ws, void* stream) {
  Dims dm;
  if (!make_dims(dm, rows, set_size, in_dim, hidden, heads, layers, mlp,
                 out_dim, false) ||
      grid < 1 || !pick_bwd_regions(dm, global_ws) || (dm.ws > 0) != WS)
    return (int)cudaErrorInvalidValue;
  if (dm.ws > 0 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = with_rings(bwd_smem_floats(dm), kBwdThreads, dm);
  if (rows == 0) return (int)cudaSuccess;
  const long ntiles = (rows + dm.tile - 1) / dm.tile;
  if (grid > ntiles) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  fused_set_transformer_bwd<WS, false><<<grid, kBwdThreads, smem, s>>>(
      (const float*)x, (const unsigned char*)key_mask, (const float*)g,
      fma_weights(w, b), (float*)dx, part, (float*)ws, dm);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Offsets og = grad_offsets(dm);
  reduce_wgrad<float><<<(unsigned)((og.off[12] + kThreads - 1) / kThreads),
                        kThreads, 0, s>>>(part, grid, og, dw);
  return (int)cudaGetLastError();
}

}  // namespace
