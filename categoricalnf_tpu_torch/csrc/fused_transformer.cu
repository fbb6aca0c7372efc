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
// the train step to (PERF.md, tools/f32_forward_rounding.py).
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
// Design (first, simple version).  One block of 256 threads per tile of
// whole sets (32 rows at S=16); no row is carried across blocks and the
// ragged last tile is masked.  The activations of the tile stay in shared
// memory for the whole net (h, an LN/attention buffer, and one buffer for
// qkv or the MLP hidden layer: 62 KB at the flagship tile), so the only
// device-memory traffic is x in, y out and the weights, which every block
// reads from global memory and which stay in L2.  The products are fp32
// FMAs and never use TF32.  The kernels are templates on the compute dtype
// (the helpers of fused_transformer.cuh round to it), built for fp32 only.
// Attention runs per set and per head (the TPU kernel's block-diagonal
// over-compute existed only for its matrix unit).  Leading dimensions in
// shared memory are odd, so the attention's row-strided reads do not
// collide in one bank.  The cast points are the reference's: LN statistics
// in fp32 and its output in the compute dtype; every dense output rounded
// once after the fp32 bias add; the residual add rounded in the compute
// dtype; attention logits and softmax in fp32, the probabilities rounded
// before A.V; head outputs rounded at the proj input.
//
// The backward does about 3x the forward's multiply-adds (recompute, dX,
// dW; 4x as written, since it reruns each block's forward once more) and
// moves x, g, dx, the weights and the fp32 weight gradients: it is bound by
// operations too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "fused_transformer.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 8;  // rows of one dense output per thread
constexpr int kMaxSet = 32;        // largest set size attention handles
constexpr int kTileTarget = 32;    // rows a tile aims for (whole sets)

// The 12 tensors of flatten_params: matrices in the compute dtype, biases
// fp32; block weights stacked on a leading layer axis.
template <typename T>
struct Weights {
  const T* embed_w; const float* embed_b;
  const T* qkv_w;   const float* qkv_b;
  const T* proj_w;  const float* proj_b;
  const T* fc1_w;   const float* fc1_b;
  const T* fc2_w;   const float* fc2_b;
  const T* out_w;   const float* out_b;
};

struct Dims {
  long rows;
  int set_size, in_dim, hidden, heads, layers, mlp, out_dim;
  int tile, tile_pad, ld_h, ld_big;
  int ld_f, ld_r2;  // backward only: MLP buffers, the second big region
};

enum Epi { kStore, kResidual, kGelu, kGlobal };

// out[r, c] <- epilogue(in[r, :kd] @ w[kd, n] + b[c]) for the tile's rows.
// Threads walk (column, group of 8 rows): neighbouring threads read
// neighbouring weight columns, and the rows of `in` are broadcast.
template <typename T, int EPI>
__device__ void dense_tile(const float* in, int ld_in, int kd,
                           const T* __restrict__ w,
                           const float* __restrict__ b, int n, float* out,
                           int ld_out, T* __restrict__ gout, int valid,
                           const Dims& dm) {
  const int groups = dm.tile_pad / kRowsPerThread;
  for (int item = threadIdx.x; item < n * groups; item += blockDim.x) {
    const int c = item % n;
    const int r0 = (item / n) * kRowsPerThread;
    float acc[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.0f;
    for (int k = 0; k < kd; ++k) {
      const float wv = Cd<T>::load(w, (long)k * n + c);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        acc[i] = fmaf(in[(r0 + i) * ld_in + k], wv, acc[i]);
    }
    const float bias = b[c];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = r0 + i;
      const float v = Cd<T>::round(acc[i] + bias);
      if constexpr (EPI == kStore) {
        out[r * ld_out + c] = v;
      } else if constexpr (EPI == kResidual) {
        out[r * ld_out + c] = Cd<T>::round(out[r * ld_out + c] + v);
      } else if constexpr (EPI == kGelu) {
        out[r * ld_out + c] = Cd<T>::round(gelu_tanh(v));
      } else {
        if (r < valid) gout[(long)r * n + c] = Cd<T>::store(acc[i] + bias);
      }
    }
  }
}

// LayerNorm without affine, one warp per row: fp32 mean and biased
// variance, output rounded to the compute dtype.
template <typename T>
__device__ void layer_norm_tile(const float* in, float* out, const Dims& dm) {
  const int lane = threadIdx.x % 32;
  const int h = dm.hidden;
  for (int r = threadIdx.x / 32; r < dm.tile_pad; r += blockDim.x / 32) {
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
      out[r * dm.ld_h + c] = Cd<T>::round((row[c] - mean) * inv);
  }
}

// Attention within each set, one thread per (head, query row).
template <typename T>
__device__ void attention_tile(const float* qkv, float* out, const Dims& dm) {
  const int H = dm.hidden, nh = dm.heads, hd = H / nh, S = dm.set_size;
  const float root_hd = sqrtf((float)hd);
  for (int item = threadIdx.x; item < dm.tile * nh; item += blockDim.x) {
    const int hh = item / dm.tile;
    const int r = item % dm.tile;
    const int set0 = (r / S) * S;
    const float* q = qkv + r * dm.ld_big + hh * hd;
    float p[kMaxSet];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxSet; ++j) {
      if (j < S) {
        const float* kr = qkv + (set0 + j) * dm.ld_big + H + hh * hd;
        float dot = 0.0f;
        for (int d = 0; d < hd; ++d) dot = fmaf(q[d], kr[d], dot);
        p[j] = dot / root_hd;
        mx = fmaxf(mx, p[j]);
      }
    }
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxSet; ++j) {
      if (j < S) {
        p[j] = expf(p[j] - mx);
        sum += p[j];
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxSet; ++j)
      if (j < S) p[j] = Cd<T>::round(p[j] / sum);
    const float* v0 = qkv + set0 * dm.ld_big + 2 * H + hh * hd;
    for (int d = 0; d < hd; ++d) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxSet; ++j)
        if (j < S) acc = fmaf(p[j], v0[j * dm.ld_big + d], acc);
      out[r * dm.ld_h + hh * hd + d] = Cd<T>::round(acc);
    }
  }
}

// The forward of a differentiable call: the backward's phase 1 with one
// residual stream and the output layer.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_set_transformer_fwd(const T* __restrict__ x, Weights<T> wt,
                          T* __restrict__ y, Dims dm) {
  extern __shared__ float smem[];
  float* h = smem;                         // [tile_pad, ld_h] residual
  float* a = h + dm.tile_pad * dm.ld_h;    // [tile_pad, ld_h] LN / attn
  float* big = a + dm.tile_pad * dm.ld_h;  // [tile_pad, ld_big] qkv / mlp
  const int H = dm.hidden, RH = dm.mlp;
  const long row0 = blockIdx.x * (long)dm.tile;
  const long left = dm.rows - row0;
  const int valid = left < dm.tile ? (int)left : dm.tile;

  for (int i = threadIdx.x; i < dm.tile_pad * dm.in_dim; i += blockDim.x) {
    const int r = i / dm.in_dim;
    big[i] = r < valid ? Cd<T>::load(x, row0 * dm.in_dim + i) : 0.0f;
  }
  __syncthreads();
  dense_tile<T, kStore>(big, dm.in_dim, dm.in_dim, wt.embed_w, wt.embed_b, H,
                        h, dm.ld_h, nullptr, valid, dm);
  __syncthreads();
  for (int l = 0; l < dm.layers; ++l) {
    layer_norm_tile<T>(h, a, dm);
    __syncthreads();
    dense_tile<T, kStore>(a, dm.ld_h, H, wt.qkv_w + (long)l * H * 3 * H,
                          wt.qkv_b + l * 3 * H, 3 * H, big, dm.ld_big,
                          nullptr, valid, dm);
    __syncthreads();
    attention_tile<T>(big, a, dm);
    __syncthreads();
    dense_tile<T, kResidual>(a, dm.ld_h, H, wt.proj_w + (long)l * H * H,
                             wt.proj_b + l * H, H, h, dm.ld_h, nullptr,
                             valid, dm);
    __syncthreads();
    layer_norm_tile<T>(h, a, dm);
    __syncthreads();
    dense_tile<T, kGelu>(a, dm.ld_h, H, wt.fc1_w + (long)l * H * RH,
                         wt.fc1_b + l * RH, RH, big, dm.ld_big, nullptr,
                         valid, dm);
    __syncthreads();
    dense_tile<T, kResidual>(big, dm.ld_big, RH, wt.fc2_w + (long)l * RH * H,
                             wt.fc2_b + l * H, H, h, dm.ld_h, nullptr, valid,
                             dm);
    __syncthreads();
  }
  layer_norm_tile<T>(h, a, dm);
  __syncthreads();
  dense_tile<T, kGlobal>(a, dm.ld_h, H, wt.out_w, wt.out_b, dm.out_dim,
                         nullptr, 0, y + row0 * dm.out_dim, valid, dm);
}

// ---------------------------------------------------------------------------
// Backward (kernel #4, fp32): replaces _fused_bwd (body _bwd_kernel), which
// recomputes a tile's forward and pulls the cotangent back with jax.vjp.
// There is no autodiff here, so each backward is written out: dense
// layers, LN without affine (fp32 statistics), tanh-gelu, the softmax per
// set and head and the two attention products.  Each cotangent is rounded
// to the compute dtype where the forward rounds its primal (the transpose
// of each cast), as autograd through plain_forward does.
//
// Design.  A persistent grid: each block walks the tiles blockIdx.x,
// blockIdx.x + gridDim.x, ...  For a tile it reruns the forward, keeping
// only the residual stream h at each block boundary in shared memory, then
// walks the blocks in reverse, recomputing each block's internals from its
// h.  dx goes straight to global memory.  Weight gradients are summed in
// fp32 into the block's own slice of a scratch buffer (the first tile
// stores, later ones add; each element always by the same thread), so no
// float atomics are used, and a second kernel sums the slices in a fixed
// order: the result is bitwise deterministic.

// Padded rows (>= valid) carry zero gradients, so they add nothing.

enum BwdEpi { kBwdStore, kBwdGelu, kBwdGlobal };

// out[r, k] <- R(sum_c g[r, c] * w[k, c]) for k < kd: the input gradient
// of a dense layer with weight w [kd, n].  kBwdGelu multiplies by
// gelu'(pre-activation held in out[r, k]) and rounds again (the gelu's
// own backward); kBwdGlobal writes rows < valid to gout [rows, kd].
template <typename T, int EPI>
__device__ void dense_bwd_tile(const float* g, int ld_g, int n,
                               const T* __restrict__ w, int kd, float* out,
                               int ld_out, T* __restrict__ gout, int valid,
                               const Dims& dm) {
  const int groups = dm.tile_pad / kRowsPerThread;
  for (int item = threadIdx.x; item < kd * groups; item += blockDim.x) {
    const int k = item % kd;
    const int r0 = (item / kd) * kRowsPerThread;
    float acc[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.0f;
    const T* wk = w + (long)k * n;
    for (int c = 0; c < n; ++c) {
      const float wv = Cd<T>::load(wk, c);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        acc[i] = fmaf(g[(r0 + i) * ld_g + c], wv, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = r0 + i;
      const float v = Cd<T>::round(acc[i]);
      if constexpr (EPI == kBwdStore) {
        out[r * ld_out + k] = v;
      } else if constexpr (EPI == kBwdGelu) {
        float* o = out + r * ld_out + k;
        *o = Cd<T>::round(v * gelu_tanh_grad(*o));
      } else {
        if (r < valid) gout[(long)r * kd + k] = Cd<T>::store(acc[i]);
      }
    }
  }
}

// The weight and bias gradients of a dense layer over the tile's rows:
// pw[k, c] (+)= sum_r x[r, k] g[r, c] and pb[c] (+)= sum_r g[r, c], into
// this block's fp32 scratch slice; the first tile of the block stores.
// Neighbouring threads own neighbouring columns, so the scratch traffic is
// coalesced and the rows of x are broadcast.
__device__ void wgrad_tile(const float* x, int ld_x, int kd, const float* g,
                           int ld_g, int n, float* __restrict__ pw,
                           float* __restrict__ pb, int valid, bool first) {
  for (int item = threadIdx.x; item < (kd + 1) * n; item += blockDim.x) {
    const int k = item / n;
    const int c = item % n;
    float acc = 0.0f;
    float* dst;
    if (k < kd) {
      for (int r = 0; r < valid; ++r)
        acc = fmaf(x[r * ld_x + k], g[r * ld_g + c], acc);
      dst = pw + (long)k * n + c;
    } else {
      for (int r = 0; r < valid; ++r) acc += g[r * ld_g + c];
      dst = pb + c;
    }
    *dst = first ? acc : *dst + acc;
  }
}

// Backward of LN without affine, one warp per row, from the forward's
// input x and the output's (rounded) cotangent g:
// dx = inv * (g - mean(g) - xhat * mean(g * xhat)), rounded; with RES it is
// added to gout (the residual branch's gradient) and rounded again.
template <typename T, bool RES>
__device__ void layer_norm_bwd_tile(const float* x, const float* g,
                                    float* gout, const Dims& dm) {
  const int lane = threadIdx.x % 32;
  const int h = dm.hidden;
  for (int r = threadIdx.x / 32; r < dm.tile_pad; r += blockDim.x / 32) {
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
      const float d = Cd<T>::round(inv * (gr[c] - mg - xhat * mgx));
      float* o = gout + r * dm.ld_h + c;
      *o = RES ? Cd<T>::round(*o + d) : d;
    }
  }
}

// The softmax row of query r in head hh, as attention_tile computes it:
// p[j] (fp32, unrounded) for j < S, with its max and sum.
__device__ __forceinline__ void attn_row(const float* qkv, int r, int hh,
                                         const Dims& dm, float (&p)[kMaxSet],
                                         float& mx, float& sum) {
  const int H = dm.hidden, hd = H / dm.heads, S = dm.set_size;
  const float root_hd = sqrtf((float)hd);
  const int set0 = (r / S) * S;
  const float* q = qkv + r * dm.ld_big + hh * hd;
  mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < kMaxSet; ++j) {
    if (j < S) {
      const float* kr = qkv + (set0 + j) * dm.ld_big + H + hh * hd;
      float dot = 0.0f;
      for (int d = 0; d < hd; ++d) dot = fmaf(q[d], kr[d], dot);
      p[j] = dot / root_hd;
      mx = fmaxf(mx, p[j]);
    }
  }
  sum = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxSet; ++j) {
    if (j < S) {
      p[j] = expf(p[j] - mx);
      sum += p[j];
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxSet; ++j)
    if (j < S) p[j] = p[j] / sum;
}

// gP[i, j] = R(go_i . v_j), the cotangent of the rounded probabilities.
__device__ __forceinline__ float attn_gp(const float* qkv, const float* go,
                                         int i, int j, int hh,
                                         const Dims& dm) {
  const int H = dm.hidden, hd = H / dm.heads;
  const float* gi = go + i * dm.ld_h + hh * hd;
  const float* vj = qkv + j * dm.ld_big + 2 * H + hh * hd;
  float acc = 0.0f;
  for (int d = 0; d < hd; ++d) acc = fmaf(gi[d], vj[d], acc);
  return acc;
}

// Attention backward, phase 1: one thread per (head, query row).  Writes
// the query gradient R(sum_j gl_ij / sqrt(hd) * k_j) and keeps the row's
// max, sum and D_i = sum_j p_ij gP_ij for phase 2.
template <typename T>
__device__ void attention_bwd_q(const float* qkv, const float* go,
                                float* gqkv, float* stats, const Dims& dm) {
  const int H = dm.hidden, nh = dm.heads, hd = H / nh, S = dm.set_size;
  const float root_hd = sqrtf((float)hd);
  for (int item = threadIdx.x; item < dm.tile_pad * nh;
       item += blockDim.x) {
    const int hh = item / dm.tile_pad;
    const int r = item % dm.tile_pad;
    float* gq = gqkv + r * dm.ld_big + hh * hd;
    if (r >= dm.tile) {  // rows past the last whole set: no attention
      for (int d = 0; d < hd; ++d) gq[d] = gq[H + d] = gq[2 * H + d] = 0.0f;
      continue;
    }
    const int set0 = (r / S) * S;
    float p[kMaxSet], mx, sum;
    attn_row(qkv, r, hh, dm, p, mx, sum);
    float gp[kMaxSet], D = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxSet; ++j) {
      if (j < S) {
        gp[j] = Cd<T>::round(attn_gp(qkv, go, r, set0 + j, hh, dm));
        D = fmaf(p[j], gp[j], D);
      }
    }
    // the softmax's backward, then the 1/sqrt(hd) scale of the logits
#pragma unroll
    for (int j = 0; j < kMaxSet; ++j)
      if (j < S) gp[j] = p[j] * (gp[j] - D) / root_hd;
    for (int d = 0; d < hd; ++d) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxSet; ++j)
        if (j < S)
          acc = fmaf(gp[j], qkv[(set0 + j) * dm.ld_big + H + hh * hd + d],
                     acc);
      gq[d] = Cd<T>::round(acc);
    }
    float* st = stats + (hh * dm.tile_pad + r) * 3;
    st[0] = mx;
    st[1] = sum;
    st[2] = D;
  }
}

// Phase 2: one thread per (head, key row j): gk_j = R(sum_i gl_ij /
// sqrt(hd) * q_i) and gv_j = R(sum_i R(p_ij) go_i), over the queries of
// j's set, with p_ij recomputed from the row statistics of phase 1.
template <typename T>
__device__ void attention_bwd_kv(const float* qkv, const float* go,
                                 float* gqkv, const float* stats,
                                 const Dims& dm) {
  const int H = dm.hidden, nh = dm.heads, hd = H / nh, S = dm.set_size;
  const float root_hd = sqrtf((float)hd);
  for (int item = threadIdx.x; item < dm.tile * nh; item += blockDim.x) {
    const int hh = item / dm.tile;
    const int j = item % dm.tile;
    const int set0 = (j / S) * S;
    const float* kj = qkv + j * dm.ld_big + H + hh * hd;
    float gl[kMaxSet], pq[kMaxSet];
#pragma unroll
    for (int ii = 0; ii < kMaxSet; ++ii) {
      if (ii < S) {
        const int i = set0 + ii;
        const float* qi = qkv + i * dm.ld_big + hh * hd;
        float dot = 0.0f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qi[d], kj[d], dot);
        const float* st = stats + (hh * dm.tile_pad + i) * 3;
        const float p = expf(dot / root_hd - st[0]) / st[1];
        const float gp = Cd<T>::round(attn_gp(qkv, go, i, j, hh, dm));
        gl[ii] = p * (gp - st[2]) / root_hd;
        pq[ii] = Cd<T>::round(p);
      }
    }
    float* gk = gqkv + j * dm.ld_big + H + hh * hd;
    for (int d = 0; d < hd; ++d) {
      float ak = 0.0f, av = 0.0f;
#pragma unroll
      for (int ii = 0; ii < kMaxSet; ++ii) {
        if (ii < S) {
          const int i = set0 + ii;
          ak = fmaf(gl[ii], qkv[i * dm.ld_big + hh * hd + d], ak);
          av = fmaf(pq[ii], go[i * dm.ld_h + hh * hd + d], av);
        }
      }
      gk[d] = Cd<T>::round(ak);
      gk[H + d] = Cd<T>::round(av);
    }
  }
}

__device__ __forceinline__ void copy_tile(const float* src, float* dst,
                                          const Dims& dm) {
  for (int i = threadIdx.x; i < dm.tile_pad * dm.ld_h; i += blockDim.x)
    dst[i] = src[i];
}

template <typename T>
__device__ void load_x_tile(const T* __restrict__ x, long row0, int valid,
                            float* dst, const Dims& dm) {
  for (int i = threadIdx.x; i < dm.tile_pad * dm.in_dim; i += blockDim.x) {
    const int r = i / dm.in_dim;
    dst[i] = r < valid ? Cd<T>::load(x, row0 * dm.in_dim + i) : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_set_transformer_bwd(const T* __restrict__ x, const T* __restrict__ g,
                          Weights<T> wt, T* __restrict__ dx,
                          float* __restrict__ part, Dims dm) {
  extern __shared__ float smem[];
  const int H = dm.hidden, RH = dm.mlp, L = dm.layers, OUT = dm.out_dim;
  const int TP = dm.tile_pad, IN = dm.in_dim;
  const int hsz = TP * dm.ld_h;
  float* hs = smem;                  // [L + 1] residual streams
  float* gh = hs + (L + 1) * hsz;    // d loss / d h
  float* a = gh + hsz;               // LN outputs
  float* o = a + hsz;                // attention output (rounded)
  float* hm = o + hsz;               // h after the attention residual
  float* gs = hm + hsz;              // ga, ga2, go, ga1
  float* qkv = gs + hsz;             // [TP, ld_big]
  float* r2 = qkv + TP * dm.ld_big;  // [TP, ld_r2]: f | m, gqkv, g, x
  float* stats = r2 + TP * dm.ld_r2; // [heads, TP, 3]
  float* f = r2;                     // [TP, ld_f] pre-gelu, then its grad
  float* m = r2 + TP * dm.ld_f;      // [TP, ld_f] R(gelu(f))
  const Offsets og = grad_offsets(dm);
  float* pw = part + blockIdx.x * og.off[12];
  const long ntiles = (dm.rows + dm.tile - 1) / dm.tile;

  for (long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const bool first = t == blockIdx.x;
    const long row0 = t * dm.tile;
    const long left = dm.rows - row0;
    const int valid = left < dm.tile ? (int)left : dm.tile;

    // 1. forward, keeping h at each block boundary
    load_x_tile<T>(x, row0, valid, r2, dm);
    __syncthreads();
    dense_tile<T, kStore>(r2, IN, IN, wt.embed_w, wt.embed_b, H, hs, dm.ld_h,
                          nullptr, valid, dm);
    __syncthreads();
    for (int l = 0; l < L; ++l) {
      float* h = hs + (l + 1) * hsz;
      copy_tile(hs + l * hsz, h, dm);
      __syncthreads();
      layer_norm_tile<T>(h, a, dm);
      __syncthreads();
      dense_tile<T, kStore>(a, dm.ld_h, H, wt.qkv_w + (long)l * H * 3 * H,
                            wt.qkv_b + l * 3 * H, 3 * H, qkv, dm.ld_big,
                            nullptr, valid, dm);
      __syncthreads();
      attention_tile<T>(qkv, o, dm);
      __syncthreads();
      dense_tile<T, kResidual>(o, dm.ld_h, H, wt.proj_w + (long)l * H * H,
                               wt.proj_b + l * H, H, h, dm.ld_h, nullptr,
                               valid, dm);
      __syncthreads();
      layer_norm_tile<T>(h, a, dm);
      __syncthreads();
      dense_tile<T, kGelu>(a, dm.ld_h, H, wt.fc1_w + (long)l * H * RH,
                           wt.fc1_b + l * RH, RH, m, dm.ld_f, nullptr, valid,
                           dm);
      __syncthreads();
      dense_tile<T, kResidual>(m, dm.ld_f, RH, wt.fc2_w + (long)l * RH * H,
                               wt.fc2_b + l * H, H, h, dm.ld_h, nullptr,
                               valid, dm);
      __syncthreads();
    }

    // 2. output layer: y = dense(R(LN(h_L)))
    layer_norm_tile<T>(hs + L * hsz, a, dm);
    const int ld_g = OUT + 1;
    for (int i = threadIdx.x; i < TP * OUT; i += blockDim.x) {
      const int r = i / OUT, c = i % OUT;
      r2[r * ld_g + c] = r < valid ? Cd<T>::load(g, row0 * OUT + i) : 0.0f;
    }
    __syncthreads();
    wgrad_tile(a, dm.ld_h, H, r2, ld_g, OUT, pw + og.off[10],
               pw + og.off[11], valid, first);
    dense_bwd_tile<T, kBwdStore>(r2, ld_g, OUT, wt.out_w, H, gs, dm.ld_h,
                                 nullptr, valid, dm);
    __syncthreads();
    layer_norm_bwd_tile<T, false>(hs + L * hsz, gs, gh, dm);
    __syncthreads();

    // 3. the blocks in reverse, each recomputed from its input h
    for (int l = L - 1; l >= 0; --l) {
      const float* h = hs + l * hsz;
      const T* qkv_w = wt.qkv_w + (long)l * H * 3 * H;
      const T* proj_w = wt.proj_w + (long)l * H * H;
      const T* fc1_w = wt.fc1_w + (long)l * H * RH;
      const T* fc2_w = wt.fc2_w + (long)l * RH * H;
      layer_norm_tile<T>(h, a, dm);
      copy_tile(h, hm, dm);
      __syncthreads();
      dense_tile<T, kStore>(a, dm.ld_h, H, qkv_w, wt.qkv_b + l * 3 * H,
                            3 * H, qkv, dm.ld_big, nullptr, valid, dm);
      __syncthreads();
      attention_tile<T>(qkv, o, dm);
      __syncthreads();
      dense_tile<T, kResidual>(o, dm.ld_h, H, proj_w, wt.proj_b + l * H, H,
                               hm, dm.ld_h, nullptr, valid, dm);
      __syncthreads();
      layer_norm_tile<T>(hm, a, dm);
      __syncthreads();
      dense_tile<T, kStore>(a, dm.ld_h, H, fc1_w, wt.fc1_b + l * RH, RH, f,
                            dm.ld_f, nullptr, valid, dm);
      __syncthreads();
      for (int i = threadIdx.x; i < TP * RH; i += blockDim.x) {
        const int r = i / RH, c = i % RH;
        m[r * dm.ld_f + c] = Cd<T>::round(gelu_tanh(f[r * dm.ld_f + c]));
      }
      __syncthreads();
      // MLP: h_out = R(hm + R(m @ W2 + b2)), m = R(gelu(f))
      wgrad_tile(m, dm.ld_f, RH, gh, dm.ld_h, H, pw + og.off[8] +
                 (long)l * RH * H, pw + og.off[9] + l * H, valid, first);
      dense_bwd_tile<T, kBwdGelu>(gh, dm.ld_h, H, fc2_w, RH, f, dm.ld_f,
                                  nullptr, valid, dm);
      __syncthreads();
      wgrad_tile(a, dm.ld_h, H, f, dm.ld_f, RH, pw + og.off[6] +
                 (long)l * H * RH, pw + og.off[7] + l * RH, valid, first);
      dense_bwd_tile<T, kBwdStore>(f, dm.ld_f, RH, fc1_w, H, gs, dm.ld_h,
                                   nullptr, valid, dm);
      __syncthreads();
      layer_norm_bwd_tile<T, true>(hm, gs, gh, dm);
      __syncthreads();
      // attention: hm = R(h + R(o @ Wp + bp))
      wgrad_tile(o, dm.ld_h, H, gh, dm.ld_h, H, pw + og.off[4] +
                 (long)l * H * H, pw + og.off[5] + l * H, valid, first);
      dense_bwd_tile<T, kBwdStore>(gh, dm.ld_h, H, proj_w, H, gs, dm.ld_h,
                                   nullptr, valid, dm);
      layer_norm_tile<T>(h, a, dm);  // a1 again, for the qkv weights
      __syncthreads();
      attention_bwd_q<T>(qkv, gs, r2, stats, dm);
      __syncthreads();
      attention_bwd_kv<T>(qkv, gs, r2, stats, dm);
      __syncthreads();
      wgrad_tile(a, dm.ld_h, H, r2, dm.ld_big, 3 * H, pw + og.off[2] +
                 (long)l * H * 3 * H, pw + og.off[3] + l * 3 * H, valid,
                 first);
      dense_bwd_tile<T, kBwdStore>(r2, dm.ld_big, 3 * H, qkv_w, H, gs,
                                   dm.ld_h, nullptr, valid, dm);
      __syncthreads();
      layer_norm_bwd_tile<T, true>(h, gs, gh, dm);
      __syncthreads();
    }

    // 4. embed: h_0 = R(x @ We + be)
    load_x_tile<T>(x, row0, valid, r2, dm);
    __syncthreads();
    wgrad_tile(r2, IN, IN, gh, dm.ld_h, H, pw + og.off[0], pw + og.off[1],
               valid, first);
    dense_bwd_tile<T, kBwdGlobal>(gh, dm.ld_h, H, wt.embed_w, IN, nullptr, 0,
                                  dx + row0 * IN, valid, dm);
    __syncthreads();
  }
}

// Shared-memory floats of one backward block (see fused_set_transformer_bwd).
inline size_t bwd_smem_floats(const Dims& dm) {
  return (size_t)dm.tile_pad *
         ((dm.layers + 6) * dm.ld_h + dm.ld_big + dm.ld_r2 + 3 * dm.heads);
}

template <typename T>
int launch_bwd(const void* x, const void* g, const void* const* w,
               const float* const* b, void* dx, float* part, float* dw,
               long rows, int set_size, int in_dim, int hidden, int heads,
               int layers, int mlp, int out_dim, int grid, void* stream) {
  if (set_size < 1 || set_size > kMaxSet || heads < 1 || hidden % heads ||
      grid < 1 || rows % set_size)
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
  dm.tile = (kTileTarget >= set_size ? kTileTarget / set_size : 1) * set_size;
  dm.tile_pad = (dm.tile + kRowsPerThread - 1) / kRowsPerThread *
                kRowsPerThread;
  dm.ld_h = hidden + 1;
  dm.ld_big = 3 * hidden + 1;
  dm.ld_f = mlp + 1;
  int r2 = 2 * dm.ld_f;
  if (dm.ld_big > r2) r2 = dm.ld_big;
  if (out_dim + 1 > r2) r2 = out_dim + 1;
  if (in_dim > r2) r2 = in_dim;
  dm.ld_r2 = r2;
  const size_t smem = sizeof(float) * bwd_smem_floats(dm);
  if (rows == 0) return (int)cudaSuccess;
  const long ntiles = (rows + dm.tile - 1) / dm.tile;
  if (grid > ntiles) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_set_transformer_bwd<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  Weights<T> wt{(const T*)w[0], b[0], (const T*)w[1], b[1],
                (const T*)w[2], b[2], (const T*)w[3], b[3],
                (const T*)w[4], b[4], (const T*)w[5], b[5]};
  cudaStream_t s = (cudaStream_t)stream;
  fused_set_transformer_bwd<T><<<grid, kThreads, smem, s>>>(
      (const T*)x, (const T*)g, wt, (T*)dx, part, dm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Offsets og = grad_offsets(dm);
  reduce_wgrad<T><<<(unsigned)((og.off[12] + kThreads - 1) / kThreads),
                    kThreads, 0, s>>>(part, grid, og, dw);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* const* w, const float* const* b,
           void* y, long rows, int set_size, int in_dim, int hidden,
           int heads, int layers, int mlp, int out_dim, void* stream) {
  if (set_size < 1 || set_size > kMaxSet || heads < 1 || hidden % heads)
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
  dm.tile = (kTileTarget >= set_size ? kTileTarget / set_size : 1) * set_size;
  dm.tile_pad = (dm.tile + kRowsPerThread - 1) / kRowsPerThread *
                kRowsPerThread;
  dm.ld_h = hidden + 1;
  const int big = 3 * hidden > mlp ? 3 * hidden : mlp;
  dm.ld_big = (big > in_dim ? big : in_dim) + 1;
  dm.ld_f = dm.ld_r2 = 0;
  const size_t smem =
      sizeof(float) * (size_t)dm.tile_pad * (2 * dm.ld_h + dm.ld_big);
  if (rows == 0) return (int)cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      fused_set_transformer_fwd<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  Weights<T> wt{(const T*)w[0], b[0], (const T*)w[1], b[1],
                (const T*)w[2], b[2], (const T*)w[3], b[3],
                (const T*)w[4], b[4], (const T*)w[5], b[5]};
  const unsigned grid = (unsigned)((rows + dm.tile - 1) / dm.tile);
  fused_set_transformer_fwd<T><<<grid, kThreads, smem,
                                 (cudaStream_t)stream>>>(
      (const T*)x, wt, (T*)y, dm);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The forward of a differentiable fp32 call, x [rows, in] to y [rows,
// out].  w: the 6 fp32 matrices (embed, qkv, proj, fc1, fc2, out); b: their 6
// fp32 biases, in the same order.  Returns cudaGetLastError().
int fused_set_transformer_train_fwd_f32(const void* x, const void* const* w,
                                        const float* const* b, void* y,
                                        long rows, int set_size, int in_dim,
                                        int hidden, int heads, int layers,
                                        int mlp, int out_dim, void* stream) {
  return launch<float>(x, w, b, y, rows, set_size, in_dim, hidden, heads,
                       layers, mlp, out_dim, stream);
}

// Backward in fp32: x [rows, in] and g [rows, out]; writes dx [rows, in]
// and the 12 fp32 weight gradients, flat in flatten_params order, to dw.
// part is fp32 scratch of grid x (the size of dw); grid (<= the number of
// tiles) is the number of persistent blocks.  The bf16 backward is the
// tensor-core kernel of fused_transformer_bf16.cu.
int fused_set_transformer_bwd_f32(const void* x, const void* g,
                                  const void* const* w, const float* const* b,
                                  void* dx, float* part, float* dw, long rows,
                                  int set_size, int in_dim, int hidden,
                                  int heads, int layers, int mlp, int out_dim,
                                  int grid, void* stream) {
  return launch_bwd<float>(x, g, w, b, dx, part, dw, rows, set_size, in_dim,
                           hidden, heads, layers, mlp, out_dim, grid, stream);
}

}  // extern "C"
