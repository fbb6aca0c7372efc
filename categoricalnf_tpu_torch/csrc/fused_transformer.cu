// Fused SetTransformer forward for Hopper (sm_90a).
//
// Replaces the TPU kernel categoricalnf_tpu/ops/pallas/fused_transformer.py
// _fused_fwd (body _fwd_kernel -> _net_forward): the whole coupling net,
// embed -> L x [LN -> QKV -> per-set, per-head attention -> proj +
// residual; LN -> fc1 -> gelu(tanh) -> fc2 + residual] -> LN -> out, for a
// tile of whole sets.
//
// Bound on an H100.  At the flagship width (H=96, 4 heads, 2 blocks, S=16,
// in 4, out 104) the net does about 164k multiply-adds a row, 5.4 GFLOP at
// 16,384 rows, while it reads 16 B and writes 208 B a row in bf16 plus
// 0.3 MB of weights: it is bound by operations (989 TFLOP/s bf16 on the
// tensor cores, 67 TFLOP/s fp32 without them), not by bytes.
//
// Design (first, simple version).  One block of 256 threads per tile of
// whole sets (32 rows at S=16); no row is carried across blocks and the
// ragged last tile is masked.  The activations of the tile stay in shared
// memory for the whole net (h, an LN/attention buffer, and one buffer for
// qkv or the MLP hidden layer: 62 KB at the flagship tile), so the only
// device-memory traffic is x in, y out and the weights, which every block
// reads from global memory and which stay in L2 (316 KB in bf16, more than
// one block's shared memory).  The products are fp32 FMAs on operands
// rounded to the compute dtype: bf16 x bf16 products are exact in fp32, so
// this reproduces the reference's bf16 -> fp32-accumulate contraction; the
// fp32 variant never uses TF32.  Attention runs per set and per head (the
// TPU kernel's block-diagonal over-compute existed only for its matrix
// unit).  Leading dimensions in shared memory are odd, so the attention's
// row-strided reads do not collide in one bank.  The cast points are the
// reference's: LN statistics in fp32 and its output in the compute dtype;
// every dense output rounded once after the fp32 bias add; the residual add
// rounded in the compute dtype; attention logits and softmax in fp32, the
// probabilities rounded before A.V; head outputs rounded at the proj input.
// Tensor-core products (mma/wgmma) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 8;  // rows of one dense output per thread
constexpr int kMaxSet = 32;        // largest set size attention handles
constexpr int kTileTarget = 32;    // rows a tile aims for (whole sets)

template <typename T>
struct Cd;

template <>
struct Cd<float> {
  static __device__ __forceinline__ float load(const float* p, long i) {
    return p[i];
  }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
};

template <>
struct Cd<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p,
                                               long i) {
    return __bfloat162float(p[i]);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
};

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
};

enum Epi { kStore, kResidual, kGelu, kGlobal };

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return x * (0.5f * (1.0f + tanhf(c * (x + 0.044715f * (x * x * x)))));
}

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

// w: the 6 matrices (embed, qkv, proj, fc1, fc2, out) in the compute dtype;
// b: their 6 fp32 biases, in the same order.  Returns cudaGetLastError().
int fused_set_transformer_fwd_bf16(const void* x, const void* const* w,
                                   const float* const* b, void* y, long rows,
                                   int set_size, int in_dim, int hidden,
                                   int heads, int layers, int mlp,
                                   int out_dim, void* stream) {
  return launch<__nv_bfloat16>(x, w, b, y, rows, set_size, in_dim, hidden,
                               heads, layers, mlp, out_dim, stream);
}

int fused_set_transformer_fwd_f32(const void* x, const void* const* w,
                                  const float* const* b, void* y, long rows,
                                  int set_size, int in_dim, int hidden,
                                  int heads, int layers, int mlp, int out_dim,
                                  void* stream) {
  return launch<float>(x, w, b, y, rows, set_size, in_dim, hidden, heads,
                       layers, mlp, out_dim, stream);
}

}  // extern "C"
