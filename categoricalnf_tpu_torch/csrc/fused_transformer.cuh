// Pieces shared by the fp32 fused SetTransformer forward/backward
// (fused_transformer.cu), the bf16 tensor-core forward and backward
// (fused_transformer_bf16.cu) and the 3xTF32 forward
// (fused_transformer_tf32x3.cu): the compute-dtype casts, tanh-gelu and its
// derivative, the layout of the flat weight gradient, the fixed-order sum
// of the backward's per-block gradient slices, the masked logit, and, for
// sets above 32 rows, the addressing of a set's rows over the blocks of a
// thread-block cluster, its launch and its barrier.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

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

constexpr float kMaskedLogit = -1e9f;  // the reference's masked logit

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return x * (0.5f * (1.0f + tanhf(c * (x + 0.044715f * (x * x * x)))));
}

// d gelu_tanh / dx, as PyTorch's GeluBackward (approximate="tanh") computes
// it in fp32.
__device__ __forceinline__ float gelu_tanh_grad(float x) {
  const float beta = 0.7978845608028654f, kappa = 0.044715f;
  const float x_sq = x * x;
  const float t = tanhf(beta * (x + kappa * x_sq * x));
  const float left = 0.5f * x, right = 1.0f + t;
  return 0.5f * right +
         left * (1.0f - t * t) * beta * (1.0f + 3.0f * kappa * x_sq);
}

// Offsets of the 12 gradients in one flat fp32 vector, in flatten_params
// order; off[12] is the total.
struct Offsets {
  long off[13];
};

template <typename D>
__host__ __device__ inline Offsets grad_offsets(const D& dm) {
  const long H = dm.hidden, L = dm.layers, RH = dm.mlp;
  const long sizes[12] = {dm.in_dim * H, H,      L * H * 3 * H, L * 3 * H,
                          L * H * H,     L * H,  L * H * RH,    L * RH,
                          L * RH * H,    L * H,  H * dm.out_dim, dm.out_dim};
  Offsets o;
  o.off[0] = 0;
  for (int j = 0; j < 12; ++j) o.off[j + 1] = o.off[j] + sizes[j];
  return o;
}

// dw[i] = sum over the grid's slices of part[s][i], in slice order; the
// matrices' gradients are rounded to the compute dtype (the transpose of
// their cast), the biases' stay fp32.
template <typename T>
__global__ void reduce_wgrad(const float* __restrict__ part, int slices,
                             Offsets og, float* __restrict__ dw) {
  const long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
  const long total = og.off[12];
  if (i >= total) return;
  float s = 0.0f;
  for (int b = 0; b < slices; ++b) s += part[b * total + i];
  int j = 0;
  while (i >= og.off[j + 1]) ++j;
  dw[i] = j % 2 == 0 ? Cd<T>::round(s) : s;
}

// ---- Sets above 32 rows ---------------------------------------------------
//
// Up to 128 rows (the reference's largest Pallas tile of whole sets) a tile
// holds one set.  Where a set is split over the blocks of a cluster (rows r
// split .. (r + 1) split - 1 in rank r), a block reads the others' rows
// through distributed shared memory (SetRows); every row-wise phase stays
// in its own block.  Each kernel's attention over the set is its own (warp
// tiles of the tensor cores in bf16 and 3xTF32, register tiles of the FMA
// units in fused_transformer_tiles.cuh).

// The rows of one set over the N blocks of a cluster: row j at base[r] +
// (j - r split) ld in rank r = j / split (every base the same buffer with
// split = the set in one block).
template <typename T, int N = 2>
struct SetRows {
  const T* base[N];
  int split, ld;
  __device__ __forceinline__ const T* row(int j) const {
    const T* b = base[0];
#pragma unroll
    for (int r = 1; r < N; ++r) {
      if (j >= split) {
        b = base[r];
        j -= split;
      }
    }
    return b + j * ld;
  }
};

namespace cg = cooperative_groups;

// The set's rows of ``mine`` (this block's buffer, rows ld apart) over
// the ``cluster`` (<= N) blocks of this block's cluster: rank r's buffer at
// the same offset for r < cluster (this block's own for its rank).
template <typename T, int N>
__device__ __forceinline__ SetRows<T, N> set_rows_of(const T* mine, int ld,
                                                     int split, int cluster) {
  SetRows<T, N> v;
  v.split = split;
  v.ld = ld;
#pragma unroll
  for (int r = 0; r < N; ++r) v.base[r] = mine;
  if (cluster > 1) {
    cg::cluster_group cl = cg::this_cluster();
    const int rank = (int)cl.block_rank();
#pragma unroll
    for (int r = 0; r < N; ++r)
      if (r < cluster && r != rank)
        v.base[r] = cl.map_shared_rank(const_cast<T*>(mine), r);
  }
  return v;
}

// kernel<<<grid, threads, smem, s>>>(args...), in clusters of ``cluster``
// blocks where that is above 1 (cudaLaunchKernelEx with the cluster
// dimension, for a set that spans them); returns cudaGetLastError().
template <typename... Ts, typename... As>
cudaError_t launch_clustered(void (*kernel)(Ts...), unsigned grid,
                             unsigned threads, size_t smem, cudaStream_t s,
                             int cluster, As... args) {
  if (cluster == 1) {
    kernel<<<grid, threads, smem, s>>>(args...);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Every thread of the set's blocks: the cluster's barrier where the set
// spans several blocks (it also orders their shared-memory writes before
// the other blocks' reads), else the block's.
__device__ __forceinline__ void set_sync(bool clustered) {
  if (clustered)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

}  // namespace
