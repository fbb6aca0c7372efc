// Pieces shared by the fp32 fused SetTransformer forward/backward
// (fused_transformer.cu) and the bf16 tensor-core forward and backward
// (fused_transformer_bf16.cu): the compute-dtype casts, tanh-gelu and its
// derivative, the layout of the flat weight gradient, and the fixed-order
// sum of the backward's per-block gradient slices.
#pragma once

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

}  // namespace
