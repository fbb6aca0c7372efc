// Mixture-of-logistics CDF kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels in categoricalnf_tpu/ops/pallas/mixture.py:
//   mixture_inverse_f32  <- mixture_inverse_pallas (_inverse_kernel)
//   mixture_forward_f32  <- mixture_forward_pallas (_forward_kernel)
//   mixture_forward_bwd_f32: its backward, which has no Pallas
//     counterpart (the reference differentiates the plain math,
//     numerics.mixture_logit_cdf_and_ldj, with XLA's autodiff)
//
// Bound on an H100.  The inverse reads y and 3 x K fp32 parameters once
// and writes x: 4 + 12K + 4 bytes an element (104 at K=8), 6.8 MB at
// M = 65,536.  It then runs 24 rtsafe iterations, each about 5
// transcendentals and 30 float operations for each of the K components,
// so it is bound by operations (the SFU's transcendental rate first).  The
// forward does one such pass and moves 4 + 12K + 8 bytes an element, so it
// is bound by bytes; so is its backward (4 + 12K + 8 in, 4 + 12K out).
//
// Design.  One thread per element.  The K parameters are loaded once and
// kept in registers for the whole root-find (the TPU kernel kept them in
// VMEM for the same reason); the log-softmax of the mixture logits and the
// clip of the log-scales happen here, not in extra passes over memory.  The
// parameter rows may be strided (they are slices of the coupling net's
// output), so each array comes with its row stride and no copy is needed.
// Full fp32: no fast-math, expf/log1pf/logf only.  K is a loop bound up to
// 16, unrolled against a compile-time maximum so the arrays stay in
// registers.  A component whose log-weight is below -5e29 (the -1e30 the
// TPU kernel pads with) is left out of the bracket.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kLogScaleMin = -5.0f;
constexpr float kLogScaleMax = 7.0f;
constexpr float kNegBig = -1e30f;
constexpr int kNumIters = 24;  // rtsafe iterations, as _inverse_kernel

__device__ __forceinline__ void log_sigmoid_pair(float z, float& lsp,
                                                 float& lsn) {
  const float sp = log1pf(expf(-fabsf(z)));  // softplus(-|z|)
  lsp = z >= 0.0f ? -sp : z - sp;
  lsn = lsp - z;
}

// Loads one element's K components: log-softmax of the logits, means,
// and the negated clipped log-scales.
template <int KMAX>
__device__ __forceinline__ void load_params(
    const float* __restrict__ pi, long pi_stride,
    const float* __restrict__ mu, long mu_stride,
    const float* __restrict__ ls, long ls_stride, long i, int k,
    float (&log_pi)[KMAX], float (&mean)[KMAX], float (&neg_ls)[KMAX]) {
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < k) {
      log_pi[j] = pi[i * pi_stride + j];
      mean[j] = mu[i * mu_stride + j];
      neg_ls[j] = -fminf(fmaxf(ls[i * ls_stride + j], kLogScaleMin),
                         kLogScaleMax);
      mx = fmaxf(mx, log_pi[j]);
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < KMAX; ++j)
    if (j < k) s += expf(log_pi[j] - mx);
  const float lse = mx + logf(s);
#pragma unroll
  for (int j = 0; j < KMAX; ++j)
    if (j < k) log_pi[j] -= lse;
}

// log F, log(1-F) and log f at x: three logsumexps over the components.
template <int KMAX>
__device__ __forceinline__ void mixture_logs(
    float x, const float (&log_pi)[KMAX], const float (&mean)[KMAX],
    const float (&neg_ls)[KMAX], const float (&inv_s)[KMAX], int k,
    float& log_cdf, float& log_sf, float& log_pdf) {
  float a[KMAX], b[KMAX], c[KMAX];
  float ma = -INFINITY, mb = -INFINITY, mc = -INFINITY;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < k) {
      float lsp, lsn;
      log_sigmoid_pair((x - mean[j]) * inv_s[j], lsp, lsn);
      a[j] = log_pi[j] + lsp;
      b[j] = log_pi[j] + lsn;
      c[j] = log_pi[j] + lsp + lsn + neg_ls[j];
      ma = fmaxf(ma, a[j]);
      mb = fmaxf(mb, b[j]);
      mc = fmaxf(mc, c[j]);
    }
  }
  float sa = 0.0f, sb = 0.0f, sc = 0.0f;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < k) {
      sa += expf(a[j] - ma);
      sb += expf(b[j] - mb);
      sc += expf(c[j] - mc);
    }
  }
  log_cdf = ma + logf(sa);
  log_sf = mb + logf(sb);
  log_pdf = mc + logf(sc);
}

// Safeguarded Newton (rtsafe), as _inverse_kernel: a Newton step inside
// the bracket, else the midpoint; the midpoint also when the step fails
// to halve the previous one (kills the Newton two-cycle across the root).
template <int KMAX>
__global__ void mixture_inverse_kernel(
    const float* __restrict__ y, const float* __restrict__ pi, long pi_stride,
    const float* __restrict__ mu, long mu_stride,
    const float* __restrict__ ls, long ls_stride, float* __restrict__ out,
    long m, int k) {
  const long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (i >= m) return;
  float log_pi[KMAX], mean[KMAX], neg_ls[KMAX], inv_s[KMAX];
  load_params<KMAX>(pi, pi_stride, mu, mu_stride, ls, ls_stride, i, k,
                    log_pi, mean, neg_ls);
  const float yi = y[i];
  float lo = INFINITY, hi = -INFINITY;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < k) {
      inv_s[j] = expf(neg_ls[j]);
      if (log_pi[j] > kNegBig * 0.5f) {
        const float cand = mean[j] + expf(-neg_ls[j]) * yi;
        lo = fminf(lo, cand);
        hi = fmaxf(hi, cand);
      }
    }
  }
  float x = 0.5f * (lo + hi);
  float dx_old = hi - lo;
  for (int it = 0; it < kNumIters; ++it) {
    float log_cdf, log_sf, log_pdf;
    mixture_logs<KMAX>(x, log_pi, mean, neg_ls, inv_s, k, log_cdf, log_sf,
                       log_pdf);
    const float g = log_cdf - log_sf - yi;
    if (g < 0.0f) lo = x; else hi = x;
    const float step = g * expf(log_cdf + log_sf - log_pdf);
    float nxt = x - step;
    const bool bad = nxt <= lo || nxt >= hi || 2.0f * fabsf(step) > dx_old ||
                     !isfinite(nxt);
    if (bad) {
      nxt = 0.5f * (lo + hi);
      dx_old = 0.5f * (hi - lo);
    } else {
      dx_old = fabsf(step);
    }
    x = nxt;
  }
  out[i] = x;
}

template <int KMAX>
__global__ void mixture_forward_kernel(
    const float* __restrict__ x, const float* __restrict__ pi, long pi_stride,
    const float* __restrict__ mu, long mu_stride,
    const float* __restrict__ ls, long ls_stride, float* __restrict__ y,
    float* __restrict__ ldj, long m, int k) {
  const long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (i >= m) return;
  float log_pi[KMAX], mean[KMAX], neg_ls[KMAX], inv_s[KMAX];
  load_params<KMAX>(pi, pi_stride, mu, mu_stride, ls, ls_stride, i, k,
                    log_pi, mean, neg_ls);
#pragma unroll
  for (int j = 0; j < KMAX; ++j)
    if (j < k) inv_s[j] = expf(neg_ls[j]);
  float log_cdf, log_sf, log_pdf;
  mixture_logs<KMAX>(x[i], log_pi, mean, neg_ls, inv_s, k, log_cdf, log_sf,
                     log_pdf);
  y[i] = log_cdf - log_sf;
  ldj[i] = log_pdf - log_cdf - log_sf;
}

// Backward of mixture_forward_kernel: given the cotangents gy, gldj of
// y = A - B and ldj = C - A - B (A, B, C the three logsumexps), pull them
// back to x, the raw logits (through the log-softmax), the means and the
// raw log-scales (zero where the clip is active, as torch.clamp).  The
// per-component terms are recomputed here, as the forward computes them,
// rather than saved as [M, K] intermediates.
template <int KMAX>
__global__ void mixture_forward_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ pi, long pi_stride,
    const float* __restrict__ mu, long mu_stride,
    const float* __restrict__ ls, long ls_stride,
    const float* __restrict__ gy, const float* __restrict__ gldj,
    float* __restrict__ gx, float* __restrict__ gpi, float* __restrict__ gmu,
    float* __restrict__ gls, long m, int k) {
  const long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (i >= m) return;
  float log_pi[KMAX], mean[KMAX], neg_ls[KMAX], inv_s[KMAX];
  load_params<KMAX>(pi, pi_stride, mu, mu_stride, ls, ls_stride, i, k,
                    log_pi, mean, neg_ls);
  const float xi = x[i];
  float z[KMAX], lsp[KMAX], a[KMAX], b[KMAX], c[KMAX];
  float ma = -INFINITY, mb = -INFINITY, mc = -INFINITY;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < k) {
      inv_s[j] = expf(neg_ls[j]);
      z[j] = (xi - mean[j]) * inv_s[j];
      float lsn;
      log_sigmoid_pair(z[j], lsp[j], lsn);
      a[j] = log_pi[j] + lsp[j];
      b[j] = log_pi[j] + lsn;
      c[j] = log_pi[j] + lsp[j] + lsn + neg_ls[j];
      ma = fmaxf(ma, a[j]);
      mb = fmaxf(mb, b[j]);
      mc = fmaxf(mc, c[j]);
    }
  }
  float sa = 0.0f, sb = 0.0f, sc = 0.0f;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < k) {
      sa += expf(a[j] - ma);
      sb += expf(b[j] - mb);
      sc += expf(c[j] - mc);
    }
  }
  const float lse_a = ma + logf(sa), lse_b = mb + logf(sb);
  const float lse_c = mc + logf(sc);
  const float g_y = gy[i], g_l = gldj[i];
  const float g_a = g_y - g_l, g_b = -g_y - g_l, g_c = g_l;
  float g_x = 0.0f, g_lp_sum = 0.0f;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < k) {
      const float ga = g_a * expf(a[j] - lse_a);
      const float gb = g_b * expf(b[j] - lse_b);
      const float gc = g_c * expf(c[j] - lse_c);
      // d lsp/dz = sigmoid(-z) = exp(lsn), d lsn/dz = -sigmoid(z), where
      // lsn = lsp - z exactly as log_sigmoid_pair computes it
      const float gz =
          (ga + gc) * expf(lsp[j] - z[j]) - (gb + gc) * expf(lsp[j]);
      g_x = fmaf(gz, inv_s[j], g_x);
      gmu[i * k + j] = -gz * inv_s[j];
      const float raw = ls[i * ls_stride + j];
      const bool inside = raw >= kLogScaleMin && raw <= kLogScaleMax;
      gls[i * k + j] = inside ? -gc - gz * z[j] : 0.0f;
      a[j] = ga + gb + gc;  // d/d log_pi
      g_lp_sum += a[j];
    }
  }
#pragma unroll
  for (int j = 0; j < KMAX; ++j)
    if (j < k) gpi[i * k + j] = a[j] - expf(log_pi[j]) * g_lp_sum;
  gx[i] = g_x;
}

constexpr int kThreads = 256;

inline unsigned blocks_for(long m) {
  return (unsigned)((m + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Each entry point returns cudaGetLastError() after its launch; the
// Python wrapper checks k (1..16), shapes, strides and dtypes first.
int mixture_inverse_f32(const float* y, const float* pi, long pi_stride,
                        const float* mu, long mu_stride, const float* ls,
                        long ls_stride, float* out, long m, int k,
                        void* stream) {
  if (m == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 8)
    mixture_inverse_kernel<8><<<blocks_for(m), kThreads, 0, s>>>(
        y, pi, pi_stride, mu, mu_stride, ls, ls_stride, out, m, k);
  else
    mixture_inverse_kernel<16><<<blocks_for(m), kThreads, 0, s>>>(
        y, pi, pi_stride, mu, mu_stride, ls, ls_stride, out, m, k);
  return (int)cudaGetLastError();
}

int mixture_forward_f32(const float* x, const float* pi, long pi_stride,
                        const float* mu, long mu_stride, const float* ls,
                        long ls_stride, float* y, float* ldj, long m, int k,
                        void* stream) {
  if (m == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 8)
    mixture_forward_kernel<8><<<blocks_for(m), kThreads, 0, s>>>(
        x, pi, pi_stride, mu, mu_stride, ls, ls_stride, y, ldj, m, k);
  else
    mixture_forward_kernel<16><<<blocks_for(m), kThreads, 0, s>>>(
        x, pi, pi_stride, mu, mu_stride, ls, ls_stride, y, ldj, m, k);
  return (int)cudaGetLastError();
}

// gpi, gmu and gls are written as contiguous [m, k]; gx as [m].
int mixture_forward_bwd_f32(const float* x, const float* pi, long pi_stride,
                            const float* mu, long mu_stride, const float* ls,
                            long ls_stride, const float* gy, const float* gldj,
                            float* gx, float* gpi, float* gmu, float* gls,
                            long m, int k, void* stream) {
  if (m == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 8)
    mixture_forward_bwd_kernel<8><<<blocks_for(m), kThreads, 0, s>>>(
        x, pi, pi_stride, mu, mu_stride, ls, ls_stride, gy, gldj, gx, gpi,
        gmu, gls, m, k);
  else
    mixture_forward_bwd_kernel<16><<<blocks_for(m), kThreads, 0, s>>>(
        x, pi, pi_stride, mu, mu_stride, ls, ls_stride, gy, gldj, gx, gpi,
        gmu, gls, m, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
