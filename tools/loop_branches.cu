// The bisections of the inverse's loop-rule backward (#1',
// mixture_inverse_loop_bwd_kernel in csrc/mixture.cu), rerun with their
// branches written out, for tools/loop_branches.py to compare with the plain
// loop's on the card.  Built with -DLEFT_TO_RIGHT, the sums over the
// components run left to right (the kernel's first version) instead of in
// torch's order (torch_sum_order).  Also: expf, logf, log1pf and the log
// sigmoid pair of csrc/mixture.cu elementwise, to compare with torch's.
#include "../categoricalnf_tpu_torch/csrc/mixture.cu"

namespace {

template <int C>
__device__ float sum_components(float (&e)[C], int k) {
#ifdef LEFT_TO_RIGHT
  float s = 0.0f;
  for (int c = 0; c < C; ++c)
    if (c < k) s = __fadd_rn(s, e[c]);
  return s;
#else
  return torch_sum_order<C>(e);
#endif
}

template <int C>
__device__ float lse(const float (&v)[C], int k) {
  float m = -INFINITY;
  for (int c = 0; c < C; ++c)
    if (c < k) m = fmaxf(m, v[c]);
  if (isinf(m)) return m;
  float e[C];
  for (int c = 0; c < C; ++c) e[c] = c < k ? expf(__fsub_rn(v[c], m)) : 0.0f;
  return __fadd_rn(logf(sum_components<C>(e, k)), m);
}

// One thread an element of contiguous [m, k] parameters: bit it of bits[i]
// is set where bisection it moved lo; log_pi as the kernel forms it.
template <int C>
__global__ void branches_kernel(const float* y, const float* pi,
                                const float* mu, const float* lsr, long m,
                                int k, unsigned long long* bits,
                                float* log_pi_out) {
  const long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (i >= m) return;
  LoopParams<C> p;
  float logit[C], mx = -INFINITY;
  for (int c = 0; c < C; ++c) {
    logit[c] = p.mean[c] = p.ls[c] = 0.0f;
    if (c < k) {
      logit[c] = pi[i * k + c];
      p.mean[c] = mu[i * k + c];
      p.ls[c] = fminf(fmaxf(lsr[i * k + c], kLogScaleMin), kLogScaleMax);
      mx = fmaxf(mx, logit[c]);
    }
  }
  float e[C];
  for (int c = 0; c < C; ++c)
    e[c] = c < k ? expf(__fsub_rn(logit[c], mx)) : 0.0f;
  const float lz = logf(sum_components<C>(e, k));
  for (int c = 0; c < C; ++c) {
    p.log_pi[c] = __fsub_rn(__fsub_rn(logit[c], mx), lz);
    p.inv_s[c] = expf(-p.ls[c]);
    if (c < k) log_pi_out[i * k + c] = p.log_pi[c];
  }
  const float yi = y[i];
  float lo = INFINITY, hi = -INFINITY;
  for (int c = 0; c < C; ++c) {
    if (c < k) {
      const float cand = __fadd_rn(p.mean[c], __fmul_rn(expf(p.ls[c]), yi));
      lo = fminf(lo, cand);
      hi = fmaxf(hi, cand);
    }
  }
  unsigned long long b = 0;
  for (int it = 0; it < kNumBisect; ++it) {
    const float mid = 0.5f * __fadd_rn(lo, hi);
    float ta[C], tb[C];
    for (int j = 0; j < C; ++j) {
      const float z = __fmul_rn(__fsub_rn(mid, p.mean[j]), p.inv_s[j]);
      float lsp, lsn;
      log_sigmoid_pair(z, lsp, lsn);
      ta[j] = __fadd_rn(p.log_pi[j], lsp);
      tb[j] = __fadd_rn(p.log_pi[j], lsn);
    }
    if (__fsub_rn(lse<C>(ta, k), lse<C>(tb, k)) < yi) {
      lo = mid;
      b |= 1ull << it;
    } else {
      hi = mid;
    }
  }
  bits[i] = b;
}

__global__ void elementwise_kernel(const float* z, float* out, long n) {
  const long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float v = z[i];
  float lsp, lsn;
  log_sigmoid_pair(v, lsp, lsn);
  out[i] = expf(v);
  out[n + i] = logf(fabsf(v));
  out[2 * n + i] = log1pf(fabsf(v));
  out[3 * n + i] = lsp;
}

}  // namespace

extern "C" {

int loop_branches(const float* y, const float* pi, const float* mu,
                  const float* ls, long m, int k, unsigned long long* bits,
                  float* log_pi) {
  const unsigned blocks = (unsigned)((m + 255) / 256);
  if (k <= 4)
    branches_kernel<4><<<blocks, 256>>>(y, pi, mu, ls, m, k, bits, log_pi);
  else if (k <= 8)
    branches_kernel<8><<<blocks, 256>>>(y, pi, mu, ls, m, k, bits, log_pi);
  else if (k <= 16)
    branches_kernel<16><<<blocks, 256>>>(y, pi, mu, ls, m, k, bits, log_pi);
  else
    branches_kernel<32><<<blocks, 256>>>(y, pi, mu, ls, m, k, bits, log_pi);
  return (int)cudaDeviceSynchronize();
}

// out: [4, n]: expf, logf(|z|), log1pf(|z|), log sigmoid(z)
int loop_elementwise(const float* z, float* out, long n) {
  elementwise_kernel<<<(unsigned)((n + 255) / 256), 256>>>(z, out, n);
  return (int)cudaDeviceSynchronize();
}

}  // extern "C"
