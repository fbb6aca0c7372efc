// Mixture-of-logistics CDF kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels in categoricalnf_tpu/ops/pallas/mixture.py:
//   mixture_inverse_f32  <- mixture_inverse_pallas (_inverse_kernel)
//   mixture_forward_f32  <- mixture_forward_pallas (_forward_kernel)
//   mixture_forward_bwd_f32: its backward, which has no Pallas
//     counterpart (the reference differentiates the plain math,
//     numerics.mixture_logit_cdf_and_ldj, with XLA's autodiff)
//   mixture_inverse_loop_bwd_f32: the inverse's backward, which has none
//     either (XLA's reverse mode through numerics.mixture_inverse_logit_cdf's
//     loop; see the note above mixture_inverse_loop_bwd_kernel)
//
// Bound on an H100.  The inverse reads y and 3 x K fp32 parameters once
// and writes x: 4 + 12K + 4 bytes an element (104 at K=8), 6.8 MB at
// M = 65,536.  It then runs rtsafe iterations over the K components until
// each element is done (up to kMaxIters; about 8 a warp at the flagship's
// inputs), so it is bound by operations.  The forward does one such pass and moves
// 4 + 12K + 8 bytes an element, so it is bound by bytes; so is its
// backward (4 + 12K + 8 in, 4 + 12K out).
//
// The forward, its backward and the inverse put an element on a group of
// lanes, a few components a lane (the TPU kernels, too, put the components
// on an axis of their own), so that the loads of the strided parameter rows and the stores of the
// [M, K] gradients run over contiguous bytes.  The parameter rows may be
// strided (they are slices of the coupling net's output), so each array
// comes with its row stride and no copy is needed.  The log-softmax of the
// mixture logits and the clip of the log-scales happen here, not in extra
// passes over memory.  Full fp32: no fast-math.
//
// The forward and its backward keep the per-element loop's order in every
// sum over the components, so both give that loop's bits (see the note
// above mixture_forward_kernel).  Bound by bytes, they run above that
// bound: their SASS holds about 1,240 (forward) and 2,370 (backward)
// instructions an element at K = 8 (tools/mixture_ab.py counts them), and
// the time the warp schedulers take to issue those, plus that of a launch
// of a few elements, comes close to the measured time (PERF.md).
//
// The inverse runs as the time to issue its instructions too, so its
// design cuts the instructions of an iteration: see the note above
// mixture_inverse_kernel.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kLogScaleMin = -5.0f;
constexpr float kLogScaleMax = 7.0f;
constexpr float kNegBig = -1e30f;
// rtsafe iterations of the inverse at most; an element stops at its own
// (rtsafe_done), the TPU's _inverse_kernel runs 24 for every element
constexpr int kMaxIters = 48;

// z must arrive rounded (callers form it with __fmul_rn): were its product
// left for nvcc to contract into z - sp, lsp would hold the exact product
// and lsn = lsp - z its rounding error, up to half an ulp of z, where it
// should be 0 (0.5 at |z| = 1e7, a narrow component far from x).
__device__ __forceinline__ void log_sigmoid_pair(float z, float& lsp,
                                                 float& lsn) {
  const float sp = log1pf(expf(-fabsf(z)));  // softplus(-|z|)
  lsp = z >= 0.0f ? -sp : z - sp;
  lsn = lsp - z;
}

// The forward (#2) and its backward (#2') spread an element over a group of
// G lanes, C components a lane (G * C >= K): lane l holds components
// j = C*l + c, c < C, so a warp holds 32 / G elements, and a warp's loads
// of the parameter rows and stores of the [M, K] gradients touch a few
// contiguous runs.  Each lane runs the per-element loop's arithmetic (the
// original one-thread kernels') for its components, and every sum over the
// components runs in that loop's order: lane 0 adds its terms to 0.0f,
// passes the sum to lane 1, which adds its own, and so on (no tree).
// Components j >= k add an exact +0.  So the two kernels give the bits of
// the per-element loop.
//
// One difference is not in the order: the per-element loop's sums of
// expf(...) fuse expf's last multiply (by a power of two) into the add,
// while these add expf's rounded result.  The two differ only where that
// product is subnormal, and there only below the sum's last bit once the
// sum holds its largest term, exp(0) = 1, which every one of these sums
// holds: the sums are equal.

constexpr unsigned kFull = 0xffffffffu;

// v of lane l of this thread's group.
template <int G>
__device__ __forceinline__ float from_lane(float v, int l) {
  if constexpr (G == 1) return v;
  else return __shfl_sync(kFull, v, l, G);
}

// The maximum over the group's components that are on (fmaxf is
// order-free, so a butterfly serves).
template <int G, int C>
__device__ __forceinline__ float group_max(const float (&v)[C],
                                           const bool (&on)[C]) {
  float m = -INFINITY;
#pragma unroll
  for (int c = 0; c < C; ++c) m = fmaxf(m, on[c] ? v[c] : -INFINITY);
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, o, G));
  return m;
}

// 0.0f + v[0] + v[1] + ... over the group's components in their order
// j = 0, 1, ...; every lane gets the sum.  v is +0 for components j >= k.
template <int G, int C>
__device__ __forceinline__ float group_sum(const float (&v)[C]) {
  float run = 0.0f;
#pragma unroll
  for (int t = 0; t < G; ++t) {
    float mine = run;
#pragma unroll
    for (int c = 0; c < C; ++c) mine = __fadd_rn(mine, v[c]);
    run = from_lane<G>(mine, t);
  }
  return run;
}

// The fmaf chain g = fmaf(a[j], b[j], g) from g = 0.0f over the group's
// components in their order; a and b are +0 for components j >= k.
template <int G, int C>
__device__ __forceinline__ float group_dot(const float (&a)[C],
                                           const float (&b)[C]) {
  float run = 0.0f;
#pragma unroll
  for (int t = 0; t < G; ++t) {
    float mine = run;
#pragma unroll
    for (int c = 0; c < C; ++c) mine = __fmaf_rn(a[c], b[c], mine);
    run = from_lane<G>(mine, t);
  }
  return run;
}

// s + e = a + b exactly (Knuth's TwoSum), every operation rounded once.
__device__ __forceinline__ float two_sum(float a, float b, float& e) {
  const float s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
  return s;
}

// group_dot compensated (Ogita, Rump and Oishi's Dot2): each product's and
// each sum's rounding error, taken exactly by an fmaf and TwoSum, is
// summed beside the sum and added once at the end, so the result is as
// accurate as a sum in twice the precision rounded to fp32.  The sum and
// its error term relay from lane to lane as group_dot's sum does.
template <int G, int C>
__device__ __forceinline__ float group_dot2(const float (&a)[C],
                                            const float (&b)[C]) {
  float run = 0.0f, run_err = 0.0f;
#pragma unroll
  for (int t = 0; t < G; ++t) {
    float mine = run, mine_err = run_err;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float p = __fmul_rn(a[c], b[c]);
      float e;
      mine = two_sum(mine, p, e);
      mine_err = __fadd_rn(mine_err, __fadd_rn(__fmaf_rn(a[c], b[c], -p),
                                               e));
    }
    run = from_lane<G>(mine, t);
    run_err = from_lane<G>(mine_err, t);
  }
  return __fadd_rn(run, run_err);
}

// The sum of exp(v - m) over the group's components that are on.
template <int G, int C>
__device__ __forceinline__ float group_sum_exp(const float (&v)[C],
                                               const bool (&on)[C], float m) {
  float e[C];
#pragma unroll
  for (int c = 0; c < C; ++c) e[c] = on[c] ? expf(v[c] - m) : 0.0f;
  return group_sum<G, C>(e);
}

// logsumexp over the group's components that are on.
template <int G, int C>
__device__ __forceinline__ float group_logsumexp(const float (&v)[C],
                                                 const bool (&on)[C]) {
  const float m = group_max<G, C>(v, on);
  return m + logf(group_sum_exp<G, C>(v, on, m));
}

// The three logsumexps of a, b and c; lanes 0, 1 and 2 of a group share
// one logf of the three sums where the group has them.
template <int G, int C>
__device__ __forceinline__ void group_logsumexp3(
    const float (&a)[C], const float (&b)[C], const float (&c)[C],
    const bool (&on)[C], float& lse_a, float& lse_b, float& lse_c) {
  const float ma = group_max<G, C>(a, on), mb = group_max<G, C>(b, on);
  const float mc = group_max<G, C>(c, on);
  const float sa = group_sum_exp<G, C>(a, on, ma);
  const float sb = group_sum_exp<G, C>(b, on, mb);
  const float sc = group_sum_exp<G, C>(c, on, mc);
  if constexpr (G == 1) {
    lse_a = ma + logf(sa);
    lse_b = mb + logf(sb);
    lse_c = mc + logf(sc);
  } else {
    const int l = (int)(threadIdx.x % G);
    const float v = logf(l == 0 ? sa : l == 1 ? sb : sc);
    lse_a = ma + from_lane<G>(v, 0);
    lse_b = mb + from_lane<G>(v, 1);
    if constexpr (G > 2) lse_c = mc + from_lane<G>(v, 2);
    else lse_c = mc + logf(sc);
  }
}

// A lane's components at x: the log-softmax of the logits, the clipped
// log-scales, z and the three log-terms of F (cdf), of 1 - F (sf) and of f
// (pdf), as the per-element loop computes them.  FULL: k == G * C, so no
// component is tested against k.
template <int C>
struct Terms {
  bool on[C];
  float raw_ls[C], log_pi[C], neg_ls[C], inv_s[C], z[C], lsp[C], cdf[C],
      sf[C], pdf[C];
};

template <int G, int C, bool FULL>
__device__ __forceinline__ void load_terms(
    Terms<C>& q, const float* __restrict__ pi, long pi_stride,
    const float* __restrict__ mu, long mu_stride,
    const float* __restrict__ ls, long ls_stride, long i, int l, bool live,
    int k, float x) {
  float logit[C], mean[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = C * l + c;
    q.on[c] = FULL || (live && j < k);
    logit[c] = -INFINITY;
    mean[c] = 0.0f;
    q.raw_ls[c] = 0.0f;
    if (live && (FULL || j < k)) {
      logit[c] = pi[i * pi_stride + j];
      mean[c] = mu[i * mu_stride + j];
      q.raw_ls[c] = ls[i * ls_stride + j];
    }
  }
  const float lse = group_logsumexp<G, C>(logit, q.on);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    q.log_pi[c] = logit[c] - lse;
    q.neg_ls[c] = -fminf(fmaxf(q.raw_ls[c], kLogScaleMin), kLogScaleMax);
    q.inv_s[c] = expf(q.neg_ls[c]);
    q.z[c] = __fmul_rn(x - mean[c], q.inv_s[c]);
    float lsn;
    log_sigmoid_pair(q.z[c], q.lsp[c], lsn);
    q.cdf[c] = q.log_pi[c] + q.lsp[c];
    q.sf[c] = q.log_pi[c] + lsn;
    q.pdf[c] = q.log_pi[c] + q.lsp[c] + lsn + q.neg_ls[c];
  }
}

// This thread's element i and lane l; ``live`` is false past m.
template <int G>
__device__ __forceinline__ void element_and_lane(long m, long& i, int& l,
                                                 bool& live) {
  const long t = blockIdx.x * (long)blockDim.x + threadIdx.x;
  i = t / G;
  l = (int)(threadIdx.x % G);
  live = i < m;
}

template <int G, int C, bool FULL>
__global__ void mixture_forward_kernel(
    const float* __restrict__ x, const float* __restrict__ pi, long pi_stride,
    const float* __restrict__ mu, long mu_stride,
    const float* __restrict__ ls, long ls_stride, float* __restrict__ y,
    float* __restrict__ ldj, long m, int k) {
  long i;
  int l;
  bool live;
  element_and_lane<G>(m, i, l, live);
  Terms<C> q;
  load_terms<G, C, FULL>(q, pi, pi_stride, mu, mu_stride, ls, ls_stride, i,
                         l, live, k, live ? x[i] : 0.0f);
  float log_cdf, log_sf, log_pdf;
  group_logsumexp3<G, C>(q.cdf, q.sf, q.pdf, q.on, log_cdf, log_sf, log_pdf);
  if (live && l == 0) {
    y[i] = log_cdf - log_sf;
    ldj[i] = log_pdf - log_cdf - log_sf;
  }
}

// Backward of mixture_forward_kernel: given the cotangents gy, gldj of
// y = A - B and ldj = C - A - B (A, B, C the three logsumexps), pull them
// back to x, the raw logits (through the log-softmax), the means and the
// raw log-scales (zero where the clip is active, as torch.clamp).  The
// per-component terms are recomputed here, as the forward computes them,
// rather than saved as [M, K] intermediates.  Each product and sum is
// rounded where the per-element loop's SASS rounds it (nvcc contracts that
// loop's products into the sums that take them): ga = g_a * exp(a - A) is
// never rounded, both sums that take it are fused multiply-adds.
template <int G, int C, bool FULL>
__global__ void mixture_forward_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ pi, long pi_stride,
    const float* __restrict__ mu, long mu_stride,
    const float* __restrict__ ls, long ls_stride,
    const float* __restrict__ gy, const float* __restrict__ gldj,
    float* __restrict__ gx, float* __restrict__ gpi, float* __restrict__ gmu,
    float* __restrict__ gls, long m, int k) {
  long i;
  int l;
  bool live;
  element_and_lane<G>(m, i, l, live);
  Terms<C> q;
  load_terms<G, C, FULL>(q, pi, pi_stride, mu, mu_stride, ls, ls_stride, i,
                         l, live, k, live ? x[i] : 0.0f);
  float lse_a, lse_b, lse_c;
  group_logsumexp3<G, C>(q.cdf, q.sf, q.pdf, q.on, lse_a, lse_b, lse_c);
  const float g_y = live ? gy[i] : 0.0f, g_l = live ? gldj[i] : 0.0f;
  const float g_a = g_y - g_l, g_b = -g_y - g_l, g_c = g_l;
  float gz[C], inv_s[C], gc[C], d_log_pi[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float ea = expf(q.cdf[c] - lse_a);
    const float gb = __fmul_rn(g_b, expf(q.sf[c] - lse_b));
    gc[c] = __fmul_rn(g_c, expf(q.pdf[c] - lse_c));
    // d lsp/dz = sigmoid(-z) = exp(lsn), d lsn/dz = -sigmoid(z), where
    // lsn = lsp - z exactly as log_sigmoid_pair computes it
    const float g = __fmaf_rn(
        __fmaf_rn(g_a, ea, gc[c]), expf(q.lsp[c] - q.z[c]),
        -__fmul_rn(__fadd_rn(gb, gc[c]), expf(q.lsp[c])));
    d_log_pi[c] = q.on[c] ? __fadd_rn(__fmaf_rn(g_a, ea, gb), gc[c]) : 0.0f;
    gz[c] = q.on[c] ? g : 0.0f;
    inv_s[c] = q.on[c] ? q.inv_s[c] : 0.0f;
  }
  const float g_x = group_dot<G, C>(gz, inv_s);
  const float g_lp_sum = group_sum<G, C>(d_log_pi);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (live && (FULL || C * l + c < k)) {
      const long o = i * k + C * l + c;
      const bool inside = q.raw_ls[c] >= kLogScaleMin &&
                          q.raw_ls[c] <= kLogScaleMax;
      gmu[o] = __fmul_rn(-gz[c], inv_s[c]);
      gls[o] = inside ? __fmaf_rn(-gz[c], q.z[c], -gc[c]) : 0.0f;
      gpi[o] = __fmaf_rn(expf(q.log_pi[c]), -g_lp_sum, d_log_pi[c]);
    }
  }
  if (live && l == 0) gx[i] = g_x;
}

// The inverse (#1): x with logit F(x) = y, by rtsafe as _inverse_kernel:
// the bracket [min_k, max_k](mu_k + s_k y) (with a slack for its
// rounding), then iterations of a Newton step inside the bracket, else the
// midpoint; the midpoint also when the step fails to halve the previous
// one (kills the Newton two-cycle across the root).  It returns the
// iterate with the least |g| (keep_best), where the TPU kernel returns the
// last; and an element stops once it is done (rtsafe_done), a warp once
// all its elements are, or after kMaxIters, where the TPU kernel runs 24
// iterations for every element.  An element takes a group of lanes as the forward's
// (kInvLanes for K <= 8, twice as many for K <= 16, C = 8 / kInvLanes
// components a lane; kWideInvLanes for K <= 32), and every lane of the
// group runs the element's rtsafe update on the same values, so that the
// group stays in step.
//
// An iterate is evaluated in one of two domains.
// - Linear, for every element with |y| <= kLinearMaxY: with e = exp(-|z|)
//   and r = 1 / (1 + e), sigmoid(|z|) = r and sigmoid(-|z|) = e r.  With
//   pi_k = exp(log pi_k) taken once, F = sum pi_k sigmoid(z_k), S = 1 - F =
//   sum pi_k sigmoid(-z_k) and f = sum pi_k / s_k sigmoid(z_k)
//   sigmoid(-z_k) cost one exp2f and one correctly rounded reciprocal a
//   component, and the element one division and one logf for g = log(F /
//   S) - y and one division for the Newton step g F S / f.  S is computed
//   as its own sum, never as 1 - F, so neither tail cancels.  Where an
//   iterate lies far right (left) of every component, S (F) may fall below
//   kLinearMin (2^-100) or underflow.  There the sign of g is still
//   certain, because log S < -69.3 < -kLinearMaxY <= -y (likewise for F),
//   and the iteration bisects on it.
// - Log, for the others, whose root may itself lie where the linear sums
//   underflow: log F, log(1 - F) and log f as three logsumexps over the
//   components, as the forward computes them, the sums relayed in the
//   per-element loop's order (a warp with any such element runs both
//   loops).  It costs an expf and a log1pf a component for the
//   log-sigmoids, three expf a component and three logf for the sums, every
//   iteration: the original one-thread kernel's arithmetic, which runs the
//   log domain for every element.

// |g| at or below kConverged (1 + |y|) counts as converged (rtsafe_update):
// 4 ulps of 1 + |y|, at or below the residual check's floor tau = 2^-21
// (softplus(y) + softplus(-y)) for every y.  At 16 ulps an element could
// stop on an iterate whose residual was twice tau where |y| is large (a
// masked bond position of GraphCNF's sample, y = 4.4e7, read 1.8 times the
// check's limit; PERF.md).  An element that cannot reach the floor
// runs on until its bracket holds no float (rtsafe_done).
//
// The groups of more than 8 components (K = 16 and 32) sum F and S
// compensated (group_dot2).  A plain fmaf chain rounds once a term: its
// error in g reached 5e-7 to 1e-6, the size of the check's floor, at K =
// 32 on the language models' samples and at K = 16 on the molecules', so
// that the best iterate by the computed |g| was at times not the best by
// the true one (a residual 1.28 and 1.07 times the check's limit,
// PERF.md).  Compensated, F and S carry about one rounding each.  K <= 8
// keeps the plain chains: they pass there, in 14% less time (PERF.md).
constexpr float kConverged = 0x1p-22f;
constexpr float kLinearMaxY = 64.0f;
constexpr float kLinearMin = 0x1p-100f;
constexpr float kBracketSlack = 0x1p-21f;
constexpr float kLog2e = 1.44269504088896341f;

// A lane's components: log-softmax of the logits, means, negated clipped
// log-scales and 1 / s; ``on``: the component exists (j < k).
template <int C>
struct InvParams {
  bool on[C];
  float log_pi[C], mean[C], neg_ls[C], inv_s[C];
};

template <int G, int C, bool FULL>
__device__ __forceinline__ void load_inverse_params(
    InvParams<C>& p, const float* __restrict__ pi, long pi_stride,
    const float* __restrict__ mu, long mu_stride,
    const float* __restrict__ ls, long ls_stride, long i, int l, int k) {
  float logit[C], raw_ls[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = C * l + c;
    p.on[c] = FULL || j < k;
    logit[c] = -INFINITY;
    p.mean[c] = 0.0f;
    raw_ls[c] = 0.0f;
    if (FULL || j < k) {
      logit[c] = pi[i * pi_stride + j];
      p.mean[c] = mu[i * mu_stride + j];
      raw_ls[c] = ls[i * ls_stride + j];
    }
  }
  const float lse = group_logsumexp<G, C>(logit, p.on);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    p.log_pi[c] = logit[c] - lse;
    p.neg_ls[c] = -fminf(fmaxf(raw_ls[c], kLogScaleMin), kLogScaleMax);
    p.inv_s[c] = expf(p.neg_ls[c]);
  }
}

// The exact bracket [min, max](mu_k + s_k y) over the components whose
// log-weight is above -5e29 (the -1e30 the TPU kernel pads with is left
// out), each end moved out by 2^-21 (|mu_k| + |s_k y|), four times what
// the rounding of s_k and of mu_k + s_k y can take from it: where one
// component holds all the weight, the root is its mu_k + s_k y, and the
// rounded end could otherwise shut it out.  fminf and fmaxf are
// order-free, so a butterfly serves.
template <int G, int C>
__device__ __forceinline__ void inverse_bracket(const InvParams<C>& p,
                                                float y, float& lo,
                                                float& hi) {
  lo = INFINITY;
  hi = -INFINITY;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (p.on[c] && p.log_pi[c] > kNegBig * 0.5f) {
      const float sy = __fmul_rn(expf(-p.neg_ls[c]), y);
      const float cand = __fadd_rn(p.mean[c], sy);
      const float margin = kBracketSlack * (fabsf(p.mean[c]) + fabsf(sy));
      lo = fminf(lo, cand - margin);
      hi = fmaxf(hi, cand + margin);
    }
  }
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(kFull, lo, o, G));
    hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, o, G));
  }
}

// One rtsafe update from g = logit F(x) - y and the Newton step.  Once
// |g| <= g_floor, g is at the level of its own rounding error and x is a
// root as far as fp32 can tell: the update then takes the Newton step
// where it stays inside the bracket, else keeps x, and never bisects.
// Without that, a Newton sequence that converged from one side (the far
// end of the bracket unmoved since the first iteration) meets g = 0, a
// step below half an ulp, or a step of rounding noise that fails to halve
// the last one; each is "bad", and the midpoint of the wide bracket then
// throws x away, to end ~1e-5 off after the remaining bisections.
__device__ __forceinline__ void rtsafe_update(float g, float step,
                                              float g_floor, float& x,
                                              float& lo, float& hi,
                                              float& dx_old) {
  if (g < 0.0f) lo = x; else hi = x;
  float nxt = x - step;
  if (fabsf(g) <= g_floor) {
    if (nxt > lo && nxt < hi) {
      x = nxt;
      dx_old = fabsf(step);
    }
    return;
  }
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

// The iterate with the least |g| so far: what rtsafe returns, so that a
// bisection late in the loop, or a Newton step that overshoots by an ulp,
// cannot leave x worse than an iterate it has already evaluated.  A g that
// is only a sign (the linear sums underflowed) is no candidate.  Returns
// whether x is the new best.
__device__ __forceinline__ bool keep_best(float g, float x, float& x_best,
                                          float& g_best) {
  if (fabsf(g) < g_best) {
    g_best = fabsf(g);
    x_best = x;
    return true;
  }
  return false;
}

// An element is done, and keeps its state from then on, once the bracket
// holds no float between its ends (both were evaluated, so the best of
// them is kept), or once its best |g| is at the convergence floor and the
// last iteration did not better it.  From the same inputs an element so
// ends with the same x whichever elements share its warp.
__device__ __forceinline__ bool rtsafe_done(bool improved, float g_best,
                                            float g_floor, float lo,
                                            float hi) {
  return nextafterf(lo, INFINITY) >= hi || (g_best <= g_floor && !improved);
}

// rtsafe in the log domain.
template <int G, int C>
__device__ __forceinline__ float rtsafe_log(const InvParams<C>& p, float y,
                                            float lo, float hi, bool active,
                                            int& iters) {
  const float g_floor = kConverged * (1.0f + fabsf(y));
  float x = 0.5f * (lo + hi);
  float dx_old = hi - lo;
  float x_best = x, g_best = INFINITY;
  bool done = !active;
#pragma unroll 1
  for (int it = 0; it < kMaxIters; ++it) {
    if (__all_sync(kFull, done)) break;
    float a[C], b[C], c[C];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      float lsp, lsn;
      log_sigmoid_pair(__fmul_rn(x - p.mean[j], p.inv_s[j]), lsp, lsn);
      a[j] = p.log_pi[j] + lsp;
      b[j] = p.log_pi[j] + lsn;
      c[j] = p.log_pi[j] + lsp + lsn + p.neg_ls[j];
    }
    float log_cdf, log_sf, log_pdf;
    group_logsumexp3<G, C>(a, b, c, p.on, log_cdf, log_sf, log_pdf);
    if (done) continue;
    const float g = log_cdf - log_sf - y;
    const bool improved = keep_best(g, x, x_best, g_best);
    rtsafe_update(g, g * expf(log_cdf + log_sf - log_pdf), g_floor, x, lo,
                  hi, dx_old);
    ++iters;
    done = rtsafe_done(improved, g_best, g_floor, lo, hi);
  }
  return g_best < INFINITY ? x_best : x;
}

// A lane's components for the linear domain: means, log2(e) / s, the
// weights pi and pi / s (0 for components j >= k).
template <int C>
struct LinParams {
  float mean[C], t_scale[C], w[C], w_pdf[C];
};

// rtsafe in the linear domain.
template <int G, int C>
__device__ __forceinline__ float rtsafe_linear(const LinParams<C>& q,
                                               float y, float lo, float hi,
                                               bool active, int& iters) {
  const float g_floor = kConverged * (1.0f + fabsf(y));
  float x = 0.5f * (lo + hi);
  float dx_old = hi - lo;
  float x_best = x, g_best = INFINITY;
  bool done = !active;
#pragma unroll 1
  for (int it = 0; it < kMaxIters; ++it) {
    if (__all_sync(kFull, done)) break;
    float sig[C], sig_neg[C], sig_pair[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float t = (x - q.mean[c]) * q.t_scale[c];  // z log2(e)
      const float e = exp2f(-fabsf(t));                 // exp(-|z|)
      const float r = __frcp_rn(1.0f + e);              // sigmoid(|z|)
      const float s = e * r;                            // sigmoid(-|z|)
      sig[c] = t >= 0.0f ? r : s;
      sig_neg[c] = t >= 0.0f ? s : r;
      sig_pair[c] = r * s;
    }
    // F and S compensated above 8 components (above); f, which only
    // scales the step, plain
    float F, S;
    if constexpr (G * C > 8) {
      F = group_dot2<G, C>(q.w, sig);
      S = group_dot2<G, C>(q.w, sig_neg);
    } else {
      F = group_dot<G, C>(q.w, sig);
      S = group_dot<G, C>(q.w, sig_neg);
    }
    const float f = group_dot<G, C>(q.w_pdf, sig_pair);
    if (done) continue;
    float g, step;
    bool improved = false;
    if (fminf(F, S) >= kLinearMin) {
      g = logf(F / S) - y;
      step = g * (F * S) / f;
      improved = keep_best(g, x, x_best, g_best);
    } else {  // the sign of g is certain; bisect
      g = S < F ? 1.0f : -1.0f;
      step = NAN;
    }
    rtsafe_update(g, step, g_floor, x, lo, hi, dx_old);
    ++iters;
    done = rtsafe_done(improved, g_best, g_floor, lo, hi);
  }
  return g_best < INFINITY ? x_best : x;
}

// No thread returns early: the group's shuffles and the warp's votes need
// every lane.  A lane past m works on element m - 1 and stores nothing (an
// empty bracket's NaN would send every iteration's reciprocal and
// divisions down their slow paths); a warp with no element of its own
// skips both loops.
template <int G, int C, bool FULL>
__global__ void mixture_inverse_kernel(
    const float* __restrict__ y, const float* __restrict__ pi, long pi_stride,
    const float* __restrict__ mu, long mu_stride,
    const float* __restrict__ ls, long ls_stride, float* __restrict__ out,
    int* __restrict__ iters_out, long m, int k) {
  long i;
  int l;
  bool live;
  element_and_lane<G>(m, i, l, live);
  const long e = live ? i : m - 1;
  InvParams<C> p;
  load_inverse_params<G, C, FULL>(p, pi, pi_stride, mu, mu_stride, ls,
                                  ls_stride, e, l, k);
  const float yi = y[e];
  float lo, hi;
  inverse_bracket<G, C>(p, yi, lo, hi);
  LinParams<C> q;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    q.mean[c] = p.mean[c];
    q.t_scale[c] = p.inv_s[c] * kLog2e;
    q.w[c] = p.on[c] ? expf(p.log_pi[c]) : 0.0f;
    q.w_pdf[c] = q.w[c] * p.inv_s[c];
  }
  const bool log_domain = fabsf(yi) > kLinearMaxY;
  float x = 0.0f;
  int iters = 0;
  if (__any_sync(kFull, live && log_domain))
    x = rtsafe_log<G, C>(p, yi, lo, hi, live && log_domain, iters);
  if (__any_sync(kFull, live && !log_domain)) {
    const float x_lin = rtsafe_linear<G, C>(q, yi, lo, hi,
                                            live && !log_domain, iters);
    if (!log_domain) x = x_lin;
  }
  if (live && l == 0) {
    out[i] = x;
    if (iters_out != nullptr) iters_out[i] = iters;
  }
}

// The inverse's backward by the reference's rule (#1'): the reference
// differentiates its inverse (categoricalnf_tpu/ops/numerics.py
// mixture_inverse_logit_cdf, 42 bisections in the bracket [min_k, max_k](mu_k
// + s_k y), then 3 Newton steps clipped to the last bracket) with XLA's
// reverse mode, and the port's plain loop (ops/numerics.py) with autograd.
// This kernel reruns that loop from the inputs, one thread an element, and
// pulls gx back through it as reverse mode does:
// - bisection: every bracket is lo0, hi0 or a midpoint of two earlier ones,
//   so it is a lo0 + b hi0 with (a, b) carried beside it (halving is exact);
//   the comparisons pass no gradient;
// - Newton: x <- min(max(x - step, lo), hi), the gradient to each side ½ at a
//   tie (jnp.clip's and torch.maximum/minimum's rule); step = (log F - log S
//   - y) exp(log F + log S - log f) by its first derivatives; the 3 iterates
//   and their clip weights are kept, the terms at each are recomputed;
// - the bracket's ends: to the arg-min and arg-max components (shared
//   equally among ties), then through mu_k + exp(ls_k) y;
// - a log-scale outside [kLogScaleMin, kLogScaleMax] gets 0 (the clip).
// Every operation mirrors the plain loop's on the card (the products and
// sums unfused, the sums over the components in the order of torch's CUDA
// kernels: torch_sum_order), so that its bisections take the plain loop's
// branches.  A branch depends on the last bit of log F - log S near the
// root, and one taken the other way moves that element's gradient between
// lo0 and hi0 by up to all of it; tools/loop_branches.py compares the
// branches on the card (PERF.md).  Bound on an H100: 45 evaluations of the K
// components' terms an element (about 20 operations a component each; 0.9
// MFLOP a K = 4 element set at M = 65,536: operations), against 12 + 24 K
// bytes an element in and out.
constexpr int kNumBisect = 42;
constexpr int kNumNewton = 3;

template <int C>
struct LoopParams {
  float log_pi[C], mean[C], ls[C], inv_s[C];
};

// The sum of e[0, k) (e[c] = 0 for c >= k) in the order of torch's sums
// over a short last dimension on the card, which torch.sum (so
// torch.logsumexp) and torch.log_softmax share: a butterfly over W lanes, W
// the least power of two >= k, so that lane 0 adds element l + o to l for o
// = W/2, ..., 1.  The halvings above W add exact zeros.  (On an H100 with
// torch 2.11 this order gives torch's bits on every row at each K of
// 1..32: tools/loop_branches.py.)
template <int C>
__device__ __forceinline__ float torch_sum_order(float (&e)[C]) {
#pragma unroll
  for (int o = C / 2; o >= 1; o /= 2) {
#pragma unroll
    for (int l = 0; l < o; ++l) e[l] = __fadd_rn(e[l], e[l + o]);
  }
  return e[0];
}

// logsumexp over the element's k components as torch.logsumexp: the max,
// then max + log(sum exp(v - max)), the sum in torch.sum's order.
template <int C>
__device__ __forceinline__ float loop_lse(const float (&v)[C], int k) {
  float m = -INFINITY;
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (c < k) m = fmaxf(m, v[c]);
  if (isinf(m)) return m;
  float e[C];
#pragma unroll
  for (int c = 0; c < C; ++c) e[c] = c < k ? expf(__fsub_rn(v[c], m)) : 0.0f;
  return __fadd_rn(logf(torch_sum_order<C>(e)), m);
}

// The terms of the loop at x: a = log pi + log sigmoid(z), b = log pi +
// log sigmoid(-z) and (PDF) c = log pi + a' + b' - ls, and their
// logsumexps log F, log S, log f.
template <int C, bool PDF>
__device__ __forceinline__ void loop_parts(const LoopParams<C>& p, int k,
                                           float x, float (&z)[C],
                                           float (&a)[C], float (&b)[C],
                                           float (&c)[C], float& lf,
                                           float& ls_, float& lp) {
#pragma unroll
  for (int j = 0; j < C; ++j) {
    z[j] = __fmul_rn(__fsub_rn(x, p.mean[j]), p.inv_s[j]);
    float lsp, lsn;
    log_sigmoid_pair(z[j], lsp, lsn);
    a[j] = __fadd_rn(p.log_pi[j], lsp);
    b[j] = __fadd_rn(p.log_pi[j], lsn);
    if constexpr (PDF)
      c[j] = __fsub_rn(__fadd_rn(__fadd_rn(p.log_pi[j], lsp), lsn), p.ls[j]);
  }
  lf = loop_lse<C>(a, k);
  ls_ = loop_lse<C>(b, k);
  if constexpr (PDF) lp = loop_lse<C>(c, k);
}

template <int C>
__global__ void mixture_inverse_loop_bwd_kernel(
    const float* __restrict__ y, const float* __restrict__ pi, long pi_stride,
    const float* __restrict__ mu, long mu_stride,
    const float* __restrict__ lsr, long ls_stride,
    const float* __restrict__ gx, float* __restrict__ gy,
    float* __restrict__ gpi, float* __restrict__ gmu, float* __restrict__ gls,
    long m, int k) {
  const long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (i >= m) return;
  LoopParams<C> p;
  bool inside[C];
  float logit[C], mx = -INFINITY;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    logit[c] = 0.0f;
    p.mean[c] = 0.0f;
    p.ls[c] = 0.0f;
    inside[c] = false;
    if (c < k) {
      logit[c] = pi[i * pi_stride + c];
      p.mean[c] = mu[i * mu_stride + c];
      const float raw = lsr[i * ls_stride + c];
      inside[c] = raw >= kLogScaleMin && raw <= kLogScaleMax;
      p.ls[c] = fminf(fmaxf(raw, kLogScaleMin), kLogScaleMax);
      mx = fmaxf(mx, logit[c]);
    }
  }
  // log_softmax as torch: (v - max) - log(sum exp(v - max))
  float e[C];
#pragma unroll
  for (int c = 0; c < C; ++c)
    e[c] = c < k ? expf(__fsub_rn(logit[c], mx)) : 0.0f;
  const float lse = logf(torch_sum_order<C>(e));
#pragma unroll
  for (int c = 0; c < C; ++c) {
    p.log_pi[c] = __fsub_rn(__fsub_rn(logit[c], mx), lse);
    p.inv_s[c] = expf(-p.ls[c]);
  }
  const float yi = y[i];

  // the bracket, and which components give its ends
  float scale[C], lo0 = INFINITY, hi0 = -INFINITY;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    scale[c] = expf(p.ls[c]);
    if (c < k) {
      const float cand = __fadd_rn(p.mean[c], __fmul_rn(scale[c], yi));
      lo0 = fminf(lo0, cand);
      hi0 = fmaxf(hi0, cand);
    }
  }
  // bisection: lo = la lo0 + lb hi0, hi = ha lo0 + hb hi0
  float lo = lo0, hi = hi0, la = 1.0f, lb = 0.0f, ha = 0.0f, hb = 1.0f;
  float z[C], ta[C], tb[C], tc[C];
#pragma unroll 1
  for (int it = 0; it < kNumBisect; ++it) {
    const float mid = 0.5f * __fadd_rn(lo, hi);
    const float ma = 0.5f * __fadd_rn(la, ha), mb = 0.5f * __fadd_rn(lb, hb);
    float lf, lsf, unused;
    loop_parts<C, false>(p, k, mid, z, ta, tb, tc, lf, lsf, unused);
    if (__fsub_rn(lf, lsf) < yi) {
      lo = mid;
      la = ma;
      lb = mb;
    } else {
      hi = mid;
      ha = ma;
      hb = mb;
    }
  }
  // Newton: the iterates and the clip's weights (to the step, to lo, to hi)
  float xs[kNumNewton], w_u[kNumNewton], w_lo[kNumNewton], w_hi[kNumNewton];
  float x = 0.5f * __fadd_rn(lo, hi);
#pragma unroll
  for (int n = 0; n < kNumNewton; ++n) {
    xs[n] = x;
    float lf, lsf, lpdf;
    loop_parts<C, true>(p, k, x, z, ta, tb, tc, lf, lsf, lpdf);
    const float step =
        __fmul_rn(__fsub_rn(__fsub_rn(lf, lsf), yi),
                  expf(__fsub_rn(__fadd_rn(lf, lsf), lpdf)));
    const float u = __fsub_rn(x, step);
    const float mxv = fmaxf(u, lo);
    const float to_u = u > lo ? 1.0f : (u == lo ? 0.5f : 0.0f);
    const float to_m = mxv < hi ? 1.0f : (mxv == hi ? 0.5f : 0.0f);
    w_u[n] = to_m * to_u;
    w_lo[n] = to_m * (1.0f - to_u);
    w_hi[n] = 1.0f - to_m;
    x = fminf(mxv, hi);
  }

  // reverse
  float g = gx[i], g_lo = 0.0f, g_hi = 0.0f, g_y = 0.0f;
  float g_lp[C], g_mu[C], g_ls[C];
#pragma unroll
  for (int c = 0; c < C; ++c) g_lp[c] = g_mu[c] = g_ls[c] = 0.0f;
#pragma unroll
  for (int n = kNumNewton - 1; n >= 0; --n) {
    g_lo += g * w_lo[n];
    g_hi += g * w_hi[n];
    const float g_u = g * w_u[n];
    float lf, lsf, lpdf;
    loop_parts<C, true>(p, k, xs[n], z, ta, tb, tc, lf, lsf, lpdf);
    const float f = __fsub_rn(__fsub_rn(lf, lsf), yi);
    const float e = expf(__fsub_rn(__fadd_rn(lf, lsf), lpdf));
    const float g_step = -g_u;
    const float g_f = g_step * e, g_e = g_step * f * e;
    const float g_lf = g_f + g_e, g_lsf = g_e - g_f, g_lpdf = -g_e;
    g_y -= g_f;
    float g_x = g_u;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (c < k) {
        const float ga = g_lf * expf(ta[c] - lf);
        const float gb = g_lsf * expf(tb[c] - lsf);
        const float gc = g_lpdf * expf(tc[c] - lpdf);
        g_lp[c] += ga + gb + gc;
        // d lsp/dz = sigmoid(-z) = exp(lsp - z), d lsn/dz = -sigmoid(z)
        float lsp, lsn;
        log_sigmoid_pair(z[c], lsp, lsn);
        const float gz =
            (ga + gc) * expf(lsp - z[c]) - (gb + gc) * expf(lsp);
        g_x += gz * p.inv_s[c];
        g_mu[c] -= gz * p.inv_s[c];
        g_ls[c] -= gc + gz * z[c];
      }
    }
    g = g_x;
  }
  // x0 = (lo + hi) / 2, then lo, hi to the bracket's ends
  const float g_lo_end = 0.5f * g + g_lo, g_hi_end = 0.5f * g + g_hi;
  const float g_lo0 = g_lo_end * la + g_hi_end * ha;
  const float g_hi0 = g_lo_end * lb + g_hi_end * hb;
  int n_lo = 0, n_hi = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (c < k) {
      const float cand = __fadd_rn(p.mean[c], __fmul_rn(scale[c], yi));
      n_lo += cand == lo0;
      n_hi += cand == hi0;
    }
  }
  float g_lp_sum = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (c < k) {
      const float cand = __fadd_rn(p.mean[c], __fmul_rn(scale[c], yi));
      const float gc = (cand == lo0 ? g_lo0 / n_lo : 0.0f) +
                       (cand == hi0 ? g_hi0 / n_hi : 0.0f);
      g_mu[c] += gc;
      g_y += gc * scale[c];
      g_ls[c] += gc * scale[c] * yi;
      g_lp_sum += g_lp[c];
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (c < k) {
      const long o = i * k + c;
      gpi[o] = g_lp[c] - expf(p.log_pi[c]) * g_lp_sum;
      gmu[o] = g_mu[c];
      gls[o] = inside[c] ? g_ls[c] : 0.0f;
    }
  }
  gy[i] = g_y;
}

constexpr int kThreads = 256;

inline unsigned blocks_for(long m) {
  return (unsigned)((m + kThreads - 1) / kThreads);
}

// Lanes of an element for K <= 8, twice as many for K <= 16, so that a
// lane holds C = 8 / lanes components.  The forward takes 4 components a
// lane; its backward, with about twice the work a component, 2: on an H100
// each was the fastest of 1, 2, 4 and 8 components a lane (PERF.md).
constexpr int kFwdLanes = 2, kBwdLanes = 4;

// The inverse's lanes an element for K <= 8, twice as many for K <= 16:
// one lane was the fastest of 1, 2, 4 and 8 at M = 65,536 on an H100,
// more lanes only at small M (PERF.md).
constexpr int kInvLanes = 1;

// Lanes an element for 16 < K <= 32, each lane holding 32 / lanes
// components (the language models' K = 32).  The split does not change a
// bit: every sum over the components runs in their order j = 0, 1, ...
// whatever the lanes, so only the time of each choice was compared on an
// H100, at the LM path's M = 131,072 (a train step) and 512 and 16
// (sampling): 8 lanes were the fastest or within 6% of it for each kernel
// (PERF.md).
constexpr int kWideFwdLanes = 8, kWideBwdLanes = 8, kWideInvLanes = 8;

// A K that fills the groups (the flagship's K = 8) takes kernels built
// without the test j < k.
template <int G, int C>
inline void forward_launch(const float* x, const float* pi, long pi_stride,
                           const float* mu, long mu_stride, const float* ls,
                           long ls_stride, float* y, float* ldj, long m,
                           int k, cudaStream_t s) {
  const unsigned blocks = blocks_for(m * G);
  if (k == G * C)
    mixture_forward_kernel<G, C, true><<<blocks, kThreads, 0, s>>>(
        x, pi, pi_stride, mu, mu_stride, ls, ls_stride, y, ldj, m, k);
  else
    mixture_forward_kernel<G, C, false><<<blocks, kThreads, 0, s>>>(
        x, pi, pi_stride, mu, mu_stride, ls, ls_stride, y, ldj, m, k);
}

template <int G, int C>
inline void bwd_launch(const float* x, const float* pi, long pi_stride,
                       const float* mu, long mu_stride, const float* ls,
                       long ls_stride, const float* gy, const float* gldj,
                       float* gx, float* gpi, float* gmu, float* gls, long m,
                       int k, cudaStream_t s) {
  const unsigned blocks = blocks_for(m * G);
  if (k == G * C)
    mixture_forward_bwd_kernel<G, C, true><<<blocks, kThreads, 0, s>>>(
        x, pi, pi_stride, mu, mu_stride, ls, ls_stride, gy, gldj, gx, gpi,
        gmu, gls, m, k);
  else
    mixture_forward_bwd_kernel<G, C, false><<<blocks, kThreads, 0, s>>>(
        x, pi, pi_stride, mu, mu_stride, ls, ls_stride, gy, gldj, gx, gpi,
        gmu, gls, m, k);
}

template <int G, int C>
inline void inverse_launch(const float* y, const float* pi, long pi_stride,
                           const float* mu, long mu_stride, const float* ls,
                           long ls_stride, float* out, int* iters, long m,
                           int k, cudaStream_t s) {
  const unsigned blocks = blocks_for(m * G);
  if (k == G * C)
    mixture_inverse_kernel<G, C, true><<<blocks, kThreads, 0, s>>>(
        y, pi, pi_stride, mu, mu_stride, ls, ls_stride, out, iters, m, k);
  else
    mixture_inverse_kernel<G, C, false><<<blocks, kThreads, 0, s>>>(
        y, pi, pi_stride, mu, mu_stride, ls, ls_stride, out, iters, m, k);
}

template <int C>
inline void loop_bwd_launch(const float* y, const float* pi, long pi_stride,
                            const float* mu, long mu_stride, const float* ls,
                            long ls_stride, const float* gx, float* gy,
                            float* gpi, float* gmu, float* gls, long m, int k,
                            cudaStream_t s) {
  mixture_inverse_loop_bwd_kernel<C><<<blocks_for(m), kThreads, 0, s>>>(
      y, pi, pi_stride, mu, mu_stride, ls, ls_stride, gx, gy, gpi, gmu, gls, m,
      k);
}

}  // namespace

extern "C" {

// Each entry point returns cudaGetLastError() after its launch; the
// Python wrapper checks k (1..32), shapes, strides and dtypes first.
int mixture_inverse_f32(const float* y, const float* pi, long pi_stride,
                        const float* mu, long mu_stride, const float* ls,
                        long ls_stride, float* out, int* iters, long m, int k,
                        void* stream) {
  if (m == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (k > 16)
    inverse_launch<kWideInvLanes, 32 / kWideInvLanes>(
        y, pi, pi_stride, mu, mu_stride, ls, ls_stride, out, iters, m, k, s);
  else if (k <= 8)
    inverse_launch<kInvLanes, 8 / kInvLanes>(y, pi, pi_stride, mu, mu_stride,
                                             ls, ls_stride, out, iters, m, k,
                                             s);
  else
    inverse_launch<2 * kInvLanes, 8 / kInvLanes>(
        y, pi, pi_stride, mu, mu_stride, ls, ls_stride, out, iters, m, k, s);
  return (int)cudaGetLastError();
}

int mixture_forward_f32(const float* x, const float* pi, long pi_stride,
                        const float* mu, long mu_stride, const float* ls,
                        long ls_stride, float* y, float* ldj, long m, int k,
                        void* stream) {
  if (m == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (k > 16)
    forward_launch<kWideFwdLanes, 32 / kWideFwdLanes>(
        x, pi, pi_stride, mu, mu_stride, ls, ls_stride, y, ldj, m, k, s);
  else if (k <= 8)
    forward_launch<kFwdLanes, 8 / kFwdLanes>(x, pi, pi_stride, mu, mu_stride,
                                             ls, ls_stride, y, ldj, m, k, s);
  else
    forward_launch<2 * kFwdLanes, 8 / kFwdLanes>(
        x, pi, pi_stride, mu, mu_stride, ls, ls_stride, y, ldj, m, k, s);
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
  if (k > 16)
    bwd_launch<kWideBwdLanes, 32 / kWideBwdLanes>(
        x, pi, pi_stride, mu, mu_stride, ls, ls_stride, gy, gldj, gx, gpi,
        gmu, gls, m, k, s);
  else if (k <= 8)
    bwd_launch<kBwdLanes, 8 / kBwdLanes>(x, pi, pi_stride, mu, mu_stride, ls,
                                         ls_stride, gy, gldj, gx, gpi, gmu,
                                         gls, m, k, s);
  else
    bwd_launch<2 * kBwdLanes, 8 / kBwdLanes>(x, pi, pi_stride, mu, mu_stride,
                                             ls, ls_stride, gy, gldj, gx, gpi,
                                             gmu, gls, m, k, s);
  return (int)cudaGetLastError();
}

// The inverse's backward by the reference's rule, from its inputs y and
// the parameters and the cotangent gx of its root: gy [m] and gpi, gmu, gls
// as contiguous [m, k].
int mixture_inverse_loop_bwd_f32(const float* y, const float* pi,
                                 long pi_stride, const float* mu,
                                 long mu_stride, const float* ls,
                                 long ls_stride, const float* gx, float* gy,
                                 float* gpi, float* gmu, float* gls, long m,
                                 int k, void* stream) {
  if (m == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 4)
    loop_bwd_launch<4>(y, pi, pi_stride, mu, mu_stride, ls, ls_stride, gx, gy,
                       gpi, gmu, gls, m, k, s);
  else if (k <= 8)
    loop_bwd_launch<8>(y, pi, pi_stride, mu, mu_stride, ls, ls_stride, gx, gy,
                       gpi, gmu, gls, m, k, s);
  else if (k <= 16)
    loop_bwd_launch<16>(y, pi, pi_stride, mu, mu_stride, ls, ls_stride, gx,
                        gy, gpi, gmu, gls, m, k, s);
  else
    loop_bwd_launch<32>(y, pi, pi_stride, mu, mu_stride, ls, ls_stride, gx,
                        gy, gpi, gmu, gls, m, k, s);
  return (int)cudaGetLastError();
}

}  // extern "C"
