// The fp32 train step's FMA pair for sets of 33 to 128 rows (the BIG
// instances of fused_transformer_fma.cuh): kernel #3, the forward of a
// differentiable fp32 call, and kernel #4, the fp32 backward, with a set
// over a thread-block cluster of 2 blocks (sets up to 64 rows) or 4 (up to
// 128), ceil(S / cluster) rows a block, so that each block keeps the
// 32-row tile of the sets up to 32; only attention crosses blocks, through
// distributed shared memory.  Their arithmetic is the pair's (fmaf chains,
// fp32 LN and softmax statistics), attention on register tiles, a warp a
// head's 16 rows against the set (attention_tiled_big).  Replaces, at these sets, the TPU kernels
// categoricalnf_tpu/ops/pallas/fused_transformer.py _fused_fwd and
// _fused_bwd, which the reference runs at sets of 64 and 128 (tiles of
// whole sets up to 128 rows).
//
// The instances live in their own source so that fused_transformer.cu,
// the build's longest, does not grow.

#include "fused_transformer_fma.cuh"

namespace {

// The backward's layout for a set above kMaxSet rows: all in shared memory
// (the BIG instance has no workspace layout) with the rings where they
// fit; 0 where it does not fit.
size_t big_bwd_smem(Dims& dm) {
  set_bwd_regions(dm, 0);
  if (sizeof(float) * bwd_smem_floats(dm) > (size_t)kMaxSmem) return 0;
  return with_rings(bwd_smem_floats(dm), kBwdThreads, dm);
}

}  // namespace

extern "C" {

// Raise the BIG kernels' dynamic shared-memory limit to a block's maximum,
// once for the current device.  Returns the first error.
int fused_set_transformer_f32_big_init(void) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_set_transformer_fwd<true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(
      fused_set_transformer_bwd<false, true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
}

// The clusters of the backward that the card holds at once at this net's
// layout (cudaOccupancyMaxActiveClusters), into *clusters: the persistent
// grid is that many clusters (a cluster of 4 fits only where 4 SMs of one
// GPC are free, so the SM count alone overstates it).  After the init.
int fused_set_transformer_f32_big_clusters(int set_size, int in_dim,
                                           int hidden, int heads, int layers,
                                           int mlp, int out_dim,
                                           int* clusters) {
  Dims dm;
  if (!make_dims(dm, set_size, set_size, in_dim, hidden, heads, layers, mlp,
                 out_dim, true))
    return (int)cudaErrorInvalidValue;
  const size_t smem = big_bwd_smem(dm);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(dm.cluster);
  cfg.blockDim = dim3(kBwdThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = dm.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(
      clusters, fused_set_transformer_bwd<false, true>, &cfg);
}

// The forward of a differentiable fp32 call at a set of 33 to 128 rows:
// the arguments of fused_set_transformer_train_fwd_f32
// (fused_transformer.cu); a cluster a set.
int fused_set_transformer_train_fwd_f32_big(
    const void* x, const void* key_mask, const void* const* w,
    const float* const* b, void* y, long rows, int set_size, int in_dim,
    int hidden, int heads, int layers, int mlp, int out_dim, void* stream) {
  Dims dm;
  if (!make_dims(dm, rows, set_size, in_dim, hidden, heads, layers, mlp,
                 out_dim, true))
    return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(dm);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const unsigned grid = (unsigned)(dm.cluster * (rows / set_size));
  return (int)launch_clustered(
      fused_set_transformer_fwd<true>, grid, kThreads, smem,
      (cudaStream_t)stream, dm.cluster, (const float*)x,
      (const unsigned char*)key_mask, fma_weights(w, b), (float*)y, dm);
}

// The fp32 backward at a set of 33 to 128 rows: the arguments of
// fused_set_transformer_bwd_f32 (fused_transformer.cu), ws null and
// global_ws 0 (its layout is all in shared memory); grid a multiple of
// the cluster, at most a cluster a set, each cluster walking the sets.
int fused_set_transformer_bwd_f32_big(const void* x, const void* key_mask,
                                      const void* g, const void* const* w,
                                      const float* const* b, void* dx,
                                      float* part, float* dw, void* ws,
                                      long rows, int set_size, int in_dim,
                                      int hidden, int heads, int layers,
                                      int mlp, int out_dim, int grid,
                                      int global_ws, void* stream) {
  Dims dm;
  if (!make_dims(dm, rows, set_size, in_dim, hidden, heads, layers, mlp,
                 out_dim, true) ||
      grid < 1 || global_ws || ws != nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t smem = big_bwd_smem(dm);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  if (grid % dm.cluster || grid > dm.cluster * (rows / set_size))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = launch_clustered(
      fused_set_transformer_bwd<false, true>, (unsigned)grid, kBwdThreads,
      smem, s, dm.cluster, (const float*)x, (const unsigned char*)key_mask,
      (const float*)g, fma_weights(w, b), (float*)dx, part, (float*)nullptr,
      dm);
  if (err != cudaSuccess) return (int)err;
  const Offsets og = grad_offsets(dm);
  reduce_wgrad<float><<<(unsigned)((og.off[12] + kThreads - 1) / kThreads),
                        kThreads, 0, s>>>(part, grid, og, dw);
  return (int)cudaGetLastError();
}

}  // extern "C"
