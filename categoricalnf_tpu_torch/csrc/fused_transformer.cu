// The fp32 train step's FMA pair for sets of up to 32 rows: kernel #3
// (the forward of a differentiable fp32 call) and kernel #4 (the fp32
// backward), whose device code and design are in fused_transformer_fma.cuh.
// The backward's instance with regions of its tile in a global workspace
// is fused_transformer_f32_ws.cu's, and sets of 33 to 128 rows take the
// instances of fused_transformer_f32_big.cu: each source builds in
// parallel with the others.

#include "fused_transformer_fma.cuh"

extern "C" {

// Raise the kernels' dynamic shared-memory limit (the forward's, and the
// backward's with every region in shared memory) to a block's maximum,
// once for the current device (the attribute belongs to its context), so
// that no launch sets it.  Returns the first error.
int fused_set_transformer_f32_init(void) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_set_transformer_fwd<false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(
      fused_set_transformer_bwd<false, false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
}

// The forward of a differentiable fp32 call, x [rows, in] to y [rows,
// out].  key_mask: null or one byte a row of x (0 = a masked key of its
// set).  w: 12 fp32 layouts, the 6 W^T [pad4(n), pad4(kd)] then the 6 W
// [pad4(kd), pad4(n)] of (embed, qkv, proj, fc1, fc2, out), zero-padded
// (the forward reads the second 6); b: their 6 fp32 biases, in the same
// order.  Returns cudaGetLastError().
int fused_set_transformer_train_fwd_f32(const void* x, const void* key_mask,
                                        const void* const* w,
                                        const float* const* b, void* y,
                                        long rows, int set_size, int in_dim,
                                        int hidden, int heads, int layers,
                                        int mlp, int out_dim, void* stream) {
  Dims dm;
  if (!make_dims(dm, rows, set_size, in_dim, hidden, heads, layers, mlp,
                 out_dim, false))
    return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(dm);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const unsigned grid = (unsigned)((rows + dm.tile - 1) / dm.tile);
  fused_set_transformer_fwd<false><<<grid, kThreads, smem,
                                     (cudaStream_t)stream>>>(
      (const float*)x, (const unsigned char*)key_mask, fma_weights(w, b),
      (float*)y, dm);
  return (int)cudaGetLastError();
}

// Backward in fp32: x [rows, in], key_mask as the forward's and g [rows,
// out]; w and b as the forward's (the backward reads all 12 layouts);
// writes dx [rows, in] and the 12 fp32 weight gradients, flat in
// flatten_params order, to dw.  part is fp32 scratch of grid x (the size
// of dw); grid (<= the number of tiles) is the number of persistent
// blocks.  The layout: every region in shared memory where it fits, else
// the residual copies, then the MLP pair, then qkv in ws, fp32 scratch of
// grid x (their floats a block) (null where the shared layout is taken);
// global_ws = 1 moves all three, a check that only the storage moves.
// This entry takes the layout all in shared memory; one with regions in
// ws is fused_set_transformer_bwd_f32_ws's (fused_transformer_f32_ws.cu).
// The bf16 backward is the tensor-core kernel of fused_transformer_bf16.cu;
// sets of 33 to 128 rows take fused_transformer_f32_big.cu's entries.
int fused_set_transformer_bwd_f32(const void* x, const void* key_mask,
                                  const void* g, const void* const* w,
                                  const float* const* b, void* dx,
                                  float* part, float* dw, void* ws,
                                  long rows, int set_size, int in_dim,
                                  int hidden, int heads, int layers, int mlp,
                                  int out_dim, int grid, int global_ws,
                                  void* stream) {
  return bwd_f32_entry<false>(x, key_mask, g, w, b, dx, part, dw, ws, rows,
                              set_size, in_dim, hidden, heads, layers, mlp,
                              out_dim, grid, global_ws, stream);
}

}  // extern "C"
