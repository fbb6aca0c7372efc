// The fp32 backward (kernel #4) of the fp32 train step's FMA pair at sets
// of up to 32 rows where its tile does not fit in shared memory: the
// instance of fused_transformer_fma.cuh that keeps regions of the tile (the
// residual copies, then the MLP pair, then qkv) in a per-block global
// workspace, GraphCNF's node flow at hidden 192 and 256.  It lives in its
// own source so that it builds in parallel with fused_transformer.cu's
// forward and shared-memory backward.

#include "fused_transformer_fma.cuh"

extern "C" {

// Raise the kernel's dynamic shared-memory limit to a block's maximum,
// once for the current device.  Returns the error.
int fused_set_transformer_f32_ws_init(void) {
  return (int)cudaFuncSetAttribute(
      fused_set_transformer_bwd<true, false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
}

// The arguments of fused_set_transformer_bwd_f32 (fused_transformer.cu),
// for a layout with regions in ws (global_ws = 1 moves all three, where
// the shared layout would fit too: a check that only the storage moves).
int fused_set_transformer_bwd_f32_ws(const void* x, const void* key_mask,
                                     const void* g, const void* const* w,
                                     const float* const* b, void* dx,
                                     float* part, float* dw, void* ws,
                                     long rows, int set_size, int in_dim,
                                     int hidden, int heads, int layers,
                                     int mlp, int out_dim, int grid,
                                     int global_ws, void* stream) {
  return bwd_f32_entry<true>(x, key_mask, g, w, b, dx, part, dw, ws, rows,
                             set_size, in_dim, hidden, heads, layers, mlp,
                             out_dim, grid, global_ws, stream);
}

}  // extern "C"
