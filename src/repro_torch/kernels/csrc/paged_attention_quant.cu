// One-token decode attention over quantized paged pools: int8 or fp8-e4m3
// codes with per-row float16 scales.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::
// paged_attention on quantized pools (pl.pallas_call at paged_attention.py:
// 154 with body _pa_kernel_quant :102, math in _pa_body :54-87). The kernel
// body, its contract, what bounds it and its design are in
// paged_attention.cuh, shared with the bf16 pools' kernel: the dot products
// run on the storage codes, each K row's scale multiplies its score and
// each V row's scale its probability, so pools cross device memory at one
// byte per element plus two bytes of scale per row and head.
#include "paged_attention.cuh"

// The wrapper (kernels/paged_attention.py) has checked D in {64, 128, 256},
// G <= 8 and the scales' shapes, and computed the launch geometry. fp8
// selects e4m3 codes, else int8.
extern "C" int paged_attention_quant(const void* q, const void* kp,
                                     const void* vp, const void* ks,
                                     const void* vs, const void* tables,
                                     const void* lengths, void* out, int fp8,
                                     int K, int G, int D, int page, int P,
                                     float scale, float cap, int grid_x,
                                     int grid_y, int smem, void* stream) {
  const dim3 grid(grid_x, grid_y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      fp8 ? pa::launch<__nv_fp8_e4m3, true>(D, q, kp, vp, ks, vs, tables,
                                            lengths, out, grid, K, G, page, P,
                                            scale, cap, smem, s)
          : pa::launch<int8_t, true>(D, q, kp, vp, ks, vs, tables, lengths,
                                     out, grid, K, G, page, P, scale, cap,
                                     smem, s);
  return static_cast<int>(e);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
