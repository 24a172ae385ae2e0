// One-token decode attention over a paged (block-pool) KV cache, bf16 pools.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::
// paged_attention (pl.pallas_call at paged_attention.py:154; bodies _pa_body
// :32 and _pa_kernel :96, float pools). The kernel body, its contract, what
// bounds it and its design are in paged_attention.cuh, shared with the
// quantized pools' kernel (paged_attention_quant.cu).
#include "paged_attention.cuh"

// The wrapper (kernels/paged_attention.py) has checked D in {64, 128, 256}
// and G <= 8, and computed the launch geometry (grid = slots x kv heads,
// the dynamic shared memory).
extern "C" int paged_attention_bf16(const void* q, const void* kp,
                                    const void* vp, const void* tables,
                                    const void* lengths, void* out, int K,
                                    int G, int D, int page, int P,
                                    float scale, float cap, int grid_x,
                                    int grid_y, int smem, void* stream) {
  return static_cast<int>(pa::launch<pa::bf16, false>(
      D, q, kp, vp, nullptr, nullptr, tables, lengths, out,
      dim3(grid_x, grid_y), K, G, page, P, scale, cap, smem,
      static_cast<cudaStream_t>(stream)));
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
