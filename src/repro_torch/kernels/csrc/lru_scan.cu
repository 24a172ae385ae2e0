// Diagonal linear recurrence h_t = a_t * h_{t-1} + b_t from a zero state.
//
// Replaces the TPU kernel src/repro/kernels/lru_scan.py::lru_scan
// (pl.pallas_call at lru_scan.py:49; body _lru_kernel :22): a, b and h are
// (B, L, D) row-major float32, the recurrence runs along L for every
// (batch row, channel) pair independently. The carry-in of a stream that
// continues across calls is folded into b_0 by the caller
// (models/recurrent.py::diag_scan), as in the reference.
//
// What bounds it on an H100: each element of a and b is read once and each
// element of h written once, 12 bytes per step and channel for two flops, so
// the kernel is bound by device memory (3.35 TB/s). On the serving path of
// falcon-mamba-7b D = d_inner * d_state = 8192 * 16 = 131072 channels and L
// is a prefill chunk (<= 64) or a whole prompt (<= 256).
//
// Design: one thread owns one channel of one batch row and walks t in order,
// carrying h in a register. The TPU kernel streams (channel tile x chunk)
// blocks through VMEM and carries h in scratch across the sequential grid;
// here the loop over L sits inside the thread, and the 131072 channels of a
// row fill the card's 132 SMs by themselves (512 blocks of 256 threads), so
// no associative scan across t is needed. Neighbouring threads own
// neighbouring channels, so every load and store is coalesced. Each thread
// loads UNROLL steps of a and b before it computes them, which keeps
// 2 * UNROLL loads in flight per thread; loads and stores are streaming
// (evict-first), since nothing is read twice. The step is an explicitly
// rounded multiply and add (__fmul_rn, __fadd_rn, never contracted into an
// FMA), which is the plain version's arithmetic, so the two agree bit for
// bit. The ragged edge of D is masked in the kernel, and offsets are 64-bit:
// B * L * D passes 2^31 at B = 64, L = 256, D = 131072.
//
// Launch geometry (kernels/lru_scan.py::launch_geometry): THREADS-thread
// blocks, gridDim.x = B * ceil(D / THREADS), channel tiles of one batch row
// adjacent. gridDim.x (up to 2^31 - 1) is used because gridDim.y stops at
// 65535.
#include <cstdint>

#include <cuda_runtime.h>

namespace {
constexpr int THREADS = 256;
constexpr int UNROLL = 8;

__global__ void __launch_bounds__(THREADS)
lru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ h, int64_t L, int64_t D,
                int64_t tiles_per_row) {
  const int64_t row = blockIdx.x / tiles_per_row;
  const int64_t d =
      (blockIdx.x - row * tiles_per_row) * THREADS + threadIdx.x;
  if (d >= D) return;
  const int64_t base = row * L * D + d;
  float carry = 0.0f;
  for (int64_t t0 = 0; t0 < L; t0 += UNROLL) {
    float av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (t0 + u < L) {
        const int64_t off = base + (t0 + u) * D;
        av[u] = __ldcs(a + off);
        bv[u] = __ldcs(b + off);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (t0 + u < L) {
        carry = __fadd_rn(__fmul_rn(av[u], carry), bv[u]);
        __stcs(h + base + (t0 + u) * D, carry);
      }
    }
  }
}
}  // namespace

extern "C" int lru_scan_f32(const void* a, const void* b, void* h,
                            long long B, long long L, long long D,
                            long long grid_x, void* stream) {
  const int64_t tiles_per_row = (D + THREADS - 1) / THREADS;
  if (grid_x != B * tiles_per_row || grid_x > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  lru_scan_kernel<<<static_cast<unsigned>(grid_x), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(h), L, D, tiles_per_row);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
