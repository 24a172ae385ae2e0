// Tiled bf16 GEMM with a float32 accumulator and a fused epilogue.
//
// Replaces the TPU kernel src/repro/kernels/gemm.py::gemm (pl.pallas_call at
// gemm.py:101; bodies _gemm_kernel :23 and _gemm_bias_kernel :46):
//   out = act((x @ w) * scale + bias) cast to the output type,
// with x (M, K) and w (K, N) row-major bf16, bias (N,) bf16 or absent, act
// none / silu / gelu (tanh form), out bf16 or float32.
//
// What bounds it on an H100: on the serving path M is the number of live
// slots at decode (a few) or the chunk length at prefill (<= 64), while K and
// N are 1024/3072, so the product does about 2*M flops per weight byte and is
// bound by reading w once. This first version is plain and right, not fast:
// each 128-thread block computes a 64x64 output tile with WMMA bf16 tensor
// core fragments (16x16x16, float32 accumulate), stepping K by 32 through
// shared memory. The ragged edges of M, N and K are zero-filled as the tiles
// are loaded, so any shape runs without padding in the wrapper. The epilogue
// runs on the accumulator tile in shared memory, so the activation costs no
// second pass over device memory. Making it fast (wgmma, TMA, split-K for the
// skinny decode shapes) is later work.
//
// The tile loop and the epilogue live in gemm_tile.cuh, shared with
// gemm_wq.cu. The launch geometry (grid = ceil(N/64) x ceil(M/64), 128
// threads) is computed by the Python wrapper, kernels/gemm.py::
// launch_geometry.
#include "gemm_tile.cuh"

namespace {
using tile::bf16;
using tile::BK;
using tile::BM;
using tile::BN;
using tile::THREADS;

__global__ void __launch_bounds__(THREADS)
gemm_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 const bf16* __restrict__ bias, void* __restrict__ out, int M,
                 int N, int K, float scale, int act, int out_f32, bool vec_x,
                 bool vec_w) {
  __shared__ __align__(128) bf16 As[BM * tile::LDA];
  __shared__ __align__(128) bf16 Bs[BK * tile::LDB];
  __shared__ __align__(128) float Cs[BM * tile::LDC];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  tile::Acc acc(threadIdx.x / 32);

  for (int k0 = 0; k0 < K; k0 += BK) {
    tile::load_tile<BM, BK, tile::LDA>(As, x, M, K, K, m0, k0, vec_x);
    tile::load_tile<BK, BN, tile::LDB>(Bs, w, K, N, N, k0, n0, vec_w);
    __syncthreads();
    acc.mma(As, Bs);
    __syncthreads();
  }
  acc.store(Cs);
  __syncthreads();
  tile::epilogue(Cs, bias, out, M, N, m0, n0, scale, act, out_f32);
}
}  // namespace

extern "C" int gemm_bf16(const void* x, const void* w, const void* bias,
                         void* out, int M, int N, int K, float scale, int act,
                         int out_f32, int grid_x, int grid_y, void* stream) {
  const bool vec_x =
      reinterpret_cast<uintptr_t>(x) % 16 == 0 && K % tile::VEC == 0;
  const bool vec_w =
      reinterpret_cast<uintptr_t>(w) % 16 == 0 && N % tile::VEC == 0;
  gemm_bf16_kernel<<<dim3(grid_x, grid_y), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(bias), out, M, N, K, scale, act, out_f32, vec_x,
      vec_w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
