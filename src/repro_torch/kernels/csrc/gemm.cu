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
// The launch geometry (grid = ceil(N/64) x ceil(M/64), 128 threads) is
// computed by the Python wrapper, kernels/gemm.py::launch_geometry.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {
using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int BM = 64, BN = 64, BK = 32, THREADS = 128;
constexpr int LDA = BK + 8;  // padded rows keep every WMMA pointer 32-byte aligned
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;
constexpr int VEC = 8;       // bf16 elements in one 16-byte load

__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == 1) return v / (1.0f + expf(-v));  // silu
  if (act == 2) {                              // gelu, tanh approximation
    const float c = 0.7978845608028654f;       // sqrt(2 / pi)
    return 0.5f * v * (1.0f + tanhf(c * (v + 0.044715f * v * v * v)));
  }
  return v;
}

// Copy the ROWS x COLS tile at (r0, c0) of the R x C row-major matrix g
// (leading dimension ld) into shared memory s (leading dimension LDS),
// writing zeros wherever the tile leaves the matrix.
template <int ROWS, int COLS, int LDS>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* __restrict__ g,
                                          int R, int C, int ld, int r0, int c0,
                                          bool vec) {
  constexpr int PER_ROW = COLS / VEC;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    const int gr = r0 + r, gc = c0 + c;
    bf16* dst = s + r * LDS + c;
    if (vec && gr < R && gc + VEC <= C) {
      *reinterpret_cast<uint4*>(dst) =
          *reinterpret_cast<const uint4*>(g + (size_t)gr * ld + gc);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        dst[j] = (gr < R && gc + j < C) ? g[(size_t)gr * ld + gc + j]
                                        : __float2bfloat16(0.0f);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
gemm_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 const bf16* __restrict__ bias, void* __restrict__ out, int M,
                 int N, int K, float scale, int act, int out_f32, bool vec_x,
                 bool vec_w) {
  __shared__ __align__(128) bf16 As[BM * LDA];
  __shared__ __align__(128) bf16 Bs[BK * LDB];
  __shared__ __align__(128) float Cs[BM * LDC];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;  // 32x32 per warp

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile<BM, BK, LDA>(As, x, M, K, K, m0, k0, vec_x);
    load_tile<BK, BN, LDB>(Bs, w, K, N, N, k0, n0, vec_w);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm + 16 * i) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * LDB + wn + 16 * j, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * LDC + wn + 16 * j,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();

  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    const int gr = m0 + r, gc = n0 + c;
    if (gr >= M || gc >= N) continue;
    float v = Cs[r * LDC + c] * scale;
    if (bias != nullptr) v += __bfloat162float(bias[gc]);
    v = apply_act(v, act);
    if (out_f32)
      static_cast<float*>(out)[(size_t)gr * N + gc] = v;
    else
      static_cast<bf16*>(out)[(size_t)gr * N + gc] = __float2bfloat16(v);
  }
}
}  // namespace

extern "C" int gemm_bf16(const void* x, const void* w, const void* bias,
                         void* out, int M, int N, int K, float scale, int act,
                         int out_f32, int grid_x, int grid_y, void* stream) {
  const bool vec_x = reinterpret_cast<uintptr_t>(x) % 16 == 0 && K % VEC == 0;
  const bool vec_w = reinterpret_cast<uintptr_t>(w) % 16 == 0 && N % VEC == 0;
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
