// The tile machinery shared by gemm.cu and gemm_wq.cu: one 128-thread block
// computes a 64x64 output tile with WMMA bf16 fragments (16x16x16, float32
// accumulate), stepping K by 32 through shared memory, then runs the fused
// epilogue (*scale, +bias, silu or gelu-tanh, cast) on the accumulator tile.
// The two kernels differ only in how they stage the weight tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace tile {
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

__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

// Copy the ROWS x COLS tile at (r0, c0) of the R x C row-major matrix g
// (leading dimension ld) into shared memory s (leading dimension LDS) as
// bf16, writing zeros wherever the tile leaves the matrix. bf16 sources
// with `vec` set move 16 bytes a thread; float32 sources are rounded.
template <int ROWS, int COLS, int LDS, typename T>
__device__ __forceinline__ void load_tile(bf16* s, const T* __restrict__ g,
                                          int R, int C, int ld, int r0, int c0,
                                          bool vec) {
  constexpr int PER_ROW = COLS / VEC;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    const int gr = r0 + r, gc = c0 + c;
    bf16* dst = s + r * LDS + c;
    if (sizeof(T) == sizeof(bf16) && vec && gr < R && gc + VEC <= C) {
      *reinterpret_cast<uint4*>(dst) =
          *reinterpret_cast<const uint4*>(g + (size_t)gr * ld + gc);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        dst[j] = __float2bfloat16(
            (gr < R && gc + j < C) ? to_float(g[(size_t)gr * ld + gc + j])
                                   : 0.0f);
    }
  }
}

// The 32x32 quarter of the block tile that warp `warp` owns.
struct Acc {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> f[2][2];
  int wm, wn;

  __device__ __forceinline__ explicit Acc(int warp)
      : wm((warp / 2) * 32), wn((warp % 2) * 32) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(f[i][j], 0.0f);
  }

  // acc += As (BM x BK) @ Bs (BK x BN), both staged in shared memory
  __device__ __forceinline__ void mma(const bf16* As, const bf16* Bs) {
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
          wmma::mma_sync(f[i][j], a[i], b[j], f[i][j]);
    }
  }

  __device__ __forceinline__ void store(float* Cs) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wm + 16 * i) * LDC + wn + 16 * j,
                                f[i][j], LDC, wmma::mem_row_major);
  }
};

// out[m0.., n0..] = act(Cs * scale + bias), cast to bf16 or float32; the
// ragged edge of M and N is not written.
template <typename BT>
__device__ __forceinline__ void epilogue(const float* Cs,
                                         const BT* __restrict__ bias,
                                         void* __restrict__ out, int M, int N,
                                         int m0, int n0, float scale, int act,
                                         int out_f32) {
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    const int gr = m0 + r, gc = n0 + c;
    if (gr >= M || gc >= N) continue;
    float v = Cs[r * LDC + c] * scale;
    if (bias != nullptr) v += to_float(bias[gc]);
    v = apply_act(v, act);
    if (out_f32)
      static_cast<float*>(out)[(size_t)gr * N + gc] = v;
    else
      static_cast<bf16*>(out)[(size_t)gr * N + gc] = __float2bfloat16(v);
  }
}
}  // namespace tile
