// Weight-only quantized GEMM: the weight crosses device memory as its
// storage codes and is dequantized inside the tile.
//
// Replaces the TPU kernel src/repro/kernels/gemm_wq.py::gemm_wq
// (pl.pallas_call at gemm_wq.py:135; bodies _wq_kernel :46 and
// _wq_bias_kernel :69, in-tile dequant _dequant_tile :33):
//   out = act((x @ (codes * scales)) * scale + bias) cast to the output type,
// with x (M, K) bf16 or float32, codes qw (K/pack, N) row-major, one of
//   CODE 0: int8, CODE 1: fp8 e4m3, CODE 2: int4 packed two per int8 byte
//   along K (pack = 2; low nibble = even K row, sign-extended by a shift
//   pair),
// scales (nb, N) float16, one row per quant block of qb = K / nb rows
// (nb = 1: per channel), bias (N,) of x's type or absent, act none / silu /
// gelu (tanh form), out bf16 or float32.
//
// What bounds it on an H100: at the serving shapes (M = 4 at decode, 64 at
// prefill; 1024 <-> 3072) it does 2*M flops per weight element against
// 1 (int8, fp8) or 0.5 (int4) bytes of codes, far below the card's ~295
// flops per byte, so reading the codes once bounds it; that is the point of
// storing them narrow. The design keeps them narrow all the way to shared
// memory: each K-step of 32 rows loads the codes of a 32 x 64 weight tile
// (2 KB int8/fp8, 1 KB int4), multiplies each by its block's scale in
// float32 and stages the product as bf16, and the tile then runs through
// the bf16 WMMA loop and fused epilogue of gemm.cu (gemm_tile.cuh). No
// dequantized weight is ever written to device memory. Every int8, int4
// and e4m3 code is exact in bf16; the product code * scale is rounded to
// bf16 once, as a bf16 weight is, which is the kernel's only departure
// from the float32 plain version (kernels/ref.py::gemm_wq_ref). Because the
// scale is applied per element, a K-step may straddle quant blocks and any
// qb with qb | K works (even for int4, so a byte never spans two blocks).
// Ragged M, N and K are zero-filled as tiles are staged. Fast paths (fp8
// codes straight into wgmma, a skinny-M schedule for decode) are later work.
//
// The launch geometry (grid = ceil(N/64) x ceil(M/64), 128 threads) is
// computed by the Python wrapper, kernels/gemm_wq.py::launch_geometry.
#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "gemm_tile.cuh"

namespace {
using tile::bf16;
using tile::BK;
using tile::BM;
using tile::BN;
using tile::THREADS;

constexpr int CODES = 8;  // consecutive weight columns one thread stages

// Logical value of one stored byte; for int4, nibble `hi` of the byte.
template <int CODE>
__device__ __forceinline__ float decode(uint8_t b, int hi) {
  if (CODE == 0) return static_cast<float>(static_cast<int8_t>(b));
  if (CODE == 1) {
    __nv_fp8_e4m3 f;
    f.__x = b;
    return static_cast<float>(f);
  }
  const int8_t s = static_cast<int8_t>(b);
  return static_cast<float>(hi ? (s >> 4)
                               : (static_cast<int8_t>(s << 4) >> 4));
}

// Stage the BK x BN weight tile at (k0, n0) into Bs as bf16 code * scale,
// zero where the tile leaves the K x N weight.
template <int CODE>
__device__ __forceinline__ void stage_weight(bf16* Bs,
                                             const uint8_t* __restrict__ qw,
                                             const __half* __restrict__ sc,
                                             int K, int N, int qb, int k0,
                                             int n0, bool vec) {
  constexpr int PACK = CODE == 2 ? 2 : 1;
  constexpr int SROWS = BK / PACK, PER_ROW = BN / CODES;
  const int KS = K / PACK;  // stored rows
  for (int i = threadIdx.x; i < SROWS * PER_ROW; i += THREADS) {
    const int rs = i / PER_ROW, c = (i % PER_ROW) * CODES;
    const int gks = k0 / PACK + rs, gc = n0 + c;
    // the CODES bytes, four to a word, byte j at bits 8 * (j % 4)
    uint2 raw = make_uint2(0u, 0u);
    if (vec && gks < KS && gc + CODES <= N) {
      raw = *reinterpret_cast<const uint2*>(qw + (size_t)gks * N + gc);
    } else {
#pragma unroll
      for (int j = 0; j < CODES; ++j) {
        const uint32_t v =
            (gks < KS && gc + j < N) ? qw[(size_t)gks * N + gc + j] : 0u;
        if (j < 4)
          raw.x |= v << (8 * j);
        else
          raw.y |= v << (8 * (j - 4));
      }
    }
#pragma unroll
    for (int p = 0; p < PACK; ++p) {
      const int row = rs * PACK + p, gk = k0 + row;
      const __half* srow = sc + (size_t)(gk / qb) * N;
      bf16* dst = Bs + row * tile::LDB + c;
#pragma unroll
      for (int j = 0; j < CODES; ++j) {
        const float s =
            (gk < K && gc + j < N) ? __half2float(srow[gc + j]) : 0.0f;
        const uint8_t b = ((j < 4 ? raw.x : raw.y) >> (8 * (j % 4))) & 0xFFu;
        dst[j] = __float2bfloat16(decode<CODE>(b, p) * s);
      }
    }
  }
}

template <int CODE, typename XT>
__global__ void __launch_bounds__(THREADS)
gemm_wq_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ qw,
               const __half* __restrict__ sc, const XT* __restrict__ bias,
               void* __restrict__ out, int M, int N, int K, int qb,
               float scale, int act, int out_f32, bool vec_x, bool vec_w) {
  __shared__ __align__(128) bf16 As[BM * tile::LDA];
  __shared__ __align__(128) bf16 Bs[BK * tile::LDB];
  __shared__ __align__(128) float Cs[BM * tile::LDC];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  tile::Acc acc(threadIdx.x / 32);

  for (int k0 = 0; k0 < K; k0 += BK) {
    tile::load_tile<BM, BK, tile::LDA>(As, x, M, K, K, m0, k0, vec_x);
    stage_weight<CODE>(Bs, qw, sc, K, N, qb, k0, n0, vec_w);
    __syncthreads();
    acc.mma(As, Bs);
    __syncthreads();
  }
  acc.store(Cs);
  __syncthreads();
  tile::epilogue(Cs, bias, out, M, N, m0, n0, scale, act, out_f32);
}

template <int CODE, typename XT>
cudaError_t launch(const void* x, const void* qw, const void* sc,
                   const void* bias, void* out, int M, int N, int K, int qb,
                   float scale, int act, int out_f32, dim3 grid,
                   cudaStream_t stream) {
  const bool vec_x = sizeof(XT) == 2 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     K % tile::VEC == 0;
  const bool vec_w =
      reinterpret_cast<uintptr_t>(qw) % 8 == 0 && N % CODES == 0;
  gemm_wq_kernel<CODE, XT><<<grid, THREADS, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const uint8_t*>(qw),
      static_cast<const __half*>(sc), static_cast<const XT*>(bias), out, M, N,
      K, qb, scale, act, out_f32, vec_x, vec_w);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch_code(int code, const void* x, const void* qw,
                        const void* sc, const void* bias, void* out, int M,
                        int N, int K, int qb, float scale, int act,
                        int out_f32, dim3 grid, cudaStream_t s) {
  switch (code) {
    case 0:
      return launch<0, XT>(x, qw, sc, bias, out, M, N, K, qb, scale, act,
                           out_f32, grid, s);
    case 1:
      return launch<1, XT>(x, qw, sc, bias, out, M, N, K, qb, scale, act,
                           out_f32, grid, s);
    case 2:
      return launch<2, XT>(x, qw, sc, bias, out, M, N, K, qb, scale, act,
                           out_f32, grid, s);
    default:
      return cudaErrorInvalidValue;
  }
}
}  // namespace

// The wrapper (kernels/gemm_wq.py) has checked shapes, dtypes, qb | K (qb
// even for int4) and contiguity, and computed the grid. x_f32 selects a
// float32 x (and bias); code is CODE above.
extern "C" int gemm_wq(const void* x, int x_f32, const void* qw, int code,
                       const void* scales, int qb, const void* bias,
                       void* out, int M, int N, int K, float scale, int act,
                       int out_f32, int grid_x, int grid_y, void* stream) {
  const dim3 grid(grid_x, grid_y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      x_f32 ? launch_code<float>(code, x, qw, scales, bias, out, M, N, K, qb,
                                 scale, act, out_f32, grid, s)
            : launch_code<bf16>(code, x, qw, scales, bias, out, M, N, K, qb,
                                scale, act, out_f32, grid, s);
  return static_cast<int>(e);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
