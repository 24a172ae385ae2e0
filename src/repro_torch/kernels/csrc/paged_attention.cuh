// The paged decode-attention kernel body, shared by paged_attention.cu
// (bf16 pools) and paged_attention_quant.cu (int8 / fp8-e4m3 pools with
// per-row float16 scales), templated on the pool's element type.
//
//   q (B, K, G, D) bf16, one token per slot, GQA groups of G query heads;
//   pools (N, page, K, D) of T; block_tables (B, P) int32; lengths (B,)
//   int32. Row p of slot b lives at pool[block_tables[b, p / page], p % page].
//   out[b, k, g] = softmax_p(scale * q . K_p, optional tanh softcap) . V_p
//   over p < lengths[b], with a float32 online softmax.
//
// Quantized pools (QUANT) carry k_scale / v_scale (N, page, K) float16 that
// follow the block table like the pools. The body is the TPU kernel's math
// (src/repro/kernels/paged_attention.py::_pa_body :54-87): the dot q . K_p
// runs on the storage codes and the row's K scale multiplies its score; the
// row's V scale multiplies its probability before the V accumulate, while
// the softmax denominator sums the unscaled probabilities. No dequantized
// page is ever written anywhere.
//
// What bounds it on an H100: the K and V rows it reads, 2 * length * D *
// sizeof(T) bytes per (slot, kv head) plus 4 bytes of scales per row when
// quantized; it does ~4 * G flops per element, far below the card's ~295
// flops per byte, so only bytes matter, and narrow pools halve them. The
// design reads each K and V row once for all G query heads of the group: one
// 128-thread block per (slot, kv head) walks the slot's pages, one warp per
// K row computes that row's G scores (lanes split D), and each thread
// accumulates its own output columns of all G heads from one load of the V
// row. Pages at or past the slot's length are never loaded, and neither are
// the rows of the last page past the length (the page count is
// kernels/paged_attention.py::pages_to_read). A slot of length 0 writes
// zeros. Splitting a long sequence over several blocks (flash-decoding) is
// later work: at B*K blocks the card is mostly idle at small batch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pa {
typedef __nv_bfloat16 bf16;

constexpr int THREADS = 128, WARPS = THREADS / 32;
constexpr int G_MAX = 8;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(int8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 v) {
  return static_cast<float>(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int D, typename T, bool QUANT>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const bf16* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp,
                       const __half* __restrict__ ks,
                       const __half* __restrict__ vs,
                       const int* __restrict__ tables,
                       const int* __restrict__ lengths, bf16* __restrict__ out,
                       int K, int G, int page, int P, float scale, float cap) {
  constexpr int DL = D / 32;                         // K columns per lane
  constexpr int DT = (D + THREADS - 1) / THREADS;    // V columns per thread
  extern __shared__ float smem[];
  float* qs = smem;               // (G, D) query rows
  float* ps = smem + G * D;       // (G, page) scores, then probabilities
  __shared__ float m_s[G_MAX], l_s[G_MAX], corr_s[G_MAX];

  const int b = blockIdx.x, k = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int length = lengths[b];
  const bf16* qb = q + (size_t)(b * K + k) * G * D;
  for (int i = tid; i < G * D; i += THREADS) qs[i] = to_float(qb[i]);
  if (tid < G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.0f;
  }
  float acc[G_MAX][DT];
#pragma unroll
  for (int g = 0; g < G_MAX; ++g)
#pragma unroll
    for (int t = 0; t < DT; ++t) acc[g][t] = 0.0f;
  __syncthreads();

  const size_t row_stride = (size_t)K * D;   // between rows of one block
  const int n_pages = (length + page - 1) / page;
  for (int j = 0; j < n_pages; ++j) {
    const size_t blk = (size_t)tables[(size_t)b * P + j];
    const int rows = min(page, length - j * page);
    const T* kbase = kp + blk * page * row_stride + (size_t)k * D;
    const T* vbase = vp + blk * page * row_stride + (size_t)k * D;
    // row r's scale is at [(blk * page + r) * K + k]
    const size_t sbase = blk * page * K + k;

    // scores: one warp per K row, that row's load shared by all G heads
    for (int r = warp; r < rows; r += WARPS) {
      const T* krow = kbase + r * row_stride + lane * DL;
      float kv[DL];
#pragma unroll
      for (int i = 0; i < DL; ++i) kv[i] = to_float(krow[i]);
      const float k_scale = QUANT ? __half2float(ks[sbase + (size_t)r * K])
                                  : 1.0f;
#pragma unroll
      for (int g = 0; g < G_MAX; ++g) {
        if (g < G) {
          float s = 0.0f;
#pragma unroll
          for (int i = 0; i < DL; ++i) s += qs[g * D + lane * DL + i] * kv[i];
          s = warp_sum(s);
          if (QUANT) s *= k_scale;
          s *= scale;
          if (cap > 0.0f) s = tanhf(s / cap) * cap;
          if (lane == 0) ps[g * page + r] = s;
        }
      }
    }
    __syncthreads();

    // online softmax, one warp per query head; with quantized pools each
    // probability leaves carrying its V row's scale
    for (int g = warp; g < G; g += WARPS) {
      float mx = NEG_INF;
      for (int r = lane; r < rows; r += 32) mx = fmaxf(mx, ps[g * page + r]);
      const float m_new = fmaxf(m_s[g], warp_max(mx));
      float sum = 0.0f;
      for (int r = lane; r < rows; r += 32) {
        const float p = expf(ps[g * page + r] - m_new);
        ps[g * page + r] =
            QUANT ? p * __half2float(vs[sbase + (size_t)r * K]) : p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_s[g] - m_new);
        corr_s[g] = c;
        l_s[g] = l_s[g] * c + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // P.V: each thread owns output columns d, one V load feeds all G heads
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      const int d = tid + t * THREADS;
      if (d < D) {
#pragma unroll
        for (int g = 0; g < G_MAX; ++g)
          if (g < G) acc[g][t] *= corr_s[g];
        for (int r = 0; r < rows; ++r) {
          const float vv = to_float(vbase[r * row_stride + d]);
#pragma unroll
          for (int g = 0; g < G_MAX; ++g)
            if (g < G) acc[g][t] += ps[g * page + r] * vv;
        }
      }
    }
    __syncthreads();  // ps and corr_s are rewritten by the next page
  }

  bf16* ob = out + (size_t)(b * K + k) * G * D;
#pragma unroll
  for (int t = 0; t < DT; ++t) {
    const int d = tid + t * THREADS;
    if (d < D) {
#pragma unroll
      for (int g = 0; g < G_MAX; ++g)
        if (g < G)
          ob[g * D + d] = __float2bfloat16(acc[g][t] / fmaxf(l_s[g], 1e-37f));
    }
  }
}

// Launch for the head dim D in {64, 128, 256}; the wrapper has checked D and
// G <= G_MAX and computed the grid (slots x kv heads) and dynamic shared
// memory.
template <typename T, bool QUANT>
cudaError_t launch(int D, const void* q, const void* kp, const void* vp,
                   const void* ks, const void* vs, const void* tables,
                   const void* lengths, void* out, dim3 grid, int K, int G,
                   int page, int P, float scale, float cap, int smem,
                   cudaStream_t stream) {
#define PA_LAUNCH(DIM)                                                       \
  paged_attention_kernel<DIM, T, QUANT><<<grid, THREADS, smem, stream>>>(    \
      static_cast<const bf16*>(q), static_cast<const T*>(kp),                \
      static_cast<const T*>(vp), static_cast<const __half*>(ks),             \
      static_cast<const __half*>(vs), static_cast<const int*>(tables),       \
      static_cast<const int*>(lengths), static_cast<bf16*>(out), K, G, page, \
      P, scale, cap)
  switch (D) {
    case 64:
      PA_LAUNCH(64);
      break;
    case 128:
      PA_LAUNCH(128);
      break;
    case 256:
      PA_LAUNCH(256);
      break;
    default:
      return cudaErrorInvalidValue;
  }
#undef PA_LAUNCH
  return cudaGetLastError();
}
}  // namespace pa
