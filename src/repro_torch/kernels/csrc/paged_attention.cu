// One-token decode attention over a paged (block-pool) KV cache.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::
// paged_attention (pl.pallas_call at paged_attention.py:154; bodies _pa_body
// :32 and _pa_kernel :96, float pools):
//   q (B, K, G, D) bf16, one token per slot, GQA groups of G query heads;
//   pools (N, page, K, D) bf16; block_tables (B, P) int32; lengths (B,) int32.
//   Row p of slot b lives at pool[block_tables[b, p / page], p % page].
//   out[b, k, g] = softmax_p(scale * q . K_p, optional tanh softcap) . V_p
//   over p < lengths[b], with a float32 online softmax.
//
// What bounds it on an H100: the K and V rows it reads, 2 * length * D * 2
// bytes per (slot, kv head); it does ~4 * G flops per byte, far below the
// card's ~295, so only bytes matter. The design reads each K and V row once
// for all G query heads of the group: one 128-thread block per (slot, kv
// head) walks the slot's pages, one warp per K row computes that row's G
// scores (lanes split D), and each thread accumulates its own output columns
// of all G heads from one load of the V row. Pages at or past the slot's
// length are never loaded, and neither are the rows of the last page past
// the length (the page count is kernels/paged_attention.py::pages_to_read).
// A slot of length 0 writes zeros. Splitting a long sequence over several
// blocks (flash-decoding) is later work: at B*K blocks the card is mostly
// idle at small batch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {
typedef __nv_bfloat16 bf16;

constexpr int THREADS = 128, WARPS = THREADS / 32;
constexpr int G_MAX = 8;
constexpr float NEG_INF = -1e30f;

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

template <int D>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                       const bf16* __restrict__ vp,
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
  for (int i = tid; i < G * D; i += THREADS) qs[i] = __bfloat162float(qb[i]);
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
    const bf16* kbase = kp + blk * page * row_stride + (size_t)k * D;
    const bf16* vbase = vp + blk * page * row_stride + (size_t)k * D;

    // scores: one warp per K row, that row's load shared by all G heads
    for (int r = warp; r < rows; r += WARPS) {
      const bf16* krow = kbase + r * row_stride + lane * DL;
      float kv[DL];
#pragma unroll
      for (int i = 0; i < DL; ++i) kv[i] = __bfloat162float(krow[i]);
#pragma unroll
      for (int g = 0; g < G_MAX; ++g) {
        if (g < G) {
          float s = 0.0f;
#pragma unroll
          for (int i = 0; i < DL; ++i) s += qs[g * D + lane * DL + i] * kv[i];
          s = warp_sum(s) * scale;
          if (cap > 0.0f) s = tanhf(s / cap) * cap;
          if (lane == 0) ps[g * page + r] = s;
        }
      }
    }
    __syncthreads();

    // online softmax, one warp per query head
    for (int g = warp; g < G; g += WARPS) {
      float mx = NEG_INF;
      for (int r = lane; r < rows; r += 32) mx = fmaxf(mx, ps[g * page + r]);
      const float m_new = fmaxf(m_s[g], warp_max(mx));
      float sum = 0.0f;
      for (int r = lane; r < rows; r += 32) {
        const float p = expf(ps[g * page + r] - m_new);
        ps[g * page + r] = p;
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
          const float vv = __bfloat162float(vbase[r * row_stride + d]);
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

template <int D>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* tables, const void* lengths, void* out,
                   dim3 grid, int K, int G, int page, int P, float scale,
                   float cap, int smem, cudaStream_t stream) {
  paged_attention_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kp),
      static_cast<const bf16*>(vp), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<bf16*>(out), K, G, page, P,
      scale, cap);
  return cudaGetLastError();
}
}  // namespace

// The wrapper (kernels/paged_attention.py) has checked D in {64, 128, 256}
// and G <= 8, and computed the launch geometry (grid = slots x kv heads,
// the dynamic shared memory).
extern "C" int paged_attention_bf16(const void* q, const void* kp,
                                    const void* vp, const void* tables,
                                    const void* lengths, void* out, int K,
                                    int G, int D, int page, int P,
                                    float scale, float cap, int grid_x,
                                    int grid_y, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_x, grid_y);
  cudaError_t e;
  switch (D) {
    case 64:
      e = launch<64>(q, kp, vp, tables, lengths, out, grid, K, G, page, P,
                     scale, cap, smem, s);
      break;
    case 128:
      e = launch<128>(q, kp, vp, tables, lengths, out, grid, K, G, page, P,
                      scale, cap, smem, s);
      break;
    case 256:
      e = launch<256>(q, kp, vp, tables, lengths, out, grid, K, G, page, P,
                      scale, cap, smem, s);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
