// FlashAttention-2 forward: causal / sliding-window / softcap / kv_len masks,
// GQA by index.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (pl.pallas_call at flash_attention.py:101; body _fa_kernel
// :25): q (BH, Sq, D), k and v (BK, Skv, D) bf16, query head b reads KV head
// b / (BH / BK), so K and V are never repeated per query head.
//   s = scale * q . k, then tanh softcap, then masks: k < kv_len,
//   causal q >= k, window q - k < window; out = softmax(s) . v in float32.
//
// What bounds it on an H100: for the prompts this repo serves (S <= a few
// hundred, D = 128) the card's tensor cores would make it bound by the bytes
// of q, k, v and out; this first version computes on the CUDA cores in
// float32 and is bound by those operations instead. One 128-thread block
// takes 32 query rows of one head (8 rows per warp); it walks the KV tiles
// of 64 rows that hold at least one unmasked key for those rows (the tile
// range is kernels/flash_attention.py::kv_tile_range: fully masked tiles are
// never loaded), staging each K and V tile once in shared memory for all 32
// rows. Each lane scores two keys per row, the running max, sum and output
// columns stay in registers, and masked keys get probability 0, so a row
// with no unmasked key writes zeros. Moving the products to wgmma is later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
typedef __nv_bfloat16 bf16;

constexpr int THREADS = 128, WARPS = THREADS / 32;
constexpr int BQ = 32, BKV = 64, ROWS = BQ / WARPS;
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

// Copy n_rows (<= TILE) rows of D bf16 from g into shared memory s with row
// stride LDS, zero-filling rows n_rows..TILE-1.
template <int TILE, int D, int LDS>
__device__ __forceinline__ void load_rows(bf16* s, const bf16* __restrict__ g,
                                          int n_rows) {
  constexpr int PAIRS = D / 2;
  const __nv_bfloat162 zero = __floats2bfloat162_rn(0.0f, 0.0f);
  for (int i = threadIdx.x; i < TILE * PAIRS; i += THREADS) {
    const int r = i / PAIRS, c = (i % PAIRS) * 2;
    *reinterpret_cast<__nv_bfloat162*>(s + r * LDS + c) =
        r < n_rows
            ? *reinterpret_cast<const __nv_bfloat162*>(g + (size_t)r * D + c)
            : zero;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       int Sq, int Skv, int G, int kv_len, int causal,
                       int window, float scale, float cap) {
  constexpr int LDK = D + 2;   // odd word stride: lanes read K rows conflict-free
  constexpr int DL = D / 32;   // output columns per lane
  __shared__ __align__(16) bf16 Qs[BQ * D];
  __shared__ __align__(16) bf16 Ks[BKV * LDK];
  __shared__ __align__(16) bf16 Vs[BKV * D];

  const int bh = blockIdx.x, q0 = blockIdx.y * BQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bf16* qh = q + ((size_t)bh * Sq + q0) * D;
  const bf16* kh = k + (size_t)(bh / G) * Skv * D;
  const bf16* vh = v + (size_t)(bh / G) * Skv * D;
  load_rows<BQ, D, D>(Qs, qh, min(BQ, Sq - q0));

  // KV tiles [t_lo, t_hi) that hold an unmasked key for rows q0..q_last
  const int q_last = min(q0 + BQ, Sq) - 1;
  int hi_key = min(kv_len, Skv) - 1;
  if (causal) hi_key = min(hi_key, q_last);
  const int lo_key = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_lo = lo_key / BKV;
  const int t_hi = hi_key >= lo_key ? hi_key / BKV + 1 : t_lo;

  float m[ROWS], l[ROWS], acc[ROWS][DL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[r][i] = 0.0f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // previous tile fully consumed (and Qs loaded)
    load_rows<BKV, D, LDK>(Ks, kh + (size_t)k0 * D, min(BKV, Skv - k0));
    load_rows<BKV, D, D>(Vs, vh + (size_t)k0 * D, min(BKV, Skv - k0));
    __syncthreads();

    // scores of this warp's ROWS rows against keys lane and lane + 32
    float s[ROWS][2];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r][0] = s[r][1] = 0.0f;
    const __nv_bfloat162* k0row =
        reinterpret_cast<const __nv_bfloat162*>(Ks + lane * LDK);
    const __nv_bfloat162* k1row =
        reinterpret_cast<const __nv_bfloat162*>(Ks + (lane + 32) * LDK);
#pragma unroll 4
    for (int c = 0; c < D / 2; ++c) {
      const float2 ka = __bfloat1622float2(k0row[c]);
      const float2 kb = __bfloat1622float2(k1row[c]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float2 qv = __bfloat1622float2(
            reinterpret_cast<const __nv_bfloat162*>(
                Qs + (warp * ROWS + r) * D)[c]);
        s[r][0] += qv.x * ka.x + qv.y * ka.y;
        s[r][1] += qv.x * kb.x + qv.y * kb.y;
      }
    }

    // masks and the online softmax, row by row
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qpos = q0 + warp * ROWS + r;
      float mx = NEG_INF;
      bool ok[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kpos = k0 + lane + 32 * h;
        float x = s[r][h] * scale;
        if (cap > 0.0f) x = tanhf(x / cap) * cap;
        ok[h] = kpos < kv_len && kpos < Skv && (!causal || qpos >= kpos) &&
                (window <= 0 || qpos - kpos < window);
        s[r][h] = x;
        if (ok[h]) mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[r], warp_max(mx));
      const float corr = expf(m[r] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s[r][h] = ok[h] ? expf(s[r][h] - m_new) : 0.0f;
        psum += s[r][h];
      }
      l[r] = l[r] * corr + warp_sum(psum);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[r][i] *= corr;
    }

    // P.V: every lane owns DL output columns; each V row is read once for
    // all ROWS rows, its probability broadcast from the lane that holds it
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      for (int jj = 0; jj < 32; ++jj) {
        const int j = 32 * h + jj;
        float vv[DL];
#pragma unroll
        for (int i = 0; i < DL; ++i)
          vv[i] = __bfloat162float(Vs[j * D + lane * DL + i]);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float p = __shfl_sync(0xffffffffu, s[r][h], jj);
#pragma unroll
          for (int i = 0; i < DL; ++i) acc[r][i] += p * vv[i];
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qpos = q0 + warp * ROWS + r;
    if (qpos < Sq) {
      bf16* orow = out + ((size_t)bh * Sq + qpos) * D + lane * DL;
      const float inv = 1.0f / fmaxf(l[r], 1e-37f);
#pragma unroll
      for (int i = 0; i < DL; ++i) orow[i] = __float2bfloat16(acc[r][i] * inv);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   dim3 grid, int Sq, int Skv, int G, int kv_len,
                   int causal, int window, float scale, float cap,
                   cudaStream_t stream) {
  flash_attention_kernel<D><<<grid, THREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), Sq, Skv, G, kv_len,
      causal, window, scale, cap);
  return cudaGetLastError();
}
}  // namespace

// The wrapper (kernels/flash_attention.py) has checked D in {64, 128} and
// the shapes, and computed the launch geometry (grid = query heads x
// ceil(Sq / 32) query tiles).
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int Sq, int Skv,
                                    int D, int G, int kv_len, int causal,
                                    int window, float scale, float cap,
                                    int grid_x, int grid_y, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(grid_x, grid_y);
  cudaError_t e;
  switch (D) {
    case 64:
      e = launch<64>(q, k, v, out, grid, Sq, Skv, G, kv_len, causal, window,
                     scale, cap, s);
      break;
    case 128:
      e = launch<128>(q, k, v, out, grid, Sq, Skv, G, kv_len, causal, window,
                      scale, cap, s);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
