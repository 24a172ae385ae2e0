// Packed row gather: out[i] = table[idx[i]] for M indices into an (N, D)
// row-major table.
//
// Replaces the TPU kernel src/repro/kernels/packed_gather.py::
// packed_gather_rows (pl.pallas_call at packed_gather.py:77; body
// _packed_kernel :48), reached through repro/kernels/ops.py
// packed_gather_rows. On the MoE serving path (models/moe.py) the table is
// one group's normed activations, (T, d_model) bf16, and idx is the
// expert-sorted token stream of length T * top_k: 256 rows of 2048 at a
// prefill chunk of qwen2-moe-a2.7b, 4 * live slots at a decode step.
//
// What bounds it on an H100: nothing but bytes. Each output row is read
// once from the table and written once, 2 * M * D * elt bytes in all, with
// no arithmetic; at the chunk shape that is 2.10 MB, 0.6 us at 3.35 TB/s,
// far below a launch's own cost, so the kernel is launch-bound where the
// path uses it.
//
// Design: the TPU kernel stages a VMEM window of the table per grid step
// and needs its indices sorted so that a pack of rows falls inside one
// window (the wrapper sorts, gathers and un-permutes). Hopper reads any row
// from device memory (or L2) at full width, so neither the window nor the
// sort is needed: out[i] is written straight from table[idx[i]] and the
// order of idx is free. Each block copies PACK rows (the TPU kernel's pack
// of 8): it loads the PACK indices once into shared memory, and each thread
// then copies one column unit of all PACK rows, issuing the PACK loads
// before the PACK stores so that PACK loads are in flight per thread.
// Neighbouring threads copy neighbouring units, so loads and stores are
// coalesced. The copy unit is 16 bytes (one uint4) where the row's byte
// width and both base addresses allow it, else the widest of 8, 4, 2 or 1
// bytes that does (chosen by the host: kernels/packed_gather.py::
// copy_unit), so a ragged row width is copied whole in narrower units and
// every access stays aligned. The copy is of raw bits, so it is exact for
// any row type. An index is read as int32 or int64; a negative one counts
// from the end and any index is then clamped to [0, N - 1], as jnp
// indexing does. Offsets are 64-bit.
//
// Launch geometry (kernels/packed_gather.py::launch_geometry): THREADS
// threads per block, gridDim.x = ceil(M / PACK).
#include <cstdint>

#include <cuda_runtime.h>

namespace {
constexpr int THREADS = 256;
constexpr int PACK = 8;

template <typename Index>
__device__ __forceinline__ int64_t clamp_row(Index i, int64_t n) {
  int64_t r = static_cast<int64_t>(i);
  if (r < 0) r += n;
  return r < 0 ? 0 : (r >= n ? n - 1 : r);
}

template <typename Unit, typename Index>
__global__ void __launch_bounds__(THREADS)
packed_gather_kernel(const Unit* __restrict__ table,
                     const Index* __restrict__ idx, Unit* __restrict__ out,
                     int64_t N, int64_t M, int64_t units) {
  __shared__ int64_t src[PACK];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * PACK;
  if (threadIdx.x < PACK) {
    const int64_t i = row0 + threadIdx.x;
    src[threadIdx.x] = i < M ? clamp_row(idx[i], N) * units : 0;
  }
  __syncthreads();
  const int64_t rows = M - row0 < PACK ? M - row0 : PACK;
  for (int64_t u = threadIdx.x; u < units; u += THREADS) {
    Unit v[PACK];
#pragma unroll
    for (int r = 0; r < PACK; ++r)
      if (r < rows) v[r] = table[src[r] + u];
#pragma unroll
    for (int r = 0; r < PACK; ++r)
      if (r < rows) out[(row0 + r) * units + u] = v[r];
  }
}

template <typename Unit>
cudaError_t launch_unit(const void* table, const void* idx, void* out,
                        int64_t N, int64_t M, int64_t units, int index_bytes,
                        unsigned grid, cudaStream_t stream) {
  const Unit* t = static_cast<const Unit*>(table);
  Unit* o = static_cast<Unit*>(out);
  if (index_bytes == 4)
    packed_gather_kernel<Unit, int32_t><<<grid, THREADS, 0, stream>>>(
        t, static_cast<const int32_t*>(idx), o, N, M, units);
  else if (index_bytes == 8)
    packed_gather_kernel<Unit, int64_t><<<grid, THREADS, 0, stream>>>(
        t, static_cast<const int64_t*>(idx), o, N, M, units);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
}  // namespace

extern "C" int packed_gather_rows(const void* table, const void* idx,
                                  void* out, long long N, long long M,
                                  long long row_bytes, int index_bytes,
                                  int unit_bytes, long long grid_x,
                                  void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(table) |
                          reinterpret_cast<uintptr_t>(out);
  if (N < 1 || M < 1 || row_bytes < 1 || unit_bytes < 1 ||
      row_bytes % unit_bytes || align % unit_bytes ||
      grid_x != (M + PACK - 1) / PACK || grid_x > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t units = row_bytes / unit_bytes;
  const unsigned grid = static_cast<unsigned>(grid_x);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (unit_bytes) {
    case 16: err = launch_unit<uint4>(table, idx, out, N, M, units,
                                      index_bytes, grid, s); break;
    case 8: err = launch_unit<uint2>(table, idx, out, N, M, units,
                                     index_bytes, grid, s); break;
    case 4: err = launch_unit<uint32_t>(table, idx, out, N, M, units,
                                        index_bytes, grid, s); break;
    case 2: err = launch_unit<uint16_t>(table, idx, out, N, M, units,
                                        index_bytes, grid, s); break;
    case 1: err = launch_unit<uint8_t>(table, idx, out, N, M, units,
                                       index_bytes, grid, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
