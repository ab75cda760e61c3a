// scatter_rows: in-place row patch of a device-resident snapshot plane,
// buf[rows[i], :] = vals[i, :].
//
// Replaces the JAX package's jitted, buffer-donating `_scatter_rows`
// (volcano_tpu/ops/devsnap.py:81, `buf.at[rows].set(vals)`), which patches
// the persistent node planes (allocatable [Np, R] f32, max_tasks [Np] i32,
// ready [Np] bool, label/taint bits [Np, LW/TW] u32, class_id [Np] i32)
// with the rows the mirror recorded dirty.  The JAX code padded the row
// list to a power of two with duplicates of its first row so one compiled
// scatter served many lengths; here the caller passes the unique list, so
// no two threads ever write the same bytes.
//
// One thread per 4-byte word of the delta (per byte when a row is not a
// whole number of words), grid-stride.  Rows must lie in [0, n_rows): the
// caller checks them on the host, where they come from.
//
// Bound: bytes -- it reads the k x row_bytes delta and the k row ids and
// writes k x row_bytes, a few KB per node-table change; launch latency
// dominates.
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(256) scatter_rows_kernel(
    T* buf, const int32_t* rows, const T* vals, int k, int64_t row_elems) {
  const int64_t total = static_cast<int64_t>(k) * row_elems;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t i = e / row_elems;
    const int64_t c = e - i * row_elems;
    buf[static_cast<int64_t>(rows[i]) * row_elems + c] = vals[e];
  }
}

}  // namespace

extern "C" int vtt_scatter_rows(void* buf, const void* rows,
                                const void* vals, int k, int64_t row_bytes,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k <= 0 || row_bytes <= 0) return 0;
  const int threads = 256;
  const bool words = (row_bytes % 4) == 0 &&
                     (reinterpret_cast<uintptr_t>(buf) % 4) == 0 &&
                     (reinterpret_cast<uintptr_t>(vals) % 4) == 0;
  const int64_t row_elems = words ? row_bytes / 4 : row_bytes;
  const int64_t total = static_cast<int64_t>(k) * row_elems;
  int64_t want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  if (words) {
    scatter_rows_kernel<uint32_t><<<blocks, threads, 0, st>>>(
        static_cast<uint32_t*>(buf), static_cast<const int32_t*>(rows),
        static_cast<const uint32_t*>(vals), k, row_elems);
  } else {
    scatter_rows_kernel<uint8_t><<<blocks, threads, 0, st>>>(
        static_cast<uint8_t*>(buf), static_cast<const int32_t*>(rows),
        static_cast<const uint8_t*>(vals), k, row_elems);
  }
  return static_cast<int>(cudaGetLastError());
}
