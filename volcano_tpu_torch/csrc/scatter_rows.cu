// scatter_rows: in-place row patch of the device-resident snapshot planes,
// buf[rows[i], :] = vals[i, :].
//
// Replaces the JAX package's jitted, buffer-donating `_scatter_rows`
// (volcano_tpu/ops/devsnap.py:81, `buf.at[rows].set(vals)`), which patches
// the persistent node planes (allocatable [Np, R] f32, max_tasks [Np] i32,
// ready [Np] bool, label/taint bits [Np, LW/TW] u32, class_id [Np] i32)
// with the rows the mirror recorded dirty, one jitted call per plane.  The
// JAX code padded the row list to a power of two with duplicates of its
// first row so one compiled scatter served many lengths; here the caller
// passes the unique list, so no two threads ever write the same bytes.
//
// `vtt_scatter_planes` (what the snapshot runs): one launch writes a node
// table delta's rows into every plane.  The delta arrives as one staged
// device buffer -- the row ids (int32 [k]) at offset 0, then each plane's
// [k, row] values at a 16-byte aligned offset -- which the host packed in
// pinned memory and copied in one asynchronous copy.  Block (x, p) writes
// plane p, grid-stride over its k x row words (bytes when a row is not a
// whole number of words: `ready`).  The planes' destinations, row sizes
// and offsets travel by value, each plane's picked with a switch over
// constant indices: indexing a by-value array with a run-time index would
// copy it to local memory in every thread.
//
// `vtt_scatter_rows`: one plane from its own row and value arrays (the
// kernel table's one-plane comparison).
//
// Rows must be unique and lie in [0, n_rows): the caller checks them on
// the host, where they come from.
//
// Bound: bytes -- it reads the k x row_bytes delta and the k row ids and
// writes k x row_bytes, a few KB per node-table change; launch latency
// dominates.
#include <algorithm>

#include "common.cuh"

namespace {

template <typename T>
__device__ __forceinline__ void write_rows(T* buf, const int32_t* rows,
                                           const T* vals, int k,
                                           int64_t row_elems) {
  const int64_t total = static_cast<int64_t>(k) * row_elems;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       e < total; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t i = e / row_elems;
    const int64_t c = e - i * row_elems;
    buf[static_cast<int64_t>(rows[i]) * row_elems + c] = vals[e];
  }
}

template <typename T>
__global__ void __launch_bounds__(256) scatter_rows_kernel(
    T* buf, const int32_t* rows, const T* vals, int k, int64_t row_elems) {
  write_rows(buf, rows, vals, k, row_elems);
}

constexpr int kMaxPlanes = 8;  // ops/kernels.py SCATTER_MAX_PLANES

struct Planes {
  uint8_t* dst[kMaxPlanes];
  int64_t row_bytes[kMaxPlanes];
  int64_t off[kMaxPlanes];
};

struct Plane {
  uint8_t* dst;
  int64_t row_bytes;
  int64_t off;
};

#define VTT_PLANE(i) \
  case i:            \
    return Plane{p.dst[i], p.row_bytes[i], p.off[i]};

__device__ __forceinline__ Plane plane_at(const Planes& p, int i) {
  switch (i) {
    VTT_PLANE(0)
    VTT_PLANE(1)
    VTT_PLANE(2)
    VTT_PLANE(3)
    VTT_PLANE(4)
    VTT_PLANE(5)
    VTT_PLANE(6)
    VTT_PLANE(7)
  }
  return Plane{nullptr, 0, 0};
}

#undef VTT_PLANE

// Block (x, p): plane p's k rows.  Values start 16-byte aligned in the
// staged buffer, so a plane whose rows are whole words, at a word-aligned
// destination, moves in words.
__global__ void __launch_bounds__(256) scatter_planes_kernel(
    const uint8_t* staged, int k, Planes planes) {
  const Plane pl = plane_at(planes, static_cast<int>(blockIdx.y));
  const int32_t* rows = reinterpret_cast<const int32_t*>(staged);
  const uint8_t* vals = staged + pl.off;
  if (pl.row_bytes % 4 == 0 &&
      reinterpret_cast<uintptr_t>(pl.dst) % 4 == 0) {
    write_rows(reinterpret_cast<uint32_t*>(pl.dst), rows,
               reinterpret_cast<const uint32_t*>(vals), k, pl.row_bytes / 4);
  } else {
    write_rows(pl.dst, rows, vals, k, pl.row_bytes);
  }
}

}  // namespace

// `desc` (host memory): int64 [n_planes, 3] -- each plane's destination
// address, row bytes and value offset in `staged` (16-byte aligned;
// `staged` itself 16-byte aligned, its first 4 * k bytes the row ids).
extern "C" int vtt_scatter_planes(const void* staged, int k, int n_planes,
                                  const void* desc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k <= 0 || n_planes <= 0) return 0;
  if (n_planes > kMaxPlanes ||
      reinterpret_cast<uintptr_t>(staged) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t* d = static_cast<const int64_t*>(desc);
  Planes planes{};
  int64_t most = 0;
  for (int p = 0; p < n_planes; ++p) {
    planes.dst[p] = reinterpret_cast<uint8_t*>(d[3 * p]);
    planes.row_bytes[p] = d[3 * p + 1];
    planes.off[p] = d[3 * p + 2];
    if (planes.off[p] % 16 != 0 || planes.row_bytes[p] <= 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int64_t elems = planes.row_bytes[p] % 4 == 0
                              ? planes.row_bytes[p] / 4
                              : planes.row_bytes[p];
    most = std::max(most, static_cast<int64_t>(k) * elems);
  }
  const int threads = 256;
  const int64_t want = (most + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 1024 ? want : 1024);
  scatter_planes_kernel<<<dim3(blocks, n_planes), threads, 0, st>>>(
      static_cast<const uint8_t*>(staged), k, planes);
  return static_cast<int>(cudaGetLastError());
}

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
