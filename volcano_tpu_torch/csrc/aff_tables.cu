// aff_tables: the dense affinity tables of a solve, rebuilt on the card
// from their sparse entries.
//
// `scatter_cnt0` replaces the JAX package's jitted `_scatter_cnt0`
// (volcano_tpu/ops/wave.py:2296): the [E + 1, D] int32 resident-match
// counts per (term, domain) from (row, col, val) entries, padded entries
// adding 0 at (0, 0).  Integer atomics: exact in any order.
//
// `scatter_profile_tables` replaces `_scatter_profile_tables`
// (wave.py:2301): the three [U, E + 1] bool profile-term tables (required
// affinity, required anti-affinity, self-match: bits 0, 1, 2 of each
// entry's flags, summed per cell as int8 counts and then tested > 0, as
// the JAX function does) and the f32 soft-weight table.  Two launches,
// and every table byte is written once:
//
// 1. `zero_planes_kernel` zeroes the four planes in one pass of 16-byte
//    stores, one a thread (each plane starts 16-byte aligned; the bytes
//    past a plane's last whole 16 take byte stores);
// 2. `scatter_profile_kernel`, one thread an entry.  Real (row, col) pairs
//    are unique (the encode takes them from `np.nonzero`), so a cell's
//    int8 count is its entry's flag bit and "count > 0" is the bit: each
//    set bit is a plain store of 1, with no atomics and no count.  The
//    soft value is an f32 add onto the zeroed cell, 0.0 + v as in JAX (a
//    real -0.0 becomes +0.0).  An entry with no flag bit and a soft value
//    of +-0.0 (every padded entry, at (0, 0)) changes nothing in JAX's sum
//    and writes nothing.
//
// Bound: bytes.  The tables are written once (zero fill, then the
// entries); at BASELINE config 5 at 10,000 x 100,000 the count table is
// [4,097, 10,016] int32 (164 MB) and the profile tables [4,096, 4,097]
// (7 bytes a cell, 117.5 MB), with a few thousand entries: the zero fill
// is the whole cost.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256) scatter_cnt0_kernel(
    const int32_t* rows, const int32_t* cols, const int32_t* vals, int k,
    int d, int32_t* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;
  const int v = vals[i];
  if (v != 0) {
    atomicAdd(&out[static_cast<int64_t>(rows[i]) * d + cols[i]], v);
  }
}

// The four planes of one call, each 16-byte aligned: `nv` whole 16-byte
// vectors, `b0` the first block of the fill that stores them, `tail` the
// bytes past the last whole vector.  Indexed with constants only (`pick`):
// an index computed at run time would copy the struct to local memory.
struct Planes {
  uint8_t* p[4];
  int64_t nv[4];
  int64_t b0[4];
  int tail[4];
};

template <typename V>
__device__ __forceinline__ V pick(int j, const V (&a)[4]) {
  return j == 0 ? a[0] : (j == 1 ? a[1] : (j == 2 ? a[2] : a[3]));
}

// One 16-byte store a thread; each block's 256 vectors lie in one plane.
__global__ void __launch_bounds__(256) zero_planes_kernel(Planes pl) {
  const int64_t b = blockIdx.x;
  const int j = (b >= pl.b0[1]) + (b >= pl.b0[2]) + (b >= pl.b0[3]);
  const int64_t v = (b - pick(j, pl.b0)) * 256 + threadIdx.x;
  if (v < pick(j, pl.nv)) {
    reinterpret_cast<uint4*>(pick(j, pl.p))[v] = make_uint4(0u, 0u, 0u, 0u);
  }
  // Tails: thread t < 64 of block 0 zeroes byte t % 16 past plane t / 16's
  // vectors.
  if (b == 0 && threadIdx.x < 64) {
    const int k = threadIdx.x >> 4;
    const int t = threadIdx.x & 15;
    if (t < pick(k, pl.tail)) pick(k, pl.p)[pick(k, pl.nv) * 16 + t] = 0;
  }
}

__global__ void __launch_bounds__(256) scatter_profile_kernel(
    const int32_t* rows, const int32_t* cols, const int8_t* flags,
    const float* soft, int k, int e, uint8_t* aff, uint8_t* anti,
    uint8_t* match, float* soft_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;
  const int f = flags[i];
  const float v = soft[i];
  if ((f & 7) == 0 && v == 0.0f) return;  // adds 0 (and +-0.0) only
  const int64_t cell = static_cast<int64_t>(rows[i]) * e + cols[i];
  if (f & 1) aff[cell] = 1;
  if (f & 2) anti[cell] = 1;
  if (f & 4) match[cell] = 1;
  atomicAdd(&soft_out[cell], v);
}

}  // namespace

extern "C" int vtt_scatter_cnt0(const void* rows, const void* cols,
                                const void* vals, int k, int e, int d,
                                void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      out, 0, static_cast<size_t>(e) * d * sizeof(int32_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k > 0) {
    scatter_cnt0_kernel<<<(k + 255) / 256, 256, 0, st>>>(
        static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cols),
        static_cast<const int32_t*>(vals), k, d,
        static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// aff / anti / match: [u, e] bool planes; soft_out: [u, e] f32; each
// plane 16-byte aligned.
extern "C" int vtt_scatter_profile_tables(
    const void* rows, const void* cols, const void* flags, const void* soft,
    int k, int u, int e, void* aff, void* anti, void* match, void* soft_out,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t cells = static_cast<int64_t>(u) * e;
  void* const planes[4] = {aff, anti, match, soft_out};
  const int64_t bytes[4] = {cells, cells, cells, cells * 4};
  Planes pl;
  int64_t blocks = 0;
  for (int j = 0; j < 4; ++j) {
    if (reinterpret_cast<uintptr_t>(planes[j]) % 16 != 0) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
    pl.p[j] = static_cast<uint8_t*>(planes[j]);
    pl.nv[j] = bytes[j] / 16;
    pl.b0[j] = blocks;
    pl.tail[j] = static_cast<int>(bytes[j] % 16);
    blocks += (pl.nv[j] + 255) / 256;
  }
  zero_planes_kernel<<<static_cast<unsigned>(blocks < 1 ? 1 : blocks), 256,
                       0, st>>>(pl);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || k <= 0) return static_cast<int>(err);
  scatter_profile_kernel<<<(k + 255) / 256, 256, 0, st>>>(
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cols),
      static_cast<const int8_t*>(flags), static_cast<const float*>(soft), k,
      e, static_cast<uint8_t*>(aff), static_cast<uint8_t*>(anti),
      static_cast<uint8_t*>(match), static_cast<float*>(soft_out));
  return static_cast<int>(cudaGetLastError());
}
