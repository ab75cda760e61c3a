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
// the JAX function does) and the f32 soft-weight table.  CUDA has no byte
// atomics, so a flag adds 1 << (8 * (cell % 4)) to the cell's 32-bit word:
// a byte cannot carry into its neighbour because real (row, col) pairs are
// unique, so no cell counts past 1.  A real cell's soft value takes one
// f32 add onto 0.0; the padded entries add +0.0 at (0, 0), and v + 0.0 = v
// for every v a table built from integer weights holds (never -0.0), so
// the order of the adds cannot change a value.
//
// Bound: bytes.  The tables are written once (zero fill, then the
// entries); at BASELINE config 5 at 10,000 x 100,000 the count table is
// [4,097, 10,016] int32 (164 MB) and the profile tables [8,192, 4,097]
// (201 MB), with a few thousand entries: the zero fill is the whole cost.
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

__global__ void __launch_bounds__(256) scatter_flags_kernel(
    const int32_t* rows, const int32_t* cols, const int8_t* flags,
    const float* soft, int k, int e, uint32_t* aff, uint32_t* anti,
    uint32_t* match, float* soft_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;
  const int64_t cell = static_cast<int64_t>(rows[i]) * e + cols[i];
  const int64_t word = cell >> 2;
  const unsigned shift = static_cast<unsigned>(cell & 3) * 8u;
  const int f = flags[i];
  if (f & 1) atomicAdd(&aff[word], 1u << shift);
  if ((f >> 1) & 1) atomicAdd(&anti[word], 1u << shift);
  if ((f >> 2) & 1) atomicAdd(&match[word], 1u << shift);
  atomicAdd(&soft_out[cell], soft[i]);
}

// Byte counts -> bool: the int8 count tested > 0.
__global__ void __launch_bounds__(256) flags_to_bool_kernel(
    uint8_t* aff, uint8_t* anti, uint8_t* match, int64_t cells) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= cells) return;
  aff[i] = static_cast<int8_t>(aff[i]) > 0 ? 1 : 0;
  anti[i] = static_cast<int8_t>(anti[i]) > 0 ? 1 : 0;
  match[i] = static_cast<int8_t>(match[i]) > 0 ? 1 : 0;
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

// aff / anti / match: byte buffers of whole 32-bit words covering u * e
// cells; soft_out: [u, e] f32.
extern "C" int vtt_scatter_profile_tables(
    const void* rows, const void* cols, const void* flags, const void* soft,
    int k, int u, int e, void* aff, void* anti, void* match, void* soft_out,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t cells = static_cast<int64_t>(u) * e;
  const size_t plane = static_cast<size_t>((cells + 3) / 4) * 4;
  cudaError_t err = cudaMemsetAsync(aff, 0, plane, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(anti, 0, plane, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(match, 0, plane, st);
  if (err == cudaSuccess) {
    err = cudaMemsetAsync(soft_out, 0, static_cast<size_t>(cells) * 4, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k > 0) {
    scatter_flags_kernel<<<(k + 255) / 256, 256, 0, st>>>(
        static_cast<const int32_t*>(rows), static_cast<const int32_t*>(cols),
        static_cast<const int8_t*>(flags), static_cast<const float*>(soft), k,
        e, static_cast<uint32_t*>(aff), static_cast<uint32_t*>(anti),
        static_cast<uint32_t*>(match), static_cast<float*>(soft_out));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = (cells + 255) / 256;
  flags_to_bool_kernel<<<static_cast<unsigned>(blocks), 256, 0, st>>>(
      static_cast<uint8_t*>(aff), static_cast<uint8_t*>(anti),
      static_cast<uint8_t*>(match), cells);
  return static_cast<int>(cudaGetLastError());
}
