// static_mask: the [P, N] static predicate mask, and its four parts.
//
// Replaces the JAX package's `static_predicate_mask`
// (volcano_tpu/ops/predicates.py:57) and its helpers `selector_mask` (:22),
// `affinity_mask` (:31), `taint_mask` (:44) and `port_mask` (:51): bitset
// algebra over the encode's uint32 words (int32 tensors here, the same
// bits).  `terms` picks what one launch computes, a compile-time choice:
//
//   kReady  node ready & node real & task real;
//   kSel    selector words a subset of the node's label words, or no
//           selector (`has_selector` false passes whatever the words hold);
//   kAff    any of the task's first min(aff_terms, A) required-affinity
//           terms a subset of the node's label words, or aff_terms == 0
//           (terms at index >= aff_terms do not count; A == 0 with
//           aff_terms > 0 passes nothing, as `jnp.any` over no terms);
//   kTaint  every node taint word tolerated;
//   kPort   the task's port words disjoint from the node's.
//
// `static_predicate_mask` is kReady | kSel | kAff | kTaint in one launch;
// each helper is its one term.  An empty word axis (LW, TW or PW == 0)
// tests nothing and passes, as `jnp.all` over a zero-width axis.
//
// Shape: a 2-D grid of task x node tiles.  A block covers 512 nodes (32
// lanes x 16 consecutive nodes) and 32 task rows (8 warps x 4 rows).  The
// tile's node words are staged in shared memory once, laid out [word][cell
// 0..15][lane] so that a warp reading one cell of one word reads 32
// consecutive words; where they do not fit (more than kMaxStaged words a
// node) they are read through the read-only cache instead.  Each lane
// keeps its 16 nodes' ready & real bits in a register mask; a warp takes
// one task row at a time (its words are one address for the warp: a
// broadcast), clears the bits of the nodes each term fails, and writes the
// row's 16 cells with one 16-byte store (byte stores where N is not a
// multiple of 16 or at the row's end), so a warp writes 512 consecutive
// bytes.  Row tiles past the grid's 65,535 y-blocks are taken by a
// grid-stride loop; every flat index is 64-bit (P x N passes 2^31 at the
// 100,000-node tier).
//
// Bound: bytes -- the [P, N] output is written once (1 GB at 100,000
// tasks x 10,000 nodes); the inputs are a few MB.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kReady = 1;
constexpr int kSel = 2;
constexpr int kAff = 4;
constexpr int kTaint = 8;
constexpr int kPort = 16;

constexpr int kLanes = 32;
constexpr int kCells = 16;
constexpr int kTileN = kLanes * kCells;  // 512 nodes a block
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kTileP = kWarps * kRowsPerWarp;  // 32 task rows a block
constexpr int kMaxStaged = 24;  // node words staged: 24 x 512 x 4 = 48 KB
constexpr int kMaxGridY = 65535;

struct MaskIn {
  int64_t P;
  int64_t N;
  int LW;
  int A;
  int TW;
  int PW;
  const uint8_t* n_ready;   // [N] (kReady)
  const uint8_t* n_real;    // [N] (kReady)
  const uint8_t* t_real;    // [P] (kReady)
  const uint32_t* n_label;  // [N, LW] (kSel, kAff)
  const uint32_t* sel;      // [P, LW] (kSel)
  const uint8_t* has_sel;   // [P] (kSel)
  const uint32_t* aff;      // [P, A, LW] (kAff)
  const int32_t* aff_terms; // [P] (kAff)
  const uint32_t* n_taint;  // [N, TW] (kTaint)
  const uint32_t* tol;      // [P, TW] (kTaint)
  const uint32_t* n_port;   // [N, PW] (kPort)
  const uint32_t* t_port;   // [P, PW] (kPort)
  uint8_t* out;             // [P, N]
  int vec;                  // N % 16 == 0: rows start 16-byte aligned
};

// Word w of the node `my0 + j` from a [N, W] table: the staged copy
// (`base` its first staged word) or the table itself.
template <bool kStaged>
__device__ __forceinline__ uint32_t node_word(const uint32_t* sm, int base,
                                              const uint32_t* table, int W,
                                              int w, int j, int lane,
                                              int64_t my0, int nv) {
  if (kStaged) return sm[(base + w) * kTileN + j * kLanes + lane];
  return j < nv ? __ldg(&table[(my0 + j) * W + w]) : 0u;
}

template <int kTerms>
__device__ __forceinline__ int staged_words(const MaskIn& in) {
  return ((kTerms & (kSel | kAff)) ? in.LW : 0) +
         ((kTerms & kTaint) ? in.TW : 0) + ((kTerms & kPort) ? in.PW : 0);
}

// The 16 cells' bits of `ok` as 16 bytes of 0 / 1.
__device__ __forceinline__ uint32_t cell_bytes(uint32_t ok, int k) {
  const uint32_t nib = (ok >> (4 * k)) & 0xFu;
  return (nib & 1u) | ((nib & 2u) << 7) | ((nib & 4u) << 14) |
         ((nib & 8u) << 21);
}

template <int kTerms, bool kStaged>
__global__ void __launch_bounds__(kWarps * kLanes)
    static_mask_kernel(const MaskIn in) {
  extern __shared__ uint32_t sm[];
  const int lane = threadIdx.x & (kLanes - 1);
  const int warp = threadIdx.x / kLanes;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kTileN;
  const int64_t my0 = n0 + lane * kCells;
  const int nv = static_cast<int>(
      max(static_cast<int64_t>(0),
          min(static_cast<int64_t>(kCells), in.N - my0)));
  const int lab_base = 0;
  const int taint_base = (kTerms & (kSel | kAff)) ? in.LW : 0;
  const int port_base = taint_base + ((kTerms & kTaint) ? in.TW : 0);

  if (kStaged) {
    // Stage the tile's node words: [word][cell][lane], zero past N.
    const int words = staged_words<kTerms>(in);
    for (int i = threadIdx.x; i < words * kTileN; i += blockDim.x) {
      const int w = i / kTileN;
      const int nl = i - w * kTileN;
      const int64_t n = n0 + nl;
      uint32_t v = 0;
      if (n < in.N) {
        if ((kTerms & (kSel | kAff)) && w < taint_base) {
          v = in.n_label[n * in.LW + (w - lab_base)];
        } else if ((kTerms & kTaint) && w < port_base) {
          v = in.n_taint[n * in.TW + (w - taint_base)];
        } else if (kTerms & kPort) {
          v = in.n_port[n * in.PW + (w - port_base)];
        }
      }
      sm[w * kTileN + (nl % kCells) * kLanes + nl / kCells] = v;
    }
    __syncthreads();
  }

  // The lane's valid cells, less the nodes that are not ready and real.
  uint32_t base = nv >= kCells ? 0xFFFFu : ((1u << nv) - 1u);
  if (kTerms & kReady) {
#pragma unroll
    for (int j = 0; j < kCells; ++j) {
      if (j < nv && !(in.n_ready[my0 + j] && in.n_real[my0 + j])) {
        base &= ~(1u << j);
      }
    }
  }
  if (nv <= 0) return;  // past the last node (no barrier follows)

  const int64_t row_tiles = (in.P + kTileP - 1) / kTileP;
  for (int64_t ty = blockIdx.y; ty < row_tiles; ty += gridDim.y) {
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int64_t t = ty * kTileP + warp * kRowsPerWarp + r;
      if (t >= in.P) break;
      uint32_t ok = base;
      if ((kTerms & kReady) && !in.t_real[t]) ok = 0;
      if ((kTerms & kSel) && ok && in.has_sel[t]) {
        const uint32_t* s = in.sel + t * in.LW;
        for (int w = 0; w < in.LW; ++w) {
          const uint32_t sw = __ldg(&s[w]);
          if (sw == 0) continue;
#pragma unroll
          for (int j = 0; j < kCells; ++j) {
            const uint32_t lw = node_word<kStaged>(
                sm, lab_base, in.n_label, in.LW, w, j, lane, my0, nv);
            if (sw & ~lw) ok &= ~(1u << j);
          }
        }
      }
      if ((kTerms & kAff) && ok) {
        const int at = __ldg(&in.aff_terms[t]);
        if (at != 0) {
          uint32_t any = 0;
          const int na = min(at, in.A);
          for (int a = 0; a < na; ++a) {
            uint32_t term = ok;
            const uint32_t* s = in.aff + (t * in.A + a) * in.LW;
            for (int w = 0; w < in.LW && term; ++w) {
              const uint32_t sw = __ldg(&s[w]);
              if (sw == 0) continue;
#pragma unroll
              for (int j = 0; j < kCells; ++j) {
                const uint32_t lw = node_word<kStaged>(
                    sm, lab_base, in.n_label, in.LW, w, j, lane, my0, nv);
                if (sw & ~lw) term &= ~(1u << j);
              }
            }
            any |= term;
          }
          ok &= any;
        }
      }
      if ((kTerms & kTaint) && ok) {
        const uint32_t* s = in.tol + t * in.TW;
        for (int w = 0; w < in.TW; ++w) {
          const uint32_t tw = __ldg(&s[w]);
          if (tw == 0xFFFFFFFFu) continue;
#pragma unroll
          for (int j = 0; j < kCells; ++j) {
            const uint32_t nw = node_word<kStaged>(
                sm, taint_base, in.n_taint, in.TW, w, j, lane, my0, nv);
            if (nw & ~tw) ok &= ~(1u << j);
          }
        }
      }
      if ((kTerms & kPort) && ok) {
        const uint32_t* s = in.t_port + t * in.PW;
        for (int w = 0; w < in.PW; ++w) {
          const uint32_t pw = __ldg(&s[w]);
          if (pw == 0) continue;
#pragma unroll
          for (int j = 0; j < kCells; ++j) {
            const uint32_t nw = node_word<kStaged>(
                sm, port_base, in.n_port, in.PW, w, j, lane, my0, nv);
            if (pw & nw) ok &= ~(1u << j);
          }
        }
      }
      uint8_t* dst = in.out + t * in.N + my0;
      if (in.vec && nv == kCells) {
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(cell_bytes(ok, 0), cell_bytes(ok, 1),
                       cell_bytes(ok, 2), cell_bytes(ok, 3));
      } else {
        for (int j = 0; j < nv; ++j) dst[j] = (ok >> j) & 1u;
      }
    }
  }
}

template <int kTerms>
cudaError_t launch(const MaskIn& in, cudaStream_t st) {
  const int words = ((kTerms & (kSel | kAff)) ? in.LW : 0) +
                    ((kTerms & kTaint) ? in.TW : 0) +
                    ((kTerms & kPort) ? in.PW : 0);
  const int64_t row_tiles = (in.P + kTileP - 1) / kTileP;
  const dim3 grid(static_cast<unsigned>((in.N + kTileN - 1) / kTileN),
                  static_cast<unsigned>(std::min<int64_t>(row_tiles,
                                                          kMaxGridY)));
  const dim3 block(kWarps * kLanes);
  if (words <= kMaxStaged) {
    const size_t smem = static_cast<size_t>(words) * kTileN * 4;
    static_mask_kernel<kTerms, true><<<grid, block, smem, st>>>(in);
  } else {
    static_mask_kernel<kTerms, false><<<grid, block, 0, st>>>(in);
  }
  return cudaGetLastError();
}

}  // namespace

// One launch of the mask `terms` selects (ops/kernels.py MASK_*): the whole
// static mask (kReady | kSel | kAff | kTaint) or one helper's term.  A
// pointer a chosen term does not read may be null.  P == 0 or N == 0
// launches nothing.
extern "C" int vtt_static_mask(int terms, int64_t P, int64_t N, int LW,
                               int A, int TW, int PW, const void* n_ready,
                               const void* n_real, const void* t_real,
                               const void* n_label, const void* sel,
                               const void* has_sel, const void* aff,
                               const void* aff_terms, const void* n_taint,
                               const void* tol, const void* n_port,
                               const void* t_port, void* out, void* stream) {
  if (P < 0 || N < 0 || LW < 0 || A < 0 || TW < 0 || PW < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (P == 0 || N == 0) return 0;
  MaskIn in;
  in.P = P;
  in.N = N;
  in.LW = LW;
  in.A = A;
  in.TW = TW;
  in.PW = PW;
  in.n_ready = static_cast<const uint8_t*>(n_ready);
  in.n_real = static_cast<const uint8_t*>(n_real);
  in.t_real = static_cast<const uint8_t*>(t_real);
  in.n_label = static_cast<const uint32_t*>(n_label);
  in.sel = static_cast<const uint32_t*>(sel);
  in.has_sel = static_cast<const uint8_t*>(has_sel);
  in.aff = static_cast<const uint32_t*>(aff);
  in.aff_terms = static_cast<const int32_t*>(aff_terms);
  in.n_taint = static_cast<const uint32_t*>(n_taint);
  in.tol = static_cast<const uint32_t*>(tol);
  in.n_port = static_cast<const uint32_t*>(n_port);
  in.t_port = static_cast<const uint32_t*>(t_port);
  in.out = static_cast<uint8_t*>(out);
  in.vec = (N % kCells) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (terms) {
    case kReady | kSel | kAff | kTaint:
      return static_cast<int>(launch<kReady | kSel | kAff | kTaint>(in, st));
    case kSel:
      return static_cast<int>(launch<kSel>(in, st));
    case kAff:
      return static_cast<int>(launch<kAff>(in, st));
    case kTaint:
      return static_cast<int>(launch<kTaint>(in, st));
    case kPort:
      return static_cast<int>(launch<kPort>(in, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
