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
// Bound: bytes -- the [P, N] output is written once (2.1 GB at the
// 10,000 x 100,000 feature store padded to 131,072 x 16,384); the inputs
// are a few MB.  At the card's 3.35 TB/s an SM has to retire ~14 output
// bytes a clock, so both the loads ahead of a store and the arithmetic per
// cell have to stay off the store's path.  The design:
//
// - Persistent node-tile blocks.  The grid is one wave of resident blocks
//   (SM count x blocks an SM holds, queried once per kernel, device and
//   shared-memory size), spread over the node tiles (x) and row groups
//   (y).  A block covers 1,024 nodes: each lane two runs of 16 consecutive
//   nodes, 512 apart, so a warp's row is two stores of 512 consecutive
//   bytes and a lane's per-row work (the task fields, the branches, the
//   address) is paid once for 32 cells.  A block stages its tile once
//   and walks the row tiles ty = blockIdx.y, += gridDim.y; every row tile
//   is covered whatever the grid.
// - Node words as cell sets.  Staged once a block: for node word w, bit b
//   and lane l, the 32-bit set of the lane's cells that lack bit b (label
//   words) or have it (taint and port words), laid out [w][b][lane] so a
//   warp's shared stores and loads are 32 consecutive words, and for each
//   (w, lane) the bits worth testing (some cell lacks / has them).  A row
//   then tests a word with one shared load per task bit left after that
//   filter -- a selector or a required term holds one to three bits, an
//   untolerated taint one -- instead of 32 compares.  Node ready & real
//   are folded into each lane's base mask.  Up to kMaxStaged (24) words a
//   node are staged (4,224 bytes a word: at 24, two blocks an SM); past
//   that, node words are read through the read-only cache, 32 compares a
//   word, as before.
// - Task words staged ahead.  A block copies the fields its terms read for
//   a batch of kBatch rows (t_real, has_selector, aff_terms and, up to
//   kMaxRowWords words a row, the selector, affinity, toleration and port
//   words) into shared memory with 16-byte `cp.async` (one contiguous span
//   a field, so a row of one 4-byte word needs no alignment of its own),
//   double-buffered: batch b+1 is in flight while batch b is computed and
//   stored.  The row path then reads no global memory.  Wider rows read
//   their words through the cache; a source not 16-byte aligned is copied
//   with plain loads.
// - Streaming stores.  Each run of 16 cells is one 16-byte `st.global.cs`
//   (evict-first: the 2 GB written do not push the task and node words out
//   of L2); byte stores where N % 16 != 0 or at a row's end.  Plain
//   stores, and TMA bulk stores of a shared [row x 512 B] tile, measured
//   slower (PERF.md).
//
// Every flat index is 64-bit (P x N passes 2^31 at the 100,000-node tier).
#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"

namespace {

constexpr int kReady = 1;
constexpr int kSel = 2;
constexpr int kAff = 4;
constexpr int kTaint = 8;
constexpr int kPort = 16;

constexpr int kLanes = 32;
constexpr int kRun = 16;  // consecutive nodes of a lane: one 16-byte store
constexpr int kGroups = 2;  // runs a lane covers, kGroupN nodes apart
constexpr int kGroupN = kLanes * kRun;  // 512: a warp's store a row
constexpr int kCells = kRun * kGroups;  // 32 cells a lane
constexpr int kTileN = kLanes * kCells;  // 1,024 nodes a block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kLanes;
constexpr int kBatch = 128;     // task rows a block stages at once
constexpr int kMaxStaged = 24;  // node words staged as cell sets
constexpr int kMaxRowWords = 8;  // task words a row staged (32 bytes)
constexpr int kMaxGridY = 65535;
// A staged node word: its [bit][lane] cell sets and [lane] filters.
constexpr int kWordBytes = kLanes * kLanes * 4 + kLanes * 4;
constexpr int kRawBytes = kCells * kLanes * 4;  // one word of the tile

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
  // A batch buffer: each staged field's byte offset (-1: not staged, read
  // through the cache), its size, and the two buffers' region (at least
  // one raw node word while the tables are built).
  int o_treal;
  int o_hassel;
  int o_at;
  int o_sel;
  int o_aff;
  int o_tol;
  int o_port;
  int buf_bytes;
  int region;
};

template <int kTerms>
__host__ __device__ __forceinline__ int staged_words(const MaskIn& in) {
  return ((kTerms & (kSel | kAff)) ? in.LW : 0) +
         ((kTerms & kTaint) ? in.TW : 0) + ((kTerms & kPort) ? in.PW : 0);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `bytes` of a task field into a batch buffer (16-byte aligned): 16-byte
// cp.async chunks when the source is 16-byte aligned (the last one
// zero-filled past `bytes`), else plain loads.
__device__ __forceinline__ void stage_span(unsigned char* dst,
                                           const void* src, int bytes) {
  const unsigned char* s = static_cast<const unsigned char*>(src);
  if ((reinterpret_cast<uintptr_t>(s) & 15) == 0) {
    for (int c = threadIdx.x * 16; c < bytes; c += kThreads * 16) {
      const int n = min(16, bytes - c);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       smem_addr(dst + c)),
                   "l"(s + c), "r"(n)
                   : "memory");
    }
  } else {
    for (int i = threadIdx.x; i < bytes; i += kThreads) dst[i] = s[i];
  }
}

// The fields the terms read for row tile `ty` into `buf`.
template <int kTerms>
__device__ __forceinline__ void stage_batch(const MaskIn& in, int64_t ty,
                                            unsigned char* buf) {
  const int64_t t0 = ty * kBatch;
  const int rows =
      static_cast<int>(min(static_cast<int64_t>(kBatch), in.P - t0));
  if (kTerms & kReady) stage_span(buf + in.o_treal, in.t_real + t0, rows);
  if (kTerms & kSel) {
    stage_span(buf + in.o_hassel, in.has_sel + t0, rows);
    if (in.o_sel >= 0) {
      stage_span(buf + in.o_sel, in.sel + t0 * in.LW, rows * in.LW * 4);
    }
  }
  if (kTerms & kAff) {
    stage_span(buf + in.o_at, in.aff_terms + t0, rows * 4);
    if (in.o_aff >= 0) {
      stage_span(buf + in.o_aff, in.aff + t0 * in.A * in.LW,
                 rows * in.A * in.LW * 4);
    }
  }
  if ((kTerms & kTaint) && in.o_tol >= 0) {
    stage_span(buf + in.o_tol, in.tol + t0 * in.TW, rows * in.TW * 4);
  }
  if ((kTerms & kPort) && in.o_port >= 0) {
    stage_span(buf + in.o_port, in.t_port + t0 * in.PW, rows * in.PW * 4);
  }
}

// Word `i` of row `r` of a task field: the staged copy at `off`, or word
// `g` of the field through the cache.
__device__ __forceinline__ uint32_t task_word(const unsigned char* buf,
                                              int off, int i,
                                              const uint32_t* field,
                                              int64_t g) {
  return off >= 0 ? reinterpret_cast<const uint32_t*>(buf + off)[i]
                  : __ldg(field + g);
}

constexpr int kSubset = 0;     // the task's bits all in the node's word
constexpr int kTolerated = 1;  // the node's bits all in the task's word
constexpr int kDisjoint = 2;   // no bit in both

// Node of cell j of `lane` in the tile at n0: run j / kRun, kGroupN apart.
__device__ __forceinline__ int64_t cell_node(int64_t n0, int lane, int j) {
  return n0 + (j / kRun) * kGroupN + lane * kRun + (j % kRun);
}

// The lane's cells that lie before N (each run a prefix of its 16 bits).
__device__ __forceinline__ uint32_t valid_cells(int64_t N, int64_t n0,
                                                int lane) {
  uint32_t m = 0;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int64_t v = N - (n0 + g * kGroupN + lane * kRun);
    const uint32_t run =
        v >= kRun ? 0xFFFFu : v > 0 ? (1u << v) - 1u : 0u;
    m |= run << (g * kRun);
  }
  return m;
}

// The cells of `live` that fail the task word `tw` against node word `w`
// (of the staged order; `wl` of its [N, W] `table`).  Staged: one table
// load per filtered task bit, until every live cell failed; else the
// lane's node words through the cache.
template <bool kStaged, int kKind>
__device__ __forceinline__ uint32_t fails(uint32_t tw, uint32_t live, int w,
                                          const uint32_t* tbl,
                                          const uint32_t* need, int lane,
                                          const uint32_t* table, int W,
                                          int wl, int64_t n0,
                                          uint32_t valid) {
  uint32_t f = 0;
  if (kStaged) {
    uint32_t bits = (kKind == kTolerated ? ~tw : tw) & need[w * kLanes + lane];
    while (bits) {
      const int b = __ffs(bits) - 1;
      bits &= bits - 1;
      f |= tbl[(w * kLanes + b) * kLanes + lane];
      if ((f & live) == live) break;
    }
  } else {
    if (kKind == kTolerated ? tw == 0xFFFFFFFFu : tw == 0u) return 0;
#pragma unroll
    for (int j = 0; j < kCells; ++j) {
      if ((valid >> j) & 1u) {
        const uint32_t nw = __ldg(&table[cell_node(n0, lane, j) * W + wl]);
        const uint32_t bad = kKind == kSubset      ? (tw & ~nw)
                             : kKind == kTolerated ? (nw & ~tw)
                                                   : (tw & nw);
        if (bad) f |= 1u << j;
      }
    }
  }
  return f;
}

// Cells 4k..4k+3 of `ok` as four bytes of 0 / 1: the nibble spread over
// four bytes by one multiply (the four shifted copies do not overlap).
__device__ __forceinline__ uint32_t cell_bytes(uint32_t ok, int k) {
  return (((ok >> (4 * k)) & 0xFu) * 0x00204081u) & 0x01010101u;
}

template <int kTerms, bool kStaged>
__global__ void __launch_bounds__(kThreads)
    static_mask_kernel(const MaskIn in) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & (kLanes - 1);
  const int warp = threadIdx.x / kLanes;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kTileN;
  const uint32_t valid = valid_cells(in.N, n0, lane);
  const int taint_base = (kTerms & (kSel | kAff)) ? in.LW : 0;
  const int port_base = taint_base + ((kTerms & kTaint) ? in.TW : 0);
  const int words = kStaged ? staged_words<kTerms>(in) : 0;
  uint32_t* tbl = reinterpret_cast<uint32_t*>(smem);
  uint32_t* need = tbl + words * kLanes * kLanes;
  unsigned char* bufs = smem + words * kWordBytes;

  if (kStaged) {
    // One node word at a time: the tile's raw words [cell][lane] (a
    // warp's stores consecutive), then its cell sets and filters.
    uint32_t* raw = reinterpret_cast<uint32_t*>(bufs);
    for (int w = 0; w < words; ++w) {
      const bool lab = (kTerms & (kSel | kAff)) && w < taint_base;
      const uint32_t* table;
      int W;
      int wl;
      if (lab) {
        table = in.n_label;
        W = in.LW;
        wl = w;
      } else if ((kTerms & kTaint) && w < port_base) {
        table = in.n_taint;
        W = in.TW;
        wl = w - taint_base;
      } else {
        table = in.n_port;
        W = in.PW;
        wl = w - port_base;
      }
      for (int i = threadIdx.x; i < kCells * kLanes; i += kThreads) {
        const int64_t n = cell_node(n0, i & (kLanes - 1), i / kLanes);
        raw[i] = n < in.N ? __ldg(&table[n * W + wl]) : 0u;
      }
      __syncthreads();
      for (int i = threadIdx.x; i < kLanes * kLanes; i += kThreads) {
        const int l = i & (kLanes - 1);
        const int b = i / kLanes;
        uint32_t m = 0;
#pragma unroll
        for (int j = 0; j < kCells; ++j) {
          m |= ((raw[j * kLanes + l] >> b) & 1u) << j;
        }
        tbl[(w * kLanes + b) * kLanes + l] = lab ? ~m : m;
      }
      if (threadIdx.x < kLanes) {
        const int l = threadIdx.x;
        const uint32_t v = valid_cells(in.N, n0, l);
        uint32_t bits = 0;
        for (int j = 0; j < kCells; ++j) {
          if ((v >> j) & 1u) {
            const uint32_t x = raw[j * kLanes + l];
            bits |= lab ? ~x : x;
          }
        }
        need[w * kLanes + l] = bits;
      }
      __syncthreads();
    }
  }

  // The lane's valid cells, less the nodes that are not ready and real.
  uint32_t base = valid;
  if (kTerms & kReady) {
#pragma unroll
    for (int j = 0; j < kCells; ++j) {
      const int64_t n = cell_node(n0, lane, j);
      if (((valid >> j) & 1u) && !(in.n_ready[n] && in.n_real[n])) {
        base &= ~(1u << j);
      }
    }
  }

  const int64_t row_tiles = (in.P + kBatch - 1) / kBatch;
  int64_t ty = blockIdx.y;
  if (ty < row_tiles) stage_batch<kTerms>(in, ty, bufs);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int k = 0; ty < row_tiles; ty += gridDim.y, ++k) {
    if (ty + gridDim.y < row_tiles) {
      stage_batch<kTerms>(in, ty + gridDim.y,
                          bufs + ((k + 1) & 1) * in.buf_bytes);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    const unsigned char* buf = bufs + (k & 1) * in.buf_bytes;
    const int rows = static_cast<int>(
        min(static_cast<int64_t>(kBatch), in.P - ty * kBatch));
    uint8_t* dst = in.out + (ty * kBatch + warp) * in.N + n0 + lane * kRun;
#pragma unroll 1
    for (int r = warp; r < rows; r += kWarps, dst += kWarps * in.N) {
      const int64_t t = ty * kBatch + r;
      uint32_t ok = base;
      if ((kTerms & kReady) && !buf[in.o_treal + r]) ok = 0;
      if ((kTerms & kSel) && ok && buf[in.o_hassel + r]) {
        for (int w = 0; w < in.LW && ok; ++w) {
          const uint32_t sw =
              task_word(buf, in.o_sel, r * in.LW + w, in.sel, t * in.LW + w);
          ok &= ~fails<kStaged, kSubset>(sw, ok, w, tbl, need, lane,
                                         in.n_label, in.LW, w, n0, valid);
        }
      }
      if ((kTerms & kAff) && ok) {
        const int at = reinterpret_cast<const int32_t*>(buf + in.o_at)[r];
        if (at != 0) {
          uint32_t any = 0;
          const int na = min(at, in.A);
          for (int a = 0; a < na && any != ok; ++a) {
            uint32_t term = ok;
            const int i0 = (r * in.A + a) * in.LW;
            const int64_t g0 = (t * in.A + a) * in.LW;
            for (int w = 0; w < in.LW && term; ++w) {
              const uint32_t aw =
                  task_word(buf, in.o_aff, i0 + w, in.aff, g0 + w);
              term &= ~fails<kStaged, kSubset>(aw, term, w, tbl, need, lane,
                                               in.n_label, in.LW, w, n0,
                                               valid);
            }
            any |= term;
          }
          ok &= any;
        }
      }
      if ((kTerms & kTaint) && ok) {
        for (int w = 0; w < in.TW && ok; ++w) {
          const uint32_t tw =
              task_word(buf, in.o_tol, r * in.TW + w, in.tol, t * in.TW + w);
          ok &= ~fails<kStaged, kTolerated>(tw, ok, taint_base + w, tbl,
                                            need, lane, in.n_taint, in.TW,
                                            w, n0, valid);
        }
      }
      if ((kTerms & kPort) && ok) {
        for (int w = 0; w < in.PW && ok; ++w) {
          const uint32_t pw = task_word(buf, in.o_port, r * in.PW + w,
                                        in.t_port, t * in.PW + w);
          ok &= ~fails<kStaged, kDisjoint>(pw, ok, port_base + w, tbl, need,
                                           lane, in.n_port, in.PW, w, n0,
                                           valid);
        }
      }
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const uint32_t run = (valid >> (g * kRun)) & 0xFFFFu;
        uint8_t* d = dst + g * kGroupN;
        if (in.vec && run == 0xFFFFu) {
          asm volatile(
              "st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(d),
              "r"(cell_bytes(ok, 4 * g)), "r"(cell_bytes(ok, 4 * g + 1)),
              "r"(cell_bytes(ok, 4 * g + 2)), "r"(cell_bytes(ok, 4 * g + 3)));
        } else {
          for (int c = 0; c < kRun && ((run >> c) & 1u); ++c) {
            d[c] = (ok >> (g * kRun + c)) & 1u;
          }
        }
      }
    }
    // Every warp is done with this buffer before it is staged again.
    __syncthreads();
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

constexpr int align16(int64_t x) {
  return static_cast<int>((x + 15) & ~static_cast<int64_t>(15));
}

// The batch buffer's layout for `kTerms` on `in`'s shapes.
template <int kTerms>
void layout(MaskIn& in) {
  int off = 0;
  auto take = [&off](int& o, int64_t bytes) {
    o = off;
    off = align16(off + bytes);
  };
  in.o_treal = in.o_hassel = in.o_at = in.o_sel = in.o_aff = in.o_tol =
      in.o_port = -1;
  const int64_t row_words =
      ((kTerms & kSel) ? in.LW : 0) +
      ((kTerms & kAff) ? static_cast<int64_t>(in.A) * in.LW : 0) +
      ((kTerms & kTaint) ? in.TW : 0) + ((kTerms & kPort) ? in.PW : 0);
  const bool words = row_words <= kMaxRowWords;
  if (kTerms & kReady) take(in.o_treal, kBatch);
  if (kTerms & kSel) {
    take(in.o_hassel, kBatch);
    if (words) take(in.o_sel, int64_t{kBatch} * in.LW * 4);
  }
  if (kTerms & kAff) {
    take(in.o_at, kBatch * 4);
    if (words) take(in.o_aff, int64_t{kBatch} * in.A * in.LW * 4);
  }
  if ((kTerms & kTaint) && words) take(in.o_tol, int64_t{kBatch} * in.TW * 4);
  if ((kTerms & kPort) && words) take(in.o_port, int64_t{kBatch} * in.PW * 4);
  in.buf_bytes = off;
  in.region = std::max(2 * off, kRawBytes);
}

// Blocks of `fn` (with `smem` bytes of dynamic shared memory) the current
// device holds at once, queried once per (kernel, device, size); sets the
// kernel's dynamic shared-memory limit first where it passes 48 KB.
cudaError_t resident_blocks(const void* fn, size_t smem, int64_t* blocks) {
  static std::mutex lock;
  static std::map<std::tuple<const void*, int, size_t>, int64_t> known;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> hold(lock);
  const auto key = std::make_tuple(fn, dev, smem);
  const auto it = known.find(key);
  if (it != known.end()) {
    *blocks = it->second;
    return cudaSuccess;
  }
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int sms = 0;
  int per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                        smem);
  }
  if (err != cudaSuccess) return err;
  *blocks = std::max<int64_t>(1, static_cast<int64_t>(sms) * per_sm);
  known[key] = *blocks;
  return cudaSuccess;
}

template <int kTerms>
cudaError_t launch(MaskIn& in, cudaStream_t st) {
  layout<kTerms>(in);
  const int words = staged_words<kTerms>(in);
  const bool staged = words <= kMaxStaged;
  const size_t smem =
      static_cast<size_t>(staged ? words : 0) * kWordBytes + in.region;
  const void* fn =
      staged ? reinterpret_cast<const void*>(static_mask_kernel<kTerms, true>)
             : reinterpret_cast<const void*>(
                   static_mask_kernel<kTerms, false>);
  int64_t blocks = 0;
  const cudaError_t err = resident_blocks(fn, smem, &blocks);
  if (err != cudaSuccess) return err;
  const int64_t tiles = (in.N + kTileN - 1) / kTileN;
  const int64_t row_tiles = (in.P + kBatch - 1) / kBatch;
  const int64_t gy = std::max<int64_t>(
      1, std::min<int64_t>({blocks / tiles, row_tiles, kMaxGridY}));
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(gy));
  if (staged) {
    static_mask_kernel<kTerms, true><<<grid, kThreads, smem, st>>>(in);
  } else {
    static_mask_kernel<kTerms, false><<<grid, kThreads, smem, st>>>(in);
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
  in.vec = (N % kRun) == 0;
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
