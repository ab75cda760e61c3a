// vcsnap: the wire-frame codec of volcano_tpu_torch's solver service.
//
// The scheduler process ships each cycle's solve inputs to the solver child
// that owns the card as ONE contiguous frame (cache/snapwire.py), and the
// assignment vectors come back the same way.  Layout (little-endian):
//
//   [0]  u32 magic 'VCSN'   [4] u32 version (1)   [8] u32 n_arrays
//   [12] u32 manifest_len   [16] manifest bytes (caller-opaque, e.g. JSON)
//   then per array, 8-byte aligned:
//     u8 dtype  u8 ndim  6 pad bytes  i64 dims[ndim]  i64 nbytes
//     data (8-byte aligned)
//
// Parsing returns offsets into the frame so the reader views array data
// without a copy.  Protocol v2's delta records (a frame may ship only the
// changed row ranges of an array the receiver mirrors) are validated and
// scattered here too.
//
// Host code: a plain C ABI read through ctypes (volcano_tpu_torch/native.py),
// built with `g++ -O2 -shared -fPIC` on first use into csrc/_build/.  Every
// function writes into caller-allocated NumPy buffers, so no memory
// management crosses the boundary.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

// Run fn(begin, end) over [0, n) in parallel chunks.  Small inputs stay
// single-threaded so thread start-up does not dominate.
void parallel_for(int64_t n, int64_t grain,
                  const std::function<void(int64_t, int64_t)>& fn) {
  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 1;
  int64_t chunks = std::min<int64_t>(hw, (n + grain - 1) / grain);
  if (chunks <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> threads;
  int64_t per = (n + chunks - 1) / chunks;
  threads.reserve(static_cast<size_t>(chunks));
  for (int64_t c = 0; c < chunks; ++c) {
    int64_t b = c * per;
    int64_t e = std::min(n, b + per);
    if (b >= e) break;
    threads.emplace_back(fn, b, e);
  }
  for (auto& t : threads) t.join();
}

inline int64_t align8(int64_t v) { return (v + 7) & ~int64_t{7}; }
inline int64_t header_bytes(uint8_t ndim) {
  return align8(8 + 8 * static_cast<int64_t>(ndim) + 8);
}

// Wire constants and the dtype table (code = index).  They mirror
// cache/snapwire.py (WIRE_MAGIC, WIRE_VERSION, WIRE_MAX_DIMS, _DTYPES);
// the table extends append-only, since codes are wire format.
constexpr uint32_t kMagic = 0x4E534356u;
constexpr uint32_t kVersion = 1u;
constexpr int32_t kMaxDims = 8;
constexpr int32_t kDtypeSize[] = {
    4,  // float32
    8,  // float64
    1,  // int8
    2,  // int16
    4,  // int32
    8,  // int64
    1,  // uint8
    2,  // uint16
    4,  // uint32
    8,  // uint64
    1,  // bool
};
constexpr int32_t kNDtypes =
    static_cast<int32_t>(sizeof(kDtypeSize) / sizeof(kDtypeSize[0]));

}  // namespace

extern "C" {

int64_t vcsnap_frame_bytes(const uint8_t* ndims, const int64_t* nbytes,
                           int32_t n, int64_t manifest_len) {
  int64_t total = align8(16 + manifest_len);
  for (int32_t i = 0; i < n; ++i) {
    total += header_bytes(ndims[i]) + align8(nbytes[i]);
  }
  return total;
}

void vcsnap_frame_pack(const uint8_t* dtypes, const uint8_t* ndims,
                       const int64_t* dims_flat, const int64_t* nbytes,
                       const uint8_t* const* srcs, int32_t n,
                       const uint8_t* manifest, int64_t manifest_len,
                       uint8_t* out) {
  uint32_t head[4] = {kMagic, kVersion, static_cast<uint32_t>(n),
                      static_cast<uint32_t>(manifest_len)};
  std::memcpy(out, head, 16);
  if (manifest_len) std::memcpy(out + 16, manifest, manifest_len);
  int64_t off = 16 + manifest_len;
  // Padding bytes are zero: the frame is byte-for-byte reproducible.
  std::memset(out + off, 0, static_cast<size_t>(align8(off) - off));
  off = align8(off);
  int64_t dim_off = 0;
  // Headers first (recording each data offset), then the data segments
  // in parallel: the large arrays dominate.
  std::vector<int64_t> data_off(static_cast<size_t>(n));
  for (int32_t i = 0; i < n; ++i) {
    int64_t hb = header_bytes(ndims[i]);
    std::memset(out + off, 0, static_cast<size_t>(hb));
    out[off] = dtypes[i];
    out[off + 1] = ndims[i];
    std::memcpy(out + off + 8, dims_flat + dim_off, 8 * ndims[i]);
    std::memcpy(out + off + 8 + 8 * ndims[i], nbytes + i, 8);
    off += hb;
    data_off[static_cast<size_t>(i)] = off;
    int64_t padded = align8(nbytes[i]);
    std::memset(out + off + nbytes[i], 0,
                static_cast<size_t>(padded - nbytes[i]));
    off += padded;
    dim_off += ndims[i];
  }
  parallel_for(n, 1, [&](int64_t b, int64_t e) {
    for (int64_t i = b; i < e; ++i) {
      if (nbytes[i]) {
        std::memcpy(out + data_off[static_cast<size_t>(i)], srcs[i],
                    static_cast<size_t>(nbytes[i]));
      }
    }
  });
}

int32_t vcsnap_frame_info(const uint8_t* buf, int64_t len,
                          int64_t* manifest_off, int64_t* manifest_len) {
  if (len < 16) return -1;
  uint32_t head[4];
  std::memcpy(head, buf, 16);
  if (head[0] != kMagic || head[1] != kVersion) return -1;
  if (manifest_off) *manifest_off = 16;
  if (manifest_len) *manifest_len = static_cast<int64_t>(head[3]);
  if (static_cast<int64_t>(head[3]) > len - 16) return -1;
  if (head[2] > 0x7FFFFFFFu) return -1;
  return static_cast<int32_t>(head[2]);
}

// Parses the headers into caller buffers sized from vcsnap_frame_info's
// count: dtypes[n], ndims[n], dims_flat[n * 8], data_off[n], nbytes[n].
// Returns 0, or -1 on a malformed frame (truncated, dim overflow, shape and
// byte length disagreeing).  The frame is hostile until this validates it.
//
// Every bounds check is written `X > len - off`, never `off + X > len`: a
// hostile header can put a value near INT64_MAX in an additive position,
// and `off + X` would wrap (signed overflow) into a passing comparison.
// `off` stays within [0, len + 7] (the +7 from align8), so `len - off`
// cannot overflow and a negative difference rejects.
int32_t vcsnap_frame_unpack(const uint8_t* buf, int64_t len, uint8_t* dtypes,
                            uint8_t* ndims, int64_t* dims_flat,
                            int64_t* data_off, int64_t* nbytes) {
  int64_t moff = 0, mlen = 0;
  int32_t n = vcsnap_frame_info(buf, len, &moff, &mlen);
  if (n < 0) return -1;
  int64_t off = align8(16 + mlen);
  for (int32_t i = 0; i < n; ++i) {
    if (16 > len - off) return -1;
    uint8_t nd = buf[off + 1];
    if (nd > kMaxDims) return -1;
    if (8 + 8 * static_cast<int64_t>(nd) + 8 > len - off) return -1;
    uint8_t dt = buf[off];
    if (dt >= kNDtypes) return -1;
    dtypes[i] = dt;
    ndims[i] = nd;
    std::memcpy(dims_flat + static_cast<int64_t>(i) * 8, buf + off + 8,
                8 * nd);
    int64_t elems = 1;
    for (uint8_t d = 0; d < nd; ++d) {
      int64_t dim = dims_flat[static_cast<int64_t>(i) * 8 + d];
      // A well-formed array's byte length fits the frame, so a dim that
      // pushes the element product past `len` marks a hostile header (and
      // guards the multiply against overflow).
      if (dim < 0 || (dim > 0 && elems > len / dim)) return -1;
      elems *= dim;
    }
    int64_t nb;
    std::memcpy(&nb, buf + off + 8 + 8 * nd, 8);
    if (nb < 0) return -1;
    // Shape x dtype width must equal the declared byte length, or a
    // reader's view would bleed into the next array's bytes.
    if (elems > len / kDtypeSize[dt]) return -1;
    if (nb != elems * kDtypeSize[dt]) return -1;
    off += header_bytes(nd);
    if (nb > len - off) return -1;
    data_off[i] = off;
    nbytes[i] = nb;
    off += align8(nb);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Delta records (protocol v2).  The wire descriptor is an int64 vector
//
//   [n_ranges, s0, e0, s1, e1, ...]
//
// of half-open [start, stop) row ranges, strictly ascending and
// non-overlapping, and the payload is the changed rows concatenated in
// range order.  The descriptor and the generation token arrive off the wire
// and are hostile until validated; rows / row_bytes / payload_bytes /
// mirror_gen come from the receiver's own mirror and are trusted.  No
// expression mixes a hostile value into arithmetic that could wrap into a
// passing comparison: counts are checked in division form, each range bound
// is compared directly against trusted limits.

// Returns the summed payload rows (>= 0), -1 on a malformed descriptor
// (truncated, out of bounds, unsorted / overlapping / empty ranges, payload
// length mismatch), -2 when the receiver's mirror generation is not the
// delta's base (the caller falls back to a full frame, never a stale solve).
int64_t vcsnap_delta_check(const int64_t* desc, int64_t desc_len,
                           int64_t rows, int64_t row_bytes,
                           int64_t payload_bytes,
                           int64_t mirror_gen, int64_t base_gen) {
  if (mirror_gen != base_gen) return -2;
  if (desc_len < 1) return -1;
  int64_t n = desc[0];
  if (n < 0 || n > (desc_len - 1) / 2) return -1;
  int64_t total = 0;
  int64_t prev_stop = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t s = desc[1 + 2 * i];
    int64_t e = desc[2 + 2 * i];
    if (s < prev_stop || s >= e || e > rows) return -1;
    total += e - s;  // disjoint within [0, rows): total <= rows
    prev_stop = e;
  }
  if (row_bytes <= 0) return payload_bytes != 0 ? -1 : total;
  if (payload_bytes % row_bytes != 0 || total != payload_bytes / row_bytes)
    return -1;
  return total;
}

// Validates, then scatters the payload rows into the caller's writable
// mirror array.  Returns 0, or the vcsnap_delta_check error; dst is
// untouched on any rejection.
int32_t vcsnap_delta_apply(uint8_t* dst, int64_t rows, int64_t row_bytes,
                           const int64_t* desc, int64_t desc_len,
                           const uint8_t* payload, int64_t payload_bytes,
                           int64_t mirror_gen, int64_t base_gen) {
  int64_t total = vcsnap_delta_check(desc, desc_len, rows, row_bytes,
                                     payload_bytes, mirror_gen, base_gen);
  if (total < 0) return static_cast<int32_t>(total);
  int64_t n = desc[0];
  int64_t off = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t s = desc[1 + 2 * i];
    int64_t e = desc[2 + 2 * i];
    int64_t nb = (e - s) * row_bytes;
    std::memcpy(dst + s * row_bytes, payload + off, static_cast<size_t>(nb));
    off += nb;
  }
  return 0;
}

}  // extern "C"
