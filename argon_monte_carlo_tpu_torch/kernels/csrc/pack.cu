// K12 pack_band, pack_indices and pack_band_pair: the selected lanes of a
// slab, packed in ascending lane order into a fixed buffer before an
// exchange.
//
// Replaces argon_monte_carlo_tpu/parallel/shard.py _compact_band (:210-230)
// and _compact_idx (:232-250): on the TPU a cumsum over the mask for the
// rank of each lane, then one scatter a field into a buffer of capacity + 1
// rows whose last row collects what does not fit.  The z-slab engine packs
// the halo bands (pos, vel, gid) up and down and then the migrants (pos,
// vel, paths, has_collided, gid) up and down; pack_band_pair does both
// directions of one exchange in one launch, straight from valid and the
// positions' z (shard.py:410-417, 479-486 of the reference): side 0 takes
// valid & (z > up_edge), or z >= up_edge for the migrants, side 1 valid &
// (z < down_edge); a side whose edge pointer is null (no neighbour there)
// packs nothing.  The edges are read on the device, so the host passes
// nothing that changes between calls.  pack_band and pack_indices pack
// one side, from a mask; the index form freezes the pairs mode's export
// lists.
//
// Computes, for each side: rank = number of selected lanes before lane i;
// lane i is kept iff it is selected and rank < capacity; the kept lanes'
// rows go to slot rank of each field's buffer; slots from min(count,
// capacity) on hold the field's fill; flag marks the filled slots; dropped
// = max(count - capacity, 0).  The lanes dropped are the highest ones, as
// on the TPU.
//
// Bound: memory.  The mask (or valid and the valid lanes' z) is read once,
// the kept rows are read and written once, the unfilled slots written once.
// A band is ~2% of a slab's lanes, so the call is a few microseconds of
// device work; the rest is the launch and the wrapper.
//
// Design: one launch, a single pass (the decoupled look-back of
// lookback.cuh, which K6 and K3 use).  A block takes a tile of 4,096 lanes
// by ticket, 16 consecutive lanes a thread (one 16-byte load of the mask or
// of valid when aligned; the valid lanes' z loaded all at once, so their
// latencies overlap), finds each lane's sides, counts both sides in one
// block scan (two 16-bit halves of an int) and looks back for the tile's
// prefix of both at once (two counts packed in one status value).  Each
// thread then writes its kept lanes' rows at their ranks, as 4-byte words,
// or as bytes for a 1-byte element (has_collided).  The block of the last
// tile knows the totals: it writes dropped and the tail fills of both
// sides, each field's tail one contiguous range of 16-byte stores.  The
// block that finishes with the status words last leaves the scratch zero.
// No count, scan or tail launch, no scratch allocated a call.  Integer and
// copy only: the output is the same in every run.
#include "common.cuh"
#include "lookback.cuh"

namespace {

constexpr int kMaxFields = 5;
constexpr int kItems = 16;  // lanes a thread
constexpr int kTile = amc::kThreads * kItems;

// One field: n rows of row_bytes bytes at src; capacity rows of each side
// at dst[side]; a 4-byte element is copied and filled as words, a 1-byte
// element as bytes.  fill holds the element's bit pattern.
struct Field {
  const uint8_t* src;
  uint8_t* dst[2];
  int row_bytes;
  int elem_bytes;
  int fill;
};

// The outputs of both sides (side 1 unused where only one side packs).
struct Outputs {
  Field f[kMaxFields];
  int num_fields;
  int sides;
  int capacity;
  int* idx[2];  // the index form, or null
  uint8_t* flag[2];
  int* dropped[2];
  uint8_t* rest;  // the two-side form: valid & !(up | down), or null
};

// Which lanes each side takes: mask (one side), or valid and z against the
// edges (two sides).
struct Select {
  const uint8_t* mask;
  const uint8_t* valid;
  const float* pos;  // (n, 3): z at pos[3 * i + 2]
  const float* up_edge;
  const float* down_edge;
  int up_inclusive;
};

__device__ __forceinline__ void copy_row(const Field& f, int side, int from,
                                         int to) {
  if (f.elem_bytes == 4) {
    int words = f.row_bytes >> 2;
    const int* s = reinterpret_cast<const int*>(f.src) +
                   static_cast<long long>(from) * words;
    int* d = reinterpret_cast<int*>(f.dst[side]) +
             static_cast<long long>(to) * words;
    for (int w = 0; w < words; ++w) d[w] = s[w];
  } else {
    const uint8_t* s = f.src + static_cast<long long>(from) * f.row_bytes;
    uint8_t* d = f.dst[side] + static_cast<long long>(to) * f.row_bytes;
    for (int b = 0; b < f.row_bytes; ++b) d[b] = s[b];
  }
}

// Bytes [lo, hi) of base take the repeated pattern of an elem_bytes-wide
// element (elements start on elem_bytes boundaries), written by the whole
// block: 16-byte stores in the aligned middle, bytes at the two ends.
__device__ __forceinline__ void fill_bytes(uint8_t* base, long long lo,
                                           long long hi, int elem_bytes,
                                           int fill) {
  if (lo >= hi) return;
  unsigned pattern = elem_bytes == 4 ? static_cast<unsigned>(fill)
                                     : (fill & 0xffu) * 0x01010101u;
  uintptr_t a = reinterpret_cast<uintptr_t>(base + lo);
  uintptr_t b = reinterpret_cast<uintptr_t>(base + hi);
  uintptr_t up = (a + 15) & ~static_cast<uintptr_t>(15);
  uintptr_t a16 = up < b ? up : b;
  uintptr_t down = b & ~static_cast<uintptr_t>(15);
  uintptr_t b16 = down > a16 ? down : a16;
  for (uintptr_t x = a + threadIdx.x; x < a16; x += amc::kThreads) {
    *reinterpret_cast<uint8_t*>(x) = (pattern >> (8 * (x & 3))) & 0xffu;
  }
  uint4 v = make_uint4(pattern, pattern, pattern, pattern);
  for (uintptr_t x = a16 + 16 * threadIdx.x; x < b16;
       x += 16 * amc::kThreads) {
    *reinterpret_cast<uint4*>(x) = v;
  }
  for (uintptr_t x = b16 + threadIdx.x; x < b; x += amc::kThreads) {
    *reinterpret_cast<uint8_t*>(x) = (pattern >> (8 * (x & 3))) & 0xffu;
  }
}

// Bit k set where byte first + k of p (k < kItems, below len) is nonzero.
template <bool kVector>
__device__ __forceinline__ unsigned nonzero_bits(const uint8_t* p,
                                                 long long first, int len) {
  unsigned bits = 0;
  if (kVector && first + kItems <= len) {
    uint4 v = *reinterpret_cast<const uint4*>(p + first);
    unsigned words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if ((words[k >> 2] >> (8 * (k & 3))) & 0xffu) bits |= 1u << k;
    }
  } else {
    for (int k = 0; k < kItems; ++k) {
      if (first + k < len && p[first + k]) bits |= 1u << k;
    }
  }
  return bits;
}

// Byte first + k of p (k < kItems, below len) = bit k of bits.
template <bool kVector>
__device__ __forceinline__ void store_bits(uint8_t* p, long long first,
                                           int len, unsigned bits) {
  if (kVector && first + kItems <= len) {
    unsigned words[4] = {0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      words[k >> 2] |= ((bits >> k) & 1u) << (8 * (k & 3));
    }
    *reinterpret_cast<uint4*>(p + first) =
        make_uint4(words[0], words[1], words[2], words[3]);
  } else {
    for (int k = 0; k < kItems; ++k) {
      if (first + k < len) p[first + k] = (bits >> k) & 1u;
    }
  }
}

// Write the kept lanes among bits (lanes first + k) of one side, the first
// of them at rank.
__device__ __forceinline__ void write_side(const Outputs& out, int side,
                                           unsigned bits, long long first,
                                           int rank) {
  while (bits != 0 && rank < out.capacity) {
    int lane = static_cast<int>(first) + __ffs(bits) - 1;
    for (int k = 0; k < out.num_fields; ++k) {
      copy_row(out.f[k], side, lane, rank);
    }
    if (out.idx[side] != nullptr) out.idx[side][rank] = lane;
    out.flag[side][rank] = 1;
    bits &= bits - 1;
    ++rank;
  }
}

// The slots of one side no lane filled, and its dropped; by the block of
// the last tile, which knows the side's total.  Each field's unfilled rows
// are one contiguous range of one repeated element.
__device__ __forceinline__ void finish_side(const Outputs& out, int side,
                                            int total, int n) {
  if (threadIdx.x == 0) *out.dropped[side] = max(total - out.capacity, 0);
  long long from = min(total, out.capacity);
  for (int j = 0; j < out.num_fields; ++j) {
    const Field& f = out.f[j];
    fill_bytes(f.dst[side], from * f.row_bytes,
               static_cast<long long>(out.capacity) * f.row_bytes,
               f.elem_bytes, f.fill);
  }
  if (out.idx[side] != nullptr) {
    fill_bytes(reinterpret_cast<uint8_t*>(out.idx[side]), 4 * from,
               4ll * out.capacity, 4, n);
  }
  fill_bytes(out.flag[side], from, out.capacity, 1, 0);
}

// kVector: the mask (or valid, and rest) is 16-byte aligned.
template <bool kVector>
__launch_bounds__(amc::kThreads) __global__ void pack_kernel(
    Select sel, int n, int ntiles, Outputs out,
    unsigned long long* __restrict__ scratch) {
  int tile = amc::take_tile(scratch);
  long long first = static_cast<long long>(tile) * kTile +
                    threadIdx.x * kItems;
  unsigned up = 0, down = 0;  // bit k: lane first + k is on the side
  if (sel.mask != nullptr) {
    up = nonzero_bits<kVector>(sel.mask, first, n);
  } else {
    unsigned live = nonzero_bits<kVector>(sel.valid, first, n);
    float up_edge = sel.up_edge != nullptr ? *sel.up_edge : 0.0f;
    float down_edge = sel.down_edge != nullptr ? *sel.down_edge : 0.0f;
    // The valid lanes' z, all loads in flight before the first compare.
    float z[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      z[k] = (live >> k) & 1u ? __ldg(sel.pos + 3 * (first + k) + 2) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      bool on = (live >> k) & 1u;
      bool is_up = on && sel.up_edge != nullptr &&
                   (sel.up_inclusive ? z[k] >= up_edge : z[k] > up_edge);
      bool is_down = on && sel.down_edge != nullptr && z[k] < down_edge;
      up |= is_up ? 1u << k : 0u;
      down |= is_down ? 1u << k : 0u;
    }
    if (out.rest != nullptr) {
      store_bits<kVector>(out.rest, first, n, live & ~(up | down));
    }
  }
  // Both sides' counts in one scan: at most kTile each, so 16 bits each.
  int tile_total;
  int rank = amc::block_exclusive_scan((__popc(up) << 16) | __popc(down),
                                       &tile_total);
  int total_up = tile_total >> 16, total_down = tile_total & 0xffff;
  bool last;
  unsigned long long prefix = amc::tile_prefix_value(
      scratch, tile, amc::pack2(total_up, total_down), ntiles, &last);
  int before_up = amc::pack2_hi(prefix), before_down = amc::pack2_lo(prefix);
  write_side(out, 0, up, first, before_up + (rank >> 16));
  if (out.sides > 1) {
    write_side(out, 1, down, first, before_down + (rank & 0xffff));
  }
  if (tile == ntiles - 1) {
    // Every ticket is taken and every earlier tile is counted in prefix.
    finish_side(out, 0, before_up + total_up, n);
    if (out.sides > 1) finish_side(out, 1, before_down + total_down, n);
  }
  if (last) amc::release_tiles(scratch, ntiles);
}

int pack_launch(const Select& sel, int n, const Outputs& out,
                unsigned long long* scratch, cudaStream_t stream) {
  int ntiles = max(amc::blocks_for(n, kTile), 1);
  uintptr_t bytes = reinterpret_cast<uintptr_t>(sel.mask) |
                    reinterpret_cast<uintptr_t>(sel.valid) |
                    reinterpret_cast<uintptr_t>(out.rest);
  if ((bytes & 15u) == 0) {
    pack_kernel<true><<<ntiles, amc::kThreads, 0, stream>>>(sel, n, ntiles,
                                                            out, scratch);
  } else {
    pack_kernel<false><<<ntiles, amc::kThreads, 0, stream>>>(sel, n, ntiles,
                                                             out, scratch);
  }
  return static_cast<int>(cudaGetLastError());
}

Field field(const uint8_t* src, uint8_t* dst, int row_bytes, int elem_bytes,
            int fill, int capacity) {
  // Side 1's rows follow side 0's (pack_band_pair's (2, capacity, ...)
  // buffers); the one-side forms never write them.
  uint8_t* second = dst == nullptr
                        ? nullptr
                        : dst + static_cast<long long>(capacity) * row_bytes;
  return {src, {dst, second}, row_bytes, elem_bytes, fill};
}

// The outputs of the fields k < num_fields, from the exported functions'
// five argument groups.
Outputs outputs(int capacity, int num_fields, const uint8_t* const* src,
                uint8_t* const* dst, const int* row_bytes,
                const int* elem_bytes, const int* fill) {
  Outputs out = {};
  for (int k = 0; k < kMaxFields; ++k) {
    out.f[k] = field(src[k], dst[k], row_bytes[k], elem_bytes[k], fill[k],
                     capacity);
  }
  out.num_fields = num_fields;
  out.capacity = capacity;
  return out;
}

}  // namespace

// The five field argument groups of an exported function as arrays.
#define AMC_FIELD_ARRAYS                                                   \
  const uint8_t* src[kMaxFields] = {src0, src1, src2, src3, src4};         \
  uint8_t* dst[kMaxFields] = {dst0, dst1, dst2, dst3, dst4};               \
  int row_bytes[kMaxFields] = {row_bytes0, row_bytes1, row_bytes2,         \
                               row_bytes3, row_bytes4};                    \
  int elem_bytes[kMaxFields] = {elem_bytes0, elem_bytes1, elem_bytes2,     \
                                elem_bytes3, elem_bytes4};                 \
  int fill[kMaxFields] = {fill0, fill1, fill2, fill3, fill4}

// Every form takes the look-back scratch (lookback.cuh): 1 + ceil(n / 4096)
// 64-bit words, zero, this stream's (shared with K6 and K3).  Fields k <
// num_fields are packed; the others' arguments are ignored.

// One side from a mask: buffers of capacity rows, flag (capacity),
// dropped (1).
AMC_EXPORT int amc_pack_band(
    const uint8_t* mask, int n, int capacity, int num_fields,
    const uint8_t* src0, uint8_t* dst0, int row_bytes0, int elem_bytes0,
    int fill0,
    const uint8_t* src1, uint8_t* dst1, int row_bytes1, int elem_bytes1,
    int fill1,
    const uint8_t* src2, uint8_t* dst2, int row_bytes2, int elem_bytes2,
    int fill2,
    const uint8_t* src3, uint8_t* dst3, int row_bytes3, int elem_bytes3,
    int fill3,
    const uint8_t* src4, uint8_t* dst4, int row_bytes4, int elem_bytes4,
    int fill4,
    uint8_t* flag, int* dropped, unsigned long long* scratch,
    cudaStream_t stream) {
  if (num_fields < 0 || num_fields > kMaxFields) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  AMC_FIELD_ARRAYS;
  Outputs out = outputs(capacity, num_fields, src, dst, row_bytes,
                        elem_bytes, fill);
  out.sides = 1;
  out.flag[0] = flag;
  out.dropped[0] = dropped;
  Select sel = {mask, nullptr, nullptr, nullptr, nullptr, 0};
  return pack_launch(sel, n, out, scratch, stream);
}

// The index form: idx[slot] = the lane, n in the unfilled slots.
AMC_EXPORT int amc_pack_indices(const uint8_t* mask, int n, int capacity,
                                int* idx, uint8_t* flag, int* dropped,
                                unsigned long long* scratch,
                                cudaStream_t stream) {
  Outputs out = {};
  out.capacity = capacity;
  out.sides = 1;
  out.idx[0] = idx;
  out.flag[0] = flag;
  out.dropped[0] = dropped;
  Select sel = {mask, nullptr, nullptr, nullptr, nullptr, 0};
  return pack_launch(sel, n, out, scratch, stream);
}

// Both directions of one exchange: side 0 (up) valid & (z > *up_edge), or
// z >= *up_edge with up_inclusive; side 1 (down) valid & (z < *down_edge);
// a null edge packs nothing on its side.  pos is (n, 3) float32; every
// dst holds (2, capacity) rows, side 1's after side 0's, flag (2,
// capacity), dropped (2); rest (n), unless null, receives the lanes that
// stay: valid & !(up | down).
AMC_EXPORT int amc_pack_band_pair(
    const uint8_t* valid, const float* pos, int n, const float* up_edge,
    const float* down_edge, int up_inclusive, int capacity, int num_fields,
    const uint8_t* src0, uint8_t* dst0, int row_bytes0, int elem_bytes0,
    int fill0,
    const uint8_t* src1, uint8_t* dst1, int row_bytes1, int elem_bytes1,
    int fill1,
    const uint8_t* src2, uint8_t* dst2, int row_bytes2, int elem_bytes2,
    int fill2,
    const uint8_t* src3, uint8_t* dst3, int row_bytes3, int elem_bytes3,
    int fill3,
    const uint8_t* src4, uint8_t* dst4, int row_bytes4, int elem_bytes4,
    int fill4,
    uint8_t* flag, int* dropped, uint8_t* rest, unsigned long long* scratch,
    cudaStream_t stream) {
  if (num_fields < 0 || num_fields > kMaxFields) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  AMC_FIELD_ARRAYS;
  Outputs out = outputs(capacity, num_fields, src, dst, row_bytes,
                        elem_bytes, fill);
  out.sides = 2;
  out.rest = rest;
  out.flag[0] = flag;
  out.flag[1] = flag + capacity;
  out.dropped[0] = dropped;
  out.dropped[1] = dropped + 1;
  Select sel = {nullptr, valid, pos, up_edge, down_edge, up_inclusive};
  return pack_launch(sel, n, out, scratch, stream);
}
