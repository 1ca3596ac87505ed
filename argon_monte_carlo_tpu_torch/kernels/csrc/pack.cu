// K12 pack_band and pack_indices: the masked lanes of a slab, packed in
// ascending lane order into a fixed buffer before an exchange.
//
// Replaces argon_monte_carlo_tpu/parallel/shard.py _compact_band (:210-230)
// and _compact_idx (:232-250): on the TPU a cumsum over the mask for the
// rank of each lane, then one scatter a field into a buffer of capacity + 1
// rows whose last row collects what does not fit.  The z-slab engine packs
// the halo bands (pos, vel, gid) up and down and then the migrants (pos,
// vel, paths, has_collided, gid) up and down, four times a slab a step;
// the index form freezes the pairs mode's export lists.
//
// Computes: rank = number of set lanes before lane i; lane i is selected
// iff mask[i] && rank < capacity; the selected lanes' rows go to slot rank
// of each field's buffer; slots from min(count, capacity) on hold the
// field's fill; flag marks the filled slots; dropped = max(count -
// capacity, 0).  The lanes dropped are the highest ones, as on the TPU.
//
// Bound: memory.  The mask is read once (a byte a lane), the selected rows
// are read and written once, the unfilled slots written once.
//
// Design: count -> scan -> write, as K6 (whose count and scan passes it
// shares), but the write pass, the one that knows the rank, moves the whole
// rows of up to five fields itself instead of emitting indices for a gather
// per field.  One thread a lane; a row is copied as 4-byte words, or as
// bytes for a 1-byte element (has_collided).  A last pass over the slots
// fills the tail and writes dropped, so no slot is written twice.  Integer
// and copy only: the output is the same in every run.
#include "common.cuh"

namespace {

constexpr int kMaxFields = 5;

// One field: n rows of row_bytes bytes at src, capacity rows at dst; a
// 4-byte element is copied and filled as words, a 1-byte element as bytes.
// fill holds the element's bit pattern.
struct Field {
  const uint8_t* src;
  uint8_t* dst;
  int row_bytes;
  int elem_bytes;
  int fill;
};

struct Fields {
  Field f[kMaxFields];
  int count;
};

__device__ __forceinline__ void copy_row(const Field& f, int from, int to) {
  if (f.elem_bytes == 4) {
    int words = f.row_bytes >> 2;
    const int* s = reinterpret_cast<const int*>(f.src) +
                   static_cast<long long>(from) * words;
    int* d = reinterpret_cast<int*>(f.dst) + static_cast<long long>(to) * words;
    for (int w = 0; w < words; ++w) d[w] = s[w];
  } else {
    const uint8_t* s = f.src + static_cast<long long>(from) * f.row_bytes;
    uint8_t* d = f.dst + static_cast<long long>(to) * f.row_bytes;
    for (int b = 0; b < f.row_bytes; ++b) d[b] = s[b];
  }
}

__device__ __forceinline__ void fill_row(const Field& f, int to) {
  if (f.elem_bytes == 4) {
    int words = f.row_bytes >> 2;
    int* d = reinterpret_cast<int*>(f.dst) + static_cast<long long>(to) * words;
    for (int w = 0; w < words; ++w) d[w] = f.fill;
  } else {
    uint8_t* d = f.dst + static_cast<long long>(to) * f.row_bytes;
    for (int b = 0; b < f.row_bytes; ++b) d[b] = static_cast<uint8_t>(f.fill);
  }
}

// Each selected lane writes its rows (and, for the index form, its own
// index) to the slot of its rank.
__global__ void pack_write_kernel(const uint8_t* __restrict__ mask, int n,
                                  const int* __restrict__ block_offsets,
                                  int capacity, Fields fields,
                                  int* __restrict__ idx,
                                  uint8_t* __restrict__ flag) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  bool set = i < n && mask[i];
  int total;
  int rank = amc::block_exclusive_scan(set ? 1 : 0, &total);
  if (!set) return;
  rank += block_offsets[blockIdx.x];
  if (rank >= capacity) return;
  for (int k = 0; k < fields.count; ++k) copy_row(fields.f[k], i, rank);
  if (idx != nullptr) idx[rank] = i;
  flag[rank] = 1;
}

// The slots no lane filled take the fills; thread 0 writes dropped.
__global__ void pack_tail_kernel(const int* __restrict__ total, int n,
                                 int capacity, Fields fields,
                                 int* __restrict__ idx,
                                 uint8_t* __restrict__ flag,
                                 int* __restrict__ dropped) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  int count = *total;
  if (k == 0) *dropped = max(count - capacity, 0);
  if (k >= capacity || k < count) return;
  for (int j = 0; j < fields.count; ++j) fill_row(fields.f[j], k);
  if (idx != nullptr) idx[k] = n;
  flag[k] = 0;
}

int pack_launch(const uint8_t* mask, int n, int capacity,
                const Fields& fields, int* idx, uint8_t* flag, int* dropped,
                int* block_vals, int* block_offsets, int* total,
                cudaStream_t stream) {
  amc::mask_scan_launch(mask, n, block_vals, block_offsets, total, stream);
  if (n > 0 && capacity > 0) {
    pack_write_kernel<<<amc::blocks_for(n), amc::kThreads, 0, stream>>>(
        mask, n, block_offsets, capacity, fields, idx, flag);
  }
  pack_tail_kernel<<<max(amc::blocks_for(capacity), 1), amc::kThreads, 0,
                     stream>>>(total, n, capacity, fields, idx, flag, dropped);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Fields k < num_fields are packed; the others' arguments are ignored.
// Scratch: block_vals, block_offsets (blocks_for(n) ints each), total (1).
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
    uint8_t* flag, int* dropped, int* block_vals, int* block_offsets,
    int* total, cudaStream_t stream) {
  if (num_fields < 0 || num_fields > kMaxFields) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Fields fields = {};
  fields.f[0] = {src0, dst0, row_bytes0, elem_bytes0, fill0};
  fields.f[1] = {src1, dst1, row_bytes1, elem_bytes1, fill1};
  fields.f[2] = {src2, dst2, row_bytes2, elem_bytes2, fill2};
  fields.f[3] = {src3, dst3, row_bytes3, elem_bytes3, fill3};
  fields.f[4] = {src4, dst4, row_bytes4, elem_bytes4, fill4};
  fields.count = num_fields;
  return pack_launch(mask, n, capacity, fields, nullptr, flag, dropped,
                     block_vals, block_offsets, total, stream);
}

// The index form: idx[slot] = the lane, n in the unfilled slots.
AMC_EXPORT int amc_pack_indices(const uint8_t* mask, int n, int capacity,
                                int* idx, uint8_t* flag, int* dropped,
                                int* block_vals, int* block_offsets,
                                int* total, cudaStream_t stream) {
  Fields fields = {};
  return pack_launch(mask, n, capacity, fields, idx, flag, dropped,
                     block_vals, block_offsets, total, stream);
}
