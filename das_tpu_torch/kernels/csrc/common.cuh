// Shared device helpers of the das_tpu_torch Hopper kernels.
//
// Replaces the in-kernel primitives of das_tpu/kernels/common.py
// (unrolled_search, select_columns) and the key mix of das_tpu/ops/join.py
// (_mix_columns), and declares the two device-wide primitives the joins
// build on (primitives.cu): an int64 inclusive scan and a stable LSD radix
// sort of int64 keys carrying an int32 payload.
//
// Every entry point has a plain C interface (loaded with ctypes), launches
// on the stream it is given, allocates nothing (the Python wrapper passes
// every output and scratch buffer) and returns cudaGetLastError().
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define DAS_THREADS 256
#define DAS_MAX_BLOCKS 8448  // 64 blocks per SM on 132 SMs; loops stride past it
#define DAS_MAXC 16          // most columns a binding table or a term may have

// small static column lists travel by value in the kernel arguments
struct DasCols {
  int n;
  int c[DAS_MAXC];
};

struct DasPairs {
  int n;
  int a[DAS_MAXC];
  int b[DAS_MAXC];
};

static inline DasCols das_cols(const int* c, int n) {
  DasCols out;
  out.n = n;
  for (int i = 0; i < n && i < DAS_MAXC; ++i) out.c[i] = c[i];
  return out;
}

static inline DasPairs das_pairs(const int* a, const int* b, int n) {
  DasPairs out;
  out.n = n;
  for (int i = 0; i < n && i < DAS_MAXC; ++i) {
    out.a[i] = a[i];
    out.b[i] = b[i];
  }
  return out;
}

static inline unsigned das_blocks(int64_t n) {
  int64_t b = (n + DAS_THREADS - 1) / DAS_THREADS;
  if (b < 1) b = 1;
  if (b > DAS_MAX_BLOCKS) b = DAS_MAX_BLOCKS;
  return (unsigned)b;
}

__device__ __forceinline__ int64_t das_clamp(int64_t x, int64_t lo, int64_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// first index i in [0, n) with keys[i] >= q (n when none): the
// searchsorted(side='left') of unrolled_search; 0 for an empty column
template <typename T>
__device__ __forceinline__ int64_t das_lower_bound(const T* keys, int64_t n, T q) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (keys[mid] < q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// first index i in [0, n) with keys[i] > q: searchsorted(side='right')
template <typename T>
__device__ __forceinline__ int64_t das_upper_bound(const T* keys, int64_t n, T q) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (keys[mid] <= q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// arithmetic shift right by 29, written out: a logical shift, then the
// sign bit replicated into the 29 vacated high bits
__device__ __forceinline__ uint64_t das_sar29(uint64_t x) {
  uint64_t s = x >> 29;
  if (x >> 63) s |= ~(~0ull >> 29);
  return s;
}

// the 64-bit column mix of ops/join.py _mix_columns, bit for bit: the
// multiply and add run in uint64 so overflow wraps (signed overflow is
// undefined in C++), each int32 value sign-extended first
__device__ __forceinline__ int64_t das_mix_row(const int32_t* row, const DasCols& cols) {
  uint64_t acc = 0;
  for (int i = 0; i < cols.n; ++i) {
    acc = acc * 0x9E3779B97F4A7C15ull + (uint64_t)(int64_t)row[cols.c[i]];
    acc ^= das_sar29(acc);
  }
  return (int64_t)acc;
}

// slot -> (left row, first slot of that row) of a pair expansion:
// li = upper_bound(offsets, j) over the inclusive offsets of the per-row
// pair counts, clamped to [0, n_left - 1] like _expand_window's li_safe;
// prev = offsets[li] - cnt[li].  Only called for j < offsets[n_left - 1].
__device__ __forceinline__ int64_t das_slot_row(const int64_t* offsets, const int64_t* cnt,
                                                int64_t n_left, int64_t j, int64_t* prev) {
  const int64_t li = das_clamp(das_upper_bound<int64_t>(offsets, n_left, j), 0, n_left - 1);
  *prev = offsets[li] - cnt[li];
  return li;
}

// ---- device-wide primitives (primitives.cu) --------------------------------

// key[i] = valid[i] ? mix(vals[i, cols]) : sentinel, for a [n, k] table
void das_mix(const int32_t* vals, int64_t n, int k, const uint8_t* valid,
             DasCols cols, int64_t sentinel, int64_t* key, cudaStream_t st);

// int64 scratch elements das_scan_i64 needs for n inputs: one block sum per
// 2048-element tile, for every level of the block-sum recursion
int64_t das_scan_scratch(int64_t n);

// inclusive prefix sum out[i] = in[0] + ... + in[i]; in == out is allowed.
// Block scan of each tile, then a scan of the tile sums, then an add pass.
cudaError_t das_scan_i64(const int64_t* in, int64_t* out, int64_t n,
                         int64_t* scratch, int64_t scratch_len, cudaStream_t st);

// blocks (4096-element tiles) of one radix pass
int64_t das_sort_tiles(int64_t n);

// stable ascending sort of int64 keys: keys_out = sorted keys, idx_out =
// the original position of each (a stable argsort).  LSD radix sort, 8
// passes of 8 bits over sign-flipped keys.  tmp_keys/tmp_idx hold n
// elements, hist and hist_incl 256 * das_sort_tiles(n) each, scan_scratch
// das_scan_scratch(256 * das_sort_tiles(n)).
cudaError_t das_radix_sort_i64(const int64_t* keys, int64_t n, int64_t* keys_out,
                               int32_t* idx_out, int64_t* tmp_keys, int32_t* tmp_idx,
                               int64_t* hist, int64_t* hist_incl,
                               int64_t* scan_scratch, int64_t scan_len,
                               cudaStream_t st);
