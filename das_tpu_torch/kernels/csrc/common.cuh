// Shared device helpers of the das_tpu_torch Hopper kernels.
//
// Replaces the in-kernel primitives of das_tpu/kernels/common.py
// (unrolled_search: a binary upper bound and the 32-way warp search the
// probe and the index join share; select_columns), the key mix of
// das_tpu/ops/join.py (_mix_columns) and the one-block scan of the joins'
// counts (_scan_offsets), and declares the device-wide primitive the
// joins build on (primitives.cu): an int64 inclusive scan.  Nothing sorts:
// the joins group rows stably by key (group.cuh) instead.
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

// 32-way cooperative search by one warp: the first index i in [lo, hi)
// with keys[i] >= q (upper: keys[i] > q), hi when none; over [0, n) it is
// searchsorted(side='left' / 'right') over the whole column, padding
// included.  Invariant: the answer lies in [lo, hi]; lane l reads the key
// at lo + (l + 1) * stride - 1 and the ballot of "still below" is a prefix
// of the lanes, whose length c leaves [lo + c * stride,
// min(lo + (c + 1) * stride - 1, hi)]: ~5 dependent loads for 2^22 keys,
// where a binary search makes ~23.  Every lane of the warp calls it with
// the same arguments and gets the answer.
template <typename K>
__device__ __forceinline__ int64_t das_warp_search(const K* keys, int64_t lo, int64_t hi, K q,
                                                   bool upper) {
  const int lane = threadIdx.x & 31;
  while (hi > lo) {
    const int64_t stride = (hi - lo + 31) >> 5;
    const int64_t p = lo + (lane + 1) * stride - 1;
    bool below = false;
    if (p < hi) {
      const K v = keys[p];
      below = upper ? v <= q : v < q;
    }
    const int c = __popc(__ballot_sync(0xffffffffu, below));
    const int64_t nhi = lo + (c + 1) * stride - 1;
    lo += c * stride;
    hi = nhi < hi ? nhi : hi;
  }
  return lo;
}

// exclusive block-wide prefix sum of one value per thread; *total = the sum
template <typename T>
__device__ T das_block_exclusive(T v, T* warp_tot, T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  T s = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T t = __shfl_up_sync(0xffffffffu, s, o);
    if (lane >= o) s += t;
  }
  if (lane == 31) warp_tot[warp] = s;
  __syncthreads();
  if (warp == 0) {
    T w = lane < nw ? warp_tot[lane] : (T)0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T t = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += t;
    }
    if (lane < nw) warp_tot[lane] = w;
  }
  __syncthreads();
  const T excl = s - v + (warp > 0 ? warp_tot[warp - 1] : (T)0);
  *total = warp_tot[nw - 1];
  __syncthreads();
  return excl;
}

// in-place inclusive scan of a[0, n) by one block, in uint64 (wraps as
// XLA's int64 sums do); each thread takes one contiguous chunk
__device__ inline void das_block_scan(uint64_t* a, int64_t n, uint64_t* warp_tot) {
  const int64_t per = (n + blockDim.x - 1) / blockDim.x;
  const int64_t b = threadIdx.x * per, e = b + per < n ? b + per : n;
  uint64_t s = 0, total;
  for (int64_t i = b; i < e; ++i) s += a[i];
  uint64_t run = das_block_exclusive<uint64_t>(s, warp_tot, &total);
  for (int64_t i = b; i < e; ++i) {
    run += a[i];
    a[i] = run;
  }
  __syncthreads();
}

// ---- device-wide primitives (primitives.cu) --------------------------------

// int64 scratch elements das_scan_i64 needs for n inputs: one block sum per
// 2048-element tile, for every level of the block-sum recursion
int64_t das_scan_scratch(int64_t n);

// inclusive prefix sum out[i] = in[0] + ... + in[i]; in == out is allowed.
// Block scan of each tile, then a scan of the tile sums, then an add pass.
cudaError_t das_scan_i64(const int64_t* in, int64_t* out, int64_t n,
                         int64_t* scratch, int64_t scratch_len, cudaStream_t st);

// log2 of the slots of an open-addressing set for n keys: the least
// bits >= 5 with 2^bits >= 2n (load factor <= 1/2)
int das_set_bits(int64_t n);

// kernels das_scan_i64 launches for n inputs (for the launch counts the
// C entries report)
int das_scan_launches(int64_t n);

// lifts a kernel's dynamic shared memory limit to `bytes`, once per device
// (done[] holds DAS_MAX_DEVICES flags, one array per kernel)
#define DAS_MAX_DEVICES 64
cudaError_t das_smem_attr(const void* kernel, int bytes, bool* done);
