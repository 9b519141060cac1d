// Kernel 3: index join of a binding table into a whole link type.
//
// Replaces das_tpu/kernels/join.py index_join_impl (single-block
// _index_join_kernel_body and grid-chunked _tiled_index_join_body, both
// built on _index_join_window): probe = type_key<<32 | left[:, lc0] for
// valid left rows (-1 otherwise), lo/hi in the (type<<32|target) posting
// index, masked counts, their int64 inclusive scan, then for every output
// slot the left row by an upper-bound search of the offsets, the right row
// targets[perm[lo + (j - prev)]], the check of the remaining pairs and the
// emit [left | right_extra].  The right side is never materialized, and
// the total offsets[-1] is exact even past cap.
//
// Bound: memory traffic of random gathers — one binary search per left
// row over the posting keys, then per output slot one perm and one targets
// row gathered from a table of millions of rows.  The simple design: a
// grid over left rows for the bounds, the device-wide scan, and a grid over
// output slots whose threads gather independently; slots past the total
// write zeros without touching the index.
#include "common.cuh"

__global__ void ij_bounds_kernel(const int32_t* lv, const uint8_t* lm, int64_t n_left, int kl,
                                 int lc0, int64_t type_key, const int64_t* keys,
                                 int64_t n_keys, int64_t* lo, int64_t* cnt) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n_left;
       i += (int64_t)gridDim.x * blockDim.x) {
    const bool valid = lm[i] != 0;
    const int64_t probe =
        valid ? (int64_t)(((uint64_t)type_key << 32) | (uint64_t)(int64_t)lv[i * kl + lc0])
              : (int64_t)-1;
    const int64_t l = das_lower_bound<int64_t>(keys, n_keys, probe);
    const int64_t h = das_upper_bound<int64_t>(keys, n_keys, probe);
    lo[i] = l;
    cnt[i] = valid ? h - l : 0;
  }
}

// pairs.a = left column, pairs.b = target position; extra = target positions
__global__ void ij_expand_kernel(int64_t cap, const int64_t* offsets, const int64_t* cnt,
                                 const int64_t* lo, int64_t n_left, const int32_t* lv,
                                 const uint8_t* lm, int kl, const int32_t* perm,
                                 int64_t n_keys, const int32_t* targets, int64_t n_rows,
                                 int arity, DasPairs pairs, DasCols extra, int32_t* out,
                                 uint8_t* ov, int64_t* tot) {
  const int64_t total = n_left > 0 ? offsets[n_left - 1] : 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) tot[0] = total;
  const int k_out = kl + extra.n;
  for (int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; j < cap;
       j += (int64_t)gridDim.x * blockDim.x) {
    int32_t* o = out + j * k_out;
    bool valid = j < total && n_keys > 0 && n_rows > 0;
    int64_t li = 0;
    const int32_t* row = targets;
    if (valid) {
      int64_t prev;
      li = das_slot_row(offsets, cnt, n_left, j, &prev);
      const int64_t ri = das_clamp(lo[li] + (j - prev), 0, n_keys - 1);
      row = targets + das_clamp((int64_t)perm[ri], 0, n_rows - 1) * arity;
      valid = lm[li] != 0;
      for (int p = 0; p < pairs.n; ++p) valid = valid && row[pairs.b[p]] == lv[li * kl + pairs.a[p]];
    }
    const int32_t* lrow = lv + li * kl;
    for (int c = 0; c < kl; ++c) o[c] = valid ? lrow[c] : 0;
    for (int c = 0; c < extra.n; ++c) o[kl + c] = valid ? row[extra.c[c]] : 0;
    ov[j] = valid ? 1 : 0;
  }
}

// check_a/check_b: the pairs after the first, as (left column, target
// position); extra: right_extra as target positions.  Scratch: lo, cnt and
// offsets hold n_left int64 each, scan_scratch das_scan_scratch(n_left).
extern "C" int das_index_join(const void* lv, const void* lm, int64_t n_left, int kl,
                              int lc0, int64_t type_key, const void* keys, int64_t n_keys,
                              const void* perm, const void* targets, int64_t n_rows,
                              int arity, const int* check_a, const int* check_b,
                              int n_check, const int* extra, int n_extra, int64_t cap,
                              void* lo, void* cnt, void* offsets, void* scan_scratch,
                              int64_t scan_len, void* out, void* ov, void* tot,
                              void* stream) {
  if (n_check > DAS_MAXC || n_extra > DAS_MAXC) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (n_left > 0) {
    ij_bounds_kernel<<<das_blocks(n_left), DAS_THREADS, 0, st>>>(
        (const int32_t*)lv, (const uint8_t*)lm, n_left, kl, lc0, type_key,
        (const int64_t*)keys, n_keys, (int64_t*)lo, (int64_t*)cnt);
    cudaError_t err = das_scan_i64((const int64_t*)cnt, (int64_t*)offsets, n_left,
                                   (int64_t*)scan_scratch, scan_len, st);
    if (err != cudaSuccess) return (int)err;
  }
  ij_expand_kernel<<<das_blocks(cap), DAS_THREADS, 0, st>>>(
      cap, (const int64_t*)offsets, (const int64_t*)cnt, (const int64_t*)lo, n_left,
      (const int32_t*)lv, (const uint8_t*)lm, kl, (const int32_t*)perm, n_keys,
      (const int32_t*)targets, n_rows, arity, das_pairs(check_a, check_b, n_check),
      das_cols(extra, n_extra), (int32_t*)out, (uint8_t*)ov, (int64_t*)tot);
  return (int)cudaGetLastError();
}
