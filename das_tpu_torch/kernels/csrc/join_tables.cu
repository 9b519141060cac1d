// Kernel 2: sort-merge equi-join of two materialized binding tables.
//
// Replaces das_tpu/kernels/join.py join_tables_impl (single-block
// _join_kernel_body and grid-chunked _tiled_join_body, built on
// _join_prologue, _expand_window and _emit_pairs): the int64 mix of each
// side's join columns (sentinels 2^63-1 left, 2^63-2 right), a STABLE
// argsort of the right keys, lo/hi of every left key, the int64 inclusive
// scan of the counts, then per output slot j the left row
// li = upper_bound(offsets, j) and the right row
// order[lo[li] + j - prev[li]], the exact equality check of every pair and
// the emit [left | right_extra].  Ties keep input order, so the pair layout
// equals the reference's bit for bit; the total is exact even past cap.
//
// Bound: memory traffic — the radix sort's 8 passes over the right keys,
// one binary search per left row, and per slot two scattered row gathers.
// The simple design composes the device-wide primitives (mix, radix sort,
// scan) with two grids: bounds over left rows, expansion over output slots.
#include "common.cuh"

__global__ void jt_bounds_kernel(const int64_t* key_l, int64_t n_left,
                                 const int64_t* key_r_sorted, int64_t n_right, int64_t* lo,
                                 int64_t* cnt) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n_left;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t q = key_l[i];
    const int64_t l = das_lower_bound<int64_t>(key_r_sorted, n_right, q);
    lo[i] = l;
    cnt[i] = das_upper_bound<int64_t>(key_r_sorted, n_right, q) - l;
  }
}

// pairs.a = left column, pairs.b = right column; extra = right columns
__global__ void jt_expand_kernel(int64_t cap, const int64_t* offsets, const int64_t* cnt,
                                 const int64_t* lo, const int32_t* order, int64_t n_left,
                                 const int32_t* lv, const uint8_t* lm, int kl,
                                 int64_t n_right, const int32_t* rv, const uint8_t* rm,
                                 int kr, DasPairs pairs, DasCols extra, int32_t* out,
                                 uint8_t* ov, int64_t* tot) {
  const int64_t total = n_left > 0 ? offsets[n_left - 1] : 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) tot[0] = total;
  const int k_out = kl + extra.n;
  for (int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; j < cap;
       j += (int64_t)gridDim.x * blockDim.x) {
    int32_t* o = out + j * k_out;
    bool valid = j < total && n_right > 0;
    int64_t li = 0, ri = 0;
    if (valid) {
      int64_t prev;
      li = das_slot_row(offsets, cnt, n_left, j, &prev);
      ri = order[das_clamp(lo[li] + (j - prev), 0, n_right - 1)];
      valid = lm[li] != 0 && rm[ri] != 0;
      for (int p = 0; p < pairs.n; ++p)
        valid = valid && lv[li * kl + pairs.a[p]] == rv[ri * kr + pairs.b[p]];
    }
    const int32_t* lrow = lv + li * kl;
    const int32_t* rrow = rv + ri * kr;
    for (int c = 0; c < kl; ++c) o[c] = valid ? lrow[c] : 0;
    for (int c = 0; c < extra.n; ++c) o[kl + c] = valid ? rrow[extra.c[c]] : 0;
    ov[j] = valid ? 1 : 0;
  }
}

// Scratch: key_l, lo, cnt, offsets hold n_left int64; key_r, key_r_sorted
// and tmp_keys n_right int64; order and tmp_idx n_right int32; hist and
// hist_incl 256 * das_sort_tiles(n_right) int64; scan_scratch scan_len
// int64, enough for both das_scan_scratch(n_left) and
// das_scan_scratch(256 * das_sort_tiles(n_right)).
extern "C" int das_join_tables(const void* lv, const void* lm, int64_t n_left, int kl,
                               const void* rv, const void* rm, int64_t n_right, int kr,
                               const int* pair_l, const int* pair_r, int n_pairs,
                               const int* extra, int n_extra, int64_t cap, void* key_l,
                               void* key_r, void* key_r_sorted, void* order, void* tmp_keys,
                               void* tmp_idx, void* hist, void* hist_incl, void* lo,
                               void* cnt, void* offsets, void* scan_scratch,
                               int64_t scan_len, void* out, void* ov, void* tot,
                               void* stream) {
  if (n_pairs > DAS_MAXC || n_extra > DAS_MAXC) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const DasCols lcols = das_cols(pair_l, n_pairs);
  const DasCols rcols = das_cols(pair_r, n_pairs);
  if (n_left > 0 && n_right > 0) {
    das_mix((const int32_t*)lv, n_left, kl, (const uint8_t*)lm, lcols,
            (int64_t)0x7FFFFFFFFFFFFFFFll, (int64_t*)key_l, st);
    das_mix((const int32_t*)rv, n_right, kr, (const uint8_t*)rm, rcols,
            (int64_t)0x7FFFFFFFFFFFFFFEll, (int64_t*)key_r, st);
    cudaError_t err = das_radix_sort_i64((const int64_t*)key_r, n_right,
                                         (int64_t*)key_r_sorted, (int32_t*)order,
                                         (int64_t*)tmp_keys, (int32_t*)tmp_idx,
                                         (int64_t*)hist, (int64_t*)hist_incl,
                                         (int64_t*)scan_scratch, scan_len, st);
    if (err != cudaSuccess) return (int)err;
    jt_bounds_kernel<<<das_blocks(n_left), DAS_THREADS, 0, st>>>(
        (const int64_t*)key_l, n_left, (const int64_t*)key_r_sorted, n_right, (int64_t*)lo,
        (int64_t*)cnt);
    err = das_scan_i64((const int64_t*)cnt, (int64_t*)offsets, n_left,
                       (int64_t*)scan_scratch, scan_len, st);
    if (err != cudaSuccess) return (int)err;
  }
  // an empty side joins to nothing: total 0, every slot zeroed
  jt_expand_kernel<<<das_blocks(cap), DAS_THREADS, 0, st>>>(
      cap, (const int64_t*)offsets, (const int64_t*)cnt, (const int64_t*)lo,
      (const int32_t*)order, (n_left > 0 && n_right > 0) ? n_left : 0, (const int32_t*)lv,
      (const uint8_t*)lm, kl, n_right, (const int32_t*)rv, (const uint8_t*)rm, kr,
      das_pairs(pair_l, pair_r, n_pairs), das_cols(extra, n_extra), (int32_t*)out,
      (uint8_t*)ov, (int64_t*)tot);
  return (int)cudaGetLastError();
}
