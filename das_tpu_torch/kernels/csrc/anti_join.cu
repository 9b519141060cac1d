// Kernel 4: anti join (the negation membership filter).
//
// Replaces das_tpu/kernels/join.py anti_join_impl (_anti_kernel_body):
// both sides' join columns are mixed into int64 keys (sentinels 2^63-1
// left, 2^63-2 right), the right keys are sorted, and a left row is kept
// iff it is valid and its key is absent from the sorted right keys
// (hi > lo of its lower/upper bound).  There is no exact check, as in the
// reference, so the mix agrees with ops/join.py bit for bit.
//
// Bound: memory traffic — the radix sort's 8 passes over the right keys
// and one binary search per left row.  The simple design reuses the
// device-wide mix and sort and adds one grid over left rows.
#include "common.cuh"

__global__ void aj_keep_kernel(const int64_t* key_l, const uint8_t* lm, int64_t n_left,
                               const int64_t* key_r_sorted, int64_t n_right, uint8_t* keep) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n_left;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t q = key_l[i];
    const bool found = das_upper_bound<int64_t>(key_r_sorted, n_right, q) >
                       das_lower_bound<int64_t>(key_r_sorted, n_right, q);
    keep[i] = (lm[i] != 0 && !found) ? 1 : 0;
  }
}

// Scratch as das_join_tables for the right side (key_r, key_r_sorted,
// tmp_keys, order, tmp_idx, hist, hist_incl, scan_scratch) plus key_l.
extern "C" int das_anti_join(const void* lv, const void* lm, int64_t n_left, int kl,
                             const void* rv, const void* rm, int64_t n_right, int kr,
                             const int* pair_l, const int* pair_r, int n_pairs, void* key_l,
                             void* key_r, void* key_r_sorted, void* order, void* tmp_keys,
                             void* tmp_idx, void* hist, void* hist_incl, void* scan_scratch,
                             int64_t scan_len, void* keep, void* stream) {
  if (n_pairs > DAS_MAXC) return (int)cudaErrorInvalidValue;
  if (n_left <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  das_mix((const int32_t*)lv, n_left, kl, (const uint8_t*)lm, das_cols(pair_l, n_pairs),
          (int64_t)0x7FFFFFFFFFFFFFFFll, (int64_t*)key_l, st);
  if (n_right > 0) {
    das_mix((const int32_t*)rv, n_right, kr, (const uint8_t*)rm, das_cols(pair_r, n_pairs),
            (int64_t)0x7FFFFFFFFFFFFFFEll, (int64_t*)key_r, st);
    cudaError_t err = das_radix_sort_i64((const int64_t*)key_r, n_right,
                                         (int64_t*)key_r_sorted, (int32_t*)order,
                                         (int64_t*)tmp_keys, (int32_t*)tmp_idx,
                                         (int64_t*)hist, (int64_t*)hist_incl,
                                         (int64_t*)scan_scratch, scan_len, st);
    if (err != cudaSuccess) return (int)err;
  }
  aj_keep_kernel<<<das_blocks(n_left), DAS_THREADS, 0, st>>>(
      (const int64_t*)key_l, (const uint8_t*)lm, n_left, (const int64_t*)key_r_sorted,
      n_right, (uint8_t*)keep);
  return (int)cudaGetLastError();
}
