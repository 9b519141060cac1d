// Kernel 1: fused probe -> gather -> verify -> term-table emit.
//
// Replaces das_tpu/kernels/probe.py (probe_term_table_impl with its
// single-block _kernel_body and grid-chunked _tiled_body, both built on
// _emit_window): the lower/upper bound of one key in a sorted posting-key
// column, then for every output slot j < cap the row perm[lo + j] (or
// INVALID past the range count), its target row, the extra_fixed and
// eq_pairs checks, and the var_cols emit (0 where masked).  The range
// count is exact even when it exceeds cap; that is what triggers the
// host's capacity retry.
//
// Bound: memory traffic of random gathers.  The search touches log2(n)
// keys; each valid slot reads one perm entry and one scattered targets row
// and writes k values.  The simple design: one one-thread launch for the
// bounds (the TPU prologue), then one thread per output slot — the window
// of perm is read coalesced, the targets gather is what it is, and slots
// past the count write zeros without reading anything.
#include "common.cuh"

template <typename K>
__global__ void probe_bounds_kernel(const K* keys, int64_t n_keys, K key, int64_t* lo_out,
                                    int32_t* count_out) {
  const int64_t lo = das_lower_bound<K>(keys, n_keys, key);
  const int64_t hi = das_upper_bound<K>(keys, n_keys, key);
  lo_out[0] = lo;
  count_out[0] = (int32_t)(hi - lo);
}

__global__ void probe_emit_kernel(int64_t cap, const int64_t* lo_p, const int32_t* count_p,
                                  const int32_t* perm, int64_t n_keys,
                                  const int32_t* targets, int64_t n_rows, int arity,
                                  DasCols var_cols, DasPairs fixed, DasPairs eq,
                                  int32_t* vals, uint8_t* mask) {
  const int64_t lo = lo_p[0];
  const int64_t count = count_p[0];
  const int k = var_cols.n;
  for (int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; j < cap;
       j += (int64_t)gridDim.x * blockDim.x) {
    bool m = j < count && n_rows > 0;
    const int32_t* row = targets;
    if (m) {
      const int64_t idx = das_clamp(lo + j, 0, n_keys - 1);
      const int64_t local = perm[idx];
      row = targets + das_clamp(local, 0, n_rows - 1) * arity;
      for (int i = 0; i < fixed.n; ++i) m = m && row[fixed.a[i]] == fixed.b[i];
      for (int i = 0; i < eq.n; ++i) m = m && row[eq.a[i]] == row[eq.b[i]];
    }
    for (int c = 0; c < k; ++c) vals[j * k + c] = m ? row[var_cols.c[c]] : 0;
    mask[j] = m ? 1 : 0;
  }
}

// keys: int32 (the key_type column, ROUTE_TYPE) or int64 (type_pos / ctype)
extern "C" int das_probe_term_table(const void* keys, int key_is_i64, int64_t n_keys,
                                    int64_t key, const void* perm, const void* targets,
                                    int64_t n_rows, int arity, int64_t cap,
                                    const int* var_cols, int n_var, const int* fixed_pos,
                                    const int* fixed_val, int n_fixed, const int* eq_a,
                                    const int* eq_b, int n_eq, void* lo_scratch, void* vals,
                                    void* mask, void* count, void* stream) {
  if (n_var > DAS_MAXC || n_fixed > DAS_MAXC || n_eq > DAS_MAXC) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (key_is_i64) {
    probe_bounds_kernel<int64_t><<<1, 1, 0, st>>>((const int64_t*)keys, n_keys, (int64_t)key,
                                                  (int64_t*)lo_scratch, (int32_t*)count);
  } else {
    probe_bounds_kernel<int32_t><<<1, 1, 0, st>>>((const int32_t*)keys, n_keys, (int32_t)key,
                                                  (int64_t*)lo_scratch, (int32_t*)count);
  }
  if (cap > 0) {
    probe_emit_kernel<<<das_blocks(cap), DAS_THREADS, 0, st>>>(
        cap, (const int64_t*)lo_scratch, (const int32_t*)count, (const int32_t*)perm, n_keys,
        (const int32_t*)targets, n_rows, arity, das_cols(var_cols, n_var),
        das_pairs(fixed_pos, fixed_val, n_fixed), das_pairs(eq_a, eq_b, n_eq),
        (int32_t*)vals, (uint8_t*)mask);
  }
  return (int)cudaGetLastError();
}
