// Kernel 1: fused probe -> gather -> verify -> term-table emit, for every
// probed term of a plan in one launch.
//
// Replaces das_tpu/kernels/probe.py (probe_term_table_impl with its
// single-block _kernel_body and grid-chunked _tiled_body, both built on
// _emit_window): the lower/upper bound of one key in a sorted posting-key
// column (searchsorted left / right over the whole capacity-padded column,
// padding = the dtype's max; an empty column gives 0), then for every
// output slot j < cap the row perm[clip(lo + j)] (INVALID past the range
// count), its target row (clipped), the extra_fixed and eq_pairs checks,
// and the var_cols emit (0 where masked).  The range count is exact even
// when it exceeds cap; that is what triggers the host's capacity retry.
//
// Design.  One launch probes up to PR_PARAM_TERMS terms; their descriptors
// (PrTerm, 232 B) travel by value in the kernel parameters (3,720 B of the
// 4 KB block), so no copy precedes the launch; a plan of more terms takes
// one launch per PR_PARAM_TERMS.  Term t owns blocks [block0, block0 +
// n_blocks) with n_blocks = min(ceil(cap / PR_TILE), PR_MAX_TERM_BLOCKS); a
// block finds its term by the block offsets the C entry computes from the
// static capacities.  Each block searches for its term's window itself:
// warp 0 the lower bound, warp 1 the upper bound, each a 32-way
// cooperative search (common.cuh das_warp_search: 32 lanes read 32 evenly
// spaced keys and a ballot narrows the range 32x a step: ~5 dependent
// loads for 2^22 keys, where a binary search makes ~23), broadcast through
// shared memory.  The blocks
// of one term repeat the search from L2; block 0 of a term writes the
// exact count.  Then each thread emits PR_SLOTS slots a pass, strided by
// the block width so that a warp's every load and store covers 32
// consecutive slots: valid slots read perm coalesced and gather their
// targets row, slots past the count read nothing, and a row of k = 1, 2 or
// 4 values is one store (k = 3 and wider rows store per value).  Giving a
// thread consecutive slots instead makes each warp store touch 32 strided
// addresses, and on the H100 more such slots a thread made the whole-type
// window slower; a sweep of slots per thread and blocks per term picked 2
// and 2,112.
//
// Bound: bytes.  The search touches ~2 x 5 x 32 keys; each valid slot
// reads one perm entry and one targets row, and every slot writes k values
// and a mask byte.  At the main path's caps (16-256 slots) the call is
// launch latency and the wrapper's host time; the whole-type window
// (2.4 M valid rows at cap 4,194,304) moves ~67 MB.
#include <cstring>

#include "common.cuh"

#define PR_THREADS 256
#define PR_SLOTS 2                       // slots a thread emits per pass
#define PR_TILE (PR_THREADS * PR_SLOTS)  // slots a block emits per pass
#define PR_PARAM_TERMS 16                // term descriptors in one launch's parameters
#define PR_MAX_TERM_BLOCKS 2112          // 16 blocks of 256 threads per SM (132 SMs)
#define PR_WORDS 95                      // int64 words of one term's host descriptor

struct PrTerm {           // one term, by value in the kernel parameters
  const void* keys;       // int32 or int64 [n_keys], sorted, padded with the dtype's max
  const int32_t* perm;    // [n_keys] bucket-local rows in key order
  const int32_t* targets; // [n_rows, arity]
  int32_t* vals;          // [cap, k]
  uint8_t* mask;          // [cap]
  int32_t* count;         // [1]
  int64_t n_keys, key, n_rows, cap;
  int32_t block0, n_blocks;
  int32_t arity;
  int8_t key_is_i64, k, n_fixed, n_eq;
  int8_t var_cols[DAS_MAXC], fixed_pos[DAS_MAXC], eq_a[DAS_MAXC], eq_b[DAS_MAXC];
  int32_t fixed_val[DAS_MAXC];
  int32_t vec;            // vals 16-byte aligned: a row is one vector store
};

struct PrTerms {
  PrTerm t[PR_PARAM_TERMS];
  int n;
};

// The source row of slot j, or null when the slot is masked.
__device__ __forceinline__ const int32_t* pr_row(const PrTerm& t, int64_t lo, int32_t count,
                                                 int64_t j) {
  if (j >= count || t.n_rows <= 0) return nullptr;
  const int64_t local = t.perm[das_clamp(lo + j, 0, t.n_keys - 1)];
  const int32_t* row = t.targets + das_clamp(local, 0, t.n_rows - 1) * t.arity;
  bool m = true;
  for (int i = 0; i < t.n_fixed; ++i) m = m && row[t.fixed_pos[i]] == t.fixed_val[i];
  for (int i = 0; i < t.n_eq; ++i) m = m && row[t.eq_a[i]] == row[t.eq_b[i]];
  return m ? row : nullptr;
}

// slot j's row of K values (K = 0: the term's own k, value by value): one
// vector store where K allows, so a warp's store covers 32 consecutive
// rows; then its mask byte
template <int K>
__device__ __forceinline__ void pr_store(const PrTerm& t, int64_t j, const int32_t* row) {
  int32_t* o = t.vals + j * (K > 0 ? K : t.k);
  const int8_t* vc = t.var_cols;
  if constexpr (K == 2) {
    *reinterpret_cast<int2*>(o) = row ? make_int2(row[vc[0]], row[vc[1]]) : make_int2(0, 0);
  } else if constexpr (K == 4) {
    *reinterpret_cast<int4*>(o) = row ? make_int4(row[vc[0]], row[vc[1]], row[vc[2]], row[vc[3]])
                                      : make_int4(0, 0, 0, 0);
  } else {
    const int k = K > 0 ? K : t.k;
    for (int c = 0; c < k; ++c) o[c] = row ? row[vc[c]] : 0;
  }
  t.mask[j] = row ? 1 : 0;
}

// A block's share of the term's slots: per pass, thread x emits the slots
// j0 + x + s * PR_THREADS (s < PR_SLOTS), so every load and store of a warp
// covers consecutive slots; the PR_SLOTS rows are looked up before any is
// stored, keeping their reads in flight together.
template <int K>
__device__ __forceinline__ void pr_emit(const PrTerm& t, int64_t lo, int32_t count, int b) {
  for (int64_t j0 = (int64_t)b * PR_TILE; j0 < t.cap; j0 += (int64_t)t.n_blocks * PR_TILE) {
    const int32_t* row[PR_SLOTS];
#pragma unroll
    for (int s = 0; s < PR_SLOTS; ++s) {
      const int64_t j = j0 + threadIdx.x + s * PR_THREADS;
      row[s] = j < t.cap ? pr_row(t, lo, count, j) : nullptr;
    }
#pragma unroll
    for (int s = 0; s < PR_SLOTS; ++s) {
      const int64_t j = j0 + threadIdx.x + s * PR_THREADS;
      if (j < t.cap) pr_store<K>(t, j, row[s]);
    }
  }
}

__global__ void __launch_bounds__(PR_THREADS)
pr_terms_kernel(const __grid_constant__ PrTerms ts) {
  __shared__ int64_t bounds[2];
  int ti = 0;
  while (ti + 1 < ts.n && (int)blockIdx.x >= ts.t[ti + 1].block0) ++ti;
  const PrTerm& t = ts.t[ti];
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int64_t b =
        t.key_is_i64
            ? das_warp_search<int64_t>((const int64_t*)t.keys, 0, t.n_keys, (int64_t)t.key,
                                       warp == 1)
            : das_warp_search<int32_t>((const int32_t*)t.keys, 0, t.n_keys, (int32_t)t.key,
                                       warp == 1);
    if ((threadIdx.x & 31) == 0) bounds[warp] = b;
  }
  __syncthreads();
  const int64_t lo = bounds[0];
  const int32_t count = (int32_t)(bounds[1] - lo);
  const int b = (int)blockIdx.x - t.block0;
  if (b == 0 && threadIdx.x == 0) *t.count = count;
  if (!t.vec) {
    pr_emit<0>(t, lo, count, b);
    return;
  }
  switch (t.k) {
    case 1: pr_emit<1>(t, lo, count, b); break;
    case 2: pr_emit<2>(t, lo, count, b); break;
    case 3: pr_emit<3>(t, lo, count, b); break;
    case 4: pr_emit<4>(t, lo, count, b); break;
    default: pr_emit<0>(t, lo, count, b); break;
  }
}

// the descriptor of one term from its PR_WORDS host words (copied out, so
// the words need no alignment): keys, key_is_i64, n_keys, key, perm,
// targets, n_rows, arity, cap, vals, mask, count; DAS_MAXC fixed values;
// k, n_fixed, n_eq; DAS_MAXC each of var_cols, fixed_pos, eq_a and eq_b.
// False when a count or a column is out of range.
static bool pr_term(const char* words, PrTerm* t) {
  int64_t w[PR_WORDS];
  memcpy(w, words, sizeof(w));
  t->keys = (const void*)w[0];
  t->key_is_i64 = (int8_t)(w[1] != 0);
  t->n_keys = w[2];
  t->key = w[3];
  t->perm = (const int32_t*)w[4];
  t->targets = (const int32_t*)w[5];
  t->n_rows = w[6];
  t->arity = (int32_t)w[7];
  t->cap = w[8];
  t->vals = (int32_t*)w[9];
  t->mask = (uint8_t*)w[10];
  t->count = (int32_t*)w[11];
  const int64_t* fixed_val = w + 12;
  const int64_t k = w[28], n_fixed = w[29], n_eq = w[30];
  if (k < 0 || k > DAS_MAXC || n_fixed < 0 || n_fixed > DAS_MAXC || n_eq < 0 ||
      n_eq > DAS_MAXC || w[7] < 0 || w[7] > 127 || t->cap < 0 || t->n_keys < 0)
    return false;
  t->k = (int8_t)k;
  t->n_fixed = (int8_t)n_fixed;
  t->n_eq = (int8_t)n_eq;
  const int64_t* var_cols = w + 31;
  const int64_t* fixed_pos = var_cols + DAS_MAXC;
  const int64_t* eq_a = fixed_pos + DAS_MAXC;
  const int64_t* eq_b = eq_a + DAS_MAXC;
  const auto in_row = [&](int64_t c) { return c >= 0 && c < t->arity; };
  for (int i = 0; i < DAS_MAXC; ++i) {
    if ((i < k && !in_row(var_cols[i])) || (i < n_fixed && !in_row(fixed_pos[i])) ||
        (i < n_eq && !(in_row(eq_a[i]) && in_row(eq_b[i]))))
      return false;
    t->var_cols[i] = (int8_t)var_cols[i];
    t->fixed_pos[i] = (int8_t)fixed_pos[i];
    t->fixed_val[i] = (int32_t)fixed_val[i];
    t->eq_a[i] = (int8_t)eq_a[i];
    t->eq_b[i] = (int8_t)eq_b[i];
  }
  t->vec = (uintptr_t)t->vals % 16 == 0;
  return true;
}

// Probes n_terms terms (desc: n_terms x PR_WORDS int64 words, see pr_term)
// in ceil(n_terms / PR_PARAM_TERMS) launches.  *launches = kernels
// launched, *regime = the design's name.
extern "C" int das_probe_terms(int n_terms, const char* desc, int* launches,
                               const char** regime, void* stream) {
  *launches = 0;
  *regime = "warp_search";
  cudaStream_t st = (cudaStream_t)stream;
  for (int first = 0; first < n_terms; first += PR_PARAM_TERMS) {
    PrTerms ts;
    ts.n = n_terms - first < PR_PARAM_TERMS ? n_terms - first : PR_PARAM_TERMS;
    int64_t blocks = 0;
    for (int i = 0; i < ts.n; ++i) {
      PrTerm& t = ts.t[i];
      if (!pr_term(desc + (int64_t)(first + i) * PR_WORDS * 8, &t))
        return (int)cudaErrorInvalidValue;
      int64_t nb = (t.cap + PR_TILE - 1) / PR_TILE;
      nb = nb < 1 ? 1 : (nb > PR_MAX_TERM_BLOCKS ? PR_MAX_TERM_BLOCKS : nb);
      t.block0 = (int32_t)blocks;
      t.n_blocks = (int32_t)nb;
      blocks += nb;
    }
    pr_terms_kernel<<<(unsigned)blocks, PR_THREADS, 0, st>>>(ts);
    *launches += 1;
  }
  return (int)cudaGetLastError();
}
