// Kernel 5: k-way star join on one shared variable.
//
// Replaces das_tpu/kernels/multiway.py multiway_join_impl (single-block
// _multiway_kernel_body and grid-chunked _tiled_multiway_body, built on
// _mw_prologue and _mw_window).  Clause 0 (the left table) and T tail
// tables that each share exactly one variable v with it are grounded in one
// pass, with no intermediate table:
//
//   1. mix clause 0's v column (sentinel 2^63-1) and each tail's v column
//      (sentinel 2^63-2) into int64 keys — the binary chain's mix;
//   2. STABLE radix sort of each tail's keys, keeping the order;
//   3. one thread per left row and tail: lower bound and count of its key
//      in the sorted tail, and the running product of the counts;
//   4. per tail an inclusive scan of the running product: its last element
//      is totals[t], the size the t-th binary intermediate would have had;
//      the last tail's scan is the slot offsets;
//   5. one thread per output slot j < totals[T-1]: its left row by an
//      upper-bound search of the offsets, its offset inside that row's
//      block decoded in mixed radix with the LAST tail fastest (floor
//      division and modulo by max(count, 1)), the int64 -> int32 cast of
//      lo + o before the clip, the gathers, the exact check of v on every
//      tail, and the row [left | each tail's extra columns]; every other
//      slot is written as zeros.
//
// Products, scans and sums run as uint64 so they wrap as XLA's int64 does
// (signed overflow is undefined in C++).  The TPU kernel's width-padded
// concatenation of the tails and its single-block / grid split exist only
// for Mosaic's fixed signature and VMEM; here each tail travels as its own
// pointer in a table the entry copies to device memory (so any number of
// tails fits one launch), and one grid covers any capacity.
//
// Bound: memory traffic — the T radix sorts (8 passes each over every tail
// row) dominate, then one binary search per left row and tail, then per
// slot the scattered row gathers.  This simple design composes the device
// primitives of primitives.cu (mix, radix sort, scan) with two small grids;
// speed (one sort pass over all tails, no sort of a whole-type tail whose
// posting index is already sorted) is later work.
#include <vector>

#include "common.cuh"

struct MwTail {
  const int32_t* tv;     // [rows, k] tail table
  const uint8_t* tm;     // [rows] validity
  const int32_t* order;  // stable argsort of the tail's mixed v keys
  const int64_t* lo;     // [n_left] lower bound of each left key
  const int64_t* cnt;    // [n_left] window width
  int64_t rows;
  int k;
  int vcol;
  int col;               // first output column of the extra columns
  DasCols extra;         // tail columns appended to the output row
};

__global__ void mw_bounds_kernel(const int64_t* key_l, int64_t n_left,
                                 const int64_t* key_sorted, int64_t rows, int64_t* lo,
                                 int64_t* cnt, int64_t* run, int first) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n_left;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t q = key_l[i];
    const int64_t l = das_lower_bound<int64_t>(key_sorted, rows, q);
    const int64_t c = das_upper_bound<int64_t>(key_sorted, rows, q) - l;
    lo[i] = l;
    cnt[i] = c;
    run[i] = first ? c : (int64_t)((uint64_t)run[i] * (uint64_t)c);
  }
}

__global__ void mw_last_kernel(const int64_t* scan, int64_t n, int64_t* dst) {
  if (blockIdx.x == 0 && threadIdx.x == 0) *dst = scan[n - 1];
}

// floor division and modulo by c >= 1 (jnp's // and % on int64)
__device__ __forceinline__ int64_t mw_floor_divmod(int64_t a, int64_t c, int64_t* mod) {
  int64_t q = a / c;
  int64_t m = a - q * c;
  if (m < 0) {
    m += c;
    q -= 1;
  }
  *mod = m;
  return q;
}

// The tail row that slot offset `rem` selects in tail t, dividing `rem` by
// the tail's window width (the mixed radix, last tail fastest).
__device__ __forceinline__ int64_t mw_tail_row(const MwTail& tl, int64_t li, int64_t* rem) {
  int64_t c = tl.cnt[li];
  if (c < 1) c = 1;
  int64_t off;
  *rem = mw_floor_divmod(*rem, c, &off);
  // (lo + o).astype(int32), then the clip to the tail's rows
  const int32_t s = (int32_t)(uint32_t)((uint64_t)tl.lo[li] + (uint64_t)off);
  const int64_t pos = das_clamp((int64_t)s, 0, tl.rows > 0 ? tl.rows - 1 : 0);
  return tl.rows > 0 ? tl.order[pos] : 0;
}

// One thread per slot.  The decode runs twice (verify, then emit) so no
// per-thread array bounds the number of tails.
__global__ void mw_expand_kernel(int64_t cap, const int64_t* offsets, const int64_t* run,
                                 int64_t n_left, const int32_t* lv, const uint8_t* lm,
                                 int kl, int vcol0, const MwTail* tails, int n_tails,
                                 const int64_t* tot, int k_out, int32_t* out, uint8_t* ov) {
  const int64_t total = tot[n_tails - 1];
  for (int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; j < cap;
       j += (int64_t)gridDim.x * blockDim.x) {
    int32_t* o = out + j * k_out;
    bool valid = j < total && n_left > 0;
    int64_t li = 0, rem0 = 0;
    if (valid) {
      li = das_clamp(das_upper_bound<int64_t>(offsets, n_left, j), 0, n_left - 1);
      rem0 = (int64_t)((uint64_t)j - ((uint64_t)offsets[li] - (uint64_t)run[li]));
      valid = lm[li] != 0;
      const int32_t lvv = lv[li * kl + vcol0];
      int64_t rem = rem0;
      for (int t = n_tails - 1; t >= 0 && valid; --t) {
        const MwTail& tl = tails[t];
        const int64_t r = mw_tail_row(tl, li, &rem);
        valid = tl.rows > 0 && tl.tm[r] != 0 && tl.tv[r * tl.k + tl.vcol] == lvv;
      }
    }
    if (!valid) {
      for (int c = 0; c < k_out; ++c) o[c] = 0;
      ov[j] = 0;
      continue;
    }
    const int32_t* lrow = lv + li * kl;
    for (int c = 0; c < kl; ++c) o[c] = lrow[c];
    int64_t rem = rem0;
    for (int t = n_tails - 1; t >= 0; --t) {
      const MwTail& tl = tails[t];
      const int32_t* trow = tl.tv + mw_tail_row(tl, li, &rem) * tl.k;
      for (int c = 0; c < tl.extra.n; ++c) o[tl.col + c] = trow[tl.extra.c[c]];
    }
    ov[j] = 1;
  }
}

// sizeof(MwTail): the bytes per tail of the device tail table
extern "C" int das_multiway_tail_bytes() { return (int)sizeof(MwTail); }

// Per tail t: tv[t], tm[t] its table and mask, rows[t] x k[t] its shape,
// vcol[t] its v column, extra[t * DAS_MAXC ...] its n_extra[t] output
// columns.  Scratch: key_l and run / offsets hold n_left int64, lo and cnt
// n_tails * n_left int64; key_r and key_sorted sum(rows) int64, order
// sum(rows) int32; tmp_keys / tmp_idx / hist / hist_incl the radix sort's
// buffers for max(rows); scan_scratch scan_len int64, enough for both
// das_scan_scratch(n_left) and das_scan_scratch(256 * das_sort_tiles(max rows));
// tail_table n_tails * das_multiway_tail_bytes() bytes of device memory.
extern "C" int das_multiway_join(const void* lv, const void* lm, int64_t n_left, int kl,
                                 int vcol0, int n_tails, void* const* tv, void* const* tm,
                                 const int64_t* rows, const int* k, const int* vcol,
                                 const int* n_extra, const int* extra, int64_t cap,
                                 void* key_l, void* key_r, void* key_sorted, void* order,
                                 void* tmp_keys, void* tmp_idx, void* hist, void* hist_incl,
                                 void* lo, void* cnt, void* run, void* offsets,
                                 void* scan_scratch, int64_t scan_len, void* tail_table,
                                 void* out, void* ov, void* tot, void* stream) {
  if (n_tails < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  std::vector<MwTail> tails(n_tails);
  int k_out = kl;
  int64_t seg = 0;
  for (int t = 0; t < n_tails; ++t) {
    if (n_extra[t] > DAS_MAXC) return (int)cudaErrorInvalidValue;
    MwTail& tl = tails[t];
    tl.tv = (const int32_t*)tv[t];
    tl.tm = (const uint8_t*)tm[t];
    tl.order = (const int32_t*)order + seg;
    tl.lo = (const int64_t*)lo + (int64_t)t * n_left;
    tl.cnt = (const int64_t*)cnt + (int64_t)t * n_left;
    tl.rows = rows[t];
    tl.k = k[t];
    tl.vcol = vcol[t];
    tl.col = k_out;
    tl.extra = das_cols(extra + t * DAS_MAXC, n_extra[t]);
    k_out += n_extra[t];
    seg += rows[t];
  }
  // pageable source: the copy is staged before this call returns
  cudaError_t err = cudaMemcpyAsync(tail_table, tails.data(), sizeof(MwTail) * n_tails,
                                    cudaMemcpyHostToDevice, st);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(tot, 0, sizeof(int64_t) * n_tails, st);
  if (err != cudaSuccess) return (int)err;
  if (n_left > 0) {
    DasCols c0;
    c0.n = 1;
    c0.c[0] = vcol0;
    das_mix((const int32_t*)lv, n_left, kl, (const uint8_t*)lm, c0,
            (int64_t)0x7FFFFFFFFFFFFFFFll, (int64_t*)key_l, st);
    seg = 0;
    for (int t = 0; t < n_tails; ++t) {
      int64_t* ks = (int64_t*)key_sorted + seg;
      if (rows[t] > 0) {
        DasCols ct;
        ct.n = 1;
        ct.c[0] = vcol[t];
        das_mix((const int32_t*)tv[t], rows[t], k[t], (const uint8_t*)tm[t], ct,
                (int64_t)0x7FFFFFFFFFFFFFFEll, (int64_t*)key_r + seg, st);
        err = das_radix_sort_i64((const int64_t*)key_r + seg, rows[t], ks,
                                 (int32_t*)order + seg, (int64_t*)tmp_keys,
                                 (int32_t*)tmp_idx, (int64_t*)hist, (int64_t*)hist_incl,
                                 (int64_t*)scan_scratch, scan_len, st);
        if (err != cudaSuccess) return (int)err;
      }
      mw_bounds_kernel<<<das_blocks(n_left), DAS_THREADS, 0, st>>>(
          (const int64_t*)key_l, n_left, ks, rows[t], (int64_t*)lo + (int64_t)t * n_left,
          (int64_t*)cnt + (int64_t)t * n_left, (int64_t*)run, t == 0 ? 1 : 0);
      err = das_scan_i64((const int64_t*)run, (int64_t*)offsets, n_left,
                         (int64_t*)scan_scratch, scan_len, st);
      if (err != cudaSuccess) return (int)err;
      mw_last_kernel<<<1, 32, 0, st>>>((const int64_t*)offsets, n_left, (int64_t*)tot + t);
      seg += rows[t];
    }
  }
  mw_expand_kernel<<<das_blocks(cap), DAS_THREADS, 0, st>>>(
      cap, (const int64_t*)offsets, (const int64_t*)run, n_left, (const int32_t*)lv,
      (const uint8_t*)lm, kl, vcol0, (const MwTail*)tail_table, n_tails,
      (const int64_t*)tot, k_out, (int32_t*)out, (uint8_t*)ov);
  return (int)cudaGetLastError();
}
