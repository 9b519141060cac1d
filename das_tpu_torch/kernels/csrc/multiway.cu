// Kernel 5: k-way star join on one shared variable.
//
// Replaces das_tpu/kernels/multiway.py multiway_join_impl (single-block
// _multiway_kernel_body and grid-chunked _tiled_multiway_body, built on
// _mw_prologue and _mw_window).  Clause 0 (the left table) and T tail
// tables that each share exactly one variable v with it are grounded in one
// pass, with no intermediate table.  What the reference computes: the mixed
// key of every v (sentinels 2^63-1 left, 2^63-2 right), a STABLE sort of
// each tail's keys, per left row and tail the window (lower bound, count)
// of its key, the running product of the counts, totals[t] = the sum of
// the t-th product, offsets = the scan of the last product, and per slot
// j < totals[T-1] the mixed-radix decode (last tail fastest, floor % and //
// by max(cnt, 1), the int64 -> int32 cast of lo + o before the clip), the
// exact check of v on every tail and the row [left | each tail's extras].
//
// Why no tail needs sorting.  For one int32 column the mix is
// x ^ (x >>arith 29) of the sign-extended value: below 2^31 for every
// int32, so no valid key meets a sentinel, and mix(~v) == mix(v), so a
// window may hold rows whose v differs from the left's (the exact check
// turns their slots invalid, but they count in totals and slot numbers).
// A left row's window is therefore exactly the valid tail rows whose MIXED
// key equals its own, in increasing row order (the stable sort), and an
// invalid left row's count is 0.  So each tail is filtered by the set of
// the left's valid mixed keys, and the survivors are grouped stably by
// (dense id of the key, tail): the same counts, products (uint64
// wraparound), totals and slot order as the sorted tails.  A slot whose
// window in some tail is empty is invalid in the reference too (whatever
// row its clip reads has another key, so another v, or is masked), so the
// decode stops there and writes zeros.
//
// Regimes, a pure function of n_left, T, R = sum of rows[t] and cap, picked
// here (mw_plan) and reported to the wrapper by name:
//
//   block   ONE launch of one block (256 threads when n_left + R + cap <=
//           8,192, else 1,024) that does everything in dynamic shared
//           memory: the set (2^bits >= 2 * n_left slots of int32 key +
//           int32 id), per-row ids, the per-bin counts and their scan
//           (bins = n_left * T, 4 + 8 + 8 B each), the staged survivors and
//           the grouped rows (12 B per tail row), the products and offsets
//           (16 B per left row): 8 * 2^bits + 20 * bins + 12 * R +
//           20 * n_left bytes <= MW_BLOCK_MAX_BYTES (200,000), with
//           R <= 16,384, cap <= 16,384 and T <= MW_PARAM_TAILS.  The
//           grounded star (128 / 144 rows, cap 64) needs ~11 KB.
//   filter  anything else whose set and bin histogram fit one count
//           block's shared memory: 8 * 2^bits + 4 * bins <= 196,608 B
//           (n_left <= 4,096 and bins <= 32,768 at the limit).  At most
//           11 launches (9 on the fan-out star): a set kernel (one block:
//           the set, ids and per-row ids in device memory); a count grid of
//           G blocks over the concatenated tail rows, each warp over a
//           contiguous range, with the set and a bin histogram in shared
//           memory, its survivors compacted in row order by ballots (no
//           barrier) into a staging area; das_scan_i64 over the bins x G
//           counts (bin-major); a place grid that writes each staged
//           survivor to its bin's next slot, in row order (4 * bins B of
//           shared memory); the products and totals over left rows; the
//           offsets scan; the expand grid.  G = min(ceil(R / 8,192), 396,
//           2^20 / bins): 396 = 3 blocks of 512 threads on each of 132 SMs,
//           one wave at the count kernel's 40 registers.
//   global  the same launches when the set or the histogram outgrows shared
//           memory: the count grid probes the set where the set kernel left
//           it, and each count and place block keeps its bin histogram and
//           next slots in its own row of a G x bins uint32 array in device
//           memory (<= 2^20 cells, or bins when bins > 2^20 and G = 1).
//
// No grid depends on the data: every loop over survivors is bounded by
// counts in device memory, and the wrapper never waits.  Nothing is sorted
// in any regime.
//
// The tail descriptors (MW_PARAM_TAILS = 24 of 112 B) travel by value in
// the kernel parameters (__grid_constant__), so no copy precedes a launch;
// a star of more tails (filter or global) copies its descriptors into the
// scratch buffer first and the kernels read them there.
//
// Bound at the main-path shapes: the grounded star is launch latency and
// the wrapper's host time (one launch, ~10 us on the card); the fan-out
// star (tails of 4,194,304 and 524,288 rows) is the count pass's read of
// every tail's mask and v column, ~38 MB at ~1.6 TB/s (latency-bound: each
// thread keeps 2 x MW_UNROLL loads in flight); the survivors are a few
// thousand.  ptxas (-Xptxas -v, sm_90a, CUDA 12.8): mw_block_kernel 62
// registers, mw_hist_kernel 40 (its global variant with an 8-byte stack
// frame), mw_place_kernel 32, mw_set_kernel 32, mw_run_kernel 28,
// mw_expand_kernel 38; no spills.
#include <vector>

#include "common.cuh"

#define MW_PARAM_TAILS 24
#define MW_BLOCK_THREADS 1024
#define MW_GRID_THREADS 512
#define MW_GRID_WARPS (MW_GRID_THREADS / 32)
#define MW_GRID_MIN_BLOCKS 3  // count blocks resident per SM: 3 x 132 = one wave
#define MW_BLOCK_MAX_BYTES 200000
#define MW_BLOCK_MAX_ROWS 16384
#define MW_BLOCK_MAX_CAP 16384
#define MW_FILTER_MAX_BYTES 196608
#define MW_FILTER_ROWS_PER_BLOCK 8192
#define MW_FILTER_MAX_BLOCKS 396
#define MW_FILTER_MAX_CELLS (1ll << 20)
#define MW_EMPTY (-1)
#define MW_UNROLL 4
#define MW_SMALL_THREADS 256

struct MwTail {          // one tail, by value in the kernel parameters
  const int32_t* tv;     // [rows, k] tail table
  const uint8_t* tm;     // [rows] validity
  int64_t rows;
  int64_t seg;           // its first row in the concatenated row space
  int k;
  int vcol;
  int col;               // first output column of its extra columns
  DasCols extra;         // tail columns appended to the output row
};

struct MwTails {
  MwTail t[MW_PARAM_TAILS];
  const MwTail* table;   // all T descriptors in device memory when T > MW_PARAM_TAILS, else null
};

__device__ __forceinline__ const MwTail* mw_list(const MwTails& ts) {
  return ts.table ? ts.table : ts.t;
}

// the mix of one int32 column (das_mix_row with one column): < 2^31
__device__ __forceinline__ int32_t mw_key(int32_t v) {
  const uint64_t x = (uint64_t)(int64_t)v;
  return (int32_t)(x ^ das_sar29(x));
}

__device__ __forceinline__ uint32_t mw_slot(int32_t key, int bits) {
  return ((uint32_t)key * 2654435761u) >> (32 - bits);
}

// id of key in the set, -1 when absent
__device__ __forceinline__ int32_t mw_find(const int32_t* skey, const int32_t* sid, int bits,
                                           int32_t key) {
  const uint32_t mask = (1u << bits) - 1u;
  for (uint32_t h = mw_slot(key, bits);; h = (h + 1) & mask) {
    const int32_t s = skey[h];
    if (s == key) return sid[h];
    if (s == MW_EMPTY) return -1;
  }
}

// exclusive block-wide prefix sum of one value per thread; *total = the sum
template <typename T>
__device__ T mw_block_exclusive(T v, T* warp_tot, T* total) {
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
__device__ void mw_block_scan(uint64_t* a, int64_t n, uint64_t* warp_tot) {
  const int64_t per = (n + blockDim.x - 1) / blockDim.x;
  const int64_t b = threadIdx.x * per, e = b + per < n ? b + per : n;
  uint64_t s = 0, total;
  for (int64_t i = b; i < e; ++i) s += a[i];
  uint64_t run = mw_block_exclusive<uint64_t>(s, warp_tot, &total);
  for (int64_t i = b; i < e; ++i) {
    run += a[i];
    a[i] = run;
  }
  __syncthreads();
}

// One block: the set of the left's valid mixed v keys (2^bits slots),
// dense ids in slot order, lid[i] = the id of left row i or -1.
__device__ void mw_build_set(const int32_t* lv, const uint8_t* lm, int64_t n_left, int kl,
                             int vcol0, int32_t* skey, int32_t* sid, int bits, int32_t* lid,
                             uint64_t* warp_tot) {
  const int64_t slots = 1ll << bits;
  const uint32_t mask = (uint32_t)slots - 1u;
  for (int64_t h = threadIdx.x; h < slots; h += blockDim.x) skey[h] = MW_EMPTY;
  __syncthreads();
  for (int64_t i = threadIdx.x; i < n_left; i += blockDim.x) {
    if (!lm[i]) continue;
    const int32_t key = mw_key(lv[i * kl + vcol0]);
    for (uint32_t h = mw_slot(key, bits);; h = (h + 1) & mask) {
      const int32_t old = atomicCAS(skey + h, MW_EMPTY, key);
      if (old == MW_EMPTY || old == key) break;
    }
  }
  __syncthreads();
  const int64_t per = (slots + blockDim.x - 1) / blockDim.x;
  const int64_t b = threadIdx.x * per, e = b + per < slots ? b + per : slots;
  uint64_t mine = 0, total;
  for (int64_t h = b; h < e; ++h) mine += skey[h] != MW_EMPTY;
  int32_t id = (int32_t)mw_block_exclusive<uint64_t>(mine, warp_tot, &total);
  for (int64_t h = b; h < e; ++h) sid[h] = skey[h] != MW_EMPTY ? id++ : -1;
  __syncthreads();
  for (int64_t i = threadIdx.x; i < n_left; i += blockDim.x)
    lid[i] = lm[i] ? mw_find(skey, sid, bits, mw_key(lv[i * kl + vcol0])) : -1;
  __syncthreads();
}

// the tail of concatenated row g, searching upward from t
__device__ __forceinline__ int mw_tail_of(const MwTail* tails, int n_tails, int64_t g, int t) {
  while (t + 1 < n_tails && g >= tails[t + 1].seg) ++t;
  return t;
}

// The bins (id * T + t, or -1 for a row that does not survive the filter)
// and tail rows of the MW_UNROLL rows r0 + u * 32 + lane below g1 (one
// warp's next 32 * MW_UNROLL rows).  Every mask and v load is issued
// before any probe, so a thread keeps 2 * MW_UNROLL reads in flight (a
// masked row's v is read and ignored).  *t is the tail hint.
__device__ __forceinline__ void mw_bins(const MwTail* tails, int n_tails, int64_t r0,
                                        int64_t g1, const int32_t* skey, const int32_t* sid,
                                        int bits, int* t, int32_t* bin, int32_t* row) {
  const int lane = threadIdx.x & 31;
  int tt[MW_UNROLL];
  uint8_t ok[MW_UNROLL];
  int32_t v[MW_UNROLL];
#pragma unroll
  for (int u = 0; u < MW_UNROLL; ++u) {
    const int64_t g = r0 + u * 32 + lane;
    tt[u] = -1;
    row[u] = 0;
    if (g < g1) {
      *t = mw_tail_of(tails, n_tails, g, *t);
      const MwTail& tl = tails[*t];
      tt[u] = *t;
      row[u] = (int32_t)(g - tl.seg);
      ok[u] = tl.tm[row[u]];
      v[u] = tl.tv[(int64_t)row[u] * tl.k + tl.vcol];
    }
  }
#pragma unroll
  for (int u = 0; u < MW_UNROLL; ++u) {
    bin[u] = -1;
    if (tt[u] >= 0 && ok[u]) {
      const int32_t d = mw_find(skey, sid, bits, mw_key(v[u]));
      if (d >= 0) bin[u] = d * n_tails + tt[u];
    }
  }
}

// Counts the survivors of rows [g0, g1) into hist[bin] (shared memory) and
// stages them in row order, with no barrier: warp w takes the contiguous
// rows [g0 + w * wchunk, ...), compacts its survivors with ballots from its
// own first row on (stage_bin / stage_row: bin and row inside the tail,
// indexed from g0) and writes their number to wcount[w].
__device__ void mw_count(const MwTail* tails, int n_tails, int64_t g0, int64_t g1,
                         const int32_t* skey, const int32_t* sid, int bits, uint32_t* hist,
                         int32_t* stage_bin, int32_t* stage_row, int64_t* wcount) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int64_t wchunk = (g1 - g0 + nw - 1) / nw;
  const int64_t w0 = g0 + warp * wchunk, w1 = w0 + wchunk < g1 ? w0 + wchunk : g1;
  int t = 0;
  int64_t n = 0;
  for (int64_t r0 = w0; r0 < w1; r0 += 32 * MW_UNROLL) {
    int32_t bin[MW_UNROLL], row[MW_UNROLL];
    mw_bins(tails, n_tails, r0, w1, skey, sid, bits, &t, bin, row);
#pragma unroll
    for (int u = 0; u < MW_UNROLL; ++u) {
      const unsigned vote = __ballot_sync(0xffffffffu, bin[u] >= 0);
      if (bin[u] >= 0) {
        atomicAdd(hist + bin[u], 1u);
        const int64_t p = (w0 - g0) + n + __popc(vote & ((1u << lane) - 1u));
        stage_bin[p] = bin[u];
        stage_row[p] = row[u];
      }
      n += __popc(vote);
    }
  }
  if (lane == 0) wcount[warp] = n;
}

// Places one round of blockDim consecutive staged survivors, in row order:
// this thread's has bin `bin` (or -1 past the end) and tail row `row`; it
// goes to
// grouped[base[bin]++] (base: the block's next slot per bin, in shared
// memory).  Only warps that hold a survivor take a turn, one after
// another (wflag: two rounds of per-warp flags in shared memory, so one
// barrier a round suffices); inside a warp equal bins rank by lane.
__device__ __forceinline__ void mw_place_round(int32_t bin, int32_t row, int32_t* base,
                                               int32_t* grouped, int32_t* wflag, int parity) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  int32_t* flags = wflag + 32 * parity;
  const unsigned any = __ballot_sync(0xffffffffu, bin >= 0);
  if (lane == 0) flags[warp] = any != 0;
  __syncthreads();
  for (int w = 0; w < nw; ++w) {
    if (!flags[w]) continue;
    if (warp == w && bin >= 0) {
      const unsigned peers = __match_any_sync(any, bin);
      const int rank = __popc(peers & ((1u << lane) - 1u));
      const int32_t b = base[bin];
      __syncwarp(any);
      grouped[b + rank] = row;
      if (rank == 0) base[bin] = b + __popc(peers);
    }
    __syncthreads();
  }
}

// Places, in order, the survivors a count pass of nwc warps over rows
// [g0, g1) staged (stage_* indexed from g0; wcount[w] of them from warp
// w's first row on): rounds over the warps' lists laid end to end, so a
// block with few survivors pays one round.  wpre: nwc + 1 int64 of shared
// memory.
__device__ void mw_place(const int32_t* stage_bin, const int32_t* stage_row, int64_t g0,
                         int64_t g1, int nwc, const int64_t* wcount, int64_t* wpre,
                         int32_t* base, int32_t* grouped, int32_t* wflag) {
  const int64_t wchunk = (g1 - g0 + nwc - 1) / nwc;
  if (threadIdx.x == 0) {
    wpre[0] = 0;
    for (int w = 0; w < nwc; ++w) wpre[w + 1] = wpre[w] + wcount[w];
  }
  __syncthreads();
  const int64_t n = wpre[nwc];
  int parity = 0;
  for (int64_t r0 = 0; r0 < n; r0 += blockDim.x, parity ^= 1) {
    const int64_t p = r0 + threadIdx.x;
    int32_t bin = -1, row = 0;
    if (p < n) {
      int w = 0;
      while (p >= wpre[w + 1]) ++w;
      const int64_t at = w * wchunk + (p - wpre[w]);
      bin = stage_bin[at];
      row = stage_row[at];
    }
    mw_place_round(bin, row, base, grouped, wflag, parity);
  }
}

// window of a left row with id d in tail t: its first grouped slot and its
// count, from the bin-major count matrix (G blocks per bin) and its scan
__device__ __forceinline__ uint64_t mw_window(int32_t d, int t, int n_tails, const int64_t* hist,
                                              const int64_t* incl, int64_t G, int64_t* lo) {
  if (d < 0) {
    *lo = 0;
    return 0;
  }
  const int64_t cell = ((int64_t)d * n_tails + t) * G;
  *lo = incl[cell] - hist[cell];
  return (uint64_t)(incl[cell + G - 1] - *lo);
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

struct MwState {         // what the expansion reads
  const int64_t* offsets;
  const int64_t* run;
  const int32_t* lid;
  const int64_t* hist;
  const int64_t* incl;
  int64_t G;
  const int32_t* grouped;
};

// The row of tail t that slot offset *rem selects (the mixed radix, last
// tail fastest), or -1 when the left row's window there is empty.
__device__ __forceinline__ int64_t mw_tail_row(const MwState& s, int t, int n_tails, int32_t d,
                                               int64_t* rem) {
  int64_t lo, off;
  const int64_t cnt = (int64_t)mw_window(d, t, n_tails, s.hist, s.incl, s.G, &lo);
  *rem = mw_floor_divmod(*rem, cnt < 1 ? 1 : cnt, &off);
  return cnt < 1 ? -1 : s.grouped[lo + off];
}

// Slot j of the output.  The decode runs twice (verify, then emit) so no
// per-thread array bounds the number of tails.
__device__ void mw_expand_slot(int64_t j, int64_t total, const MwState& s, int64_t n_left,
                               const int32_t* lv, const uint8_t* lm, int kl, int vcol0,
                               const MwTail* tails, int n_tails, int k_out, int32_t* out,
                               uint8_t* ov) {
  int32_t* o = out + j * k_out;
  bool valid = j < total && n_left > 0;
  int64_t li = 0, rem0 = 0;
  int32_t d = -1;
  if (valid) {
    li = das_clamp(das_upper_bound<int64_t>(s.offsets, n_left, j), 0, n_left - 1);
    rem0 = (int64_t)((uint64_t)j - ((uint64_t)s.offsets[li] - (uint64_t)s.run[li]));
    d = s.lid[li];
    valid = lm[li] != 0 && d >= 0;
    const int32_t lvv = lv[li * kl + vcol0];
    int64_t rem = rem0;
    for (int t = n_tails - 1; t >= 0 && valid; --t) {
      const MwTail& tl = tails[t];
      const int64_t r = mw_tail_row(s, t, n_tails, d, &rem);
      valid = r >= 0 && tl.tm[r] != 0 && tl.tv[r * tl.k + tl.vcol] == lvv;
    }
  }
  if (!valid) {
    for (int c = 0; c < k_out; ++c) o[c] = 0;
    ov[j] = 0;
    return;
  }
  const int32_t* lrow = lv + li * kl;
  for (int c = 0; c < kl; ++c) o[c] = lrow[c];
  int64_t rem = rem0;
  for (int t = n_tails - 1; t >= 0; --t) {
    const MwTail& tl = tails[t];
    const int32_t* trow = tl.tv + mw_tail_row(s, t, n_tails, d, &rem) * tl.k;
    for (int c = 0; c < tl.extra.n; ++c) o[tl.col + c] = trow[tl.extra.c[c]];
  }
  ov[j] = 1;
}

// ---- regime block: one launch ------------------------------------------------

__global__ void __launch_bounds__(MW_BLOCK_THREADS)
mw_block_kernel(const int32_t* lv, const uint8_t* lm, int64_t n_left, int kl, int vcol0,
                const __grid_constant__ MwTails ts, int n_tails, int64_t n_rows, int bits,
                int64_t cap, int k_out, int32_t* out, uint8_t* ov, int64_t* tot) {
  extern __shared__ __align__(16) unsigned char mw_smem[];
  __shared__ uint64_t warp_tot[32];
  __shared__ unsigned long long totals[MW_PARAM_TAILS];
  __shared__ int32_t wflag[64];
  __shared__ int64_t wcount[32];
  __shared__ int64_t wpre[33];
  const MwTail* tails = ts.t;
  const int64_t slots = 1ll << bits, n_bins = n_left * n_tails;
  uint64_t* hist = reinterpret_cast<uint64_t*>(mw_smem);
  uint64_t* incl = hist + n_bins;
  uint64_t* run = incl + n_bins;
  uint64_t* offsets = run + n_left;
  int32_t* skey = reinterpret_cast<int32_t*>(offsets + n_left);
  int32_t* sid = skey + slots;
  int32_t* lid = sid + slots;
  uint32_t* cnt32 = reinterpret_cast<uint32_t*>(lid + n_left);
  int32_t* grouped = reinterpret_cast<int32_t*>(cnt32 + n_bins);
  int32_t* stage_bin = grouped + n_rows;
  int32_t* stage_row = stage_bin + n_rows;

  mw_build_set(lv, lm, n_left, kl, vcol0, skey, sid, bits, lid, warp_tot);
  for (int64_t b = threadIdx.x; b < n_bins; b += blockDim.x) cnt32[b] = 0;
  if (threadIdx.x < MW_PARAM_TAILS) totals[threadIdx.x] = 0;
  __syncthreads();
  mw_count(tails, n_tails, 0, n_rows, skey, sid, bits, cnt32, stage_bin, stage_row, wcount);
  __syncthreads();
  for (int64_t b = threadIdx.x; b < n_bins; b += blockDim.x) hist[b] = incl[b] = cnt32[b];
  __syncthreads();
  mw_block_scan(incl, n_bins, warp_tot);
  for (int64_t b = threadIdx.x; b < n_bins; b += blockDim.x)
    cnt32[b] = (uint32_t)(incl[b] - hist[b]);
  __syncthreads();
  mw_place(stage_bin, stage_row, 0, n_rows, blockDim.x >> 5, wcount, wpre,
           reinterpret_cast<int32_t*>(cnt32), grouped, wflag);
  for (int64_t i = threadIdx.x; i < n_left; i += blockDim.x) {
    uint64_t r = 1;
    for (int t = 0; t < n_tails; ++t) {
      int64_t lo;
      r *= mw_window(lid[i], t, n_tails, reinterpret_cast<const int64_t*>(hist),
                     reinterpret_cast<const int64_t*>(incl), 1, &lo);
      if (r) atomicAdd(totals + t, (unsigned long long)r);
    }
    run[i] = offsets[i] = r;
  }
  __syncthreads();
  mw_block_scan(offsets, n_left, warp_tot);
  if ((int)threadIdx.x < n_tails) tot[threadIdx.x] = (int64_t)totals[threadIdx.x];
  const int64_t total = (int64_t)totals[n_tails - 1];
  const MwState s{reinterpret_cast<const int64_t*>(offsets), reinterpret_cast<const int64_t*>(run),
                  lid, reinterpret_cast<const int64_t*>(hist),
                  reinterpret_cast<const int64_t*>(incl), 1, grouped};
  for (int64_t j = threadIdx.x; j < cap; j += blockDim.x)
    mw_expand_slot(j, total, s, n_left, lv, lm, kl, vcol0, tails, n_tails, k_out, out, ov);
}

// ---- regimes filter and global ------------------------------------------------

__global__ void __launch_bounds__(MW_BLOCK_THREADS)
mw_set_kernel(const int32_t* lv, const uint8_t* lm, int64_t n_left, int kl, int vcol0,
              int32_t* skey, int32_t* sid, int bits, int32_t* lid, int64_t* tot, int n_tails) {
  __shared__ uint64_t warp_tot[32];
  for (int t = threadIdx.x; t < n_tails; t += blockDim.x) tot[t] = 0;
  mw_build_set(lv, lm, n_left, kl, vcol0, skey, sid, bits, lid, warp_tot);
}

// the set into shared memory: skey then sid, 2^bits int32 each
__device__ __forceinline__ void mw_load_set(const int32_t* skey, const int32_t* sid, int bits,
                                            int32_t* s_key, int32_t* s_id) {
  for (int64_t h = threadIdx.x; h < (1ll << bits); h += blockDim.x) {
    s_key[h] = skey[h];
    s_id[h] = sid[h];
  }
}

// rows [g0, g1) of block b: contiguous ranges of `chunk` rows
__device__ __forceinline__ void mw_range(int64_t n_rows, int64_t chunk, int64_t* g0,
                                         int64_t* g1) {
  *g0 = blockIdx.x * chunk;
  *g1 = *g0 + chunk < n_rows ? *g0 + chunk : n_rows;
}

// the count pass: block b's rows [b * chunk, ...) against the set, its
// per-bin counts to column b of the bin-major count matrix, its survivors
// staged (in row order, per warp) from its first row on, their numbers to
// wcount[b * MW_GRID_WARPS + warp].  kGlobal: the set is probed in device
// memory and the histogram is row b of gwork (G x n_bins uint32), else
// both live in shared memory.
template <bool kGlobal>
__global__ void __launch_bounds__(MW_GRID_THREADS, MW_GRID_MIN_BLOCKS)
mw_hist_kernel(const __grid_constant__ MwTails ts, int n_tails, int64_t n_rows, int64_t chunk,
               const int32_t* skey, const int32_t* sid, int bits, int64_t n_bins,
               int64_t* hist, int32_t* stage_bin, int32_t* stage_row, int64_t* wcount,
               uint32_t* gwork) {
  extern __shared__ __align__(16) unsigned char mw_smem[];
  const int32_t* s_key = skey;
  const int32_t* s_id = sid;
  uint32_t* h;
  if (kGlobal) {
    h = gwork + (int64_t)blockIdx.x * n_bins;
  } else {
    int32_t* k = reinterpret_cast<int32_t*>(mw_smem);
    int32_t* d = k + (1ll << bits);
    mw_load_set(skey, sid, bits, k, d);
    s_key = k;
    s_id = d;
    h = reinterpret_cast<uint32_t*>(d + (1ll << bits));
  }
  for (int64_t b = threadIdx.x; b < n_bins; b += blockDim.x) h[b] = 0;
  __syncthreads();
  int64_t g0, g1;
  mw_range(n_rows, chunk, &g0, &g1);
  mw_count(mw_list(ts), n_tails, g0, g1, s_key, s_id, bits, h, stage_bin + g0, stage_row + g0,
           wcount + (int64_t)blockIdx.x * MW_GRID_WARPS);
  __syncthreads();
  for (int64_t b = threadIdx.x; b < n_bins; b += blockDim.x)
    hist[b * gridDim.x + blockIdx.x] = h[b];
}

// the place pass: block b's staged survivors to their bins' slots (the next
// slot per bin in shared memory, or in row b of gwork when kGlobal)
template <bool kGlobal>
__global__ void __launch_bounds__(MW_GRID_THREADS)
mw_place_kernel(int64_t n_rows, int64_t chunk, int64_t n_bins, const int64_t* hist,
                const int64_t* incl, const int32_t* stage_bin, const int32_t* stage_row,
                const int64_t* wcount, int32_t* grouped, uint32_t* gwork) {
  extern __shared__ __align__(16) unsigned char mw_smem[];
  __shared__ int32_t wflag[64];
  __shared__ int64_t wpre[MW_GRID_WARPS + 1];
  int32_t* base = kGlobal ? reinterpret_cast<int32_t*>(gwork + (int64_t)blockIdx.x * n_bins)
                          : reinterpret_cast<int32_t*>(mw_smem);
  for (int64_t b = threadIdx.x; b < n_bins; b += blockDim.x) {
    const int64_t cell = b * gridDim.x + blockIdx.x;
    base[b] = (int32_t)(incl[cell] - hist[cell]);
  }
  __syncthreads();
  int64_t g0, g1;
  mw_range(n_rows, chunk, &g0, &g1);
  mw_place(stage_bin + g0, stage_row + g0, g0, g1, MW_GRID_WARPS,
           wcount + (int64_t)blockIdx.x * MW_GRID_WARPS, wpre, base, grouped, wflag);
}

// one thread per left row (the grid covers n_left exactly, so every lane
// of a warp takes part in the per-tail warp sums)
__global__ void __launch_bounds__(DAS_THREADS)
mw_run_kernel(int64_t n_left, int n_tails, const int32_t* lid, const int64_t* hist,
              const int64_t* incl, int64_t G, int64_t* run, int64_t* tot) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int32_t d = i < n_left ? lid[i] : -1;
  uint64_t r = 1;
  for (int t = 0; t < n_tails; ++t) {
    int64_t lo;
    r *= mw_window(d, t, n_tails, hist, incl, G, &lo);
    uint64_t sum = r;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, o);
    if ((threadIdx.x & 31) == 0 && sum)
      atomicAdd(reinterpret_cast<unsigned long long*>(tot + t), (unsigned long long)sum);
  }
  if (i < n_left) run[i] = (int64_t)r;
}

__global__ void mw_expand_kernel(int64_t cap, MwState s, int64_t n_left, const int32_t* lv,
                                 const uint8_t* lm, int kl, int vcol0,
                                 const __grid_constant__ MwTails ts, int n_tails,
                                 const int64_t* tot, int k_out, int32_t* out, uint8_t* ov) {
  const int64_t total = tot[n_tails - 1];
  const MwTail* tails = mw_list(ts);
  for (int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; j < cap;
       j += (int64_t)gridDim.x * blockDim.x)
    mw_expand_slot(j, total, s, n_left, lv, lm, kl, vcol0, tails, n_tails, k_out, out, ov);
}

// ---- the plan and the entry --------------------------------------------------------

enum { MW_BLOCK, MW_FILTER, MW_GLOBAL };
static const char* const MW_REGIME_NAME[] = {"block", "filter", "global"};

// A call's regime and shapes: the set's log2 slots, the bins, the blocks G
// of the count and place grids (at most MW_FILTER_MAX_CELLS bins x G cells
// of counts), the scan scratch, the dynamic shared memory of the block (or
// count) kernel and the bytes of the scratch buffer.
struct MwPlan {
  int regime, bits;
  int64_t n_rows, n_bins, G, scan_len, smem, bytes;
};

static MwPlan mw_plan(int64_t n_left, int n_tails, const int64_t* rows, int64_t cap) {
  MwPlan p;
  p.n_rows = 0;
  for (int t = 0; t < n_tails; ++t) p.n_rows += rows[t];
  p.bits = das_set_bits(n_left);
  p.n_bins = n_left * n_tails;
  p.G = p.scan_len = p.bytes = 0;
  p.smem = 8 * (1ll << p.bits) + 20 * p.n_bins + 12 * p.n_rows + 20 * n_left;
  if (n_tails <= MW_PARAM_TAILS && p.n_rows <= MW_BLOCK_MAX_ROWS && cap <= MW_BLOCK_MAX_CAP &&
      p.smem <= MW_BLOCK_MAX_BYTES) {
    p.regime = MW_BLOCK;
    return p;
  }
  p.smem = 8 * (1ll << p.bits) + 4 * p.n_bins;
  p.regime = p.smem <= MW_FILTER_MAX_BYTES ? MW_FILTER : MW_GLOBAL;
  if (p.regime == MW_GLOBAL) p.smem = 0;
  int64_t g = (p.n_rows + MW_FILTER_ROWS_PER_BLOCK - 1) / MW_FILTER_ROWS_PER_BLOCK;
  if (g > MW_FILTER_MAX_BLOCKS) g = MW_FILTER_MAX_BLOCKS;
  if (p.n_bins > 0 && g > MW_FILTER_MAX_CELLS / p.n_bins) g = MW_FILTER_MAX_CELLS / p.n_bins;
  p.G = g < 1 ? 1 : g;
  const int64_t a = das_scan_scratch(p.n_bins * p.G), b = das_scan_scratch(n_left);
  p.scan_len = a > b ? a : b;
  // the tail table (T > MW_PARAM_TAILS); int64: hist, incl (n_bins * G
  // each), run, offsets (n_left each), the scan scratch, wcount
  // (G * MW_GRID_WARPS); int32: skey, sid (2^bits each), lid (n_left),
  // grouped, stage_bin, stage_row (n_rows each); global: gwork
  // (G * n_bins uint32)
  p.bytes = (n_tails > MW_PARAM_TAILS ? (int64_t)sizeof(MwTail) * n_tails : 0) +
            8 * (2 * p.n_bins * p.G + 2 * n_left + p.scan_len + p.G * MW_GRID_WARPS) +
            4 * (2 * (1ll << p.bits) + n_left + 3 * p.n_rows) +
            (p.regime == MW_GLOBAL ? 4 * p.n_bins * p.G : 0);
  return p;
}

// bytes of the scratch buffer das_multiway needs (0 in regime block)
extern "C" int64_t das_multiway_scratch(int64_t n_left, int n_tails, const int64_t* rows,
                                        int64_t cap) {
  return n_tails < 1 ? 0 : mw_plan(n_left, n_tails, rows, cap).bytes;
}

// the descriptors of the T tails into desc[0, T); *k_out is the output width
static bool mw_tails(int n_tails, void* const* tv, void* const* tm, const int64_t* rows,
                     const int* k, const int* vcol, const int* n_extra, const int* extra,
                     int kl, MwTail* desc, int* k_out) {
  *k_out = kl;
  int64_t seg = 0;
  for (int t = 0; t < n_tails; ++t) {
    if (n_extra[t] > DAS_MAXC) return false;
    MwTail& tl = desc[t];
    tl.tv = (const int32_t*)tv[t];
    tl.tm = (const uint8_t*)tm[t];
    tl.rows = rows[t];
    tl.seg = seg;
    tl.k = k[t];
    tl.vcol = vcol[t];
    tl.col = *k_out;
    tl.extra = das_cols(extra + t * DAS_MAXC, n_extra[t]);
    *k_out += n_extra[t];
    seg += rows[t];
  }
  return true;
}

static cudaError_t mw_block(const MwPlan& p, const int32_t* lv, const uint8_t* lm,
                            int64_t n_left, int kl, int vcol0, const MwTails& ts, int n_tails,
                            int64_t cap, int k_out, int32_t* out, uint8_t* ov, int64_t* tot,
                            cudaStream_t st) {
  static bool attr_done[DAS_MAX_DEVICES];
  cudaError_t err = das_smem_attr((const void*)mw_block_kernel, MW_BLOCK_MAX_BYTES, attr_done);
  if (err != cudaSuccess) return err;
  const unsigned threads =
      n_left + p.n_rows + cap <= 8192 ? MW_SMALL_THREADS : MW_BLOCK_THREADS;
  mw_block_kernel<<<1, threads, (size_t)p.smem, st>>>(lv, lm, n_left, kl, vcol0, ts, n_tails,
                                                     p.n_rows, p.bits, cap, k_out, out, ov, tot);
  return cudaSuccess;
}

template <bool kGlobal>
static cudaError_t mw_filter(const MwPlan& p, const int32_t* lv, const uint8_t* lm,
                             int64_t n_left, int kl, int vcol0, const MwTails& ts, int n_tails,
                             int64_t cap, int k_out, char* scratch, int32_t* out, uint8_t* ov,
                             int64_t* tot, int* launches, cudaStream_t st) {
  const int bits = p.bits;
  const int64_t n_bins = p.n_bins, G = p.G, n_rows = p.n_rows;
  int64_t* hist = (int64_t*)scratch;
  int64_t* incl = hist + n_bins * G;
  int64_t* run = incl + n_bins * G;
  int64_t* offsets = run + n_left;
  int64_t* scan_scratch = offsets + n_left;
  int64_t* wcount = scan_scratch + p.scan_len;
  int32_t* skey = (int32_t*)(wcount + G * MW_GRID_WARPS);
  int32_t* sid = skey + (1ll << bits);
  int32_t* lid = sid + (1ll << bits);
  int32_t* grouped = lid + n_left;
  int32_t* stage_bin = grouped + n_rows;
  int32_t* stage_row = stage_bin + n_rows;
  uint32_t* gwork = kGlobal ? (uint32_t*)(stage_row + n_rows) : nullptr;
  if (!kGlobal) {
    static bool hist_done[DAS_MAX_DEVICES], place_done[DAS_MAX_DEVICES];
    cudaError_t err =
        das_smem_attr((const void*)mw_hist_kernel<false>, MW_FILTER_MAX_BYTES, hist_done);
    if (err == cudaSuccess)
      err = das_smem_attr((const void*)mw_place_kernel<false>, MW_FILTER_MAX_BYTES, place_done);
    if (err != cudaSuccess) return err;
  }
  const int64_t chunk = n_rows > 0 ? (n_rows + G - 1) / G : 1;
  mw_set_kernel<<<1, MW_BLOCK_THREADS, 0, st>>>(lv, lm, n_left, kl, vcol0, skey, sid, bits, lid,
                                                tot, n_tails);
  mw_hist_kernel<kGlobal><<<(unsigned)G, MW_GRID_THREADS, (size_t)p.smem, st>>>(
      ts, n_tails, n_rows, chunk, skey, sid, bits, n_bins, hist, stage_bin, stage_row, wcount,
      gwork);
  cudaError_t err = das_scan_i64(hist, incl, n_bins * G, scan_scratch, p.scan_len, st);
  if (err != cudaSuccess) return err;
  mw_place_kernel<kGlobal><<<(unsigned)G, MW_GRID_THREADS, kGlobal ? 0 : (size_t)(4 * n_bins),
                             st>>>(n_rows, chunk, n_bins, hist, incl, stage_bin, stage_row,
                                   wcount, grouped, gwork);
  if (n_left > 0)
    mw_run_kernel<<<(unsigned)((n_left + DAS_THREADS - 1) / DAS_THREADS), DAS_THREADS, 0, st>>>(
        n_left, n_tails, lid, hist, incl, G, run, tot);
  err = das_scan_i64(run, offsets, n_left, scan_scratch, p.scan_len, st);
  if (err != cudaSuccess) return err;
  const MwState s{offsets, run, lid, hist, incl, G, grouped};
  mw_expand_kernel<<<das_blocks(cap), DAS_THREADS, 0, st>>>(cap, s, n_left, lv, lm, kl, vcol0, ts,
                                                           n_tails, tot, k_out, out, ov);
  *launches = 4 + (n_left > 0) + das_scan_launches(n_bins * G) + das_scan_launches(n_left);
  return cudaSuccess;
}

// The star join.  Per tail t: tv[t], tm[t] its table and mask, rows[t] x
// k[t] its shape, vcol[t] its v column, extra[t * DAS_MAXC ...] its
// n_extra[t] output columns.  `scratch` holds das_multiway_scratch(...)
// bytes (null when that is 0).  *launches = kernels launched, *regime =
// the regime's name.
extern "C" int das_multiway(const void* lv, const void* lm, int64_t n_left, int kl, int vcol0,
                            int n_tails, void* const* tv, void* const* tm, const int64_t* rows,
                            const int* k, const int* vcol, const int* n_extra, const int* extra,
                            int64_t cap, void* scratch, void* out, void* ov, void* tot,
                            int* launches, const char** regime, void* stream) {
  *launches = 0;
  *regime = "";
  if (n_tails < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const MwPlan p = mw_plan(n_left, n_tails, rows, cap);
  MwTails ts;
  ts.table = nullptr;
  int k_out;
  if (n_tails <= MW_PARAM_TAILS) {
    if (!mw_tails(n_tails, tv, tm, rows, k, vcol, n_extra, extra, kl, ts.t, &k_out))
      return (int)cudaErrorInvalidValue;
  } else {
    // the descriptors go to the front of the scratch buffer; the copy from
    // pageable memory is staged before this call returns
    std::vector<MwTail> desc(n_tails);
    if (!mw_tails(n_tails, tv, tm, rows, k, vcol, n_extra, extra, kl, desc.data(), &k_out))
      return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaMemcpyAsync(scratch, desc.data(), sizeof(MwTail) * n_tails,
                                      cudaMemcpyHostToDevice, st);
    if (err != cudaSuccess) return (int)err;
    ts.table = (const MwTail*)scratch;
    scratch = (char*)scratch + sizeof(MwTail) * n_tails;
  }
  *regime = MW_REGIME_NAME[p.regime];
  const int32_t* l = (const int32_t*)lv;
  const uint8_t* m = (const uint8_t*)lm;
  int32_t* o = (int32_t*)out;
  uint8_t* v = (uint8_t*)ov;
  int64_t* tt = (int64_t*)tot;
  cudaError_t err;
  if (p.regime == MW_BLOCK) {
    err = mw_block(p, l, m, n_left, kl, vcol0, ts, n_tails, cap, k_out, o, v, tt, st);
    if (err == cudaSuccess) *launches = 1;
  } else if (p.regime == MW_FILTER) {
    err = mw_filter<false>(p, l, m, n_left, kl, vcol0, ts, n_tails, cap, k_out, (char*)scratch,
                           o, v, tt, launches, st);
  } else {
    err = mw_filter<true>(p, l, m, n_left, kl, vcol0, ts, n_tails, cap, k_out, (char*)scratch,
                          o, v, tt, launches, st);
  }
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
