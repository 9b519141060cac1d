// Stable grouping without a sort: the engine under the multiway star join
// (multiway.cu) and the sort-merge join (join_tables.cu).
//
// A join window is the run of right-side (tail) rows whose mixed key equals
// a left row's key, in increasing row order: what a STABLE argsort of the
// right keys followed by searchsorted gives.  Only the grouping matters,
// not the order of the keys.  So the left keys go into an open-addressing
// set with dense ids; each tail row is kept iff its key is in the set; the
// survivors are counted per bin = id * T + t and block, the bin-major count
// matrix is scanned (das_scan_i64), and the survivors are placed into their
// bins in row order.  A left row's window in tail t is then its bin's run.
//
// What differs between the two joins is a Keys policy:
//
//   using K;                        key type: int32_t or int64_t
//   static constexpr bool kMarked;  true when a key may equal kEmpty
//   static constexpr K kEmpty;      the empty-slot marker
//   bool left_key(int64_t i, K* key) const;                 false: no key
//   struct Row;                     what a tail row's key is made from
//   Row tail_row(const GrpTail& t, int64_t row) const;      the loads
//   bool tail_key(const Row& r, K* key) const;              false: no key
//
// The count pass issues GRP_UNROLL rows' tail_row loads before it computes
// any tail_key: a key computed between the rows' loads exposes each row's
// load latency in turn (on the H100 that made the fan-out star's count
// pass ~30% slower).
//
// A key equal to kEmpty (possible only when kMarked) never enters a slot:
// inserting it sets sid[2^bits], which then holds its id (the last one),
// and a lookup of it reads that word: the anti join's marker-plus-flag.
//
// Everything here has internal linkage, so each source that includes it
// gets its own kernels.
#pragma once

#include "common.cuh"

#define GRP_PARAM_TAILS 24
#define GRP_SET_THREADS 1024
#define GRP_GRID_THREADS 512
#define GRP_GRID_WARPS (GRP_GRID_THREADS / 32)
#define GRP_GRID_MIN_BLOCKS 3  // count blocks resident per SM: 3 x 132 = one wave
#define GRP_FILTER_MAX_BYTES 196608
#define GRP_FILTER_ROWS_PER_BLOCK 8192
#define GRP_FILTER_MAX_BLOCKS 396
#define GRP_FILTER_MAX_CELLS (1ll << 20)
#define GRP_UNROLL 4

namespace {

struct GrpTail {         // one tail, by value in the kernel parameters
  const int32_t* tv;     // [rows, k] tail table
  const uint8_t* tm;     // [rows] validity
  int64_t rows;
  int64_t seg;           // its first row in the concatenated row space
  int k;
  int vcol;
  int col;               // first output column of its extra columns
  DasCols extra;         // tail columns appended to the output row
};

struct GrpTails {
  GrpTail t[GRP_PARAM_TAILS];
  const GrpTail* table;  // all T descriptors in device memory when T > GRP_PARAM_TAILS, else null
};

__device__ __forceinline__ const GrpTail* grp_list(const GrpTails& ts) {
  return ts.table ? ts.table : ts.t;
}

__device__ __forceinline__ uint32_t grp_slot(int32_t key, int bits) {
  return ((uint32_t)key * 2654435761u) >> (32 - bits);
}

__device__ __forceinline__ uint32_t grp_slot(int64_t key, int bits) {
  return (uint32_t)(((uint64_t)key * 0x9E3779B97F4A7C15ull) >> (64 - bits));
}

__device__ __forceinline__ int32_t grp_cas(int32_t* p, int32_t cmp, int32_t v) {
  return atomicCAS(p, cmp, v);
}

__device__ __forceinline__ int64_t grp_cas(int64_t* p, int64_t cmp, int64_t v) {
  return (int64_t)atomicCAS(reinterpret_cast<unsigned long long*>(p), (unsigned long long)cmp,
                            (unsigned long long)v);
}

// ids in sid[]: one per slot, and one more for the marked key
template <typename Keys>
__host__ __device__ constexpr int64_t grp_sid_len(int bits) {
  return (1ll << bits) + (Keys::kMarked ? 1 : 0);
}

// id of key in the set, -1 when absent
template <typename Keys>
__device__ __forceinline__ int32_t grp_find(const typename Keys::K* skey, const int32_t* sid,
                                            int bits, typename Keys::K key) {
  if constexpr (Keys::kMarked) {
    if (key == Keys::kEmpty) return sid[1ll << bits];
  }
  const uint32_t mask = (1u << bits) - 1u;
  for (uint32_t h = grp_slot(key, bits);; h = (h + 1) & mask) {
    const typename Keys::K s = skey[h];
    if (s == key) return sid[h];
    if (s == Keys::kEmpty) return -1;
  }
}

// One block: the set of the keys of rows [0, n) (keys.left_key), 2^bits
// slots, dense ids in slot order (the marked key last), lid[i] = the id of
// row i or -1 when it has no key.  Returns the number of ids.
template <typename Keys>
__device__ int64_t grp_build_set(const Keys& keys, int64_t n, typename Keys::K* skey,
                                 int32_t* sid, int bits, int32_t* lid, uint64_t* warp_tot) {
  using K = typename Keys::K;
  const int64_t slots = 1ll << bits;
  const uint32_t mask = (uint32_t)slots - 1u;
  for (int64_t h = threadIdx.x; h < slots; h += blockDim.x) skey[h] = Keys::kEmpty;
  if constexpr (Keys::kMarked) {
    if (threadIdx.x == 0) sid[slots] = -1;
  }
  __syncthreads();
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
    K key;
    if (!keys.left_key(i, &key)) continue;
    if constexpr (Keys::kMarked) {
      if (key == Keys::kEmpty) {
        sid[slots] = 0;
        continue;
      }
    }
    for (uint32_t h = grp_slot(key, bits);; h = (h + 1) & mask) {
      const K old = grp_cas(skey + h, Keys::kEmpty, key);
      if (old == Keys::kEmpty || old == key) break;
    }
  }
  __syncthreads();
  const int64_t per = (slots + blockDim.x - 1) / blockDim.x;
  const int64_t b = threadIdx.x * per, e = b + per < slots ? b + per : slots;
  uint64_t mine = 0, total;
  for (int64_t h = b; h < e; ++h) mine += skey[h] != Keys::kEmpty;
  int32_t id = (int32_t)das_block_exclusive<uint64_t>(mine, warp_tot, &total);
  for (int64_t h = b; h < e; ++h) sid[h] = skey[h] != Keys::kEmpty ? id++ : -1;
  int64_t n_ids = (int64_t)total;
  if constexpr (Keys::kMarked) {
    const bool marked = sid[slots] >= 0;
    n_ids += marked;
    __syncthreads();
    if (threadIdx.x == 0 && marked) sid[slots] = (int32_t)total;
  }
  __syncthreads();
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
    K key;
    lid[i] = keys.left_key(i, &key) ? grp_find<Keys>(skey, sid, bits, key) : -1;
  }
  __syncthreads();
  return n_ids;
}

// the tail of concatenated row g, searching upward from t
__device__ __forceinline__ int grp_tail_of(const GrpTail* tails, int n_tails, int64_t g, int t) {
  while (t + 1 < n_tails && g >= tails[t + 1].seg) ++t;
  return t;
}

// The bins (id * T + t, or -1 for a row that does not survive the filter)
// and tail rows of the GRP_UNROLL rows r0 + u * 32 + lane below g1 (one
// warp's next 32 * GRP_UNROLL rows).  Every row's loads are issued before
// any key is computed or probed, so a thread keeps GRP_UNROLL rows' reads
// in flight.  *t is the tail hint.
template <typename Keys>
__device__ __forceinline__ void grp_bins(const Keys& keys, const GrpTail* tails, int n_tails,
                                         int64_t r0, int64_t g1,
                                         const typename Keys::K* skey, const int32_t* sid,
                                         int bits, int* t, int32_t* bin, int32_t* row) {
  const int lane = threadIdx.x & 31;
  int tt[GRP_UNROLL];
  typename Keys::Row raw[GRP_UNROLL];
#pragma unroll
  for (int u = 0; u < GRP_UNROLL; ++u) {
    const int64_t g = r0 + u * 32 + lane;
    tt[u] = -1;
    row[u] = 0;
    if (g < g1) {
      *t = grp_tail_of(tails, n_tails, g, *t);
      const GrpTail& tl = tails[*t];
      tt[u] = *t;
      row[u] = (int32_t)(g - tl.seg);
      raw[u] = keys.tail_row(tl, row[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < GRP_UNROLL; ++u) {
    bin[u] = -1;
    typename Keys::K key;
    if (tt[u] >= 0 && keys.tail_key(raw[u], &key)) {
      const int32_t d = grp_find<Keys>(skey, sid, bits, key);
      if (d >= 0) bin[u] = d * n_tails + tt[u];
    }
  }
}

// Counts the survivors of rows [g0, g1) into hist[bin] (shared memory) and
// stages them in row order, with no barrier: warp w takes the contiguous
// rows [g0 + w * wchunk, ...), compacts its survivors with ballots from its
// own first row on (stage_bin / stage_row: bin and row inside the tail,
// indexed from g0) and writes their number to wcount[w].
template <typename Keys>
__device__ void grp_count(const Keys& keys, const GrpTail* tails, int n_tails, int64_t g0,
                          int64_t g1, const typename Keys::K* skey, const int32_t* sid,
                          int bits, uint32_t* hist, int32_t* stage_bin, int32_t* stage_row,
                          int64_t* wcount) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int64_t wchunk = (g1 - g0 + nw - 1) / nw;
  const int64_t w0 = g0 + warp * wchunk, w1 = w0 + wchunk < g1 ? w0 + wchunk : g1;
  int t = 0;
  int64_t n = 0;
  for (int64_t r0 = w0; r0 < w1; r0 += 32 * GRP_UNROLL) {
    int32_t bin[GRP_UNROLL], row[GRP_UNROLL];
    grp_bins(keys, tails, n_tails, r0, w1, skey, sid, bits, &t, bin, row);
#pragma unroll
    for (int u = 0; u < GRP_UNROLL; ++u) {
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

// Places one round of blockDim consecutive rows, in row order: this
// thread's has bin `bin` (or -1: none) and row `row`; it goes to
// grouped[base[bin]++] (base: the next slot per bin).  Only warps that hold
// a row take a turn, one after another (wflag: two rounds of per-warp flags
// in shared memory, so one barrier a round suffices); inside a warp equal
// bins rank by lane.
__device__ __forceinline__ void grp_place_round(int32_t bin, int32_t row, int32_t* base,
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
__device__ void grp_place(const int32_t* stage_bin, const int32_t* stage_row, int64_t g0,
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
    grp_place_round(bin, row, base, grouped, wflag, parity);
  }
}

// window of a left row with id d in tail t: its first grouped slot and its
// count, from the bin-major count matrix (G blocks per bin) and its scan
__device__ __forceinline__ uint64_t grp_window(int32_t d, int t, int n_tails, const int64_t* hist,
                                               const int64_t* incl, int64_t G, int64_t* lo) {
  if (d < 0) {
    *lo = 0;
    return 0;
  }
  const int64_t cell = ((int64_t)d * n_tails + t) * G;
  *lo = incl[cell] - hist[cell];
  return (uint64_t)(incl[cell + G - 1] - *lo);
}

struct GrpState {        // what an expansion reads
  const int64_t* offsets;
  const int64_t* run;
  const int32_t* lid;
  const int64_t* hist;
  const int64_t* incl;
  int64_t G;
  const int32_t* grouped;
};

// ---- the grid passes (regimes filter and global) ------------------------------

template <typename Keys>
__global__ void __launch_bounds__(GRP_SET_THREADS)
grp_set_kernel(const __grid_constant__ Keys keys, int64_t n_left, typename Keys::K* skey,
               int32_t* sid, int bits, int32_t* lid, int64_t* tot, int n_tails) {
  __shared__ uint64_t warp_tot[32];
  for (int t = threadIdx.x; t < n_tails; t += blockDim.x) tot[t] = 0;
  grp_build_set(keys, n_left, skey, sid, bits, lid, warp_tot);
}

// rows [g0, g1) of block b: contiguous ranges of `chunk` rows
__device__ __forceinline__ void grp_range(int64_t n_rows, int64_t chunk, int64_t* g0,
                                          int64_t* g1) {
  *g0 = blockIdx.x * chunk;
  *g1 = *g0 + chunk < n_rows ? *g0 + chunk : n_rows;
}

// the count pass: block b's rows [b * chunk, ...) against the set, its
// per-bin counts to column b of the bin-major count matrix, its survivors
// staged (in row order, per warp) from its first row on, their numbers to
// wcount[b * GRP_GRID_WARPS + warp].  kGlobal: the set is probed in device
// memory and the histogram is row b of gwork (G x n_bins uint32), else
// both live in shared memory (the set: keys, then ids).
template <bool kGlobal, typename Keys>
__global__ void __launch_bounds__(GRP_GRID_THREADS, GRP_GRID_MIN_BLOCKS)
grp_hist_kernel(const __grid_constant__ GrpTails ts, int n_tails, int64_t n_rows, int64_t chunk,
                const __grid_constant__ Keys keys, const typename Keys::K* skey,
                const int32_t* sid, int bits, int64_t n_bins, int64_t* hist, int32_t* stage_bin,
                int32_t* stage_row, int64_t* wcount, uint32_t* gwork) {
  using K = typename Keys::K;
  extern __shared__ __align__(16) unsigned char grp_smem[];
  const K* s_key = skey;
  const int32_t* s_id = sid;
  uint32_t* h;
  if (kGlobal) {
    h = gwork + (int64_t)blockIdx.x * n_bins;
  } else {
    K* k = reinterpret_cast<K*>(grp_smem);
    int32_t* d = reinterpret_cast<int32_t*>(k + (1ll << bits));
    for (int64_t i = threadIdx.x; i < (1ll << bits); i += blockDim.x) k[i] = skey[i];
    for (int64_t i = threadIdx.x; i < grp_sid_len<Keys>(bits); i += blockDim.x) d[i] = sid[i];
    s_key = k;
    s_id = d;
    h = reinterpret_cast<uint32_t*>(d + grp_sid_len<Keys>(bits));
  }
  for (int64_t b = threadIdx.x; b < n_bins; b += blockDim.x) h[b] = 0;
  __syncthreads();
  int64_t g0, g1;
  grp_range(n_rows, chunk, &g0, &g1);
  grp_count(keys, grp_list(ts), n_tails, g0, g1, s_key, s_id, bits, h, stage_bin + g0,
            stage_row + g0, wcount + (int64_t)blockIdx.x * GRP_GRID_WARPS);
  __syncthreads();
  for (int64_t b = threadIdx.x; b < n_bins; b += blockDim.x)
    hist[b * gridDim.x + blockIdx.x] = h[b];
}

// the place pass: block b's staged survivors to their bins' slots (the next
// slot per bin in shared memory, or in row b of gwork when kGlobal)
template <bool kGlobal>
__global__ void __launch_bounds__(GRP_GRID_THREADS)
grp_place_kernel(int64_t n_rows, int64_t chunk, int64_t n_bins, const int64_t* hist,
                 const int64_t* incl, const int32_t* stage_bin, const int32_t* stage_row,
                 const int64_t* wcount, int32_t* grouped, uint32_t* gwork) {
  extern __shared__ __align__(16) unsigned char grp_smem[];
  __shared__ int32_t wflag[64];
  __shared__ int64_t wpre[GRP_GRID_WARPS + 1];
  int32_t* base = kGlobal ? reinterpret_cast<int32_t*>(gwork + (int64_t)blockIdx.x * n_bins)
                          : reinterpret_cast<int32_t*>(grp_smem);
  for (int64_t b = threadIdx.x; b < n_bins; b += blockDim.x) {
    const int64_t cell = b * gridDim.x + blockIdx.x;
    base[b] = (int32_t)(incl[cell] - hist[cell]);
  }
  __syncthreads();
  int64_t g0, g1;
  grp_range(n_rows, chunk, &g0, &g1);
  grp_place(stage_bin + g0, stage_row + g0, g0, g1, GRP_GRID_WARPS,
            wcount + (int64_t)blockIdx.x * GRP_GRID_WARPS, wpre, base, grouped, wflag);
}

// one thread per left row: the running product of its window counts over
// the tails (uint64, wrapping as XLA's int64) and the per-tail totals (the
// grid covers n_left exactly, so every lane of a warp takes part in the
// per-tail warp sums)
__global__ void __launch_bounds__(DAS_THREADS)
grp_run_kernel(int64_t n_left, int n_tails, const int32_t* lid, const int64_t* hist,
               const int64_t* incl, int64_t G, int64_t* run, int64_t* tot) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  const int32_t d = i < n_left ? lid[i] : -1;
  uint64_t r = 1;
  for (int t = 0; t < n_tails; ++t) {
    int64_t lo;
    r *= grp_window(d, t, n_tails, hist, incl, G, &lo);
    uint64_t sum = r;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, o);
    if ((threadIdx.x & 31) == 0 && sum)
      atomicAdd(reinterpret_cast<unsigned long long*>(tot + t), (unsigned long long)sum);
  }
  if (i < n_left) run[i] = (int64_t)r;
}

// ---- the plan and the launches ------------------------------------------------

// The grid passes' shapes: the set's log2 slots, the bins, the blocks G of
// the count and place grids (at most GRP_FILTER_MAX_CELLS bins x G cells of
// counts), the scan scratch, whether the set and histogram live in device
// memory (global), the count kernel's dynamic shared memory and the bytes
// of the scratch buffer (after `lead` bytes the caller keeps in front).
struct GrpPlan {
  bool global;
  int bits;
  int64_t n_rows, n_bins, G, scan_len, smem, bytes;
};

template <typename Keys>
GrpPlan grp_plan(int64_t n_left, int n_tails, int64_t n_rows, int64_t lead,
                 bool global_only = false) {
  GrpPlan p;
  p.n_rows = n_rows;
  p.bits = das_set_bits(n_left);
  p.n_bins = n_left * n_tails;
  const int64_t set_bytes = (int64_t)sizeof(typename Keys::K) * (1ll << p.bits) +
                            4 * grp_sid_len<Keys>(p.bits);
  p.smem = set_bytes + 4 * p.n_bins;
  p.global = global_only || p.smem > GRP_FILTER_MAX_BYTES;
  if (p.global) p.smem = 0;
  int64_t g = (n_rows + GRP_FILTER_ROWS_PER_BLOCK - 1) / GRP_FILTER_ROWS_PER_BLOCK;
  if (g > GRP_FILTER_MAX_BLOCKS) g = GRP_FILTER_MAX_BLOCKS;
  if (p.n_bins > 0 && g > GRP_FILTER_MAX_CELLS / p.n_bins) g = GRP_FILTER_MAX_CELLS / p.n_bins;
  p.G = g < 1 ? 1 : g;
  const int64_t a = das_scan_scratch(p.n_bins * p.G), b = das_scan_scratch(n_left);
  p.scan_len = a > b ? a : b;
  // int64: hist, incl (n_bins * G each), run, offsets (n_left each), the
  // scan scratch, wcount (G * GRP_GRID_WARPS); then the set; int32: lid
  // (n_left), grouped, stage_bin, stage_row (n_rows each); global: gwork
  // (G * n_bins uint32)
  p.bytes = lead + 8 * (2 * p.n_bins * p.G + 2 * n_left + p.scan_len + p.G * GRP_GRID_WARPS) +
            set_bytes + 4 * (n_left + 3 * n_rows) + (p.global ? 4 * p.n_bins * p.G : 0);
  return p;
}

// The grid passes over the scratch buffer (grp_plan(...).bytes after its
// lead): the set kernel (which zeroes tot[0, T)), the count grid, the scan
// of the counts, the place grid, the products and totals, the offsets scan.
// *s is what the caller's expansion reads; *launches = kernels launched.
template <bool kGlobal, typename Keys>
cudaError_t grp_group(const GrpPlan& p, const Keys& keys, int64_t n_left, const GrpTails& ts,
                      int n_tails, char* scratch, int64_t* tot, GrpState* s, int* launches,
                      cudaStream_t st) {
  using K = typename Keys::K;
  const int bits = p.bits;
  const int64_t n_bins = p.n_bins, G = p.G, n_rows = p.n_rows;
  int64_t* hist = (int64_t*)scratch;
  int64_t* incl = hist + n_bins * G;
  int64_t* run = incl + n_bins * G;
  int64_t* offsets = run + n_left;
  int64_t* scan_scratch = offsets + n_left;
  int64_t* wcount = scan_scratch + p.scan_len;
  K* skey = (K*)(wcount + G * GRP_GRID_WARPS);
  int32_t* sid = (int32_t*)(skey + (1ll << bits));
  int32_t* lid = sid + grp_sid_len<Keys>(bits);
  int32_t* grouped = lid + n_left;
  int32_t* stage_bin = grouped + n_rows;
  int32_t* stage_row = stage_bin + n_rows;
  uint32_t* gwork = kGlobal ? (uint32_t*)(stage_row + n_rows) : nullptr;
  if (!kGlobal) {
    static bool hist_done[DAS_MAX_DEVICES], place_done[DAS_MAX_DEVICES];
    cudaError_t err = das_smem_attr((const void*)grp_hist_kernel<false, Keys>,
                                    GRP_FILTER_MAX_BYTES, hist_done);
    if (err == cudaSuccess)
      err = das_smem_attr((const void*)grp_place_kernel<false>, GRP_FILTER_MAX_BYTES,
                          place_done);
    if (err != cudaSuccess) return err;
  }
  const int64_t chunk = n_rows > 0 ? (n_rows + G - 1) / G : 1;
  grp_set_kernel<Keys><<<1, GRP_SET_THREADS, 0, st>>>(keys, n_left, skey, sid, bits, lid, tot,
                                                      n_tails);
  grp_hist_kernel<kGlobal, Keys><<<(unsigned)G, GRP_GRID_THREADS, (size_t)p.smem, st>>>(
      ts, n_tails, n_rows, chunk, keys, skey, sid, bits, n_bins, hist, stage_bin, stage_row,
      wcount, gwork);
  cudaError_t err = das_scan_i64(hist, incl, n_bins * G, scan_scratch, p.scan_len, st);
  if (err != cudaSuccess) return err;
  grp_place_kernel<kGlobal><<<(unsigned)G, GRP_GRID_THREADS, kGlobal ? 0 : (size_t)(4 * n_bins),
                              st>>>(n_rows, chunk, n_bins, hist, incl, stage_bin, stage_row,
                                    wcount, grouped, gwork);
  if (n_left > 0)
    grp_run_kernel<<<(unsigned)((n_left + DAS_THREADS - 1) / DAS_THREADS), DAS_THREADS, 0, st>>>(
        n_left, n_tails, lid, hist, incl, G, run, tot);
  err = das_scan_i64(run, offsets, n_left, scan_scratch, p.scan_len, st);
  if (err != cudaSuccess) return err;
  *s = GrpState{offsets, run, lid, hist, incl, G, grouped};
  *launches = 3 + (n_left > 0) + das_scan_launches(n_bins * G) + das_scan_launches(n_left);
  return cudaSuccess;
}

}  // namespace
