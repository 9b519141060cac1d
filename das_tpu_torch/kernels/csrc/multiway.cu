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
//           R <= 16,384, cap <= 16,384 and T <= GRP_PARAM_TAILS.  The
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
// The set, the count, scan and place passes and the products are the
// stable grouping engine of group.cuh, with this join's key policy
// (MwStarKeys: the int32 mix of one column; a masked row has no key); the
// sort-merge join (join_tables.cu) runs the same engine on int64 keys.
//
// The tail descriptors (GRP_PARAM_TAILS = 24 of 112 B) travel by value in
// the kernel parameters (__grid_constant__), so no copy precedes a launch;
// a star of more tails (filter or global) copies its descriptors into the
// scratch buffer first and the kernels read them there.
//
// Bound at the main-path shapes: the grounded star is launch latency and
// the wrapper's host time (one launch, ~10 us on the card); the fan-out
// star (tails of 4,194,304 and 524,288 rows) is the count pass's read of
// every tail's mask and v column, ~38 MB at ~1.6 TB/s (latency-bound: each
// thread keeps 2 x GRP_UNROLL loads in flight); the survivors are a few
// thousand.  ptxas (-Xptxas -v, sm_90a, CUDA 12.8): mw_block_kernel 60
// registers, the engine's count kernel 40, place 32, set 32, run 28,
// mw_expand_kernel 38; no spills.
#include <vector>

#include "group.cuh"

#define MW_BLOCK_THREADS 1024
#define MW_BLOCK_MAX_BYTES 200000
#define MW_BLOCK_MAX_ROWS 16384
#define MW_BLOCK_MAX_CAP 16384
#define MW_SMALL_THREADS 256

// the mix of one int32 column (das_mix_row with one column): < 2^31
__device__ __forceinline__ int32_t mw_key(int32_t v) {
  const uint64_t x = (uint64_t)(int64_t)v;
  return (int32_t)(x ^ das_sar29(x));
}

// the engine's key policy: the mixed v of a valid row (never -1, the empty
// marker); a masked row has no key (its v is read and ignored)
struct MwStarKeys {
  using K = int32_t;
  static constexpr bool kMarked = false;
  static constexpr int32_t kEmpty = -1;
  const int32_t* lv;
  const uint8_t* lm;
  int kl;
  int vcol0;
  __device__ __forceinline__ bool left_key(int64_t i, int32_t* key) const {
    if (!lm[i]) return false;
    *key = mw_key(lv[i * kl + vcol0]);
    return true;
  }
  struct Row {
    uint8_t ok;
    int32_t v;
  };
  __device__ __forceinline__ Row tail_row(const GrpTail& t, int64_t row) const {
    return Row{t.tm[row], t.tv[row * t.k + t.vcol]};
  }
  __device__ __forceinline__ bool tail_key(const Row& r, int32_t* key) const {
    *key = mw_key(r.v);
    return r.ok != 0;
  }
};

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

// The row of tail t that slot offset *rem selects (the mixed radix, last
// tail fastest), or -1 when the left row's window there is empty.
__device__ __forceinline__ int64_t mw_tail_row(const GrpState& s, int t, int n_tails, int32_t d,
                                               int64_t* rem) {
  int64_t lo, off;
  const int64_t cnt = (int64_t)grp_window(d, t, n_tails, s.hist, s.incl, s.G, &lo);
  *rem = mw_floor_divmod(*rem, cnt < 1 ? 1 : cnt, &off);
  return cnt < 1 ? -1 : s.grouped[lo + off];
}

// Slot j of the output.  The decode runs twice (verify, then emit) so no
// per-thread array bounds the number of tails.
__device__ void mw_expand_slot(int64_t j, int64_t total, const GrpState& s, int64_t n_left,
                               const int32_t* lv, const uint8_t* lm, int kl, int vcol0,
                               const GrpTail* tails, int n_tails, int k_out, int32_t* out,
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
      const GrpTail& tl = tails[t];
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
    const GrpTail& tl = tails[t];
    const int32_t* trow = tl.tv + mw_tail_row(s, t, n_tails, d, &rem) * tl.k;
    for (int c = 0; c < tl.extra.n; ++c) o[tl.col + c] = trow[tl.extra.c[c]];
  }
  ov[j] = 1;
}

// ---- regime block: one launch ------------------------------------------------

__global__ void __launch_bounds__(MW_BLOCK_THREADS)
mw_block_kernel(const __grid_constant__ MwStarKeys keys, int64_t n_left,
                const __grid_constant__ GrpTails ts, int n_tails, int64_t n_rows, int bits,
                int64_t cap, int k_out, int32_t* out, uint8_t* ov, int64_t* tot) {
  extern __shared__ __align__(16) unsigned char mw_smem[];
  __shared__ uint64_t warp_tot[32];
  __shared__ unsigned long long totals[GRP_PARAM_TAILS];
  __shared__ int32_t wflag[64];
  __shared__ int64_t wcount[32];
  __shared__ int64_t wpre[33];
  const GrpTail* tails = ts.t;
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

  grp_build_set(keys, n_left, skey, sid, bits, lid, warp_tot);
  for (int64_t b = threadIdx.x; b < n_bins; b += blockDim.x) cnt32[b] = 0;
  if (threadIdx.x < GRP_PARAM_TAILS) totals[threadIdx.x] = 0;
  __syncthreads();
  grp_count(keys, tails, n_tails, 0, n_rows, skey, sid, bits, cnt32, stage_bin, stage_row,
            wcount);
  __syncthreads();
  for (int64_t b = threadIdx.x; b < n_bins; b += blockDim.x) hist[b] = incl[b] = cnt32[b];
  __syncthreads();
  das_block_scan(incl, n_bins, warp_tot);
  for (int64_t b = threadIdx.x; b < n_bins; b += blockDim.x)
    cnt32[b] = (uint32_t)(incl[b] - hist[b]);
  __syncthreads();
  grp_place(stage_bin, stage_row, 0, n_rows, blockDim.x >> 5, wcount, wpre,
            reinterpret_cast<int32_t*>(cnt32), grouped, wflag);
  for (int64_t i = threadIdx.x; i < n_left; i += blockDim.x) {
    uint64_t r = 1;
    for (int t = 0; t < n_tails; ++t) {
      int64_t lo;
      r *= grp_window(lid[i], t, n_tails, reinterpret_cast<const int64_t*>(hist),
                      reinterpret_cast<const int64_t*>(incl), 1, &lo);
      if (r) atomicAdd(totals + t, (unsigned long long)r);
    }
    run[i] = offsets[i] = r;
  }
  __syncthreads();
  das_block_scan(offsets, n_left, warp_tot);
  if ((int)threadIdx.x < n_tails) tot[threadIdx.x] = (int64_t)totals[threadIdx.x];
  const int64_t total = (int64_t)totals[n_tails - 1];
  const GrpState s{reinterpret_cast<const int64_t*>(offsets),
                   reinterpret_cast<const int64_t*>(run), lid,
                   reinterpret_cast<const int64_t*>(hist),
                   reinterpret_cast<const int64_t*>(incl), 1, grouped};
  for (int64_t j = threadIdx.x; j < cap; j += blockDim.x)
    mw_expand_slot(j, total, s, n_left, keys.lv, keys.lm, keys.kl, keys.vcol0, tails, n_tails,
                   k_out, out, ov);
}

// ---- regimes filter and global: the engine's grid passes, then this ------------

__global__ void mw_expand_kernel(int64_t cap, GrpState s, int64_t n_left, const int32_t* lv,
                                 const uint8_t* lm, int kl, int vcol0,
                                 const __grid_constant__ GrpTails ts, int n_tails,
                                 const int64_t* tot, int k_out, int32_t* out, uint8_t* ov) {
  const int64_t total = tot[n_tails - 1];
  const GrpTail* tails = grp_list(ts);
  for (int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; j < cap;
       j += (int64_t)gridDim.x * blockDim.x)
    mw_expand_slot(j, total, s, n_left, lv, lm, kl, vcol0, tails, n_tails, k_out, out, ov);
}

// ---- the plan and the entry --------------------------------------------------------

enum { MW_BLOCK, MW_FILTER, MW_GLOBAL };
static const char* const MW_REGIME_NAME[] = {"block", "filter", "global"};

// A call's regime, the block kernel's dynamic shared memory and the grid
// passes' plan (whose bytes are the scratch buffer's: 0 in regime block).
struct MwPlan {
  int regime;
  int64_t smem;
  GrpPlan grid;
};

static MwPlan mw_plan(int64_t n_left, int n_tails, const int64_t* rows, int64_t cap) {
  int64_t n_rows = 0;
  for (int t = 0; t < n_tails; ++t) n_rows += rows[t];
  MwPlan p;
  // the tail table (T > GRP_PARAM_TAILS) goes in front of the engine's buffers
  p.grid = grp_plan<MwStarKeys>(
      n_left, n_tails, n_rows, n_tails > GRP_PARAM_TAILS ? (int64_t)sizeof(GrpTail) * n_tails : 0);
  p.smem = 8 * (1ll << p.grid.bits) + 20 * p.grid.n_bins + 12 * n_rows + 20 * n_left;
  if (n_tails <= GRP_PARAM_TAILS && n_rows <= MW_BLOCK_MAX_ROWS && cap <= MW_BLOCK_MAX_CAP &&
      p.smem <= MW_BLOCK_MAX_BYTES) {
    p.regime = MW_BLOCK;
    p.grid.bytes = 0;
  } else {
    p.regime = p.grid.global ? MW_GLOBAL : MW_FILTER;
  }
  return p;
}

// bytes of the scratch buffer das_multiway needs (0 in regime block)
extern "C" int64_t das_multiway_scratch(int64_t n_left, int n_tails, const int64_t* rows,
                                        int64_t cap) {
  return n_tails < 1 ? 0 : mw_plan(n_left, n_tails, rows, cap).grid.bytes;
}

// the descriptors of the T tails into desc[0, T); *k_out is the output width
static bool mw_tails(int n_tails, void* const* tv, void* const* tm, const int64_t* rows,
                     const int* k, const int* vcol, const int* n_extra, const int* extra,
                     int kl, GrpTail* desc, int* k_out) {
  *k_out = kl;
  int64_t seg = 0;
  for (int t = 0; t < n_tails; ++t) {
    if (n_extra[t] > DAS_MAXC) return false;
    GrpTail& tl = desc[t];
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

static cudaError_t mw_block(const MwPlan& p, const MwStarKeys& keys, int64_t n_left,
                            const GrpTails& ts, int n_tails, int64_t cap, int k_out, int32_t* out,
                            uint8_t* ov, int64_t* tot, cudaStream_t st) {
  static bool attr_done[DAS_MAX_DEVICES];
  cudaError_t err = das_smem_attr((const void*)mw_block_kernel, MW_BLOCK_MAX_BYTES, attr_done);
  if (err != cudaSuccess) return err;
  const int64_t n_rows = p.grid.n_rows;
  const unsigned threads = n_left + n_rows + cap <= 8192 ? MW_SMALL_THREADS : MW_BLOCK_THREADS;
  mw_block_kernel<<<1, threads, (size_t)p.smem, st>>>(keys, n_left, ts, n_tails, n_rows,
                                                     p.grid.bits, cap, k_out, out, ov, tot);
  return cudaSuccess;
}

template <bool kGlobal>
static cudaError_t mw_filter(const MwPlan& p, const MwStarKeys& keys, int64_t n_left,
                             const GrpTails& ts, int n_tails, int64_t cap, int k_out,
                             char* scratch, int32_t* out, uint8_t* ov, int64_t* tot,
                             int* launches, cudaStream_t st) {
  GrpState s;
  cudaError_t err = grp_group<kGlobal>(p.grid, keys, n_left, ts, n_tails, scratch, tot, &s,
                                       launches, st);
  if (err != cudaSuccess) return err;
  mw_expand_kernel<<<das_blocks(cap), DAS_THREADS, 0, st>>>(
      cap, s, n_left, keys.lv, keys.lm, keys.kl, keys.vcol0, ts, n_tails, tot, k_out, out, ov);
  *launches += 1;
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
  GrpTails ts;
  ts.table = nullptr;
  int k_out;
  if (n_tails <= GRP_PARAM_TAILS) {
    if (!mw_tails(n_tails, tv, tm, rows, k, vcol, n_extra, extra, kl, ts.t, &k_out))
      return (int)cudaErrorInvalidValue;
  } else {
    // the descriptors go to the front of the scratch buffer; the copy from
    // pageable memory is staged before this call returns
    std::vector<GrpTail> desc(n_tails);
    if (!mw_tails(n_tails, tv, tm, rows, k, vcol, n_extra, extra, kl, desc.data(), &k_out))
      return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaMemcpyAsync(scratch, desc.data(), sizeof(GrpTail) * n_tails,
                                      cudaMemcpyHostToDevice, st);
    if (err != cudaSuccess) return (int)err;
    ts.table = (const GrpTail*)scratch;
    scratch = (char*)scratch + sizeof(GrpTail) * n_tails;
  }
  *regime = MW_REGIME_NAME[p.regime];
  const MwStarKeys keys{(const int32_t*)lv, (const uint8_t*)lm, kl, vcol0};
  int32_t* o = (int32_t*)out;
  uint8_t* v = (uint8_t*)ov;
  int64_t* tt = (int64_t*)tot;
  cudaError_t err;
  if (p.regime == MW_BLOCK) {
    err = mw_block(p, keys, n_left, ts, n_tails, cap, k_out, o, v, tt, st);
    if (err == cudaSuccess) *launches = 1;
  } else if (p.regime == MW_FILTER) {
    err = mw_filter<false>(p, keys, n_left, ts, n_tails, cap, k_out, (char*)scratch, o, v, tt,
                           launches, st);
  } else {
    err = mw_filter<true>(p, keys, n_left, ts, n_tails, cap, k_out, (char*)scratch, o, v, tt,
                          launches, st);
  }
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
