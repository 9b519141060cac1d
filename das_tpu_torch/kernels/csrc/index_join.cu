// Kernel 3: index join of a binding table into a whole link type.
//
// Replaces das_tpu/kernels/join.py index_join_impl (single-block
// _index_join_kernel_body and grid-chunked _tiled_index_join_body, both
// built on _index_join_window, _expand_window and _scan_offsets).  What the
// reference computes, bit for bit:
//   - the probe of left row i: type_key<<32 | (int64)vals[i, lc0] when the
//     row is valid (a negative value is sign-extended, so its probe is
//     negative and finds nothing in the non-negative keys), -1 otherwise;
//   - lo and hi: searchsorted left and right over the WHOLE posting column
//     (type<<32 | target, capacity-padded with int64 max);
//   - the count hi - lo, masked to 0 for an invalid row, and the int64
//     inclusive scan of the counts (summed as uint64, so it wraps as XLA's
//     int64 does); the total is the last offset, exact even past cap;
//   - for every slot j < cap: the left row li = upper_bound(offsets, j)
//     clipped to [0, n_left - 1], prev = offsets[li] - cnt[li], the source
//     row targets[clip(perm[clip(lo[li] + j - prev)])], the check of the
//     pairs after the first, and the emit [left row | right_extra]; a slot
//     at or past the total, or failing a check, is 0 with valid = False.
// n_left == 0 or n_keys == 0 gives total 0 and zeroed slots.  The right
// side is never materialized.
//
// Regimes, a pure function of n_left and cap, picked here (ij_plan) and
// reported to the wrapper by name:
//
//   block   ONE launch, no scratch, when n_left <= IJ_BLOCK_MAX_LEFT (128),
//           cap <= IJ_BLOCK_MAX_CAP (16,384) and n_left * cap <=
//           IJ_BLOCK_MAX_WORK (2^19): one thread-block cluster
//           of IJ_CLUSTER (8) blocks of 256 threads, on 8 SMs, whose state
//           lives in their shared memory (32 * n_left bytes a block).  The
//           2 * n_left searches (row, lower or upper bound) are dealt to
//           the blocks in turn and, within a block, to its warps in turn;
//           each is a 32-way cooperative search over the whole column
//           (common.cuh das_warp_search, ~5 dependent loads for 2^22 keys),
//           so a row's two bounds run side by side on two warps (searching
//           the upper bound from lo on the same warp took 8.61 us against
//           7.42 on the main path); an invalid row is not searched.  After
//           a cluster barrier every block reads all the bounds from their
//           owners' shared memory (Hopper's distributed shared memory),
//           scans the masked counts itself (das_block_scan, uint64), and
//           expands its share of the slots: thread x of block b takes
//           slots j0 + 256 * b + x and that + 2,048 a pass, so a warp's
//           loads of perm and its stores cover consecutive slots, with both
//           slots' loads in flight before either is stored.  Why a cluster
//           and not one block: one block's 32 warps send all the searches'
//           scattered loads through one SM, 32 lines a warp a step, and
//           that SM's load pipe set the time (7.47 us on the main path; a
//           round of 32 searches cost 4.4 us, so `global` was faster from
//           32 rows); spread over 8 SMs a round costs ~1.6-2 us.  The
//           limits are where `global` becomes faster on the card, which
//           depends on rows and slots together (PERF.md section 6,
//           scripts/profile_torch_kernels.py --sweep on the H100, block
//           against global in us): 128 rows at cap 4,096 12.68 / 12.69
//           and 129 rows 12.45 / 12.68; 64 rows at cap 8,192 11.80 / 12.36
//           and at 16,384 13.57 / 12.22; 16 rows at cap 16,384 8.68 /
//           10.37.  The main path's call (a gene's processes in a probe
//           capacity of 16 rows, cap 2,048) is one round of searches.
//   global  any larger left side or cap: a grid over left rows, each
//           thread searching its row's lower and upper bound by binary
//           searches interleaved step for step (two independent loads in
//           flight; one warp-cooperative search per row took 78.69 us
//           against 11.72 us on a 65,536-row left side, its scattered
//           lines outweighing its shallower chain); the hand-written
//           device-wide scan (primitives.cu das_scan_i64) of the counts in
//           place; an expand grid doing the cluster's expansion with the
//           offsets in device memory.  Scratch, which the C entry sizes
//           (das_index_join_scratch) and carves: lo and the counts (then
//           offsets), n_left int64 each, and the scan's block sums.
//           2 + das_scan_launches(n_left) launches (1 when n_left == 0).
//
// Bound: latency at the main path's shapes, bytes on large ones.  The call
// must read the left table, 2 x ~22 levels of the posting column per
// valid left row (the top levels shared), one perm entry and one targets
// row per valid slot, and write the output: tens of KB on the main path,
// nanoseconds at 3.35 TB/s, so the block regime is one launch whose chain
// of dependent loads (the probe value, ~5 search steps, the remote bounds,
// perm, then targets) sets its time.  ptxas (-Xptxas -v, sm_90a, CUDA
// 12.8): ij_block_kernel 48 registers, 8 bytes of stack (8 bytes spilled),
// 256 bytes of static shared memory; ij_bounds_kernel 30 registers,
// ij_expand_kernel 48, no spills.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define IJ_CLUSTER 8            // blocks of the block regime's cluster
#define IJ_CLUSTER_THREADS 256
#define IJ_BLOCK_MAX_LEFT 128
#define IJ_BLOCK_MAX_CAP 16384
#define IJ_BLOCK_MAX_WORK (1ll << 19)  // most n_left * cap
#define IJ_GRID_THREADS 256
#define IJ_SLOTS 2  // slots a thread expands per pass

namespace {

struct IjArgs {
  const int32_t* lv;       // [n_left, kl] left table
  const uint8_t* lm;       // [n_left] its mask
  const int64_t* keys;     // [n_keys] posting column, sorted, padded with int64 max
  const int32_t* perm;     // [n_keys] the row of each key
  const int32_t* targets;  // [n_rows, arity]
  int64_t n_left, n_keys, n_rows, type_key;
  int kl, lc0, arity;
  DasPairs checks;         // the pairs after the first: (left column, target position)
  DasCols extra;           // right_extra as target positions

  // the probe of a valid left row; the int32 value is sign-extended
  __device__ __forceinline__ int64_t probe(int64_t i) const {
    return (int64_t)(((uint64_t)type_key << 32) | (uint64_t)(int64_t)lv[i * kl + lc0]);
  }
};

// Expands slots [0, cap): pass by pass from `first` by IJ_SLOTS * lanes,
// this thread takes the slots j0 + s * lanes (s < IJ_SLOTS), where `lanes`
// threads of consecutive `first` share the passes, so a warp's loads of
// perm and its stores cover consecutive slots.  Each slot below the total
// finds its left row by an upper bound over the inclusive offsets and its
// key ri = lo[li] + j - prev, gathers perm and the targets row and checks
// the pairs; all the pass's rows are looked up before any is stored.  Every
// slot below cap is written, zeros where it fails.
__device__ __forceinline__ void ij_expand(const IjArgs& a, const int64_t* lo,
                                          const int64_t* offsets, int64_t total, int64_t first,
                                          int64_t lanes, int64_t cap, int32_t* out, uint8_t* ov) {
  const int k_out = a.kl + a.extra.n;
  for (int64_t j0 = first; j0 < cap; j0 += IJ_SLOTS * lanes) {
    const int32_t* row[IJ_SLOTS];
    int64_t li[IJ_SLOTS];
#pragma unroll
    for (int s = 0; s < IJ_SLOTS; ++s) {
      const int64_t j = j0 + s * lanes;
      row[s] = nullptr;
      li[s] = 0;
      if (j < cap && j < total && a.n_rows > 0) {
        const int64_t i = das_clamp(das_upper_bound<int64_t>(offsets, a.n_left, j), 0,
                                    a.n_left - 1);
        const int64_t prev = i > 0 ? offsets[i - 1] : 0;
        const int64_t ri = das_clamp(lo[i] + (j - prev), 0, a.n_keys - 1);
        const int32_t* r = a.targets + das_clamp((int64_t)a.perm[ri], 0, a.n_rows - 1) * a.arity;
        const int32_t* l = a.lv + i * a.kl;
        bool ok = true;
        for (int p = 0; p < a.checks.n; ++p) ok = ok && r[a.checks.b[p]] == l[a.checks.a[p]];
        row[s] = ok ? r : nullptr;
        li[s] = i;
      }
    }
#pragma unroll
    for (int s = 0; s < IJ_SLOTS; ++s) {
      const int64_t j = j0 + s * lanes;
      if (j >= cap) continue;
      int32_t* o = out + j * k_out;
      const int32_t* l = a.lv + li[s] * a.kl;
      const int32_t* r = row[s];
      for (int c = 0; c < a.kl; ++c) o[c] = r ? l[c] : 0;
      for (int c = 0; c < a.extra.n; ++c) o[a.kl + c] = r ? r[a.extra.c[c]] : 0;
      ov[j] = r ? 1 : 0;
    }
  }
}

// ---- regime block: one launch of one cluster -------------------------------------

// Search item k (row k / 2; lower bound for even k, upper for odd) belongs
// to block k % IJ_CLUSTER of the cluster, whose warps take its items in
// turn and keep each bound in their block's found[k]; after a cluster
// barrier every block reads the bounds of all rows from the owners' shared
// memory, scans the masked counts itself, and expands its share of the
// slots.  The second barrier keeps every block's shared memory alive until
// the others have read it.
__global__ void __cluster_dims__(IJ_CLUSTER, 1, 1) __launch_bounds__(IJ_CLUSTER_THREADS)
ij_block_kernel(const __grid_constant__ IjArgs a, int64_t cap, int32_t* out, uint8_t* ov,
                int64_t* tot) {
  extern __shared__ __align__(16) unsigned char ij_smem[];
  __shared__ uint64_t warp_tot[32];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int64_t n_left = a.n_left;
  int64_t* found = reinterpret_cast<int64_t*>(ij_smem);     // [2 * n_left] this block's bounds
  int64_t* lo = found + 2 * n_left;                          // [n_left] window's first key
  uint64_t* off = reinterpret_cast<uint64_t*>(lo + n_left);  // [n_left] count, then offset
  const int warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  for (int64_t k = (int64_t)warp * IJ_CLUSTER + rank; k < 2 * n_left;
       k += (int64_t)n_warps * IJ_CLUSTER) {
    const int64_t i = k >> 1;
    if (!a.lm[i]) continue;   // its count is 0 and its window never read
    const int64_t b = das_warp_search<int64_t>(a.keys, 0, a.n_keys, a.probe(i), k & 1);
    if ((threadIdx.x & 31) == 0) found[k] = b;
  }
  cluster.sync();
  for (int64_t i = threadIdx.x; i < n_left; i += blockDim.x) {
    off[i] = 0;
    if (!a.lm[i]) continue;
    const int64_t l = cluster.map_shared_rank(found, (int)((2 * i) % IJ_CLUSTER))[2 * i];
    const int64_t h = cluster.map_shared_rank(found, (int)((2 * i + 1) % IJ_CLUSTER))[2 * i + 1];
    lo[i] = l;
    off[i] = (uint64_t)(h - l);
  }
  cluster.sync();
  das_block_scan(off, n_left, warp_tot);
  const int64_t total = n_left > 0 ? (int64_t)off[n_left - 1] : 0;
  if (rank == 0 && threadIdx.x == 0) tot[0] = total;
  ij_expand(a, lo, reinterpret_cast<const int64_t*>(off), total,
            (int64_t)rank * blockDim.x + threadIdx.x, (int64_t)IJ_CLUSTER * blockDim.x, cap,
            out, ov);
}

// ---- regime global: bounds grid, device-wide scan, expand grid -------------------

// lower and upper bound of q over keys[0, n) by two binary searches whose
// steps are interleaved, so both loads of a step are in flight together
__device__ __forceinline__ void ij_equal_range(const int64_t* keys, int64_t n, int64_t q,
                                               int64_t* lower, int64_t* upper) {
  int64_t l0 = 0, l1 = n, h0 = 0, h1 = n;
  while (l0 < l1 || h0 < h1) {
    const int64_t ml = (l0 + l1) >> 1, mh = (h0 + h1) >> 1;
    const int64_t kl = l0 < l1 ? keys[ml] : 0;
    const int64_t kh = h0 < h1 ? keys[mh] : 0;
    if (l0 < l1) {
      if (kl < q) l0 = ml + 1; else l1 = ml;
    }
    if (h0 < h1) {
      if (kh <= q) h0 = mh + 1; else h1 = mh;
    }
  }
  *lower = l0;
  *upper = h0;
}

__global__ void ij_bounds_kernel(const __grid_constant__ IjArgs a, int64_t* lo, int64_t* cnt) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < a.n_left;
       i += (int64_t)gridDim.x * blockDim.x) {
    int64_t l = 0, h = 0;
    if (a.lm[i]) ij_equal_range(a.keys, a.n_keys, a.probe(i), &l, &h);
    lo[i] = l;
    cnt[i] = h - l;
  }
}

__global__ void ij_expand_kernel(const __grid_constant__ IjArgs a, int64_t cap,
                                 const int64_t* lo, const int64_t* offsets, int32_t* out,
                                 uint8_t* ov, int64_t* tot) {
  const int64_t total = a.n_left > 0 ? offsets[a.n_left - 1] : 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) tot[0] = total;
  ij_expand(a, lo, offsets, total, blockIdx.x * (int64_t)blockDim.x + threadIdx.x,
            (int64_t)gridDim.x * blockDim.x, cap, out, ov);
}

// ---- the plan and the entry ------------------------------------------------------

struct IjPlan {
  bool block;
  int64_t smem;     // regime block: dynamic shared memory of each block
  int64_t scan;     // regime global: int64 block sums of the scan
  int64_t bytes;    // regime global: the scratch buffer (lo, counts, block sums)
};

IjPlan ij_plan(int64_t n_left, int64_t cap) {
  IjPlan p;
  p.block = n_left <= IJ_BLOCK_MAX_LEFT && cap <= IJ_BLOCK_MAX_CAP &&
            n_left * cap <= IJ_BLOCK_MAX_WORK;
  p.smem = 32 * n_left;
  p.scan = p.block ? 0 : das_scan_scratch(n_left);
  p.bytes = p.block ? 0 : 8 * (2 * n_left + p.scan);
  return p;
}

unsigned ij_grid(int64_t n) {
  int64_t b = (n + IJ_GRID_THREADS * IJ_SLOTS - 1) / (IJ_GRID_THREADS * IJ_SLOTS);
  return (unsigned)(b < 1 ? 1 : (b > DAS_MAX_BLOCKS ? DAS_MAX_BLOCKS : b));
}

}  // namespace

// bytes of the scratch buffer das_index_join needs (0 in regime block)
extern "C" int64_t das_index_join_scratch(int64_t n_left, int64_t cap) {
  return ij_plan(n_left, cap).bytes;
}

// The join.  check_a / check_b: the pairs after the first, as (left
// column, target position); extra: right_extra as target positions.
// `scratch` holds das_index_join_scratch(n_left, cap) bytes (null when that
// is 0).  *launches = kernels launched, *regime = the regime's name.
extern "C" int das_index_join(const void* lv, const void* lm, int64_t n_left, int kl,
                              int lc0, int64_t type_key, const void* keys, int64_t n_keys,
                              const void* perm, const void* targets, int64_t n_rows,
                              int arity, const int* check_a, const int* check_b,
                              int n_check, const int* extra, int n_extra, int64_t cap,
                              void* scratch, void* out, void* ov, void* tot, int* launches,
                              const char** regime, void* stream) {
  *launches = 0;
  const IjPlan p = ij_plan(n_left, cap);
  *regime = p.block ? "block" : "global";
  if (n_check > DAS_MAXC || n_extra > DAS_MAXC || lc0 < 0 || lc0 >= kl)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const IjArgs a{(const int32_t*)lv, (const uint8_t*)lm, (const int64_t*)keys,
                 (const int32_t*)perm, (const int32_t*)targets, n_left, n_keys, n_rows,
                 type_key, kl, lc0, arity, das_pairs(check_a, check_b, n_check),
                 das_cols(extra, n_extra)};
  if (p.block) {   // 32 * IJ_BLOCK_MAX_LEFT bytes: no attribute beyond the default 48 KB
    ij_block_kernel<<<IJ_CLUSTER, IJ_CLUSTER_THREADS, (size_t)p.smem, st>>>(
        a, cap, (int32_t*)out, (uint8_t*)ov, (int64_t*)tot);
    *launches = 1;
    return (int)cudaGetLastError();
  }
  int64_t* lo = (int64_t*)scratch;
  int64_t* offsets = lo + n_left;
  if (n_left > 0) {
    ij_bounds_kernel<<<das_blocks(n_left), DAS_THREADS, 0, st>>>(a, lo, offsets);
    cudaError_t err = das_scan_i64(offsets, offsets, n_left, offsets + n_left, p.scan, st);
    if (err != cudaSuccess) return (int)err;
    *launches = 1 + das_scan_launches(n_left);
  }
  ij_expand_kernel<<<ij_grid(cap), IJ_GRID_THREADS, 0, st>>>(a, cap, lo, offsets, (int32_t*)out,
                                                             (uint8_t*)ov, (int64_t*)tot);
  *launches += 1;
  return (int)cudaGetLastError();
}
