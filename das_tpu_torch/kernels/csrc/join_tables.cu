// Kernel 2: sort-merge equi-join of two materialized binding tables, with
// no sort.
//
// Replaces das_tpu/kernels/join.py join_tables_impl (single-block
// _join_kernel_body and grid-chunked _tiled_join_body, built on
// _join_prologue, _expand_window and _emit_pairs).  What the reference
// computes: the int64 mix of each side's join columns (sentinels 2^63-1
// for an invalid left row, 2^63-2 for an invalid right row), a STABLE
// argsort of the right keys, lo/hi of every left key (the count of an
// invalid left row is not masked), the int64 inclusive scan of the counts,
// then per output slot j the left row li = upper_bound(offsets, j) and the
// right row order[lo[li] + j - prev[li]], the exact check of every pair and
// of both masks, and the emit [left | right_extra]; the total is exact
// even past cap.
//
// Why nothing is sorted.  The output depends only on each left row's
// window: the right rows whose mixed key equals its key, in increasing row
// order (the stable sort).  So the right rows are grouped stably by key,
// and a left row's window is its key's group.  A two-pair key is a full
// int64 mix, so a valid key may equal either sentinel: an invalid left row
// (2^63-1) takes the window of the valid right rows whose key is 2^63-1,
// and a valid left key equal to 2^63-2 takes the window of the invalid
// right rows.  Those slots count in the total and fail the exact check,
// as do slots of keys that collide between different values.  The set's
// empty marker is 2^63-1; a key equal to it takes the id in the word after
// the slots (group.cuh, the anti join's marker-plus-flag), so every key,
// the sentinels included, gets exactly its argsort + searchsorted window.
//
// Regimes, a pure function of n_left, n_right and cap, picked here
// (jt_plan) and reported to the wrapper by name:
//
//   block   ONE launch of one block (256 threads when n_left + n_right +
//           cap <= 8,192, else 1,024), everything in dynamic shared memory:
//           each row's key mixed where the row is read; a set of the right
//           keys (2^bits >= 2 * n_right slots of int64 key + int32 id) with
//           dense ids; per-id counts and their block scan; the right rows
//           placed stably by id (grp_place_round: warps in turn, equal ids
//           in a warp by lane); each left row's count (0 when its key is
//           absent) and their block scan (the offsets), the total and the
//           expansion over the cap slots.  12 * 2^bits + 4 + 24 * n_right
//           + 12 * n_left bytes <= JT_BLOCK_MAX_BYTES (200,000), with
//           cap <= JT_BLOCK_MAX_CAP (16,384).  The main path's join (a few
//           thousand left rows, a few dozen right rows) needs ~50 KB.
//   global  the stable grouping engine of group.cuh, which the multiway
//           join runs too, as its one-tail case with an int64 key
//           (JtLeftKeys): the set of the LEFT keys (every row; an invalid
//           row's key is its sentinel) and the bin counts in device memory,
//           the right rows filtered by the set (an invalid row by its
//           sentinel) and grouped stably by id, the per-row counts, their
//           scan, then an expand grid.  7 launches, more when a scan of
//           more than 2,048 counts recurses.
//
// An empty side gives total 0 and zeroed slots (block: one launch; global:
// the expand grid alone).
//
// Bound at the main-path shapes: launch latency and the wrapper's host
// time.  The bytes the call must move (both tables, the output) are tens
// of KB, nanoseconds at 3.35 TB/s, so the block regime is one launch with
// no scratch tensor.  ptxas (-Xptxas -v, sm_90a, CUDA 12.8):
// jt_block_kernel 32 registers, jt_expand_kernel 38, no spills; the
// engine's count kernel on int64 keys spills 48 bytes at its 40-register
// cap (regime global only).
#include "group.cuh"

#define JT_BLOCK_THREADS 1024
#define JT_SMALL_THREADS 256
#define JT_BLOCK_MAX_BYTES 200000
#define JT_BLOCK_MAX_CAP 16384
#define JT_SENTINEL_L ((int64_t)0x7FFFFFFFFFFFFFFFll)
#define JT_SENTINEL_R ((int64_t)0x7FFFFFFFFFFFFFFEll)
#define JT_EMPTY JT_SENTINEL_L

namespace {

// one side of the join: its table, mask, width, join columns and the key
// of its invalid rows
struct JtSide {
  const int32_t* v;
  const uint8_t* m;
  int k;
  DasCols cols;
  int64_t sentinel;
  __device__ __forceinline__ int64_t key(int64_t i) const {
    return m[i] ? das_mix_row(v + i * k, cols) : sentinel;
  }
};

struct JtArgs {
  JtSide left, right;
  DasCols extra;         // right columns appended to the output row
  int64_t n_left, n_right;
};

// the engine's key policy in regime global: the set holds the left keys,
// the one tail is the right side
struct JtLeftKeys {
  using K = int64_t;
  static constexpr bool kMarked = true;
  static constexpr int64_t kEmpty = JT_EMPTY;
  JtSide left, right;
  __device__ __forceinline__ bool left_key(int64_t i, int64_t* key) const {
    *key = left.key(i);
    return true;
  }
  struct Row {
    int64_t key;
  };
  __device__ __forceinline__ Row tail_row(const GrpTail&, int64_t row) const {
    return Row{right.key(row)};
  }
  __device__ __forceinline__ bool tail_key(const Row& r, int64_t* key) const {
    *key = r.key;
    return true;
  }
};

// regime block: the set holds the right keys (read where the kernel
// parameter holds them, so no copy of the side goes to local memory)
struct JtRightKeys {
  using K = int64_t;
  static constexpr bool kMarked = true;
  static constexpr int64_t kEmpty = JT_EMPTY;
  const JtSide* right;
  __device__ __forceinline__ bool left_key(int64_t i, int64_t* key) const {
    *key = right->key(i);
    return true;
  }
};

// Slot j: the pair (li, ri) when `valid` (j < total), checked exactly —
// both masks and every pair of columns — then [left | right_extra] or zeros.
__device__ __forceinline__ void jt_emit(int64_t j, bool valid, int64_t li, int64_t ri,
                                        const JtArgs& a, int32_t* out, uint8_t* ov) {
  const JtSide& l = a.left;
  const JtSide& r = a.right;
  const int k_out = l.k + a.extra.n;
  int32_t* o = out + j * k_out;
  if (valid) {
    valid = l.m[li] != 0 && r.m[ri] != 0;
    for (int p = 0; p < l.cols.n; ++p)
      valid = valid && l.v[li * l.k + l.cols.c[p]] == r.v[ri * r.k + r.cols.c[p]];
  }
  if (!valid) {
    for (int c = 0; c < k_out; ++c) o[c] = 0;
    ov[j] = 0;
    return;
  }
  const int32_t* lrow = l.v + li * l.k;
  const int32_t* rrow = r.v + ri * r.k;
  for (int c = 0; c < l.k; ++c) o[c] = lrow[c];
  for (int c = 0; c < a.extra.n; ++c) o[l.k + c] = rrow[a.extra.c[c]];
  ov[j] = 1;
}

// ---- regime block: one launch --------------------------------------------------

__global__ void __launch_bounds__(JT_BLOCK_THREADS)
jt_block_kernel(const __grid_constant__ JtArgs a, int bits, int64_t cap, int32_t* out,
                uint8_t* ov, int64_t* tot) {
  extern __shared__ __align__(16) unsigned char jt_smem[];
  __shared__ uint64_t warp_tot[32];
  __shared__ int32_t wflag[64];
  const int64_t n_left = a.n_left, n_right = a.n_right, slots = 1ll << bits;
  uint64_t* off = reinterpret_cast<uint64_t*>(jt_smem);      // [n_left] counts, then offsets
  uint64_t* incl = off + n_left;                              // [ids] inclusive scan of cnt
  int64_t* skey = reinterpret_cast<int64_t*>(incl + n_right);  // [slots]
  int32_t* sid = reinterpret_cast<int32_t*>(skey + slots);     // [slots + 1]
  int32_t* rid = sid + slots + 1;                              // [n_right] id of each right row
  uint32_t* cnt = reinterpret_cast<uint32_t*>(rid + n_right);  // [ids] rows per id
  int32_t* base = reinterpret_cast<int32_t*>(cnt + n_right);   // [ids] next slot per id
  int32_t* grouped = base + n_right;                           // [n_right] rows grouped by id
  int32_t* lid = grouped + n_right;                            // [n_left] id of each left key

  const int64_t n_ids = grp_build_set(JtRightKeys{&a.right}, n_right, skey, sid, bits, rid,
                                      warp_tot);
  for (int64_t d = threadIdx.x; d < n_ids; d += blockDim.x) cnt[d] = 0;
  __syncthreads();
  for (int64_t j = threadIdx.x; j < n_right; j += blockDim.x) atomicAdd(cnt + rid[j], 1u);
  __syncthreads();
  for (int64_t d = threadIdx.x; d < n_ids; d += blockDim.x) incl[d] = cnt[d];
  __syncthreads();
  das_block_scan(incl, n_ids, warp_tot);
  for (int64_t d = threadIdx.x; d < n_ids; d += blockDim.x) base[d] = (int32_t)(incl[d] - cnt[d]);
  __syncthreads();
  int parity = 0;
  for (int64_t r0 = 0; r0 < n_right; r0 += blockDim.x, parity ^= 1) {
    const int64_t j = r0 + threadIdx.x;
    grp_place_round(j < n_right ? rid[j] : -1, (int32_t)j, base, grouped, wflag, parity);
  }
  for (int64_t i = threadIdx.x; i < n_left; i += blockDim.x) {
    const int32_t d = grp_find<JtRightKeys>(skey, sid, bits, a.left.key(i));
    lid[i] = d;
    off[i] = d >= 0 ? cnt[d] : 0;
  }
  __syncthreads();
  das_block_scan(off, n_left, warp_tot);
  const int64_t total = n_left > 0 ? (int64_t)off[n_left - 1] : 0;
  if (threadIdx.x == 0) tot[0] = total;
  const int64_t* offsets = reinterpret_cast<const int64_t*>(off);
  for (int64_t j = threadIdx.x; j < cap; j += blockDim.x) {
    const bool valid = j < total;
    int64_t li = 0, ri = 0;
    if (valid) {
      li = das_clamp(das_upper_bound<int64_t>(offsets, n_left, j), 0, n_left - 1);
      const int32_t d = lid[li];
      const int64_t prev = offsets[li] - (int64_t)cnt[d];
      ri = grouped[(int64_t)(incl[d] - cnt[d]) + (j - prev)];
    }
    jt_emit(j, valid, li, ri, a, out, ov);
  }
}

// ---- regime global: the engine's grid passes, then this ---------------------------

__global__ void jt_expand_kernel(int64_t cap, GrpState s, const __grid_constant__ JtArgs a,
                                 int64_t* tot, int32_t* out, uint8_t* ov) {
  const int64_t n_left = a.n_left;
  const bool empty = n_left == 0 || a.n_right == 0;
  const int64_t total = empty ? 0 : tot[0];
  if (empty && blockIdx.x == 0 && threadIdx.x == 0) tot[0] = 0;
  for (int64_t j = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; j < cap;
       j += (int64_t)gridDim.x * blockDim.x) {
    const bool valid = j < total;
    int64_t li = 0, ri = 0;
    if (valid) {
      li = das_clamp(das_upper_bound<int64_t>(s.offsets, n_left, j), 0, n_left - 1);
      int64_t lo;
      grp_window(s.lid[li], 0, 1, s.hist, s.incl, s.G, &lo);
      ri = s.grouped[lo + (j - (s.offsets[li] - s.run[li]))];
    }
    jt_emit(j, valid, li, ri, a, out, ov);
  }
}

// ---- the plan and the entry ------------------------------------------------------

struct JtPlan {
  bool block;
  int bits;              // regime block: log2 slots of the right keys' set
  int64_t smem;          // regime block: dynamic shared memory
  GrpPlan grid;          // regime global: the engine's plan (bytes: the scratch buffer)
};

JtPlan jt_plan(int64_t n_left, int64_t n_right, int64_t cap) {
  JtPlan p;
  p.bits = das_set_bits(n_right);
  p.smem = 12 * (1ll << p.bits) + 4 + 24 * n_right + 12 * n_left;
  p.block = p.smem <= JT_BLOCK_MAX_BYTES && cap <= JT_BLOCK_MAX_CAP;
  p.grid = grp_plan<JtLeftKeys>(n_left, 1, n_right, 0, true);
  if (p.block || n_left == 0 || n_right == 0) p.grid.bytes = 0;
  return p;
}

}  // namespace

// bytes of the scratch buffer das_join_tables needs (0 in regime block and
// for an empty side)
extern "C" int64_t das_join_tables_scratch(int64_t n_left, int64_t n_right, int64_t cap) {
  return jt_plan(n_left, n_right, cap).grid.bytes;
}

// The join.  pair_l / pair_r: the n_pairs join columns of each side;
// extra: the right columns appended to the output.  `scratch` holds
// das_join_tables_scratch(...) bytes (null when that is 0).  *launches =
// kernels launched, *regime = the regime's name.
extern "C" int das_join_tables(const void* lv, const void* lm, int64_t n_left, int kl,
                               const void* rv, const void* rm, int64_t n_right, int kr,
                               const int* pair_l, const int* pair_r, int n_pairs,
                               const int* extra, int n_extra, int64_t cap, void* scratch,
                               void* out, void* ov, void* tot, int* launches,
                               const char** regime, void* stream) {
  *launches = 0;
  const JtPlan p = jt_plan(n_left, n_right, cap);
  *regime = p.block ? "block" : "global";
  if (n_pairs > DAS_MAXC || n_extra > DAS_MAXC) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const JtArgs a{JtSide{(const int32_t*)lv, (const uint8_t*)lm, kl, das_cols(pair_l, n_pairs),
                        JT_SENTINEL_L},
                 JtSide{(const int32_t*)rv, (const uint8_t*)rm, kr, das_cols(pair_r, n_pairs),
                        JT_SENTINEL_R},
                 das_cols(extra, n_extra), n_left, n_right};
  if (p.block) {
    static bool attr_done[DAS_MAX_DEVICES];
    cudaError_t err = das_smem_attr((const void*)jt_block_kernel, JT_BLOCK_MAX_BYTES, attr_done);
    if (err != cudaSuccess) return (int)err;
    const unsigned threads =
        n_left + n_right + cap <= 8192 ? JT_SMALL_THREADS : JT_BLOCK_THREADS;
    jt_block_kernel<<<1, threads, (size_t)p.smem, st>>>(a, p.bits, cap, (int32_t*)out,
                                                        (uint8_t*)ov, (int64_t*)tot);
    *launches = 1;
    return (int)cudaGetLastError();
  }
  GrpState s{};
  int n = 0;
  if (n_left > 0 && n_right > 0) {
    GrpTails ts;
    ts.table = nullptr;
    ts.t[0] = GrpTail{(const int32_t*)rv, (const uint8_t*)rm, n_right, 0, kr, 0, kl,
                      das_cols(extra, n_extra)};
    cudaError_t err = grp_group<true>(p.grid, JtLeftKeys{a.left, a.right}, n_left, ts, 1,
                                      (char*)scratch, (int64_t*)tot, &s, &n, st);
    if (err != cudaSuccess) return (int)err;
  }
  jt_expand_kernel<<<das_blocks(cap), DAS_THREADS, 0, st>>>(cap, s, a, (int64_t*)tot,
                                                          (int32_t*)out, (uint8_t*)ov);
  *launches = n + 1;
  return (int)cudaGetLastError();
}
