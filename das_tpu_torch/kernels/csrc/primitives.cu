// Device-wide primitives of the join kernels: the column mix, an int64
// inclusive scan and a stable LSD radix sort of int64 keys.
//
// Replaces, inside das_tpu/kernels/join.py, the in-kernel `jnp.argsort` /
// `jnp.sort` of the right keys (_join_prologue, _anti_kernel_body) and the
// `associative_scan` of the per-row pair counts (_scan_offsets).  On the
// TPU those ran on one core over a VMEM-resident block; on Hopper they are
// grid-wide, so each is a short sequence of launches on one stream.
//
// Bound: memory traffic.  The scan reads and writes each int64 once per
// level; the sort makes 8 passes, each reading the keys twice (histogram,
// scatter) and writing them once with a scattered store.  The simple design
// keeps every pass a plain grid over fixed tiles (no decoupled look-back,
// no onesweep), which is correct first and leaves speed to later work.
#include "common.cuh"

#define SCAN_ITEMS 8
#define SCAN_TILE (DAS_THREADS * SCAN_ITEMS)
#define SORT_ITEMS 16
#define SORT_TILE (DAS_THREADS * SORT_ITEMS)
#define SORT_WARPS (DAS_THREADS / 32)

__global__ void mix_kernel(const int32_t* vals, int64_t n, int k, const uint8_t* valid,
                           DasCols cols, int64_t sentinel, int64_t* key) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    key[i] = valid[i] ? das_mix_row(vals + i * k, cols) : sentinel;
  }
}

void das_mix(const int32_t* vals, int64_t n, int k, const uint8_t* valid, DasCols cols,
             int64_t sentinel, int64_t* key, cudaStream_t st) {
  if (n > 0) mix_kernel<<<das_blocks(n), DAS_THREADS, 0, st>>>(vals, n, k, valid, cols,
                                                               sentinel, key);
}

// ---- scan -------------------------------------------------------------------

// inclusive scan of one SCAN_TILE tile per block; the tile's total goes to
// block_sums[blockIdx.x].  Each thread sums SCAN_ITEMS consecutive items,
// the per-thread totals are scanned with warp shuffles, then written back.
__global__ void scan_tile_kernel(const int64_t* in, int64_t* out, int64_t n,
                                 int64_t* block_sums) {
  __shared__ int64_t warp_tot[DAS_THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t base = (int64_t)blockIdx.x * SCAN_TILE + (int64_t)tid * SCAN_ITEMS;
  int64_t v[SCAN_ITEMS];
  int64_t run = 0;
#pragma unroll
  for (int i = 0; i < SCAN_ITEMS; ++i) {
    int64_t idx = base + i;
    run += idx < n ? in[idx] : 0;
    v[i] = run;
  }
  int64_t s = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int64_t t = __shfl_up_sync(0xffffffffu, s, o);
    if (lane >= o) s += t;
  }
  if (lane == 31) warp_tot[warp] = s;
  __syncthreads();
  if (warp == 0) {
    int64_t w = lane < DAS_THREADS / 32 ? warp_tot[lane] : 0;
#pragma unroll
    for (int o = 1; o < DAS_THREADS / 32; o <<= 1) {
      int64_t t = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += t;
    }
    if (lane < DAS_THREADS / 32) warp_tot[lane] = w;
  }
  __syncthreads();
  const int64_t excl = s - run + (warp > 0 ? warp_tot[warp - 1] : 0);
#pragma unroll
  for (int i = 0; i < SCAN_ITEMS; ++i) {
    int64_t idx = base + i;
    if (idx < n) out[idx] = v[i] + excl;
  }
  if (tid == DAS_THREADS - 1) block_sums[blockIdx.x] = excl + run;
}

// adds the scanned sum of all earlier tiles to every item of tile b > 0
__global__ void scan_add_kernel(int64_t* out, int64_t n, const int64_t* scanned_sums) {
  if (blockIdx.x == 0) return;
  const int64_t add = scanned_sums[blockIdx.x - 1];
  const int64_t base = (int64_t)blockIdx.x * SCAN_TILE;
  for (int i = threadIdx.x; i < SCAN_TILE; i += DAS_THREADS) {
    int64_t idx = base + i;
    if (idx < n) out[idx] += add;
  }
}

static int64_t scan_tiles(int64_t n) { return (n + SCAN_TILE - 1) / SCAN_TILE; }

int64_t das_scan_scratch(int64_t n) {
  int64_t total = 0;
  while (n > 0) {
    int64_t nb = scan_tiles(n);
    total += nb;
    if (nb <= 1) break;
    n = nb;
  }
  return total;
}

cudaError_t das_scan_i64(const int64_t* in, int64_t* out, int64_t n, int64_t* scratch,
                         int64_t scratch_len, cudaStream_t st) {
  if (n <= 0) return cudaSuccess;
  const int64_t nb = scan_tiles(n);
  if (nb > scratch_len) return cudaErrorInvalidValue;
  scan_tile_kernel<<<(unsigned)nb, DAS_THREADS, 0, st>>>(in, out, n, scratch);
  if (nb > 1) {
    cudaError_t err = das_scan_i64(scratch, scratch, nb, scratch + nb, scratch_len - nb, st);
    if (err != cudaSuccess) return err;
    scan_add_kernel<<<(unsigned)nb, DAS_THREADS, 0, st>>>(out, n, scratch);
  }
  return cudaGetLastError();
}

// ---- radix sort ---------------------------------------------------------------

#define SIGN_BIT 0x8000000000000000ull

// flip the sign bit so unsigned digit order is signed key order; the
// payload starts as the identity permutation
__global__ void sort_prep_kernel(const int64_t* keys, int64_t n, uint64_t* k_out,
                                 int32_t* idx_out) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    k_out[i] = (uint64_t)keys[i] ^ SIGN_BIT;
    idx_out[i] = (int32_t)i;
  }
}

__global__ void sort_finish_kernel(uint64_t* k, int64_t n) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    k[i] ^= SIGN_BIT;
  }
}

// digit counts of one tile, stored digit-major: hist[d * n_tiles + tile]
__global__ void sort_hist_kernel(const uint64_t* k, int64_t n, int shift, int64_t n_tiles,
                                 int64_t* hist) {
  __shared__ int32_t h[256];
  h[threadIdx.x] = 0;
  __syncthreads();
  const int64_t base = (int64_t)blockIdx.x * SORT_TILE;
  for (int i = threadIdx.x; i < SORT_TILE; i += DAS_THREADS) {
    int64_t idx = base + i;
    if (idx < n) atomicAdd(&h[(k[idx] >> shift) & 255], 1);
  }
  __syncthreads();
  hist[(int64_t)threadIdx.x * n_tiles + blockIdx.x] = h[threadIdx.x];
}

// stable scatter of one tile.  The tile is walked in rounds of DAS_THREADS
// consecutive items; inside a round an item's rank among equal digits is
// its rank among matching lanes of its warp (__match_any_sync) plus the
// counts of the same digit in earlier warps, earlier rounds and (through
// the digit-major scan) earlier tiles — so equal keys keep input order.
__global__ void sort_scatter_kernel(const uint64_t* k_in, const int32_t* v_in, int64_t n,
                                    int shift, int64_t n_tiles, const int64_t* hist,
                                    const int64_t* hist_incl, uint64_t* k_out,
                                    int32_t* v_out) {
  __shared__ int64_t base[256];
  __shared__ int32_t wpre[SORT_WARPS][256];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t cell = (int64_t)tid * n_tiles + blockIdx.x;
  base[tid] = hist_incl[cell] - hist[cell];
  const unsigned lt_mask = (1u << lane) - 1u;
  for (int r = 0; r < SORT_ITEMS; ++r) {
#pragma unroll
    for (int w = 0; w < SORT_WARPS; ++w) wpre[w][tid] = 0;
    __syncthreads();
    const int64_t idx = (int64_t)blockIdx.x * SORT_TILE + (int64_t)r * DAS_THREADS + tid;
    const bool active = idx < n;
    const uint64_t key = active ? k_in[idx] : 0;
    const int32_t val = active ? v_in[idx] : 0;
    const int d = (int)((key >> shift) & 255);
    // inactive lanes (the ragged tail) match only themselves
    const unsigned peers = __match_any_sync(0xffffffffu, active ? d : 256 + lane);
    const int rank = __popc(peers & lt_mask);
    if (active && rank == 0) wpre[warp][d] = __popc(peers);
    __syncthreads();
    int32_t off = 0;
#pragma unroll
    for (int w = 0; w < SORT_WARPS; ++w) {
      int32_t c = wpre[w][tid];
      wpre[w][tid] = off;
      off += c;
    }
    __syncthreads();
    if (active) {
      const int64_t pos = base[d] + wpre[warp][d] + rank;
      k_out[pos] = key;
      v_out[pos] = val;
    }
    __syncthreads();
    base[tid] += off;
  }
}

int64_t das_sort_tiles(int64_t n) { return (n + SORT_TILE - 1) / SORT_TILE; }

cudaError_t das_radix_sort_i64(const int64_t* keys, int64_t n, int64_t* keys_out,
                               int32_t* idx_out, int64_t* tmp_keys, int32_t* tmp_idx,
                               int64_t* hist, int64_t* hist_incl, int64_t* scan_scratch,
                               int64_t scan_len, cudaStream_t st) {
  if (n <= 0) return cudaSuccess;
  const int64_t n_tiles = das_sort_tiles(n);
  uint64_t* a_k = reinterpret_cast<uint64_t*>(keys_out);
  uint64_t* b_k = reinterpret_cast<uint64_t*>(tmp_keys);
  sort_prep_kernel<<<das_blocks(n), DAS_THREADS, 0, st>>>(keys, n, a_k, idx_out);
  // 8 passes ping-pong keys_out -> tmp -> keys_out ...; an even count
  // leaves the result in keys_out / idx_out
  for (int pass = 0; pass < 8; ++pass) {
    const int shift = 8 * pass;
    const bool even = (pass & 1) == 0;
    const uint64_t* src_k = even ? a_k : b_k;
    const int32_t* src_v = even ? idx_out : tmp_idx;
    uint64_t* dst_k = even ? b_k : a_k;
    int32_t* dst_v = even ? tmp_idx : idx_out;
    sort_hist_kernel<<<(unsigned)n_tiles, DAS_THREADS, 0, st>>>(src_k, n, shift, n_tiles,
                                                                 hist);
    cudaError_t err = das_scan_i64(hist, hist_incl, 256 * n_tiles, scan_scratch, scan_len, st);
    if (err != cudaSuccess) return err;
    sort_scatter_kernel<<<(unsigned)n_tiles, DAS_THREADS, 0, st>>>(
        src_k, src_v, n, shift, n_tiles, hist, hist_incl, dst_k, dst_v);
  }
  sort_finish_kernel<<<das_blocks(n), DAS_THREADS, 0, st>>>(a_k, n);
  return cudaGetLastError();
}

// ---- C entry points of the primitives (exercised by the card tests) ----------

extern "C" int das_scan_inclusive_i64(const void* in, void* out, int64_t n, void* scratch,
                                      int64_t scratch_len, void* stream) {
  cudaError_t err = das_scan_i64((const int64_t*)in, (int64_t*)out, n, (int64_t*)scratch,
                                 scratch_len, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int das_argsort_i64(const void* keys, int64_t n, void* keys_out, void* idx_out,
                               void* tmp_keys, void* tmp_idx, void* hist, void* hist_incl,
                               void* scan_scratch, int64_t scan_len, void* stream) {
  cudaError_t err = das_radix_sort_i64(
      (const int64_t*)keys, n, (int64_t*)keys_out, (int32_t*)idx_out, (int64_t*)tmp_keys,
      (int32_t*)tmp_idx, (int64_t*)hist, (int64_t*)hist_incl, (int64_t*)scan_scratch,
      scan_len, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
