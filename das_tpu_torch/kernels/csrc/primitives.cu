// Device-wide primitives of the join kernels: an int64 inclusive scan, and
// the small host helpers the C entries share (set sizes, launch counts,
// the shared-memory attribute, error names).
//
// Replaces, inside das_tpu/kernels/join.py and multiway.py, the
// `associative_scan` of the per-row pair counts (_scan_offsets).  On the
// TPU it ran on one core over a VMEM-resident block; on Hopper it is
// grid-wide, so it is a short sequence of launches on one stream.  No
// kernel sorts: the joins group rows stably instead (group.cuh).
//
// Bound: memory traffic.  The scan reads and writes each int64 once per
// level.  The simple design keeps every pass a plain grid over fixed tiles
// (no decoupled look-back), which is correct first and leaves speed to
// later work.
#include "common.cuh"

#define SCAN_ITEMS 8
#define SCAN_TILE (DAS_THREADS * SCAN_ITEMS)

// ---- scan -------------------------------------------------------------------

// inclusive scan of one SCAN_TILE tile per block; the tile's total goes to
// block_sums[blockIdx.x].  Each thread sums SCAN_ITEMS consecutive items,
// the per-thread totals are scanned with warp shuffles, then written back.
// The sums run in uint64 so they wrap as XLA's int64 sums do (signed
// overflow is undefined in C++).
__global__ void scan_tile_kernel(const int64_t* in, int64_t* out, int64_t n,
                                 int64_t* block_sums) {
  __shared__ uint64_t warp_tot[DAS_THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t base = (int64_t)blockIdx.x * SCAN_TILE + (int64_t)tid * SCAN_ITEMS;
  uint64_t v[SCAN_ITEMS];
  uint64_t run = 0;
#pragma unroll
  for (int i = 0; i < SCAN_ITEMS; ++i) {
    int64_t idx = base + i;
    run += idx < n ? (uint64_t)in[idx] : 0ull;
    v[i] = run;
  }
  uint64_t s = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    uint64_t t = __shfl_up_sync(0xffffffffu, s, o);
    if (lane >= o) s += t;
  }
  if (lane == 31) warp_tot[warp] = s;
  __syncthreads();
  if (warp == 0) {
    uint64_t w = lane < DAS_THREADS / 32 ? warp_tot[lane] : 0ull;
#pragma unroll
    for (int o = 1; o < DAS_THREADS / 32; o <<= 1) {
      uint64_t t = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += t;
    }
    if (lane < DAS_THREADS / 32) warp_tot[lane] = w;
  }
  __syncthreads();
  const uint64_t excl = s - run + (warp > 0 ? warp_tot[warp - 1] : 0ull);
#pragma unroll
  for (int i = 0; i < SCAN_ITEMS; ++i) {
    int64_t idx = base + i;
    if (idx < n) out[idx] = (int64_t)(v[i] + excl);
  }
  if (tid == DAS_THREADS - 1) block_sums[blockIdx.x] = (int64_t)(excl + run);
}

// adds the scanned sum of all earlier tiles to every item of tile b > 0
__global__ void scan_add_kernel(int64_t* out, int64_t n, const int64_t* scanned_sums) {
  if (blockIdx.x == 0) return;
  const uint64_t add = (uint64_t)scanned_sums[blockIdx.x - 1];
  const int64_t base = (int64_t)blockIdx.x * SCAN_TILE;
  for (int i = threadIdx.x; i < SCAN_TILE; i += DAS_THREADS) {
    int64_t idx = base + i;
    if (idx < n) out[idx] = (int64_t)((uint64_t)out[idx] + add);
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

int das_set_bits(int64_t n) {
  int bits = 5;
  while ((1ll << bits) < 2 * n) ++bits;
  return bits;
}

int das_scan_launches(int64_t n) {
  if (n <= 0) return 0;
  const int64_t nb = scan_tiles(n);
  return nb > 1 ? 2 + das_scan_launches(nb) : 1;
}

cudaError_t das_smem_attr(const void* kernel, int bytes, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < DAS_MAX_DEVICES && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < DAS_MAX_DEVICES) done[dev] = true;
  return err;
}

// ---- C entry points of the primitives (exercised by the card tests) ----------

// the CUDA error's name, for the wrappers' messages
extern "C" const char* das_error_name(int err) { return cudaGetErrorName((cudaError_t)err); }

extern "C" int das_scan_inclusive_i64(const void* in, void* out, int64_t n, void* scratch,
                                      int64_t scratch_len, void* stream) {
  cudaError_t err = das_scan_i64((const int64_t*)in, (int64_t*)out, n, (int64_t*)scratch,
                                 scratch_len, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
